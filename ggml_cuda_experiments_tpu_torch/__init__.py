"""ggml_cuda_experiments_tpu_torch — the PyTorch/CUDA port for NVIDIA Hopper.

A second package beside ``ggml_cuda_experiments_tpu`` (the JAX/Pallas
reference, which stays as it is). Plain tensor code is PyTorch; every Pallas
kernel on the ported path has a hand-written CUDA C++ counterpart for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes``. The package imports neither jax nor anything of the reference
package: it keeps its own copies of the configurations (``models.config``)
and of the oracles (``oracle``).

Subpackages
-----------
- ``ops``     kernel wrappers (``quant_matmul``, ``flash_decode``,
              ``flash_attention``, ``prefill_fuse``, ``paged_attention``,
              ``fused_attention``, ``layer_kernel``, the dense GEMM
              ``matmul``, the staging / reduction ``primitives``), the LSE
              merge (``lse``) and the build (``_build``). Each wrapper runs
              its plain PyTorch version for a CPU tensor and launches its
              kernel (or raises) for a CUDA one.
- ``csrc``    the CUDA C++ kernels, each with a plain C entry point.
- ``models``  the Llama model (``generate`` and its batch-1 decode
              branches), the serving ``Engine``, sampling, the
              configurations and the bridge from the JAX parameters.
- ``parallel`` several ranks over ``torch.distributed``: the mesh and its
              collectives, ``run_spmd``, ring / Ulysses attention and the
              context-parallel decode, tensor, pipeline and 5-axis steps,
              the multi-host layer.
- ``oracle``  the NumPy oracles: the quantization formats and per-row
              KV codecs (``quant``), attention (``attention``) and the
              full-model forward and perplexity (``model``).
- ``utils``   platform selection (the card unless a device is named),
              device facts, the correctness harness (``harness``) and
              device timing (``bench``).
- ``tools``   the kernel lab's tools (``kernel_test``, ``gemm_bench``,
              ``perplexity``, ...) and ``multihost_run``, each run with
              ``python -m``.
"""

__version__ = "0.1.0"
