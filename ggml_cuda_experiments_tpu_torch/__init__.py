"""ggml_cuda_experiments_tpu_torch — the PyTorch/CUDA port for NVIDIA Hopper.

A second package beside ``ggml_cuda_experiments_tpu`` (the JAX/Pallas
reference, which stays as it is). Plain tensor code is PyTorch; every Pallas
kernel on the ported path has a hand-written CUDA C++ counterpart for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes``. The package never imports jax. It reuses two pure modules of the
reference: ``models.config`` (``ModelConfig``, ``PRESETS``) and
``oracle.quant`` (NumPy only).

Subpackages
-----------
- ``ops``     kernel wrappers (``quant_matmul``, ``flash_decode``,
              ``flash_attention``), the LSE merge (``lse``) and the build
              (``_build``). Each wrapper runs its plain PyTorch version for a
              CPU tensor and launches its kernel (or raises) for a CUDA one.
- ``csrc``    the CUDA C++ kernels, each with a plain C entry point.
- ``models``  the Llama model (batch-1 greedy path, unfused branch), the
              config re-export and the bridge from the JAX parameters.
- ``utils``   platform selection and device facts.
"""

__version__ = "0.1.0"
