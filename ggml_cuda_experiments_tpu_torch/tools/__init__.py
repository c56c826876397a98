"""The kernel lab's tools, each run as a module:

    python -m ggml_cuda_experiments_tpu_torch.tools.kernel_test   # flash decode vs the oracle
    python -m ggml_cuda_experiments_tpu_torch.tools.gemm_bench    # the hand GEMM vs the library
    python -m ggml_cuda_experiments_tpu_torch.tools.perplexity    # prefill logits / PPL vs the oracle
    python -m ggml_cuda_experiments_tpu_torch.tools.spec_bench    # speculative windows vs generate_scan
    python -m ggml_cuda_experiments_tpu_torch.tools.bench         # the benchmark entry (bench.py's metrics)
    python -m ggml_cuda_experiments_tpu_torch.tools.exp_q4        # the exact-matvec stage rungs
    python -m ggml_cuda_experiments_tpu_torch.tools.exp_q4_r2     # the int8 matvec's stage ladder
    python -m ggml_cuda_experiments_tpu_torch.tools.shape_probe   # the 7B shapes, prep hoisted
    python -m ggml_cuda_experiments_tpu_torch.tools.roofline_sweep  # the ladder's grid, pair protocol
    python -m ggml_cuda_experiments_tpu_torch.tools.q6_probe      # the q6_k head's rungs
    python -m ggml_cuda_experiments_tpu_torch.tools.probe_mosaic_r3  # the Mosaic probes, launch cost
    python -m ggml_cuda_experiments_tpu_torch.tools.membench      # memory movement, GB/s
    python -m ggml_cuda_experiments_tpu_torch.tools.multihost_run # 4 ranks, 2 hosts

Each runs on the card unless given ``--cpu`` (the plain versions, no
device times; spec_bench and roofline_sweep run on the card only), and
each ``main(argv)`` returns the exit code.
"""
