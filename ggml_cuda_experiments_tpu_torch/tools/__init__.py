"""The kernel lab's tools, each run as a module:

    python -m ggml_cuda_experiments_tpu_torch.tools.kernel_test   # flash decode vs the oracle
    python -m ggml_cuda_experiments_tpu_torch.tools.gemm_bench    # the hand GEMM vs the library
    python -m ggml_cuda_experiments_tpu_torch.tools.perplexity    # prefill logits / PPL vs the oracle

Each runs on the card unless given ``--cpu`` (the plain versions, no
device times), and each ``main(argv)`` returns the exit code.
"""
