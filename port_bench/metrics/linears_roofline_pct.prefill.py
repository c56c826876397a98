"""``ops/quant_matmul.py`` in a prefill: ``q4k_gemm`` up to 512 rows, above
it the f32 fallback's dequantization and product (``qmatmul_ref``), and the
head's matvec: the least time of the prompt's linears (bytes at GGML
sizes, operations at bf16) over the device time of every kernel launched
inside the benchmark's span around ``llama.apply_linear``, and of the
quantized kernels by name."""

from port_bench.lib import work

PATTERNS = [r"gemm_stream_kernel", r"gemm_tc_kernel", r"q6k_matvec_kernel",
            r"q6k_q8_matvec_kernel", r"q4_matvec_kernel",
            r"q4_q8_matvec_kernel"]


def read(ctx):
    bound = work.linears_bound_s(ctx.spec, ctx.linear_steps(decode=False))
    return ctx.roofline_pct(bound, PATTERNS, linear_span=True)
