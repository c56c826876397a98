"""``ops/layer_kernel.py`` ``model_step`` (``layer_decode_kernel<false>``,
every decoder layer in one launch): the bytes its steps need (the 32
layers' weights at GGML sizes, the cache read up to each length and
written once) over HBM bandwidth, over the kernel's device time."""

from port_bench.lib import work

PATTERNS = [r"layer_decode_kernel<false"]


def read(ctx):
    need = sum(work.layer_kernel_bytes(ctx.spec, c)
               for c in ctx.decode_contexts())
    return ctx.roofline_pct(need / work.PEAK_BYTES_S, PATTERNS)
