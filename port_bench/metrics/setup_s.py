"""Set-up seconds: the process's start (imports, the kernel library's
load or build), the weights drawn and quantized, and the warm-up."""


def read(ctx):
    return ctx.setup_s
