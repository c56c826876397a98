"""Dispatch in a prefill: kernel launches in the traced window over its
requests. A count: it repeats exactly for a seed."""


def read(ctx):
    if ctx.view is None or not ctx.view.kernels:
        return None
    return len(ctx.view.kernels) / len(ctx.traced)
