"""Device steps and dispatch (``llama._forward``, ``apply_linear``):
kernel launches in the traced window over the tokens its
requests served. A count: it repeats exactly for a seed."""


def read(ctx):
    if ctx.view is None or not ctx.view.kernels:
        return None
    return len(ctx.view.kernels) / ctx.served_tokens(ctx.traced)
