"""Checkpoint and quantizer (``quant_matmul.quantize``,
``quantize_params``): the seconds of the set-up's span around
drawing the dense weights and quantizing them."""


def read(ctx):
    return ctx.weights_s
