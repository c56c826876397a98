"""The model's dense weights, drawn from the run's seed on the card.

Both sides take their weights from here: the program quantizes the draws
with its own quantizer, the reference with its frozen copy. Each layer has
its own generator, so the reference can draw layer by layer what the
program drew before it, and each layer is one ``randn`` call in bf16, the
type the weights are served in, cut into views.
"""

from __future__ import annotations

import math

import torch

_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream (a layer, the embedding, the head)
    of a run's seed, which may exceed 32 bits."""
    return (seed * 1_000_003 + (stream + 7) * 0x9E3779B97F4A7C15) & _MASK


def layer_shapes(spec) -> list[tuple[str, tuple[int, ...]]]:
    """Every dense leaf of one decoder layer, in draw order."""
    d, hd = spec.dim, spec.head_dim
    shapes = [("wq", (spec.n_heads * hd, d)), ("wk", (spec.n_kv_heads * hd, d)),
              ("wv", (spec.n_kv_heads * hd, d)), ("wo", (d, spec.n_heads * hd))]
    inter = spec.intermediate
    return shapes + [("w_gate", (inter, d)), ("w_up", (inter, d)),
                     ("w_down", (d, inter))]


def _draw(shapes, seed: int, stream: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16)
    out, off = {}, 0
    for key, shape in shapes:
        n = math.prod(shape)
        # a normal draw scaled by 1/sqrt(fan-in), as a checkpoint's
        # initialisation keeps activations near unit scale
        out[key] = flat[off:off + n].view(shape).mul_(1.0 / math.sqrt(shape[-1]))
        off += n
    return out


def draw_layer(spec, seed: int, li: int, device) -> dict:
    """Layer ``li``'s dense bf16 weights (norm weights are ones)."""
    return _draw(layer_shapes(spec), seed, li, device)


def draw_embed(spec, seed: int, device) -> torch.Tensor:
    e = _draw([("embed", (spec.vocab_size, spec.dim))], seed, -1, device)
    return e["embed"].mul_(0.02 * math.sqrt(spec.dim))


def draw_head(spec, seed: int, device) -> torch.Tensor:
    return _draw([("head", (spec.vocab_size, spec.dim))], seed, -2,
                  device)["head"]
