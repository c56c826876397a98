"""A frozen copy of GGML's Q4_K and Q6_K block quantizers and of the port's
effective-scale folding (Q4_K-E: es = bf16(d * sc), em = bf16(dmin * mn)
per 32-block; Q6_K-E: es = bf16(d * sc) per 16-block), with the
dequantization to f32.

The reference works the quantized weights out again from the dense draws
with this copy, so it takes nothing that the program made. A test holds it
bit-equal to the program's own quantizer at a small size; if the program's
encoding ever changes, that test says so, and this file stays as the
yardstick.
"""

from __future__ import annotations

import torch

QK = 32
QK6 = 16
QK_K = 256
_ROWS = 2048                    # rows per chunk, to bound the temporaries


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    # an IEEE division: a scalar divisor would let the card multiply by
    # the reciprocal, which differs in the last bit
    return a / torch.full_like(a, b)


def _recip0(b: torch.Tensor) -> torch.Tensor:
    return torch.where(b != 0, torch.ones_like(b) / b, torch.zeros_like(b))


def _f16_round(x: torch.Tensor) -> torch.Tensor:
    return x.half().float()


def q4_k_blocks(w: torch.Tensor):
    """Q4_K of w [n, K] (K % 256 == 0): q uint8 [n, K/32, 32] (0..15),
    sc, mn f32 [n, K/32] (6-bit), d, dmin f32 [n, K/256] (fp16 values)."""
    x = w.float()
    n, k = x.shape
    xb = x.reshape(n, k // QK_K, 8, QK)
    mn_f = torch.clamp(xb.amin(-1), max=0.0)
    mx_f = torch.clamp(xb.amax(-1), min=0.0)
    scale_f = _div(mx_f - mn_f, 15.0)
    neg_mn = -mn_f
    d = _f16_round(_div(scale_f.amax(-1), 63.0))
    dmin = _f16_round(_div(neg_mn.amax(-1), 63.0))
    sc = torch.clamp(torch.round(scale_f * _recip0(d)[..., None]), 0, 63)
    mn = torch.clamp(torch.round(neg_mn * _recip0(dmin)[..., None]), 0, 63)
    eff_scale = d[..., None] * sc
    eff_min = dmin[..., None] * mn
    q = torch.clamp(torch.round((xb + eff_min[..., None])
                                * _recip0(eff_scale)[..., None]), 0, 15)
    return (q.to(torch.uint8).reshape(n, k // QK, QK),
            sc.reshape(n, k // QK), mn.reshape(n, k // QK), d, dmin)


def q4_k_e(w: torch.Tensor):
    """Q4_K-E of w [n, K]: (q uint8 [n, K/32, 32], es bf16 [n, K/32],
    em bf16 [n, K/32])."""
    q, sc, mn, d, dmin = q4_k_blocks(w)
    es = (d.repeat_interleave(8, -1) * sc).to(torch.bfloat16)
    em = (dmin.repeat_interleave(8, -1) * mn).to(torch.bfloat16)
    return q, es, em


def q6_k_blocks(w: torch.Tensor):
    """Q6_K of w [n, K]: q uint8 [n, K/16, 16] (0..63), sc f32 [n, K/16]
    (int8 values), d f32 [n, K/256]."""
    x = w.float()
    n, k = x.shape
    xb = x.reshape(n, k // QK_K, QK_K // QK6, QK6)
    ax = xb.abs()
    # np.argmax's rule: the first index of the largest |x|
    first = torch.where(ax == ax.amax(-1, keepdim=True),
                        torch.arange(QK6, device=x.device), QK6)
    maxv = xb.gather(-1, first.amin(-1, keepdim=True))[..., 0]
    scale_f = _div(maxv, -32.0)
    d = _f16_round(_div(scale_f.abs().amax(-1), 127.0))
    sc = torch.clamp(torch.round(scale_f * _recip0(d)[..., None]), -127, 127)
    eff = d[..., None] * sc
    q = torch.clamp(torch.round(xb * _recip0(eff)[..., None]), -32, 31) + 32
    return (q.to(torch.uint8).reshape(n, k // QK6, QK6),
            sc.reshape(n, k // QK6), d)


def q6_k_e(w: torch.Tensor):
    """Q6_K-E of w [n, K]: (q uint8 [n, K/16, 16], es bf16 [n, K/16])."""
    q, sc, d = q6_k_blocks(w)
    return q, (d.repeat_interleave(QK_K // QK6, -1) * sc).to(torch.bfloat16)


def dequant(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """w [n, K] quantized to ``fmt`` ("q4_k" as Q4_K-E, "q6_k" as Q6_K-E)
    and dequantized: f32 [n, K], row chunk by row chunk."""
    n, k = w.shape
    out = torch.empty((n, k), dtype=torch.float32, device=w.device)
    for r in range(0, n, _ROWS):
        part = w[r:r + _ROWS]
        if fmt == "q4_k":
            q, es, em = q4_k_e(part)
            v = q.float() * es.float()[..., None] - em.float()[..., None]
        elif fmt == "q6_k":
            q, es = q6_k_e(part)
            v = es.float()[..., None] * (q.float() - 32.0)
        else:
            raise ValueError(f"format {fmt!r}: q4_k or q6_k")
        out[r:r + _ROWS] = v.reshape(part.shape[0], k)
    return out
