"""The associative (O, M, S) log-sum-exp combine, in PyTorch.

Port of the reference's ``ops/lse.py``. A partial is (o, m, s): un-normalized
output o = sum_j exp(x_j - m) v_j, running max m, running denominator
s = sum_j exp(x_j - m). The combine

    m'  = max(m_a, m_b)
    s'  = s_a * exp(m_a - m') + s_b * exp(m_b - m')
    o'  = o_a * exp(m_a - m') + o_b * exp(m_b - m')

is associative and commutative, so any split of the KV positions gives the
same result. ``flash_decode_ref`` merges its splits with these functions; the
CUDA path merges them with the ``lse_merge`` kernel in ``csrc/flash_decode.cu``,
which applies the same guard for an empty split (m = -inf).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AttnPartial(NamedTuple):
    """Partial attention state over some subset of KV positions.

    o: [..., D] un-normalized weighted values, float32
    m: [..., 1] running max of logits, float32
    s: [..., 1] running sum of exp(logit - m), float32
    """

    o: torch.Tensor
    m: torch.Tensor
    s: torch.Tensor


def lse_identity(o_shape, dtype=torch.float32, device=None) -> AttnPartial:
    """Identity element: m = -inf, s = 0, o = 0."""
    o = torch.zeros(o_shape, dtype=dtype, device=device)
    m = torch.full((*o_shape[:-1], 1), -torch.inf, dtype=dtype, device=device)
    s = torch.zeros((*o_shape[:-1], 1), dtype=dtype, device=device)
    return AttnPartial(o, m, s)


def lse_combine(a: AttnPartial, b: AttnPartial) -> AttnPartial:
    """Associative combine of two partial attention states."""
    m = torch.maximum(a.m, b.m)
    # exp(-inf - -inf) would be NaN; guard the all-masked case.
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    ea = torch.where(a.m == -torch.inf, zero, torch.exp(a.m - m))
    eb = torch.where(b.m == -torch.inf, zero, torch.exp(b.m - m))
    s = a.s * ea + b.s * eb
    o = a.o * ea + b.o * eb
    return AttnPartial(o, m, s)


def lse_combine_stacked(parts: AttnPartial, axis: int = 0) -> AttnPartial:
    """Fold a stacked array of partials along ``axis`` into one partial,
    as a log-depth tree of ``lse_combine``s."""
    p = AttnPartial(*(torch.movedim(f, axis, 0) for f in parts))
    n = p.o.shape[0]
    while n > 1:
        half = n // 2
        even = AttnPartial(*(f[0:2 * half:2] for f in p))
        odd = AttnPartial(*(f[1:2 * half:2] for f in p))
        comb = lse_combine(even, odd)
        if n % 2:
            comb = AttnPartial(*(torch.cat([c, f[-1:]], dim=0)
                                 for c, f in zip(comb, p)))
        p = comb
        n = p.o.shape[0]
    return AttnPartial(p.o[0], p.m[0], p.s[0])


def lse_finalize(p: AttnPartial, out_dtype=None) -> torch.Tensor:
    """Normalize a partial into the attention output: o / s. Fully masked
    rows (s == 0) give 0 instead of NaN."""
    s = torch.where(p.s == 0.0, torch.ones_like(p.s), p.s)
    out = p.o / s
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out
