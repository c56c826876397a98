"""Q8_0, Q4_0, Q4_K (Q4_K-E or "s6") and Q6_K-E quantized linears: the
container, the device quantizers, and the fused dequant matvec / GEMM
wrappers.

Port of the reference's ``ops/quant_matmul.py`` for its four formats:
``fmt="q8_0"`` and ``fmt="q4_0"`` (GGML's 32-block formats, one scale d per
block, stored as fp16: the oracle rounds d through fp16, so fp16 holds it
exactly and a weight costs GGML's own 1.0625 / 0.5625 bytes),
``fmt="q4_k"`` with the Q4_K-E encoding (per-32-block effective scales
``es = bf16(f32(d) * sc)`` and mins ``em = bf16(f32(dmin) * mn)``) and
``fmt="q6_k"`` with the Q6_K-E encoding (per-16-block
``es = bf16(f32(d) * sc)``). The weights stay in LOGICAL column order: the
reference's interleaved lane orders and its signed-friendly nibbles exist
only because Mosaic has no consecutive-element expand, and Hopper has no
such limit. The q4_k and q4_0 payload is the oracle's per-32-block planar
nibble packing (``oracle/quant.py``): byte j of a block holds element j in
its low nibble and element j + 16 in its high nibble; q8_0's is the int8
values themselves. Dequantization is ``w = q * f32(d)`` (q8_0),
``w = (q - 8) * f32(d)`` (q4_0), ``w = q * f32(es) - f32(em)`` (q4_k) and
``w = f32(es) * (q - 32)`` (q6_k), bit-equal to the reference's
``dequantize_jnp`` for the same oracle blocks. q4_0 is q4_k's function with
es = d and em = 8 d (exact), so it shares q4_k's kernels through a scale
trait.

q4_k has a second, opt-in encoding, the reference's ``enc="s6"`` (K a
multiple of 4096, else the quantizer keeps "e", as the reference does): the
6-bit sub-scales and mins one byte each, ``es`` int8 [N, 2 K/32] (the sc of
a row's blocks, then their mn) and the superblock scales ``d`` bf16
[N, 2 K/256] (the superblocks' d, then their dmin; bf16 of the fp16
value), both in logical order: 0.578125 bytes a weight against Q4_K-E's
0.625. Its effective scale and min are f32(d) * sc and f32(dmin) * mn,
exact in f32 and not rounded again (``scales_to_e``), so the s6 function
differs from the Q4_K-E one of the same blocks by Q4_K-E's bf16 rounding of
es / em. Every q4_k kernel has an s6 instance that decodes these bytes
itself (``q4k_s6_matvec``, ``q4k_s6_q8_matvec``, ``q4k_s6_gemm``,
``mlp_fused`` and ``ops/fused_attention.py``'s fused attention, each
counted under its own ``LAUNCHES`` key); ``scales_to_e`` is the plain
versions' expansion and runs on no kernel path.

Kernels:
- ``q4k_matvec`` / ``q40_matvec`` (``csrc/q4k_matmul.cu``) — B = 1, exact
  f32 activations; replace the reference's ``_chunk_kernel``,
  ``_vpu2_kernel`` and, at K/32 outside its repeat-aligned counts
  (tinyllama's w_down), ``_vpu_e_kernel``. A persistent grid of 4-row
  warps; where rows are few, each row's blocks split over
  ``matvec_splits`` warps of a CTA and folded in split order.
- ``q80_matvec`` (``csrc/q80_matvec.cu``) — q8_0, B = 1, the reference's
  ``_mxu_kernel`` rounding: sum_j bf16(x_j) * bf16(q_j * d) in f32; also
  takes its any-K ``_vpu_e_kernel`` route. The same persistent grid, in
  2-row warps, the products on ``mma.sync``; its splits, ring depth and
  grid from ``q80_plan``.
- ``q4k_gemm`` / ``q40_gemm`` / ``q80_gemm`` (``csrc/q4k_gemm.cu``) —
  B >= 2, bf16 operands with f32 accumulation (the reference's numerics);
  replace ``_mxu_kernel``, ``_pipe_sub_kernel`` and ``_pipe_kernel``. One
  launch a call, on the route ``gemm_route`` picks from M: a weight stream
  on ``mma.sync`` for decode batches, ``wgmma`` above.
- ``q4k_q8_matvec`` / ``q40_q8_matvec`` (``csrc/q4k_q8.cu``) — B = 1 with
  int8 activations (``x_quant8``); replace ``_chunk8_kernel`` /
  ``_chunk8_compute``.
- ``mlp_fused`` (``csrc/fused_decode.cu``) — the whole batch-1 silu MLP in
  one launch; replaces ``_fused_mlp_kernel``.
- ``q6k_matvec`` (``csrc/q6k_matvec.cu``) — q6_k, B = 1, exact f32
  activations, (K/16) % 128 == 0; replaces ``_chunk6_kernel``.
- ``q6k_q8_matvec`` (``csrc/q6k_matvec.cu``) — q6_k, B = 1, K % 4096 == 0,
  the hybrid int8 / f32 numerics of ``_chunk6h_kernel``, reproduced
  exactly (``quantize_activations_q6``).

The int8-activation numerics are the reference's, reproduced exactly: per
32-block, with xl / xh the block's elements 0-15 / 16-31 (the two nibbles
of one byte), a = xl - xh/16 and b = xh/16 are quantized to int8 with
scale amax/127 (1 where amax == 0), round half to even, clip +-127; then
y = sum_b es*(sa*sum(lo*aq) + sb*sum(p*bq) + 8*sum(xh)) - em*sum(xl + xh)
with lo the low nibbles and p = lo + 16*hi - 128 (the byte XOR 0x80 read
as int8); es = d and em = 8 d for q4_0. Both integer dots are exact; only
the f32 fold order differs.

Each wrapper runs its plain PyTorch version (``qmatmul_ref``) for a CPU
tensor and launches its kernel, or raises, for a CUDA tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.ops.flash_decode import _sm_count
from ggml_cuda_experiments_tpu_torch.oracle import quant as oq
from ggml_cuda_experiments_tpu_torch.oracle.quant import QK, QK6, QK_K
from ggml_cuda_experiments_tpu_torch.utils.platform import (
    kernels_for, resolve_device)

# kernel launches, counted by the wrappers right after each launch
LAUNCHES = {"q4k_matvec": 0, "q4k_gemm": 0, "q4k_q8_matvec": 0,
            "fused_mlp": 0, "q6k_matvec": 0, "q6k_q8_matvec": 0,
            "q80_matvec": 0, "q40_matvec": 0, "q40_q8_matvec": 0,
            "q80_gemm": 0, "q40_gemm": 0, "q4k_s6_matvec": 0,
            "q4k_s6_q8_matvec": 0, "q4k_s6_gemm": 0, "fused_mlp_s6": 0,
            "q4k_gemm_phase": 0}
FORMATS = ("q8_0", "q4_0", "q4_k", "q6_k")
ENCODINGS = ("e", "s6")         # q4_k's scale encodings
S6_K = 4096                     # s6 needs K % S6_K == 0


@dataclasses.dataclass(frozen=True)
class QuantLinear:
    """Quantized weight W [N, K] (output-major, like GGML), logical order.

    q8_0: qs int8 [N, K], d fp16 [N, K/32]. 1.0625 bytes per weight.
    q4_0: qs uint8 [N, K/2] (per-32-block planar nibbles, as q4_k's),
    d fp16 [N, K/32]. 0.5625 bytes per weight.
    q4_k ("Q4_K-E", ``enc="e"``): qs uint8 [N, K/2] (per-32-block planar
    nibbles), es bf16 [N, K/32], em bf16 [N, K/32]. 0.625 bytes per weight.
    q4_k "s6" (``enc="s6"``, K % 4096 == 0): qs as Q4_K-E's, es int8
    [N, 2 K/32] (the blocks' 6-bit sc, then their mn), d bf16 [N, 2 K/256]
    (the superblocks' d, then their dmin), em None. 0.578125 bytes per
    weight.
    q6_k ("Q6_K-E"): per 16-element block b, qs uint8 [N, K/2] bytes
    8b..8b+7 (byte j: the low 4 bits of element j, those of element j + 8
    in the high nibble), qh uint8 [N, K/4] bytes 4b..4b+3 (byte i: the high
    2 bits of elements i, i + 4, i + 8, i + 12 at bits 0-1, 2-3, 4-5,
    6-7), es bf16 [N, K/16]; em is None. 0.875 bytes per weight.

    A stack of experts (``models/moe.stack_expert_quant``) carries a
    leading E dim on every array; ``shape`` and ``array_shape`` stay one
    expert's. The kernels take one expert at a time
    (``moe._expert_slice``): a stack fails their shape checks.
    """

    fmt: str
    shape: tuple[int, int]
    qs: torch.Tensor
    es: torch.Tensor | None = None
    em: torch.Tensor | None = None
    qh: torch.Tensor | None = None
    d: torch.Tensor | None = None
    enc: str = "e"

    @property
    def s6(self) -> bool:
        return self.fmt == "q4_k" and self.enc == "s6"

    @property
    def array_shape(self) -> tuple[int, int]:
        n, kq = self.qs.shape[-2:]
        return n, kq * (1 if self.fmt == "q8_0" else 2)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.qs, self.es, self.em, self.qh, self.d)
                   if t is not None)


def _fmt_check(fmt: str) -> None:
    if fmt not in FORMATS:
        raise NotImplementedError(
            f"format {fmt!r}: the port serves {', '.join(FORMATS)}")


# ---------------------------------------------------------------------------
# quantization (torch transcriptions of the oracle's quantize_q4_k and
# quantize_q6_k, with the reference's effective-scale folding)
# ---------------------------------------------------------------------------

def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as an IEEE division. A Python-scalar divisor would let the CUDA
    kernel multiply by the reciprocal instead, which differs from NumPy in
    the last bit."""
    return a / torch.full_like(a, b)


def _recip0(b: torch.Tensor) -> torch.Tensor:
    """The oracle's ``np_div(1, b)``: 1/b where b != 0, else 0."""
    return torch.where(b != 0, torch.ones_like(b) / b, torch.zeros_like(b))


def _f16_round(x: torch.Tensor) -> torch.Tensor:
    return x.half().float()


def _q4_k_rows(w: torch.Tensor):
    """The oracle's Q4_K blocks of w [n, K]: (qs uint8 [n, K/2] planar
    nibbles, sc uint8 [n, K/32], mn uint8 [n, K/32], d f32 [n, K/256],
    dmin f32 [n, K/256])."""
    x = w.float()
    n, k = x.shape
    xb = x.reshape(n, k // QK_K, 8, QK)
    mn_f = torch.clamp(xb.amin(-1), max=0.0)
    mx_f = torch.clamp(xb.amax(-1), min=0.0)
    scale_f = _div(mx_f - mn_f, 15.0)                       # [n, nsb, 8]
    neg_mn = -mn_f
    d = _f16_round(_div(scale_f.amax(-1), 63.0))            # [n, nsb]
    dmin = _f16_round(_div(neg_mn.amax(-1), 63.0))
    sc = torch.clamp(torch.round(scale_f * _recip0(d)[..., None]), 0, 63)
    mn = torch.clamp(torch.round(neg_mn * _recip0(dmin)[..., None]), 0, 63)
    eff_scale = d[..., None] * sc                           # exact: sc <= 63
    eff_min = dmin[..., None] * mn
    inv_s = _recip0(eff_scale)
    q = torch.clamp(torch.round((xb + eff_min[..., None]) * inv_s[..., None]),
                    0, 15).to(torch.uint8)
    q = q.reshape(n, k // QK, QK)
    qs = (q[..., :16] | (q[..., 16:] << 4)).reshape(n, k // 2)
    return (qs, sc.to(torch.uint8).reshape(n, k // QK),
            mn.to(torch.uint8).reshape(n, k // QK), d, dmin)


def _pack_q6(q: torch.Tensor):
    """6-bit values q uint8 [n, K] (0..63) -> the Q6_K-E (qs [n, K/2],
    qh [n, K/4]) of the container's docstring."""
    n, k = q.shape
    b = q.reshape(n, k // QK6, QK6)
    lo = b & 0x0F
    qs = (lo[..., :8] | (lo[..., 8:] << 4)).reshape(n, k // 2)
    hi = (b >> 4).reshape(n, k // QK6, 4, 4)      # [.., s, i]: element 4s + i
    qh = (hi[..., 0, :] | (hi[..., 1, :] << 2) | (hi[..., 2, :] << 4)
          | (hi[..., 3, :] << 6))
    return qs, qh.reshape(n, k // 4)


def _q6_high(qh: torch.Tensor) -> torch.Tensor:
    """qh uint8 [n, K/4] -> the high 2 bits uint8 [n, K/16, 16]."""
    u = qh.reshape(qh.shape[0], -1, 4)
    return torch.stack([(u >> s) & 3 for s in (0, 2, 4, 6)],
                       dim=-2).reshape(qh.shape[0], -1, QK6)


def _q6_values(qs: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """Q6_K-E bytes -> q uint8 [n, K/16, 16], values 0..63."""
    p = qs.reshape(qs.shape[0], -1, 8)
    return torch.cat([p & 0x0F, p >> 4], dim=-1) | (_q6_high(qh) << 4)


def _q6_k_rows(w: torch.Tensor):
    """The oracle's Q6_K blocks of w [n, K]: (qs uint8 [n, K] values
    q + 32, sc int8 [n, K/16], d f32 [n, K/256])."""
    x = w.float()
    n, k = x.shape
    xb = x.reshape(n, k // QK_K, QK_K // QK6, QK6)
    ax = xb.abs()
    # np.argmax's rule, spelled out: the first index of the largest |x|
    first = torch.where(ax == ax.amax(-1, keepdim=True),
                        torch.arange(QK6, device=x.device), QK6)
    maxv = xb.gather(-1, first.amin(-1, keepdim=True))[..., 0]
    scale_f = _div(maxv, -32.0)                              # [n, nsb, 16]
    d = _f16_round(_div(scale_f.abs().amax(-1), 127.0))      # [n, nsb]
    sc = torch.clamp(torch.round(scale_f * _recip0(d)[..., None]),
                     -127, 127).to(torch.int8)
    eff = d[..., None] * sc.float()                          # exact
    q = torch.clamp(torch.round(xb * _recip0(eff)[..., None]), -32, 31) + 32
    return q.to(torch.uint8).reshape(n, k), sc.reshape(n, k // QK6), d


def _q8_0_rows(w: torch.Tensor):
    """The oracle's Q8_0 blocks of w [n, K]: (qs int8 [n, K], d f32
    [n, K/32])."""
    x = w.float()
    n, k = x.shape
    xb = x.reshape(n, k // QK, QK)
    d = _f16_round(_div(xb.abs().amax(-1), 127.0))            # [n, K/32]
    q = torch.clamp(torch.round(xb * _recip0(d)[..., None]), -127, 127)
    return q.to(torch.int8).reshape(n, k), d


def _q4_0_rows(w: torch.Tensor):
    """The oracle's Q4_0 blocks of w [n, K]: (qs uint8 [n, K/2], d f32
    [n, K/32])."""
    x = w.float()
    n, k = x.shape
    xb = x.reshape(n, k // QK, QK)
    ax = xb.abs()
    # np.argmax's rule, spelled out: the first index of the largest |x|
    first = torch.where(ax == ax.amax(-1, keepdim=True),
                        torch.arange(QK, device=x.device), QK)
    maxv = xb.gather(-1, first.amin(-1, keepdim=True))[..., 0]
    d = _f16_round(_div(maxv, -8.0))                           # [n, K/32]
    q = torch.clamp(torch.round(xb * _recip0(d)[..., None]) + 8, 0,
                    15).to(torch.uint8)
    qs = (q[..., :QK // 2] | (q[..., QK // 2:] << 4)).reshape(n, k // 2)
    return qs, d


_QUANT_ROWS = 2048          # rows per chunk of the device quantizer
# each format's row quantizer and the oracle dataclass of its fields
_BLOCKS = {"q8_0": (_q8_0_rows, oq.Q8_0), "q4_0": (_q4_0_rows, oq.Q4_0),
           "q4_k": (_q4_k_rows, oq.Q4_K), "q6_k": (_q6_k_rows, oq.Q6_K)}


def _block(fmt: str) -> int:
    """The K granule of a format: its 32-block, or q4_k / q6_k's
    256-superblock."""
    return QK_K if fmt in ("q4_k", "q6_k") else QK


def quantize_blocks(w: torch.Tensor, fmt: str = "q4_k"):
    """The oracle's blocks of a float [N, K] weight, computed on its own
    device: ``oracle/quant.py``'s Q8_0, Q4_0, Q4_K or Q6_K with tensor
    fields on w's device, bit-equal to its ``quantize_q8_0`` /
    ``quantize_q4_0`` / ``quantize_q4_k`` / ``quantize_q6_k``. These are
    the GGML fields a GGUF writer encodes. Works in row chunks to bound the
    f32 temporaries."""
    _fmt_check(fmt)
    n, k = w.shape
    if k % _block(fmt):
        raise ValueError(f"{fmt} needs K % {_block(fmt)} == 0 (got K={k})")
    rows, blocks = _BLOCKS[fmt]
    parts = [rows(w[r:r + _QUANT_ROWS]) for r in range(0, n, _QUANT_ROWS)]
    return blocks(*(torch.cat(f) for f in zip(*parts)), shape=(n, k))


def quantize(w: torch.Tensor, fmt: str = "q4_k", enc: str = "e"
             ) -> QuantLinear:
    """Quantize a float [N, K] weight on its own device: ``quantize_blocks``
    folded by ``from_oracle``, so bit-equal to the oracle's
    ``quantize_q8_0`` / ``quantize_q4_0`` / ``quantize_q4_k`` /
    ``quantize_q6_k`` (the last two followed by the reference's Q4_K-E /
    Q6_K-E scale folding, or q4_k's s6 encoding with ``enc="s6"``)."""
    return from_oracle(quantize_blocks(w, fmt), device=w.device, enc=enc)


_Q4K_FIELDS = ("qs", "sc", "mn", "d", "dmin", "shape")
_Q6K_FIELDS = ("qs", "sc", "d", "shape")
_Q32_FIELDS = ("qs", "d", "shape")


def _field(a) -> torch.Tensor:
    """An oracle block field as a contiguous tensor: a NumPy array shares
    its CPU memory, a tensor stays where it lies."""
    if isinstance(a, torch.Tensor):
        return a.contiguous()
    return torch.from_numpy(np.ascontiguousarray(a))


def block_format(t) -> str:
    """The format of planar oracle blocks ``t``, read from their fields
    (Q4_K: qs, sc, mn, d, dmin, shape; Q6_K: qs, sc, d, shape; Q8_0 and
    Q4_0: qs, d, shape, told apart by the width and dtype of qs), so the
    blocks of the port's oracle and of any oracle with the same layout are
    taken alike. A field may be a NumPy array or a tensor."""
    if all(hasattr(t, f) for f in _Q4K_FIELDS):
        return "q4_k"
    if all(hasattr(t, f) for f in _Q6K_FIELDS):
        return "q6_k"
    if all(hasattr(t, f) for f in _Q32_FIELDS):
        k = t.shape[-1]
        qs = _field(t.qs)
        fmt = {(k, torch.int8): "q8_0", (k // 2, torch.uint8): "q4_0"}.get(
            (qs.shape[-1], qs.dtype))
        if fmt is None:
            raise ValueError(f"qs {qs.dtype} {tuple(qs.shape)} is neither "
                             f"Q8_0 nor Q4_0 of shape {tuple(t.shape)}")
        return fmt
    raise NotImplementedError(f"{type(t).__name__} is none of the port's "
                              f"formats ({', '.join(FORMATS)})")


def from_oracle(t, device=None, enc: str = "e") -> QuantLinear:
    """Port container from planar Q8_0, Q4_0, Q4_K or Q6_K blocks (the same
    values; fp16 d, or the bf16 effective scales), on the card unless
    ``device`` says otherwise. ``t``'s fields (``block_format``) may be
    NumPy arrays or tensors; tensor fields are folded where they lie (a
    GGUF tensor decoded on the card stays there). ``enc`` (q4_k only, as
    in the reference; the other formats ignore it): "e" (Q4_K-E) or "s6",
    which falls back to "e" where K % 4096 != 0."""
    if enc not in ENCODINGS:
        raise ValueError(f"enc {enc!r}: one of {', '.join(ENCODINGS)}")
    device = resolve_device(device)
    fmt = block_format(t)
    n, k = t.shape
    qs = _field(t.qs)
    if fmt == "q4_k" and enc == "s6" and k % S6_K == 0:
        sm = torch.cat([_field(t.sc), _field(t.mn)], -1)
        dd = torch.cat([_field(t.d), _field(t.dmin)], -1)
        return QuantLinear(fmt=fmt, shape=(n, k), enc="s6",
                           qs=qs.to(device, torch.uint8),
                           es=sm.to(device, torch.int8),
                           d=dd.to(device, torch.bfloat16))
    if fmt == "q4_k":
        d8 = _field(t.d).float().repeat_interleave(8, -1)   # [N, K/32] f32
        dm8 = _field(t.dmin).float().repeat_interleave(8, -1)
        es = (d8 * _field(t.sc).float()).to(torch.bfloat16)
        em = (dm8 * _field(t.mn).float()).to(torch.bfloat16)
        return QuantLinear(fmt=fmt, shape=(n, k),
                           qs=qs.to(device, torch.uint8),
                           es=es.to(device), em=em.to(device))
    if fmt == "q6_k":
        d16 = _field(t.d).float().repeat_interleave(QK_K // QK6, -1)
        es = (d16 * _field(t.sc).float()).to(torch.bfloat16)
        qs, qh = _pack_q6(qs.to(torch.uint8).reshape(n, k))
        return QuantLinear(fmt=fmt, shape=(n, k), qs=qs.to(device),
                           es=es.to(device), qh=qh.to(device))
    d = _field(t.d).float().half()
    return QuantLinear(fmt=fmt, shape=(n, k), qs=qs.to(device),
                       d=d.to(device))


def _nibbles(qs: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Planar nibble bytes [n, K/2] -> q [n, K/32, 32] f32, 0..15."""
    p = qs.reshape(n, k // QK, QK // 2)
    return torch.cat([p & 0x0F, p >> 4], dim=-1).float()


def scales_to_e(ql: QuantLinear) -> QuantLinear:
    """An s6 q4_k weight with its scales expanded to the "e" fields: es =
    f32(d) * sc and em = f32(dmin) * mn, f32 [N, K/32], NOT rounded to bf16
    (the reference's ``scales_to_e``: the same scales the s6 kernels
    compute). Any other weight is returned as it is. The plain versions
    take it; no kernel does (its es / em are not bf16)."""
    if not ql.s6:
        return ql
    kb = ql.array_shape[1] // QK
    d = ql.d.float().repeat_interleave(8, -1)    # [N, 2 K/32]: d | dmin
    sm = ql.es.float()                           # [N, 2 K/32]: sc | mn
    return QuantLinear(fmt="q4_k", shape=ql.shape, qs=ql.qs,
                       es=d[..., :kb] * sm[..., :kb],
                       em=d[..., kb:] * sm[..., kb:])


def dequantize(ql: QuantLinear, dtype=torch.float32) -> torch.Tensor:
    """Dense logical-order [N, K]: w = q * f32(d) (q8_0),
    w = (q - 8) * f32(d) (q4_0), w = q * f32(es) - f32(em) (q4_k; s6
    through ``scales_to_e``), w = f32(es) * (q - 32) (q6_k)."""
    ql = scales_to_e(ql)
    n, k = ql.array_shape
    if ql.fmt == "q6_k":
        q = _q6_values(ql.qs, ql.qh).float() - 32.0         # [N, K/16, 16]
        return (ql.es.float()[..., None] * q).reshape(n, k).to(dtype)
    if ql.fmt == "q8_0":
        q = ql.qs.reshape(n, k // QK, QK).float()
        w = q * ql.d.float()[..., None]
    elif ql.fmt == "q4_0":
        w = (_nibbles(ql.qs, n, k) - 8.0) * ql.d.float()[..., None]
    else:
        w = (_nibbles(ql.qs, n, k) * ql.es.float()[..., None]
             - ql.em.float()[..., None])
    return w.reshape(n, k).to(dtype)


def qmatmul_ref(x: torch.Tensor, ql: QuantLinear,
                compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version: dequantize, round both operands to ``compute_dtype``,
    multiply with f32 accumulation. Returns f32 [B, N]. The analog of the
    reference's ``qmatmul_xla``; with bf16 it is the numerics of its MXU
    kernels (products of bf16 values are exact in f32)."""
    w = dequantize(ql).to(compute_dtype).float()
    return x.to(compute_dtype).float() @ w.T


# ---------------------------------------------------------------------------
# int8 activations (the reference's x_quant8 numerics)
# ---------------------------------------------------------------------------

def _block_scale(v: torch.Tensor) -> torch.Tensor:
    """Per-block int8 scale of v [..., n]: amax / 127, or 1 where amax is
    0 (IEEE division, as the kernels compute it)."""
    amax = v.abs().amax(-1)
    return torch.where(amax == 0, torch.ones_like(amax), _div(amax, 127.0))


def _q8(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v / scale[..., None]), -127, 127).to(
        torch.int8)


def quantize_activations_q8(x: torch.Tensor):
    """Per-32-block int8 operands of x [K] (or [1, K]) for the integer-dot
    matvec: (aq, bq) int8 [K/32, 16], the quantized a = xl - xh/16 and
    b = xh/16 of each block, and sc f32 [4, K/32] holding c = 8*sum(xh),
    xs = sum(xl + xh), sa and sb. Bit-equal to the reference's
    ``_quant_rows_blockwise`` / ``_act_quant_build`` for the same x."""
    xb = x.float().reshape(-1, QK)
    xl, xh = xb[:, :QK // 2], xb[:, QK // 2:]
    b = xh / 16.0                                # exact: a power of two
    a = xl - b
    sa, sb = _block_scale(a), _block_scale(b)
    sc = torch.stack([8.0 * xh.sum(-1), (xl + xh).sum(-1), sa, sb])
    return _q8(a, sa), _q8(b, sb), sc


_Q8_ROWS = 4096             # rows per chunk of the plain int8 matvec


def _scale_min(ql: QuantLinear, r0: int, r1: int):
    """Rows r0:r1 of the per-32-block (es, em) f32 of a q4_k weight (s6
    through ``scales_to_e``), or of a q4_0 one (es = d, em = 8 d, exact)."""
    if ql.fmt == "q4_0":
        es = ql.d[r0:r1].float()
        return es, 8.0 * es
    if ql.s6:
        e = scales_to_e(dataclasses.replace(
            ql, qs=ql.qs[r0:r1], es=ql.es[r0:r1], d=ql.d[r0:r1]))
        return e.es, e.em
    return ql.es[r0:r1].float(), ql.em[r0:r1].float()


def qmatmul_q8_ref(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """Plain version of the int8-activation matvec (q4_k or q4_0): y f32
    [1, N] for x [1, K] (see the module docstring for the formula). The
    integer block dots are exact in f32 (|sum| < 2^24)."""
    _need(ql, "q4_k", "q4_0")
    n, k = ql.array_shape
    aq, bq, (c, xs, sa, sb) = quantize_activations_q8(x.reshape(-1))
    aqf, bqf = aq.float(), bq.float()
    ys = []
    for r in range(0, n, _Q8_ROWS):
        p = ql.qs[r:r + _Q8_ROWS].reshape(-1, k // QK, QK // 2)
        zl = torch.einsum("nbt,bt->nb", (p & 0x0F).float(), aqf)
        zp = torch.einsum("nbt,bt->nb", (p ^ 0x80).view(torch.int8).float(),
                          bqf)
        z = sa * zl + sb * zp + c
        es, em = _scale_min(ql, r, r + _Q8_ROWS)
        ys.append((es * z - em * xs).sum(-1))
    return torch.cat(ys)[None]


def _need(ql: QuantLinear, *fmts: str) -> None:
    if ql.fmt not in fmts:
        raise ValueError(f"a {' or '.join(fmts)} weight is needed here, got "
                         f"{ql.fmt}")


# ---------------------------------------------------------------------------
# q6_k products (the reference's _chunk6_kernel and _chunk6h_kernel)
# ---------------------------------------------------------------------------

def qmatmul_q6_ref(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """Plain version of ``q6k_matvec``: y f32 [1, N] for x [1, K] f32,
    y_n = sum_b es_b * sum_j x_j (q_j - 32) over the 16-blocks, in f32."""
    _need(ql, "q6_k")
    n, k = ql.array_shape
    xb = x.float().reshape(k // QK6, QK6)
    ys = []
    for r in range(0, n, _Q8_ROWS):
        q = _q6_values(ql.qs[r:r + _Q8_ROWS], ql.qh[r:r + _Q8_ROWS])
        z = torch.einsum("nbj,bj->nb", q.float() - 32.0, xb)
        ys.append((ql.es[r:r + _Q8_ROWS].float() * z).sum(-1))
    return torch.cat(ys)[None]


def quantize_activations_q6(x: torch.Tensor):
    """Per-16-block int8 operands of x [K] for the hybrid q6_k matvec:
    (aq, bq) int8 [K/16, 8], the quantized a = xl - xh/16 and b = xh/16 of
    each block (xl, xh: its elements 0-7 and 8-15, the two nibbles of one
    weight byte; scale amax / 127 over the block's 8 values), and sc f32
    [3, K/16] holding sa, sb and cc = 8*sum(xh) - 32*sum(xl + xh). The int8
    operands and scales are bit-equal to the reference's
    ``_quant_rows_blockwise`` in ``_qmatmul_chunk6h`` for the same x."""
    xb = x.float().reshape(-1, QK6)
    xl, xh = xb[:, :QK6 // 2], xb[:, QK6 // 2:]
    b = xh / 16.0                                # exact: a power of two
    a = xl - b
    sa, sb = _block_scale(a), _block_scale(b)
    cc = 8.0 * xh.sum(-1) - 32.0 * (xl + xh).sum(-1)
    return _q8(a, sa), _q8(b, sb), torch.stack([sa, sb, cc])


def qmatmul_q6q8_ref(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """Plain version of ``q6k_q8_matvec`` (the reference's
    ``_chunk6h_kernel``): y f32 [1, N] for x [1, K] f32. Per 16-block,
    z1 = sum(lo * aq) over the low nibbles and z2 = sum(p * bq) over the
    bytes XOR 0x80 read as int8 (p = lo + 16*hi - 128) are exact integer
    dots, zbit = sum(h * x) over the high 2 bits is f32, and
    y = sum_b es * (sa*z1 + sb*z2 + cc + 16*zbit)."""
    _need(ql, "q6_k")
    n, k = ql.array_shape
    xb = x.float().reshape(k // QK6, QK6)
    aq, bq, (sa, sb, cc) = quantize_activations_q6(x.reshape(-1))
    aqf, bqf = aq.float(), bq.float()
    ys = []
    for r in range(0, n, _Q8_ROWS):
        p = ql.qs[r:r + _Q8_ROWS].reshape(-1, k // QK6, QK6 // 2)
        z1 = torch.einsum("nbt,bt->nb", (p & 0x0F).float(), aqf)
        z2 = torch.einsum("nbt,bt->nb", (p ^ 0x80).view(torch.int8).float(),
                          bqf)
        zbit = torch.einsum("nbj,bj->nb",
                            _q6_high(ql.qh[r:r + _Q8_ROWS]).float(), xb)
        ys.append((ql.es[r:r + _Q8_ROWS].float()
                   * (sa * z1 + sb * z2 + cc + 16.0 * zbit)).sum(-1))
    return torch.cat(ys)[None]


def mlp_fused_ref(x: torch.Tensor, w_gu: QuantLinear,
                  w_down: QuantLinear) -> torch.Tensor:
    """Plain version of ``mlp_fused``: the w_gu int8 matvec, silu(g) * u in
    f32, the w_down int8 matvec of that mid. x f32 [1, K]; y f32 [1, Nd]."""
    y = qmatmul_q8_ref(x, w_gu)[0]
    kd = y.shape[0] // 2
    g, u = y[:kd], y[kd:]
    return qmatmul_q8_ref(((g * torch.sigmoid(g)) * u)[None], w_down)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_ql(ql: QuantLinear, device: torch.device, fmt: str = "q4_k",
              enc: str = "e") -> tuple[int, int]:
    """Raise unless ``ql`` is a ``fmt`` weight of encoding ``enc`` (q4_k)
    whose arrays are what the kernels read."""
    _need(ql, fmt)
    n, k = ql.array_shape
    if k % _block(fmt):
        raise ValueError(f"{fmt} kernels need K % {_block(fmt)} == 0 "
                         f"(got {k})")
    if fmt == "q4_k" and ql.enc != enc:
        raise ValueError(f"a q4_k {enc!r} kernel got an {ql.enc!r} weight")
    if ql.s6:
        if k % S6_K:
            raise ValueError(f"s6 kernels need K % {S6_K} == 0 (got {k})")
        scales = (("es", ql.es, torch.int8, (n, k // 16), 16),
                  ("d", ql.d, torch.bfloat16, (n, k // 128), 16))
    elif fmt == "q4_k":
        scales = (("es", ql.es, torch.bfloat16, (n, k // QK), 2),
                  ("em", ql.em, torch.bfloat16, (n, k // QK), 2))
    else:
        scales = (("d", ql.d, torch.float16, (n, k // QK), 2),)
    qs = ((n, k), torch.int8) if fmt == "q8_0" else ((n, k // 2), torch.uint8)
    _check_arrays(device, (("qs", ql.qs, qs[1], qs[0], 16), *scales))
    return n, k


def _check_arrays(device, arrays) -> None:
    """Raise unless each (name, tensor, dtype, shape, alignment) is a
    contiguous tensor of that dtype and shape on ``device`` whose data
    starts at a multiple of the alignment."""
    for name, t, dt, shape, align in arrays:
        if t is None or t.device != device or t.dtype != dt \
                or tuple(t.shape) != shape or not t.is_contiguous():
            got = "None" if t is None else (
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(f"{name}: need contiguous {dt} {shape} on "
                             f"{device}, got {got}")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def _check_weight(ql: QuantLinear, x: torch.Tensor, fmt: str = "q4_k",
                  enc: str = "e") -> tuple[int, int]:
    n, k = _check_ql(ql, x.device, fmt, enc)
    if x.dim() != 2 or x.shape[1] != k or not x.is_contiguous():
        raise ValueError(f"x: need contiguous [B, {k}], got {tuple(x.shape)}")
    return n, k


# The exact-f32 matvec's plan (csrc/q4k_matmul.cu): a warp takes
# MV_ROWS rows at once, a CTA MV_WARPS warps, and about MV_WARPS_PER_SM
# warps are resident an SM (2 CTAs). Where the row groups are too few to
# give every resident warp one, each row's blocks are split over
# ``matvec_splits`` warps of one CTA.
MV_ROWS = 4
MV_WARPS = 8
MV_WARPS_PER_SM = 16


def matvec_splits(n: int, k: int, sms: int) -> int:
    """Warps a row's 32-blocks are split over in ``q4k_matvec`` /
    ``q40_matvec``: the fewest (1, 2, 4 or 8) that give about
    ``MV_WARPS_PER_SM`` busy warps an SM, each split keeping at least 32
    blocks (one block a lane). A plain function of N, K and the SM count."""
    if n < 1 or k < 32 or k % 32 or sms < 1:
        raise ValueError(f"matvec_splits: N {n}, K {k}, SMs {sms}")
    groups = -(-n // MV_ROWS)
    most = max(1, min(MV_WARPS, k // 32 // 32))
    s = 1
    while 2 * s <= most and groups * s < sms * MV_WARPS_PER_SM:
        s *= 2
    return s


def matvec_blocks(k: int, splits: int) -> list[tuple[int, int]]:
    """The 32-blocks [b0, b1) of each split of a row, in split order (the
    kernel's rule: split s takes [s KB / S, (s + 1) KB / S), counted in
    groups of 8 blocks where KB is a multiple of 8, so that each split's
    scales start on 16 bytes)."""
    kb = k // 32
    u = 1 if kb % 8 else 8
    return [(u * (s * (kb // u) // splits), u * ((s + 1) * (kb // u) // splits))
            for s in range(splits)]


# q80_matvec's plan (csrc/q80_matvec.cu): MV_WARPS warps a CTA of
# Q80_ROWS-row groups, each warp streaming steps of Q80_STEP blocks
# (Q80_STAGE_BYTES with their scales) through a ring of 2 or 3 stages; a
# CTA's shared memory is x (``q80_x_bytes``) and the rings. The H100's
# limits: 228 KB of shared memory an SM, 227 KB a CTA, 1 KB of it reserved
# a CTA.
Q80_ROWS = 2
Q80_STEP = 64
Q80_STAGE_BYTES = 4496
Q80_STATIC_BYTES = 4 * 2 * MV_WARPS * Q80_ROWS
SMEM_PER_SM = 233472
SMEM_PER_CTA = 232448
SMEM_RESERVED_PER_CTA = 1024


def q80_x_bytes(k: int) -> int:
    """Shared bytes of x in ``q80_matvec``: K f32 as copied in, then bf16
    with a step of zero blocks after K and 16 bytes of pad after every 8
    blocks, rounded up to 16 bytes."""
    kb = k // 32
    b = kb + Q80_STEP
    return -(-max(128 * kb, 64 * b + 16 * (b // 8)) // 16) * 16


def q80_stages(k: int) -> tuple[int, int]:
    """(ring stages, CTAs an SM) of ``q80_matvec`` at K: 2 stages and 2
    CTAs where both fit an SM, else 3 stages and one CTA, else 2 and one
    (about 70 KB of weight in flight an SM in the first two). A plain
    function of K."""
    if k < 32 or k % 32:
        raise ValueError(f"q80_stages: K {k}")

    def cta(stages):
        return (q80_x_bytes(k) + MV_WARPS * stages * Q80_STAGE_BYTES
                + Q80_STATIC_BYTES)
    if 2 * (cta(2) + SMEM_RESERVED_PER_CTA) <= SMEM_PER_SM:
        return 2, 2
    for stages in (3, 2):
        if cta(stages) <= SMEM_PER_CTA:
            return stages, 1
    raise ValueError(f"q80_matvec: K {k} leaves no room for x and a ring "
                     f"in {SMEM_PER_CTA} bytes of shared memory")


def q80_plan(n: int, k: int, sms: int) -> tuple[int, int, int]:
    """(splits, stages, grid) of ``q80_matvec`` at N x K on ``sms`` SMs: the
    ring from ``q80_stages``, the grid the resident CTAs or fewer, and the
    split (1, 2, 4 or 8 warps a row group, ``matvec_blocks``' spans): the
    fewest whose row tiles reach half the SMs, then more while the tiles
    overflow the resident CTAs by a fifth or more of a round and a split
    keeps two steps. Fitted to the H100 at the 7B and tinyllama linears
    (PERF.md): a split costs a fold a tile, a step its math whether its
    blocks are there or not, and each CTA copies x. A plain function of N,
    K and the SM count."""
    if n < 1 or sms < 1:
        raise ValueError(f"q80_plan: N {n}, K {k}, SMs {sms}")
    stages, per_sm = q80_stages(k)
    kb = k // 32
    unit = 1 if kb % 8 else 8
    ctas = per_sm * sms
    groups = -(-n // Q80_ROWS)
    choices = [s for s in (1, 2, 4, 8) if s <= kb // unit]

    def tiles(s):
        return -(-groups // (MV_WARPS // s))

    def span(s):
        return max(b1 - b0 for b0, b1 in matvec_blocks(k, s))
    s = next((c for c in choices if 2 * tiles(c) >= sms), choices[-1])
    while (tiles(s) > ctas and -(-tiles(s) // ctas) * ctas > 1.2 * tiles(s)
           and 2 * s in choices and span(2 * s) >= 2 * Q80_STEP):
        s *= 2
    return s, stages, min(tiles(s), ctas)


def _scales(ql: QuantLinear) -> tuple:
    """A weight's scale arrays in its kernels' argument order: q4_k (es,
    em), s6 (es, d), q4_0 / q8_0 (d,)."""
    if ql.s6:
        return ql.es, ql.d
    return (ql.es, ql.em) if ql.fmt == "q4_k" else (ql.d,)


def _launch(name: str, fmt: str, x: torch.Tensor, ql: QuantLinear,
            dtype: torch.dtype, gemm: bool = False, enc: str = "e"
            ) -> torch.Tensor:
    """Check x (``dtype``; one row unless ``gemm``) and the ``fmt`` weight
    (of encoding ``enc``), launch the C entry ``name`` (x, qs, its scale
    arrays, y, [M,] N, K, [route | splits,] stream) and count the launch; a
    GEMM takes ``gemm_route``'s route and needs x on 16 bytes, the
    exact-f32 matvecs ``matvec_splits``' split, ``q80_matvec``
    ``q80_plan``'s."""
    n, k = _check_weight(ql, x, fmt, enc)
    if x.dtype != dtype or (x.shape[0] != 1 and not gemm):
        raise ValueError(f"{name}: x must be {dtype} "
                         f"{'[M, K]' if gemm else '[1, K]'}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    m = x.shape[0]
    route = gemm_route(m) if gemm else None
    if gemm and x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start on 16 bytes")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    scales = _scales(ql)
    if gemm:
        extra = (GEMM_ROUTE_ID[route],)
    elif name in _SPLIT_MATVECS:
        extra = (matvec_splits(n, k, _sm_count(x.device.index or 0)),)
    elif name == "q80_matvec":
        extra = q80_plan(n, k, _sm_count(x.device.index or 0))
    else:
        extra = ()
    rc = getattr(_build.lib(), name)(
        x.data_ptr(), ql.qs.data_ptr(), *(t.data_ptr() for t in scales),
        y.data_ptr(), *((m,) if gemm else ()), n, k, *extra,
        _build.stream_of(x))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    if gemm:
        GEMM_ROUTE_LAUNCHES[route] += 1
    return y


_SPLIT_MATVECS = ("q4k_matvec", "q40_matvec", "q4k_s6_matvec")


def q4k_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """y [1, N] f32 = x [1, K] f32 . deq(W)^T, exact f32 activations."""
    if not kernels_for(x):
        return qmatmul_ref(x, ql, torch.float32)
    return _launch("q4k_matvec", "q4_k", x, ql, torch.float32)


def q4k_s6_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """``q4k_matvec`` for an s6 W: the same warps, its scales decoded from
    the s6 bytes in the kernel."""
    if not kernels_for(x):
        return qmatmul_ref(x, ql, torch.float32)
    return _launch("q4k_s6_matvec", "q4_k", x, ql, torch.float32, enc="s6")


def q40_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """``q4k_matvec`` for a q4_0 W (es = d, em = 8 d)."""
    if not kernels_for(x):
        return qmatmul_ref(x, ql, torch.float32)
    return _launch("q40_matvec", "q4_0", x, ql, torch.float32)


def q80_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """y [1, N] f32 = bf16(x) [1, K] . bf16(q * d)^T for a q8_0 W, f32
    accumulation (x f32, rounded to bf16 in the kernel)."""
    if not kernels_for(x):
        return qmatmul_ref(x, ql, torch.bfloat16)
    return _launch("q80_matvec", "q8_0", x, ql, torch.float32)


# The GEMM's two routes (csrc/q4k_gemm.cu): "stream" (mma.sync, the
# weight stream of a decode batch) for M <= STREAM_MAX_M, "tc" (wgmma with
# the dequantized weight as register A) above. The stream kernel takes at
# most 32 rows, and on the H100 it beats the tensor-core route up to there
# (PERF.md §6).
STREAM_MAX_M = 32
GEMM_ROUTE_ID = {"stream": 0, "tc": 1}
# GEMM launches by route, counted beside LAUNCHES
GEMM_ROUTE_LAUNCHES = {"stream": 0, "tc": 0}


def gemm_route(m: int) -> str:
    """The route of a GEMM over ``m`` rows of x: a plain function of M."""
    if m < 1:
        raise ValueError(f"gemm_route: m must be positive, got {m}")
    return "stream" if m <= STREAM_MAX_M else "tc"


# ``phase`` of ``q4k_gemm``: measurement-only variants of the tc route's
# kernel (tools/profile_decode.py --pipe), the reference's ``_pipe_kernel``
# phases plus "stream". "all" is the production call; "dequant" skips the
# wgmma, "dot" the dequantization (the wgmma takes the raw W words),
# "stream" both (only the ring's copies run). Every variant stages every
# byte of W, its scales and x, takes the tc route at any M, gives wrong
# outputs, and counts as ``q4k_gemm_phase``. The plain version takes "all"
# only; no model path passes a phase.
GEMM_PHASES = {"all": 0, "dequant": 1, "dot": 2, "stream": 3}


def q4k_gemm(x: torch.Tensor, ql: QuantLinear,
             phase: str = "all") -> torch.Tensor:
    """y [M, N] f32 = bf16(x) [M, K] . bf16(deq(W))^T, f32 accumulation.
    ``phase``: ``GEMM_PHASES`` (measurement only)."""
    if phase not in GEMM_PHASES:
        raise ValueError(f"q4k_gemm: phase {phase!r} is not one of "
                         f"{', '.join(GEMM_PHASES)}")
    if not kernels_for(x):
        if phase != "all":
            raise ValueError(f"q4k_gemm: the plain version has no phase "
                             f"{phase!r} (measurement-only, the kernel's)")
        return qmatmul_ref(x, ql, torch.bfloat16)
    if phase == "all":
        return _launch("q4k_gemm", "q4_k", x, ql, torch.bfloat16, gemm=True)
    n, k = _check_weight(ql, x)
    if x.dtype != torch.bfloat16 or x.data_ptr() % 16:
        raise ValueError("q4k_gemm: x must be bf16 [M, K] on 16 bytes")
    m = x.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = _build.lib().q4k_gemm_phase(
        x.data_ptr(), ql.qs.data_ptr(), ql.es.data_ptr(), ql.em.data_ptr(),
        y.data_ptr(), m, n, k, GEMM_PHASES[phase], _build.stream_of(x))
    _build.check(rc, "q4k_gemm_phase")
    LAUNCHES["q4k_gemm_phase"] += 1
    return y


def q4k_s6_gemm(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """``q4k_gemm`` for an s6 W (both routes decode the s6 bytes)."""
    if not kernels_for(x):
        return qmatmul_ref(x, ql, torch.bfloat16)
    return _launch("q4k_s6_gemm", "q4_k", x, ql, torch.bfloat16, gemm=True,
                   enc="s6")


def q40_gemm(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """``q4k_gemm`` for a q4_0 W."""
    if not kernels_for(x):
        return qmatmul_ref(x, ql, torch.bfloat16)
    return _launch("q40_gemm", "q4_0", x, ql, torch.bfloat16, gemm=True)


def q80_gemm(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """``q4k_gemm`` for a q8_0 W."""
    if not kernels_for(x):
        return qmatmul_ref(x, ql, torch.bfloat16)
    return _launch("q80_gemm", "q8_0", x, ql, torch.bfloat16, gemm=True)


def q8_matvec_supported(ql: QuantLinear) -> bool:
    """The reference's gate of its int8-activation matvec beyond B == 1:
    q4_k or q4_0 with (K/32) % 128 == 0."""
    return (ql.fmt in ("q4_k", "q4_0")
            and (ql.array_shape[1] // QK) % 128 == 0)


def _check_q8(x: torch.Tensor, ql: QuantLinear, name: str,
              fmt: str = "q4_k", enc: str = "e") -> tuple[int, int]:
    n, k = _check_weight(ql, x, fmt, enc)
    if x.dtype != torch.float32 or x.shape[0] != 1 \
            or not q8_matvec_supported(ql):
        raise ValueError(f"{name}: x must be f32 [1, K] with K % 4096 == 0, "
                         f"got {x.dtype} {tuple(x.shape)}")
    return n, k


def _q8_launch(name: str, fmt: str, x: torch.Tensor, ql: QuantLinear,
               enc: str = "e") -> torch.Tensor:
    _check_q8(x, ql, name, fmt, enc)
    return _launch(name, fmt, x, ql, torch.float32, enc=enc)


def q4k_q8_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """y [1, N] f32 = the int8-activation matvec of x [1, K] f32."""
    if not kernels_for(x):
        return qmatmul_q8_ref(x, ql)
    return _q8_launch("q4k_q8_matvec", "q4_k", x, ql)


def q4k_s6_q8_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """``q4k_q8_matvec`` for an s6 W."""
    if not kernels_for(x):
        return qmatmul_q8_ref(x, ql)
    return _q8_launch("q4k_s6_q8_matvec", "q4_k", x, ql, enc="s6")


def q40_q8_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """``q4k_q8_matvec`` for a q4_0 W (es = d, em = 8 d)."""
    if not kernels_for(x):
        return qmatmul_q8_ref(x, ql)
    return _q8_launch("q40_q8_matvec", "q4_0", x, ql)


def q6_hybrid_ok(k: int) -> bool:
    """The reference's gate of its hybrid q6_k matvec (B == 1)."""
    return k % 4096 == 0


def q6_exact_ok(k: int) -> bool:
    """The reference's gate of its exact-f32 q6_k matvec (B == 1)."""
    return (k // QK6) % 128 == 0


def _check_q6(x: torch.Tensor, ql: QuantLinear, name: str, ok
              ) -> tuple[int, int]:
    _need(ql, "q6_k")
    n, k = ql.array_shape
    _check_arrays(x.device, (
        ("qs", ql.qs, torch.uint8, (n, k // 2), 16),
        ("qh", ql.qh, torch.uint8, (n, k // 4), 8),
        ("es", ql.es, torch.bfloat16, (n, k // QK6), 4)))
    if x.dtype != torch.float32 or tuple(x.shape) != (1, k) \
            or not x.is_contiguous() or not ok(k):
        raise ValueError(f"{name}: x must be contiguous f32 [1, {k}] and K "
                         f"inside the kernel's gate, got {x.dtype} "
                         f"{tuple(x.shape)}")
    return n, k


def _q6_launch(name: str, x: torch.Tensor, ql: QuantLinear, ok
               ) -> torch.Tensor:
    n, k = _check_q6(x, ql, name, ok)
    y = torch.empty((1, n), dtype=torch.float32, device=x.device)
    rc = getattr(_build.lib(), name)(
        x.data_ptr(), ql.qs.data_ptr(), ql.qh.data_ptr(), ql.es.data_ptr(),
        y.data_ptr(), n, k, _build.stream_of(x))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return y


def q6k_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """y [1, N] f32 = x [1, K] f32 . deq(W)^T for a q6_k W with
    (K/16) % 128 == 0, exact f32 activations."""
    if not kernels_for(x):
        return qmatmul_q6_ref(x, ql)
    return _q6_launch("q6k_matvec", x, ql, q6_exact_ok)


def q6k_q8_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """y [1, N] f32 = the hybrid int8 / f32 matvec of x [1, K] f32 with a
    q6_k W, K % 4096 == 0."""
    if not kernels_for(x):
        return qmatmul_q6q8_ref(x, ql)
    return _q6_launch("q6k_q8_matvec", x, ql, q6_hybrid_ok)


# each format's (B == 1 matvec, int8-activation matvec, B >= 2 GEMM), by
# name: looked up when called, so a wrapper replaced on the module (a
# counting spy) is the one that runs
_ROUTES = {"q4_k": ("q4k_matvec", "q4k_q8_matvec", "q4k_gemm"),
           "q4_k~s6": ("q4k_s6_matvec", "q4k_s6_q8_matvec", "q4k_s6_gemm"),
           "q4_0": ("q40_matvec", "q40_q8_matvec", "q40_gemm"),
           "q8_0": ("q80_matvec", None, "q80_gemm")}


def qmatmul(x: torch.Tensor, ql: QuantLinear,
            x_quant8: bool = False) -> torch.Tensor:
    """y [B, N] = x [B, K] @ deq(W)^T in x's dtype, x in logical order.

    q4_k and q4_0: B == 1 runs the int8-activation matvec when ``x_quant8``
    and the reference's gate allow it (its ``_chunk8_kernel``), else the
    exact-f32 matvec (its ``_chunk_kernel`` / ``_vpu2_kernel`` /
    ``_vpu_e_kernel``); B >= 2 the bf16 GEMM (its ``_mxu_kernel`` and, for
    its ``pipelined`` prefill range, ``_pipe_sub_kernel``: the same
    function, so the port has one kernel and no ``pipelined`` flag). An s6
    q4_k weight takes the s6 instance of each (the reference's B 2-8 VPU
    loop expands s6 with ``scales_to_e``; the port's B 2-8 rows are the
    GEMM's stream route, which decodes s6 itself).

    q8_0 (``x_quant8`` has no effect, as in the reference): B == 1 runs
    ``q80_matvec`` (its ``_mxu_kernel`` at repeat-aligned K/32, its
    ``_vpu_e_kernel`` elsewhere), B >= 2 the GEMM.

    q6_k, as the reference dispatches it (``x_quant8`` has no effect): B == 1
    runs the hybrid matvec at K % 4096 == 0 (its ``_chunk6h_kernel``), else
    the exact-f32 one at (K/16) % 128 == 0 (its ``_chunk6_kernel``); every
    other shape takes its ``qmatmul_xla`` with bf16 compute, a plain
    dequantize + matmul and no kernel in the JAX package either."""
    if ql.fmt == "q6_k":
        k = ql.array_shape[1]
        if x.shape[0] == 1 and q6_hybrid_ok(k):
            y = q6k_q8_matvec(x.float().contiguous(), ql)
        elif x.shape[0] == 1 and q6_exact_ok(k):
            y = q6k_matvec(x.float().contiguous(), ql)
        else:
            y = qmatmul_ref(x, ql, torch.bfloat16)
        return y.to(x.dtype)
    matvec, matvec_q8, gemm = _ROUTES["q4_k~s6" if ql.s6 else ql.fmt]
    if x.shape[0] == 1:
        name = matvec_q8 if x_quant8 and q8_matvec_supported(ql) else matvec
        y = globals()[name](x.float().contiguous(), ql)
    else:
        y = globals()[gemm](x.to(torch.bfloat16).contiguous(), ql)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# the fused batch-1 MLP
# ---------------------------------------------------------------------------

def mlp_fused_supported(w_gu, w_down) -> bool:
    """The reference's decision, from shapes: it runs ``mlp_fused`` where
    ``quantize_params`` built ``w_gu_f`` (q4_k, dim and the padded
    intermediate multiples of 4096) and ``mlp_fused_supported`` accepts it
    (one 4096 segment of K, (K/32) % 128 == 0), i.e. w_gu [2 Kd, 4096] and
    w_down [Nd, Kd] with Kd % 4096 == 0."""
    if not (isinstance(w_gu, QuantLinear) and isinstance(w_down, QuantLinear)):
        return False
    if w_gu.fmt != "q4_k" or w_down.fmt != "q4_k":
        return False
    ng, kg = w_gu.array_shape
    _, kd = w_down.array_shape
    return kg == 4096 and ng == 2 * kd and kd % 4096 == 0


def mlp_fused(x: torch.Tensor, w_gu: QuantLinear,
              w_down: QuantLinear) -> torch.Tensor:
    """y [1, Nd] f32 = the fused silu MLP of x [1, 4096] f32 (normed, in
    logical order; w_gu = [gate; up] rows, logical order too). Two s6
    weights take the s6 instance (``fused_mlp_s6``); on the card both
    weights must share one encoding."""
    if not kernels_for(x):
        return mlp_fused_ref(x, w_gu, w_down)
    if not mlp_fused_supported(w_gu, w_down):
        raise ValueError(f"mlp_fused: w_gu {w_gu.array_shape}, w_down "
                         f"{w_down.array_shape} outside the fused gate")
    enc = w_gu.enc
    name = "fused_mlp_s6" if enc == "s6" else "fused_mlp"
    ng, kg = _check_q8(x, w_gu, name, enc=enc)
    nd, kd = _check_ql(w_down, x.device, enc=enc)
    ws = torch.empty((ng,), dtype=torch.float32, device=x.device)
    y = torch.empty((1, nd), dtype=torch.float32, device=x.device)
    rc = getattr(_build.lib(), name)(
        x.data_ptr(), w_gu.qs.data_ptr(),
        *(t.data_ptr() for t in _scales(w_gu)), w_down.qs.data_ptr(),
        *(t.data_ptr() for t in _scales(w_down)), ws.data_ptr(),
        y.data_ptr(), kg, kd, nd, _build.stream_of(x))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return y
