"""Q4_K-E quantized linears: the container, the device quantizer, and the
fused dequant matvec / GEMM wrappers.

Port of the reference's ``ops/quant_matmul.py`` for ``fmt="q4_k"`` with the
Q4_K-E encoding (per-32-block effective scales ``es = bf16(f32(d) * sc)`` and
mins ``em = bf16(f32(dmin) * mn)``). The weights stay in LOGICAL column
order: the reference's interleaved lane orders exist only because Mosaic has
no consecutive-element expand, and Hopper has no such limit. The payload is
the oracle's per-32-block planar nibble packing (``oracle/quant.py``): byte j
of a block holds element j in its low nibble and element j + 16 in its high
nibble. Dequantization is ``w = q * f32(es) - f32(em)``, bit-equal to the
reference's ``dequantize_jnp`` for the same oracle blocks.

Kernels (``csrc/q4k_matmul.cu``):
- ``q4k_matvec`` — B = 1, exact f32 activations; replaces the reference's
  ``_chunk_kernel`` and ``_vpu2_kernel``.
- ``q4k_gemm`` — B >= 2, bf16 operands with f32 accumulation (the
  reference's numerics); replaces ``_mxu_kernel``, ``_pipe_sub_kernel`` and
  ``_pipe_kernel``.

Each wrapper runs its plain PyTorch version (``qmatmul_ref``) for a CPU
tensor and launches its kernel, or raises, for a CUDA tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ggml_cuda_experiments_tpu.oracle import quant as quant_ref
from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

QK = quant_ref.QK            # 32
QK_K = quant_ref.QK_K        # 256

# kernel launches, counted by the wrappers right after each launch
LAUNCHES = {"q4k_matvec": 0, "q4k_gemm": 0}


@dataclasses.dataclass(frozen=True)
class QuantLinear:
    """Quantized weight W [N, K] (output-major, like GGML), logical order.

    q4_k ("Q4_K-E"): qs uint8 [N, K/2] (per-32-block planar nibbles),
    es bf16 [N, K/32], em bf16 [N, K/32].
    """

    fmt: str
    shape: tuple[int, int]
    qs: torch.Tensor
    es: torch.Tensor
    em: torch.Tensor

    @property
    def array_shape(self) -> tuple[int, int]:
        n, kq = self.qs.shape
        return n, 2 * kq

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.qs, self.es, self.em))


def _fmt_check(fmt: str) -> None:
    if fmt != "q4_k":
        raise NotImplementedError(
            f"format {fmt!r}: the port has q4_k (Q4_K-E) only so far")


# ---------------------------------------------------------------------------
# quantization (torch transcription of oracle.quantize_q4_k + q4_k_effective)
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


def _quantize_q4_k_rows(w: torch.Tensor):
    """Oracle Q4_K quantization of w [n, K] -> (qs uint8 [n, K/2],
    es bf16 [n, K/32], em bf16 [n, K/32]) in the Q4_K-E encoding."""
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
    es = eff_scale.reshape(n, k // QK).to(torch.bfloat16)
    em = eff_min.reshape(n, k // QK).to(torch.bfloat16)
    return qs, es, em


_QUANT_ROWS = 2048          # rows per chunk of the device quantizer


def quantize(w: torch.Tensor, fmt: str = "q4_k") -> QuantLinear:
    """Quantize a float [N, K] weight on its own device. Bit-equal to the
    oracle's ``quantize_q4_k`` followed by the reference's
    ``q4_k_effective``. Works in row chunks to bound the f32 temporaries."""
    _fmt_check(fmt)
    n, k = w.shape
    if k % QK_K:
        raise ValueError(f"q4_k needs K % {QK_K} == 0 (got K={k})")
    parts = [_quantize_q4_k_rows(w[r:r + _QUANT_ROWS])
             for r in range(0, n, _QUANT_ROWS)]
    qs, es, em = (torch.cat(f) for f in zip(*parts))
    return QuantLinear(fmt="q4_k", shape=(n, k), qs=qs, es=es, em=em)


def from_oracle(t: quant_ref.Q4_K, device=None) -> QuantLinear:
    """Port container from the oracle's planar Q4_K blocks (the same bytes,
    plus the Q4_K-E bf16 effective scales)."""
    if not isinstance(t, quant_ref.Q4_K):
        raise NotImplementedError(f"from_oracle: {type(t).__name__} "
                                  "(the port has q4_k only so far)")
    n, k = t.shape
    d8 = torch.from_numpy(np.repeat(t.d, 8, axis=-1))       # [N, K/32] f32
    dm8 = torch.from_numpy(np.repeat(t.dmin, 8, axis=-1))
    es = (d8 * torch.from_numpy(t.sc).float()).to(torch.bfloat16)
    em = (dm8 * torch.from_numpy(t.mn).float()).to(torch.bfloat16)
    qs = torch.from_numpy(np.ascontiguousarray(t.qs, np.uint8))
    return QuantLinear(fmt="q4_k", shape=(n, k), qs=qs.to(device),
                       es=es.to(device), em=em.to(device))


def dequantize(ql: QuantLinear, dtype=torch.float32) -> torch.Tensor:
    """Dense logical-order [N, K]: w = q * f32(es) - f32(em)."""
    n, k = ql.array_shape
    p = ql.qs.reshape(n, k // QK, QK // 2)
    q = torch.cat([p & 0x0F, p >> 4], dim=-1).float()       # [N, K/32, 32]
    w = q * ql.es.float()[..., None] - ql.em.float()[..., None]
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
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_weight(ql: QuantLinear, x: torch.Tensor) -> tuple[int, int]:
    _fmt_check(ql.fmt)
    n, k = ql.array_shape
    if k % QK_K:
        raise ValueError(f"q4_k kernels need K % {QK_K} == 0 (got {k})")
    for name, t, dt, shape in (("qs", ql.qs, torch.uint8, (n, k // 2)),
                               ("es", ql.es, torch.bfloat16, (n, k // QK)),
                               ("em", ql.em, torch.bfloat16, (n, k // QK))):
        if t.device != x.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {dt} {shape} on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if ql.qs.data_ptr() % 16:
        raise ValueError("qs must be 16-byte aligned")
    if x.dim() != 2 or x.shape[1] != k or not x.is_contiguous():
        raise ValueError(f"x: need contiguous [B, {k}], got {tuple(x.shape)}")
    return n, k


def q4k_matvec(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """y [1, N] f32 = x [1, K] f32 . deq(W)^T, exact f32 activations."""
    if not kernels_for(x):
        return qmatmul_ref(x, ql, torch.float32)
    n, k = _check_weight(ql, x)
    if x.dtype != torch.float32 or x.shape[0] != 1:
        raise ValueError(f"q4k_matvec: x must be f32 [1, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    y = torch.empty((1, n), dtype=torch.float32, device=x.device)
    rc = _build.lib().q4k_matvec(
        x.data_ptr(), ql.qs.data_ptr(), ql.es.data_ptr(), ql.em.data_ptr(),
        y.data_ptr(), n, k, _build.stream_of(x))
    _build.check(rc, "q4k_matvec")
    LAUNCHES["q4k_matvec"] += 1
    return y


def q4k_gemm(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """y [M, N] f32 = bf16(x) [M, K] . bf16(deq(W))^T, f32 accumulation."""
    if not kernels_for(x):
        return qmatmul_ref(x, ql, torch.bfloat16)
    n, k = _check_weight(ql, x)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"q4k_gemm: x must be bf16, got {x.dtype}")
    m = x.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = _build.lib().q4k_gemm(
        x.data_ptr(), ql.qs.data_ptr(), ql.es.data_ptr(), ql.em.data_ptr(),
        y.data_ptr(), m, n, k, _build.stream_of(x))
    _build.check(rc, "q4k_gemm")
    LAUNCHES["q4k_gemm"] += 1
    return y


def qmatmul(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """y [B, N] = x [B, K] @ deq(W)^T in x's dtype, x in logical order.

    B == 1 runs the exact-f32 matvec (the reference's ``_chunk_kernel`` /
    ``_vpu2_kernel``); B >= 2 the bf16 GEMM (its ``_mxu_kernel`` and, for
    its ``pipelined`` prefill range, ``_pipe_sub_kernel``: the same
    function, so the port has one kernel and no ``pipelined`` flag)."""
    if x.shape[0] == 1:
        y = q4k_matvec(x.float().contiguous(), ql)
    else:
        y = q4k_gemm(x.to(torch.bfloat16).contiguous(), ql)
    return y.to(x.dtype)
