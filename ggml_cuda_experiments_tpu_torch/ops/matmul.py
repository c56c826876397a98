"""Dense GEMM: C = op(x) @ op(w) with f32 (int8: int32) accumulation.

Port of the JAX package's ``ops/matmul.py`` (``matmul`` and its
``_matmul_kernel``, the analog of the reference's WMMA HMMA / IMMA GEMMs).
The kernels are behind ``matmul_nt`` in ``csrc/matmul.cu``, and ``route``
picks one from dtype, layout and alignment alone:

- ``"wgmma"``: bf16 / f16 in every transpose combination, and int8 when
  both operands are K-major, where TMA can describe both operands (base
  16-byte aligned, leading stride a multiple of 16 bytes): wgmma fed by a
  TMA ring, f32 (int32) accumulators;
- ``"mma"``: the other bf16 / f16 / int8 operands (int8 with an M- or
  N-major operand, strides TMA cannot take): mma.sync tiles;
- ``"ffma"``: f32, by FFMA on the CUDA cores (never TF32, which would miss
  the JAX tests' 1e-4).

Any M, N, K: nothing is padded, and the transposes are read through
strides, so nothing is copied (an operand none of whose strides is 1 is
made contiguous first). The C side refuses a route the operands cannot
take; no route gives way to another.

Same signature as the JAX function. ``block_m`` / ``block_n`` / ``block_k``
are accepted so that callers port unchanged; the JAX result does not depend
on them, and neither do this one or its route (the kernels' tiles are
fixed). The default output dtype follows the JAX one: int32 for int8
inputs, else the inputs' dtype, rounded from the accumulator at the store.

``matmul`` runs ``matmul_ref`` for a CPU tensor and launches its kernel, or
raises, for a CUDA tensor.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"matmul": 0}
_IN_KIND = {torch.bfloat16: 0, torch.float16: 1, torch.int8: 2,
            torch.float32: 3}
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.int32: 3}
# the output dtypes each input dtype takes
_OUTS = {torch.int8: (torch.int32, torch.float32)}
_FLOAT_OUTS = (torch.float32, torch.bfloat16, torch.float16)


def default_out_dtype(dtype: torch.dtype) -> torch.dtype:
    """The JAX ``matmul``'s default: int32 for int8, else the input's."""
    return torch.int32 if dtype == torch.int8 else dtype


def _operands(x, w, out_dtype, transpose_a, transpose_b):
    """op(x) [M, K] and op(w) [K, N] as views, and the output dtype."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"matmul: 2-D operands, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _IN_KIND:
        raise ValueError(f"matmul: x and w of one dtype among bf16, f16, f32 "
                         f"and int8, got {x.dtype} and {w.dtype}")
    a = x.T if transpose_a else x
    b = w.T if transpose_b else w
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: contraction mismatch {a.shape[1]} vs "
                         f"{b.shape[0]}")
    out_dtype = default_out_dtype(x.dtype) if out_dtype is None else out_dtype
    if out_dtype not in _OUTS.get(x.dtype, _FLOAT_OUTS):
        raise ValueError(f"matmul: {x.dtype} inputs give "
                         f"{_OUTS.get(x.dtype, _FLOAT_OUTS)}, not {out_dtype}")
    return a, b, out_dtype


def matmul_ref(x, w, *, out_dtype=None, transpose_a: bool = False,
               transpose_b: bool = False) -> torch.Tensor:
    """Plain version: the product in f32 (TF32 off, which it checks on the
    card), rounded to ``out_dtype``; int8 in f64, which is exact
    (|sum| <= 127^2 K < 2^53) where CUDA has no integer matmul."""
    a, b, out_dtype = _operands(x, w, out_dtype, transpose_a, transpose_b)
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("matmul_ref: torch.backends.cuda.matmul.allow_tf32"
                           " is on; the plain version computes in full f32")
    if x.dtype == torch.int8:
        return (a.double() @ b.double()).to(out_dtype)
    return (a.float() @ b.float()).to(out_dtype)


def _layout(t: torch.Tensor):
    """(K-major?, leading stride, t) of an operand view t [R, K]: element
    (r, k) at r * ld + k when K-major, else at k * ld + r."""
    R, K = t.shape
    if t.stride(1) == 1 or K == 1:
        return True, (t.stride(0) if R > 1 else K), t
    if t.stride(0) == 1 or R == 1:
        return False, (t.stride(1) if K > 1 else R), t
    return True, K, t.contiguous()


def _tma_ok(t: torch.Tensor, kmajor: bool, ld: int) -> bool:
    """Can TMA describe the operand view t [R, K]: base 16-byte aligned and
    a leading stride of a multiple of 16 bytes (one stored row needs no
    stride)."""
    rows = t.shape[0] if kmajor else t.shape[1]
    return t.data_ptr() % 16 == 0 and (
        rows == 1 or ld * t.element_size() % 16 == 0)


def _plan(a: torch.Tensor, b: torch.Tensor):
    """The route and the operands' layouts for op(x) = a [M, K], op(w) =
    b [K, N]: (route, (a_k, lda, a), (b_k, ldb, op(w)^T [N, K]))."""
    pa, pb = _layout(a), _layout(b.T)
    if a.dtype == torch.float32:
        return "ffma", pa, pb
    tma = _tma_ok(pa[2], pa[0], pa[1]) and _tma_ok(pb[2], pb[0], pb[1])
    if tma and (a.dtype != torch.int8 or (pa[0] and pb[0])):
        return "wgmma", pa, pb
    return "mma", pa, pb


def route(x: torch.Tensor, w: torch.Tensor, *, transpose_a: bool = False,
          transpose_b: bool = False) -> str:
    """The kernel ``matmul`` launches for these operands: "wgmma", "mma" or
    "ffma" (see the module docstring). A plain function of dtype, layout
    and alignment; the block sizes do not enter it."""
    a, b, _ = _operands(x, w, None, transpose_a, transpose_b)
    return _plan(a, b)[0]


_ROUTE_ID = {"wgmma": 0, "mma": 1, "ffma": 2}


def matmul(x: torch.Tensor, w: torch.Tensor, *, block_m: int = 256,
           block_n: int = 256, block_k: int = 512, out_dtype=None,
           transpose_a: bool = False, transpose_b: bool = False
           ) -> torch.Tensor:
    """C = op(x) @ op(w). x: [M, K] (or [K, M] if ``transpose_a``), w:
    [K, N] (or [N, K] if ``transpose_b``), of one dtype: bf16, f16 or f32
    (f32 accumulation) or int8 (int32). Returns [M, N] in ``out_dtype``
    (default: int32 for int8, else the inputs' dtype)."""
    if min(block_m, block_n, block_k) < 1:
        raise ValueError("matmul: block sizes must be positive")
    if not kernels_for(x):
        return matmul_ref(x, w, out_dtype=out_dtype, transpose_a=transpose_a,
                          transpose_b=transpose_b)
    a, b, out_dtype = _operands(x, w, out_dtype, transpose_a, transpose_b)
    if w.device != x.device:
        raise ValueError(f"matmul: w on {w.device}, x on {x.device}")
    (M, K), N = a.shape, b.shape[1]
    if min(M, N, K) == 0:
        return torch.zeros((M, N), dtype=out_dtype, device=x.device)
    kind, (a_k, lda, a), (b_k, ldb, bt) = _plan(a, b)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    rc = _build.lib().matmul_nt(
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), M, N, K, lda, ldb,
        int(a_k), int(b_k), _IN_KIND[x.dtype], _OUT_KIND[out_dtype],
        _ROUTE_ID[kind], _build.stream_of(x))
    _build.check(rc, "matmul_nt")
    LAUNCHES["matmul"] += 1
    return out
