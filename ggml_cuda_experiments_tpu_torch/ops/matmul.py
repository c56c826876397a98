"""Dense GEMM: C = op(x) @ op(w) with f32 (int8: int32) accumulation.

Port of the JAX package's ``ops/matmul.py`` (``matmul`` and its
``_matmul_kernel``, the analog of the reference's WMMA HMMA / IMMA GEMMs).
The kernel is ``matmul_nt`` in ``csrc/matmul.cu``: bf16 and f16 through the
tensor cores with f32 accumulators, int8 through them with int32 ones
(bitwise exact), f32 by FFMA on the CUDA cores (never TF32, which would
miss the JAX tests' 1e-4). Any M, N, K: the kernel masks its tile loads,
so nothing is padded, and the transposes are read through strides, so
nothing is copied (an operand none of whose strides is 1 is made
contiguous first).

Same signature as the JAX function. ``block_m`` / ``block_n`` / ``block_k``
are accepted so that callers port unchanged; the JAX result does not depend
on them, and neither does this one (the kernel's tiles are fixed). The
default output dtype follows the JAX one: int32 for int8 inputs, else the
inputs' dtype, rounded from the f32 accumulator at the store.

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
    a_k, lda, a = _layout(a)
    b_k, ldb, bt = _layout(b.T)              # op(w)^T [N, K]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    rc = _build.lib().matmul_nt(
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), M, N, K, lda, ldb,
        int(a_k), int(b_k), _IN_KIND[x.dtype], _OUT_KIND[out_dtype],
        _build.stream_of(x))
    _build.check(rc, "matmul_nt")
    LAUNCHES["matmul"] += 1
    return out
