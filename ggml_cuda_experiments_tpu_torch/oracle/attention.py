"""Reference (oracle) attention math in NumPy.

The port's own copy of the JAX package's ``oracle/attention.py`` (the
analog of the reference's CPU oracle, ``mulmat_cpu`` and its online
softmax, ``utils.h:5-49``): ``mulmat_ref``, ``softmax_ref``,
``online_softmax_ref`` and ``attention_ref``, in float32. One difference:
the JAX copy rounds operands through ``ml_dtypes``, which the port does not
have; ``_round_through`` rounds f32 through ``torch.bfloat16`` (or NumPy's
own float16) instead, bit-equal to ``ml_dtypes`` (round to nearest even,
signed zeros, subnormals and infinities kept).
"""

from __future__ import annotations

import numpy as np
import torch


def _dtype_name(dtype) -> str:
    return getattr(dtype, "__name__", None) or str(dtype).split(".")[-1]


def _round_through(x: np.ndarray, dtype) -> np.ndarray:
    """Round-trip ``x`` through a narrower dtype (bf16 / fp16) back to f32.

    ``dtype``: None (no rounding), a bfloat16 (``torch.bfloat16``, the
    string "bfloat16", or any type named so) or a float16 (``np.float16``,
    ``torch.float16``, "float16")."""
    if dtype is None:
        return np.asarray(x, np.float32)
    name = _dtype_name(dtype)
    if name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return t.to(torch.bfloat16).to(torch.float32).numpy()
    if name in ("float16", "half"):
        return np.asarray(x).astype(np.float16).astype(np.float32)
    raise ValueError(f"_round_through: bfloat16 or float16, got {dtype!r}")


def mulmat_ref(
    a: np.ndarray,
    b: np.ndarray,
    *,
    b_transposed: bool = False,
    scale: float = 1.0,
    mask: np.ndarray | None = None,
    operand_dtype=None,
) -> np.ndarray:
    """C = (A @ B) * scale + mask, accumulated in float32.

    ``b_transposed`` means B is stored [N, K] and used as B^T, matching the
    reference's "matrix B transposed" overload (utils.h:5-16).
    ``operand_dtype`` optionally rounds both operands through a narrow dtype
    first (bf16 for a tensor-core-faithful comparison).
    """
    a = _round_through(a, operand_dtype)
    b = _round_through(b, operand_dtype)
    if b_transposed:
        c = a.astype(np.float32) @ b.astype(np.float32).T
    else:
        c = a.astype(np.float32) @ b.astype(np.float32)
    if scale != 1.0:
        c = c * np.float32(scale)
    if mask is not None:
        c = c + mask.astype(np.float32)
    return c


def softmax_ref(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Plain numerically-stable softmax (two-pass)."""
    x = np.asarray(x, np.float32)
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


def online_softmax_ref(x: np.ndarray
                       ) -> tuple[np.ndarray, np.float32, np.float32]:
    """Single-pass online softmax over a 1-D vector.

    Returns (probs, m, l) where m is the running max and l the running sum of
    exponentials — the recurrence of the reference oracle (utils.h:30-49)
    and of every flash kernel's inner loop:

        m' = max(m, x_i);  l' = l * exp(m - m') + exp(x_i - m')
    """
    x = np.asarray(x, np.float32)
    m = np.float32(-np.inf)
    l = np.float32(0.0)
    out = np.empty_like(x)
    for i, xi in enumerate(x):
        m_new = max(m, xi)
        l = l * np.exp(m - m_new) + np.exp(xi - m_new)
        m = m_new
        out[i] = xi
    # second (vector) pass to materialize probabilities given final (m, l)
    return np.exp(out - m) / l, m, l


def attention_ref(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    mask: np.ndarray | None = None,
    scale: float | None = None,
    causal: bool = False,
    operand_dtype=None,
) -> np.ndarray:
    """Full multi-head attention oracle with GQA broadcast.

    Shapes (batch-first):
        q:    [B, Hq,  Sq, D]
        k, v: [B, Hkv, Sk, D]
        mask: broadcastable to [B, Hq, Sq, Sk] (additive, -inf for masked)
    Returns O: [B, Hq, Sq, D] float32.

    GQA: q head h attends to kv head ``h // (Hq // Hkv)`` (the reference's
    kernel_test.h:53).
    """
    q, k, v = (np.asarray(t) for t in (q, k, v))
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    assert Hq % Hkv == 0, f"GQA requires Hq % Hkv == 0, got {Hq}/{Hkv}"
    r = Hq // Hkv
    if scale is None:
        scale = 1.0 / np.sqrt(D)

    out = np.empty((B, Hq, Sq, D), np.float32)
    for b in range(B):
        for h in range(Hq):
            hk = h // r
            m = None
            if mask is not None:
                mm = np.broadcast_to(mask, (B, Hq, Sq, Sk))
                m = mm[b, h]
            s = mulmat_ref(
                q[b, h], k[b, hk], b_transposed=True, scale=scale, mask=m,
                operand_dtype=operand_dtype,
            )
            if causal:
                i = np.arange(Sq)[:, None]
                j = np.arange(Sk)[None, :]
                # queries are the *last* Sq positions of the Sk-long context
                s = np.where(j <= i + (Sk - Sq), s, -np.inf)
            p = softmax_ref(s, axis=-1)
            out[b, h] = mulmat_ref(p, v[b, hk], operand_dtype=operand_dtype)
    return out
