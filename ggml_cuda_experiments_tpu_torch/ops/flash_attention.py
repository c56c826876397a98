"""Causal flash-attention forward for prefill.

Port of the reference's ``ops/flash_attention.py`` (``flash_attention`` and
its ``_flash_kernel``) without the additive mask and the lse residual, which
the main path does not use. The CUDA kernel (``csrc/flash_attention.cu``)
takes 64-query tiles against 64-key tiles with bf16 tensor-core products,
f32 online softmax, P rounded to bf16 before P.V as in the reference, and
skips key tiles past the causal frontier. Causality follows the reference's
decode convention: the Sq queries are the last Sq positions of the Sk-long
context (query i attends key j iff j <= i + Sk - Sq). GQA maps query head h
to KV head h // (Hq / Hkv).
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"flash_attention": 0}


def flash_attention_ref(q, k, v, *, scale=None, causal=False):
    """Plain version: q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] -> [B, Hq, Sq,
    D] in q's dtype. Scores and softmax statistics in f32; the
    probabilities are rounded to v's dtype before P.V and the sum is
    divided by the f32 row sum afterwards, the rounding points of the
    reference's ``_flash_kernel`` and of the CUDA kernel."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    r = Hq // Hkv
    kf = k.float().repeat_interleave(r, dim=1)
    vf = v.float().repeat_interleave(r, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos + (Sk - Sq), s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = p.to(v.dtype).float() @ vf
    return (o / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def flash_attention(q, k, v, *, scale=None, causal=False):
    """O = softmax(Q K^T * scale) V without materializing the scores.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] bf16, Hq % Hkv == 0, D 64 or
    128. Returns O [B, Hq, Sq, D] bf16."""
    if not kernels_for(q):
        return flash_attention_ref(q, k, v, scale=scale, causal=causal)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 \
                or t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous 4-D bf16 on "
                             f"{q.device}")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention kernel: D in (64, 128), got {D}")
    if causal and Sk < Sq:
        raise ValueError("causal attention needs Sk >= Sq")
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    out = torch.empty_like(q)
    rc = _build.lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Sq, Sk, D, scale, int(causal), _build.stream_of(q))
    _build.check(rc, "flash_attention_fwd")
    LAUNCHES["flash_attention"] += 1
    return out
