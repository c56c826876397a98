"""Flash-attention forward for prefill: causal and/or an additive mask.

Port of the reference's ``ops/flash_attention.py`` (``flash_attention`` and
its ``_flash_kernel``), with its lse residual (``return_residuals=True``,
the per-row log-sum-exp that ring attention merges by). The CUDA kernel
(``csrc/flash_attention.cu``) takes 64-query tiles against 64-key tiles fed
by a cp.async ring, with S, P and O in registers (mma.sync bf16, f32
accumulation), the online softmax in f32, P rounded to bf16 before P.V as
in the reference; it skips key tiles past the causal frontier and launches
the heaviest query tiles first. The additive f32 mask is read in place through its strides,
so a broadcast dim (stride 0) is never materialized. Causality follows the
reference's decode convention: the Sq queries are the last Sq positions of
the Sk-long context (query i attends key j iff j <= i + Sk - Sq). GQA maps
query head h to KV head h // (Hq / Hkv). A row whose every key is masked
gives 0 and, with the residual, lse = -inf. The residual is one more store
of the same kernel, counted apart as ``flash_attention_lse``.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"flash_attention": 0, "flash_attention_lse": 0}


def flash_attention_ref(q, k, v, mask=None, *, scale=None, causal=False,
                        return_residuals=False):
    """Plain version: q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] -> [B, Hq, Sq,
    D] in q's dtype. Scores and softmax statistics in f32; the
    probabilities are rounded to v's dtype before P.V and the sum is
    divided by the f32 row sum afterwards, the rounding points of the
    reference's ``_flash_kernel`` and of the CUDA kernel. With
    ``return_residuals``: (o, lse [B, Hq, Sq] f32), lse = m + log l from
    the same row statistics, -inf where l = 0."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    r = Hq // Hkv
    kf = k.float().repeat_interleave(r, dim=1)
    vf = v.float().repeat_interleave(r, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.float()
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos + (Sk - Sq), s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m == -torch.inf, 0.0, torch.exp(s - m))
    o = p.to(v.dtype).float() @ vf
    l = p.sum(dim=-1, keepdim=True)
    o = (o / torch.where(l == 0, 1.0, l)).to(q.dtype)
    if not return_residuals:
        return o
    lse = torch.where(l == 0, -torch.inf,
                      m + torch.log(torch.where(l == 0, 1.0, l)))
    return o, lse[..., 0]


def flash_attention(q, k, v, mask=None, *, scale=None, causal=False,
                    return_residuals=False):
    """O = softmax(Q K^T * scale + mask) V without materializing the scores.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] bf16, Hq % Hkv == 0, D 64 or
    128. mask: optional additive f32 mask broadcastable from
    [B|1, Hq|1, Sq, Sk] (-inf where masked). Returns O [B, Hq, Sq, D]
    bf16, or with ``return_residuals`` (O, lse [B, Hq, Sq] f32): the
    log-sum-exp of each row's scaled, masked scores, -inf for a row with
    no visible key."""
    if not kernels_for(q):
        return flash_attention_ref(q, k, v, mask, scale=scale, causal=causal,
                                   return_residuals=return_residuals)
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
    strides = (0, 0, 0, 0)
    if mask is not None:
        if mask.device != q.device or mask.dtype != torch.float32:
            raise ValueError(f"mask: need f32 on {q.device}, got "
                             f"{mask.dtype} on {mask.device}")
        if mask.dim() != 4 or mask.shape[0] not in (1, B) \
                or mask.shape[1] not in (1, Hq):
            raise ValueError(f"mask {tuple(mask.shape)} does not broadcast "
                             f"from [B|1, Hq|1, Sq, Sk] = [{B}, {Hq}, {Sq}, "
                             f"{Sk}]")
        mask = torch.broadcast_to(mask, (B, Hq, Sq, Sk))
        strides = mask.stride()
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_residuals else None)
    rc = _build.lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Hq, Hkv, Sq, Sk, D, scale, int(causal), *strides,
        _build.stream_of(q))
    _build.check(rc, "flash_attention_fwd")
    if return_residuals:
        LAUNCHES["flash_attention_lse"] += 1
        return out, lse
    LAUNCHES["flash_attention"] += 1
    return out
