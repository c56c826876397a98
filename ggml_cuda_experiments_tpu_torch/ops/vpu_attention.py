"""Online-softmax attention on the CUDA cores for few queries and small head
dims, packaged as a differentiable op.

Port of the reference's ``ops/vpu_attention.py``: ``vpu_attention`` (its
``jax.custom_vjp``) becomes a ``torch.autograd.Function``, and its Pallas
``_vpu_attn_kernel`` two hand-written CUDA kernels in
``csrc/vpu_attention.cu`` (f32 FFMA, no tensor cores, as the xformers kernel
the reference cites): ``vpu_attention_partials`` splits the keys over CTAs
(``pick_splits``: whole 64-key tiles, about two waves of the card) and writes
per-split f32 partials, and ``vpu_attention_merge`` folds them in split
order. Each has its plain version beside it (``_vpu_partials_ref``,
``_vpu_merge_ref``); ``vpu_attention_ref`` is the unsplit plain version the
CPU path runs. The backward is the reference's: plain recompute algebra from
(q, k, v, o, lse), here in plain torch, since the reference has no backward
kernel either.

o = softmax(scale * q k^T + mask) v with f32 scores, softmax state and
accumulator, o in q's dtype; lse = m + log(l) in f32. Key j is visible to
query row t iff j < lengths[b] and, when causal, j <= q0_pos + t. A hidden
score is ``MASK_VALUE`` (-0.7 * float32 max), not -inf, as in the reference:
a row with no visible key (lengths[b] == 0) gets the mean of v over all S
keys and lse = MASK_VALUE + log(S). q [B, H, T, D], k / v [B, H, S, D] share
H (no GQA), D <= 128. ``block_k`` changes only the order of the f32 sums in
the reference; here it is checked (S % min(block_k, S) == 0) and otherwise
unused.

A split's partials for row t: m and l, the max and the sum of exp(s - m)
over the split's keys below S (hidden ones at ``MASK_VALUE``), and o =
sum exp(s - m) v, un-normalized. A row with a visible key whose keys all lie
before the split gets the identity (m = -inf, l = 0, o = 0): its masked
scores there weigh exp(MASK_VALUE - m) = 0 against its visible ones.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.ops.flash_decode import _sm_count
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"vpu_attention": 0, "vpu_attention_merge": 0}
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_KEYS = 64       # keys per tile of the partials kernel
TILE_ROWS = 8        # query rows per CTA


def pick_splits(batch: int, heads: int, T: int, S: int,
                sms: int) -> tuple[int, int]:
    """(splits, keys per split) of S for the partials kernel: each split a
    whole number of 64-key tiles covering [0, S), as many as bring the
    batch * heads * ceil(T / 8) * splits CTAs to about two waves of the
    card's ``sms`` SMs."""
    tiles = -(-S // TILE_KEYS)
    want = -(-2 * sms // (batch * heads * -(-T // TILE_ROWS)))
    span = -(-tiles // max(1, want)) * TILE_KEYS
    return -(-S // span), span



def _check_args(q, k, v, block_k):
    B, H, T, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: need [B, H, T, D] and "
                         "[B, H, S, D]")
    if D > 128:
        raise ValueError(f"head dim {D} > 128")
    S = k.shape[2]
    bk = min(block_k, S)
    if S % bk:
        raise ValueError(f"S = {S} is not a multiple of block_k = {bk}")


def _visible(T, S, lengths, causal, q0_pos, device):
    """[B, 1, T, S] bool: key j visible to query row t of batch b."""
    kpos = torch.arange(S, device=device)
    vis = kpos[None, None, None, :] < lengths.to(device).long()[
        :, None, None, None]
    if causal:
        qpos = q0_pos + torch.arange(T, device=device)
        vis = vis & (kpos[None, :] <= qpos[:, None])[None, None]
    return vis


def _work_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def vpu_attention_ref(q, k, v, lengths, causal=True, scale=None, q0_pos=0):
    """Plain version: (o in q's dtype, lse), computed in f32 (both in f64
    for f64 inputs) with the same mask constant as the kernel."""
    T, D = q.shape[2], q.shape[3]
    S = k.shape[2]
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    wd = _work_dtype(q)
    s = (q.to(wd) * scale) @ k.to(wd).transpose(-1, -2)
    s = torch.where(_visible(T, S, lengths, causal, q0_pos, q.device), s,
                    MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ v.to(wd)) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _limits(T, S, lengths, causal, q0_pos, device):
    """[B, 1, T] int64: the keys each row can see (its visible keys are
    [0, limit)); 0 for a row with no visible key."""
    lim = lengths.to(device).long().clamp(0, S)[:, None, None]
    if causal:
        qpos = q0_pos + torch.arange(T, device=device)
        lim = torch.minimum(lim, (qpos + 1)[None, None])
    return lim


def _vpu_partials_ref(q, k, v, lengths, causal, scale, q0_pos, span):
    """Plain version of the partials kernel: (o [B, H, T, n, D], m, l [B, H,
    T, n]) for the n = ceil(S / span) splits of ``span`` keys (module
    docstring), in f32 (f64 for f64 inputs)."""
    B, H, T, D = q.shape
    S = k.shape[2]
    n = -(-S // span)
    wd = _work_dtype(q)
    s = (q.to(wd) * scale) @ k.to(wd).transpose(-1, -2)
    s = torch.where(_visible(T, S, lengths, causal, q0_pos, q.device), s,
                    MASK_VALUE)
    pad = n * span - S
    s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf).reshape(
        B, H, T, n, span)
    vs = torch.nn.functional.pad(v.to(wd), (0, 0, 0, pad)).reshape(
        B, H, n, span, D)
    m = s.amax(dim=-1)                 # finite: every split has a key < S
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhtnk,bhnkd->bhtnd", p, vs)
    lim = _limits(T, S, lengths, causal, q0_pos, q.device)[..., None]
    start = torch.arange(n, device=q.device) * span
    ident = (lim > 0) & (start >= lim)                    # [B, 1, T, n]
    m = torch.where(ident, -torch.inf, m)
    l = torch.where(ident, 0.0, l)
    o = torch.where(ident[..., None], 0.0, o)
    return o, m, l


def _vpu_merge_ref(o, m, l, dtype):
    """Plain version of the merge kernel: (o [B, H, T, D] in ``dtype``,
    lse [B, H, T]) from the partials, w_i = exp(m_i - max m) (0 for the
    identity), o = sum w_i o_i / sum w_i l_i, lse = max m + log(sum w_i
    l_i)."""
    mx = m.amax(dim=-1, keepdim=True)
    w = torch.where(m == -torch.inf, 0.0, torch.exp(m - mx))
    lt = (w * l).sum(dim=-1)
    ld = torch.where(lt == 0, 1.0, lt)
    out = (w[..., None] * o).sum(dim=-2) / ld[..., None]
    return out.to(dtype), mx[..., 0] + torch.log(ld)


def _vpu_partials(q, k, v, lengths, *, causal, scale, q0_pos, span):
    """(o, m, l) partials of ``span``-key splits: the partials kernel for
    CUDA tensors, ``_vpu_partials_ref`` for CPU ones."""
    if not kernels_for(q):
        return _vpu_partials_ref(q, k, v, lengths, causal, scale, q0_pos,
                                 span)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous 4-D {q.dtype} on "
                             f"{q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"vpu_attention kernel: f32 or bf16, got {q.dtype}")
    if lengths.device != q.device or lengths.shape != (q.shape[0],):
        raise ValueError(f"lengths: need [{q.shape[0]}] on {q.device}")
    B, H, T, D = q.shape
    S = k.shape[2]
    if span < TILE_KEYS or span % TILE_KEYS:
        raise ValueError(f"span {span}: need a multiple of {TILE_KEYS}")
    n = -(-S // span)
    lens = lengths.to(torch.int32).contiguous()
    o = torch.empty((B, H, T, n, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, T, n), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    # whole 16-byte rows from 16-byte-aligned bases take cp.async
    vec = (D * q.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (k, v))
    rc = _build.lib().vpu_attention_partials(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, T, S, D,
        float(scale), int(causal), int(q0_pos), span, n, _DTYPES[q.dtype],
        int(vec), _build.stream_of(q))
    _build.check(rc, "vpu_attention_partials")
    LAUNCHES["vpu_attention"] += 1
    return o, m, l


def _vpu_merge(o, m, l, dtype):
    """(o in ``dtype``, lse) from the partials: the merge kernel for CUDA
    tensors, ``_vpu_merge_ref`` for CPU ones."""
    if not kernels_for(o):
        return _vpu_merge_ref(o, m, l, dtype)
    if dtype not in _DTYPES:
        raise ValueError(f"vpu_attention_merge: f32 or bf16, got {dtype}")
    B, H, T, n, D = o.shape
    for name, t, shape in (("o", o, (B, H, T, n, D)), ("m", m, (B, H, T, n)),
                           ("l", l, (B, H, T, n))):
        if t.device != o.device or t.dtype != torch.float32 \
                or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous f32 {shape} on "
                             f"{o.device}")
    out = torch.empty((B, H, T, D), dtype=dtype, device=o.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=o.device)
    rc = _build.lib().vpu_attention_merge(
        o.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B * H * T, D, n, _DTYPES[dtype], _build.stream_of(o))
    _build.check(rc, "vpu_attention_merge")
    LAUNCHES["vpu_attention_merge"] += 1
    return out, lse


def _vpu_attention_fwd_impl(q, k, v, lengths, *, causal, scale, block_k=256,
                            q0_pos=0):
    """(o, lse): the two kernels for CUDA tensors (partials over the
    ``pick_splits`` split, then the merge), the unsplit plain version for
    CPU ones."""
    _check_args(q, k, v, block_k)
    if scale is None:
        scale = float(1.0 / q.shape[-1] ** 0.5)
    if not kernels_for(q):
        return vpu_attention_ref(q, k, v, lengths, causal, scale, q0_pos)
    B, H, T, _ = q.shape
    _, span = pick_splits(B, H, T, k.shape[2], _sm_count(q.device.index or 0))
    return _vpu_merge(*_vpu_partials(q, k, v, lengths, causal=causal,
                                     scale=scale, q0_pos=q0_pos, span=span),
                      q.dtype)


def _vpu_attention_bwd(q, k, v, lengths, o, lse, do, *, causal, scale,
                       q0_pos):
    """The reference's backward: P = exp(s - lse), dV = P^T dO,
    dS = P * (dO V^T - rowsum(dO * O)) * scale (masked), dQ = dS K,
    dK = dS^T Q; in f32 (f64 for f64 inputs), cast to the inputs' dtypes."""
    T, S = q.shape[2], k.shape[2]
    wd = _work_dtype(q)
    qf, kf, vf, dof = (t.to(wd) for t in (q, k, v, do))
    vis = _visible(T, S, lengths, causal, q0_pos, q.device)
    s = torch.where(vis, (qf @ kf.transpose(-1, -2)) * scale, MASK_VALUE)
    p = torch.exp(s - lse.to(wd)[..., None])
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * o.to(wd)).sum(dim=-1, keepdim=True)
    ds = torch.where(vis, p * (dp - delta) * scale, 0.0)
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _VpuAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, scale, block_k, q0_pos):
        o, lse = _vpu_attention_fwd_impl(q, k, v, lengths, causal=causal,
                                         scale=scale, block_k=block_k,
                                         q0_pos=q0_pos)
        ctx.save_for_backward(q, k, v, lengths, o, lse)
        ctx.causal, ctx.scale, ctx.q0_pos = causal, scale, q0_pos
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        dq, dk, dv = _vpu_attention_bwd(q, k, v, lengths, o, lse, do,
                                        causal=ctx.causal, scale=ctx.scale,
                                        q0_pos=ctx.q0_pos)
        return dq, dk, dv, None, None, None, None, None


def vpu_attention(q, k, v, lengths, causal=True, scale=None, block_k=256,
                  q0_pos=0):
    """o = softmax(scale * q k^T + mask) v on the CUDA cores.

    q [B, H, T, D], k / v [B, H, S, D], lengths [B] valid KV prefix.
    ``q0_pos``: absolute position of q's first row (causal masking of a
    suffix window). Differentiable in q, k and v."""
    if scale is None:
        scale = float(1.0 / q.shape[-1] ** 0.5)
    return _VpuAttention.apply(q, k, v, lengths, causal, scale, block_k,
                               q0_pos)
