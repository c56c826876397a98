"""Split-KV flash decode: single-token attention against the KV cache.

Port of the reference's ``ops/flash_decode.py`` (``flash_decode`` with its
``_decode_kernel`` for GQA and ``_decode_kernel_ht`` for MHA). Two kernels in
``csrc/flash_decode.cu`` carry it:

- ``flash_decode_partials``: grid (B * Hkv, n_splits); a CTA holds the G
  query heads of one KV head as the rows that share each K/V tile, and
  emits that split's (o, m, s) partial;
- ``lse_merge``: folds the splits with the ``ops/lse.py`` combine and writes
  o / s in bf16.

A split covers whole 64-key tiles of the valid keys (``split_tiles``): the
kernel reads ``lengths`` on the card and cuts [0, len) into ceil(len / 64)
tiles, ceil(tiles / n_splits) to a split; a split with no key emits the LSE
identity. n_splits depends only on the padded cache length and the SM
count (``pick_splits``), so the launch needs nothing from the device and a
captured graph replays with new lengths.

A quantized cache (int8 or ``float8_e4m3fn`` K / V with f32 per-token
``k_scale`` / ``v_scale`` [(L,) B, Hkv, S]) takes the reference's scale
path: the k scale multiplies the score rows, the v scale the probability
rows of P.V (the row sums stay unscaled), and ``p * v_scale`` is rounded to
bf16 before the product where a KV head serves G > 1 query heads (the
reference's ``_decode_kernel``; its MHA ``_decode_kernel_ht`` keeps f32).
Its kernel is ``flash_decode_partials_q``, counted as ``flash_decode_q``.
"""

from __future__ import annotations

import functools

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.ops.lse import (
    AttnPartial, lse_combine_stacked, lse_finalize)
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"flash_decode": 0, "flash_decode_q": 0, "lse_merge": 0}
_KV_KIND = {torch.int8: 1, torch.float8_e4m3fn: 2}

TILE_KEYS = 64             # keys a tile of the kernel
_MAX_GROUP = 16            # query heads per KV head the kernel takes
_CTAS_PER_SM = 1           # CTAs an SM in the wave pick_splits aims for


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pick_splits(batch: int, n_kv_heads: int, seq: int, sms: int) -> int:
    """Splits per (sequence, KV head): the fewest tiles a split that still
    give about one CTA an SM over a full cache, each split a whole number
    of 64-key tiles."""
    tiles = -(-seq // TILE_KEYS)
    per = -(-tiles * batch * n_kv_heads // (_CTAS_PER_SM * sms))
    return max(1, -(-tiles // max(1, per)))


def split_tiles(lengths: torch.Tensor, n_splits: int) -> torch.Tensor:
    """Tiles a split of each sequence takes, [B]: ceil(ceil(len / 64) /
    n_splits), at least 1. Split i holds keys [i * span, (i + 1) * span) of
    [0, len), with span = 64 times this (the kernel's ``fd_split``)."""
    tiles = (lengths.clamp(min=0) + TILE_KEYS - 1) // TILE_KEYS
    return ((tiles + n_splits - 1) // n_splits).clamp(min=1)


def _layer_view(k, v, layer, k_scale=None, v_scale=None):
    """(k, v, k_scale, v_scale) of one layer as [B, Hkv, S(, D)] views, and
    the layer index."""
    if (k.dim() == 5) != (layer is not None):
        raise ValueError("pass `layer` iff k/v carry a leading layer dim")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if layer is None:
        return k, v, k_scale, v_scale, 0
    layer = int(layer)
    if not 0 <= layer < k.shape[0]:
        raise ValueError(f"layer {layer} out of range [0, {k.shape[0]})")
    if k_scale is not None:
        k_scale, v_scale = k_scale[layer], v_scale[layer]
    return k[layer], v[layer], k_scale, v_scale, layer


def _partials_ref(q, k, v, lengths, scale, n_splits, k_scale=None,
                  v_scale=None, round_pv=None):
    """Plain per-split partials: o [B, Hkv, n, G, D], m/s [B, Hkv, n, G, 1]
    f32, splitting each sequence's valid keys into n spans of whole 64-key
    tiles like the kernel (``split_tiles``). With scales (a quantized
    cache), the scale path of the module docstring; ``round_pv`` (default:
    G > 1) rounds p * v_scale to bf16."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k.float())
    if k_scale is None:
        s = s * scale
    else:
        s = s * (k_scale * scale)[:, :, None, :]
    keys = torch.arange(S, device=q.device)
    valid = keys[None, :] < lengths[:, None]
    span = split_tiles(lengths.to(q.device).clamp(0, S), n_splits)
    span = span * TILE_KEYS
    split_of = keys[None, :] // span[:, None]                    # [B, S]
    os_, ms, ss = [], [], []
    for i in range(n_splits):
        inside = (valid & (split_of == i))[:, None, None, :]
        sc = torch.where(inside, s, -torch.inf)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(inside, torch.exp(sc - torch.where(
            m == -torch.inf, 0.0, m)), 0.0)
        pv = p
        if v_scale is not None:
            pv = p * v_scale[:, :, None, :]
            if (G > 1) if round_pv is None else round_pv:
                pv = pv.to(torch.bfloat16).float()
        vi = torch.where(inside[:, :, 0, :, None], v.float(), 0.0)
        os_.append(torch.einsum("bhgs,bhsd->bhgd", pv, vi))
        ms.append(m)
        ss.append(p.sum(-1, keepdim=True))
    return AttnPartial(torch.stack(os_, 2), torch.stack(ms, 2),
                       torch.stack(ss, 2))


def _merge_ref(parts: AttnPartial, out_dtype) -> torch.Tensor:
    B, Hkv, _, G, D = parts.o.shape
    merged = lse_combine_stacked(parts, axis=2)
    return lse_finalize(merged, out_dtype=out_dtype).reshape(B, Hkv * G, D)


def flash_decode_ref(q, k, v, lengths=None, *, scale=None, kv_splits=1,
                     layer=None, k_scale=None, v_scale=None):
    """Plain version: per-split (o, m, s) partials in f32, merged with
    ``lse_combine_stacked`` and normalized with ``lse_finalize``. Same
    arguments as ``flash_decode``; returns [B, Hq, D] in q's dtype."""
    k, v, k_scale, v_scale, _ = _layer_view(k, v, layer, k_scale, v_scale)
    B, _, D = q.shape
    S = k.shape[2]
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
    return _merge_ref(_partials_ref(q, k, v, lengths, scale, kv_splits,
                                    k_scale, v_scale), q.dtype)


def _check_partials_args(q, k, v, kl, lengths, n_splits, k_scale, v_scale):
    """What the partials kernel takes, checked before its launch; returns the
    cache's dtype. ``kl`` is k's layer view. The kernel copies K and V rows
    16 bytes at a time, so their bases must be 16-byte aligned."""
    B, Hkv, S, D = kl.shape
    Bq, Hq, Dq = q.shape
    quantized = k_scale is not None
    kv_dtype = k.dtype if quantized else torch.bfloat16
    if quantized and kv_dtype not in _KV_KIND:
        raise ValueError(f"k/v: a quantized cache is int8 or float8_e4m3fn, "
                         f"got {kv_dtype}")
    for name, t, dt in (("q", q, torch.bfloat16), ("k", k, kv_dtype),
                        ("v", v, kv_dtype)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dt} on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte rows, its "
                             f"base must be 16-byte aligned")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.device != q.device or t.dtype != torch.float32 \
                    or t.shape != k.shape[:-1] or not t.is_contiguous():
                raise ValueError(f"{name}: need contiguous f32 "
                                 f"{tuple(k.shape[:-1])} on {q.device}")
    if v.shape != k.shape or Bq != B or Dq != D or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    G = Hq // Hkv
    if D not in (64, 128) or G > _MAX_GROUP or n_splits < 1:
        raise ValueError(f"flash_decode kernel: D in (64, 128), Hq/Hkv <= "
                         f"{_MAX_GROUP}, n_splits >= 1 (got D={D}, G={G}, "
                         f"n_splits={n_splits})")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (B,) or not lengths.is_contiguous():
        raise ValueError("lengths: need contiguous int32 [B] on q's device")
    return kv_dtype


def flash_decode_partials(q, k, v, lengths, *, scale, n_splits, layer=None,
                          k_scale=None, v_scale=None) -> AttnPartial:
    """Kernel 1 of ``flash_decode``: the per-split partials,
    o [B, Hkv, n, G, D], m/s [B, Hkv, n, G, 1] f32. With ``k_scale`` /
    ``v_scale`` the cache is int8 or fp8 (``flash_decode_partials_q``)."""
    kl, vl, ksl, vsl, li = _layer_view(k, v, layer, k_scale, v_scale)
    if not kernels_for(q):
        return _partials_ref(q, kl, vl, lengths, scale, n_splits, ksl, vsl)
    kv_dtype = _check_partials_args(q, k, v, kl, lengths, n_splits, k_scale,
                                    v_scale)
    B, Hkv, S, D = kl.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    quantized = k_scale is not None
    o = torch.empty((B, Hkv, n_splits, G, D), dtype=torch.float32,
                    device=q.device)
    m = torch.empty((B, Hkv, n_splits, G, 1), dtype=torch.float32,
                    device=q.device)
    s = torch.empty_like(m)
    if quantized:
        rc = _build.lib().flash_decode_partials_q(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            m.data_ptr(), s.data_ptr(), B, Hq, Hkv, S, D, li, n_splits,
            _KV_KIND[kv_dtype], int(G > 1), scale, _build.stream_of(q))
        _build.check(rc, "flash_decode_partials_q")
        LAUNCHES["flash_decode_q"] += 1
        return AttnPartial(o, m, s)
    rc = _build.lib().flash_decode_partials(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), m.data_ptr(), s.data_ptr(),
        B, Hq, Hkv, S, D, li, n_splits, scale, _build.stream_of(q))
    _build.check(rc, "flash_decode_partials")
    LAUNCHES["flash_decode"] += 1
    return AttnPartial(o, m, s)


def lse_merge(parts: AttnPartial) -> torch.Tensor:
    """Kernel 2 of ``flash_decode``: fold the split axis of the partials
    and normalize -> [B, Hq, D] bf16."""
    if not kernels_for(parts.o):
        return _merge_ref(parts, torch.bfloat16)
    B, Hkv, n, G, D = parts.o.shape
    for name, t, shape in (("o", parts.o, (B, Hkv, n, G, D)),
                           ("m", parts.m, (B, Hkv, n, G, 1)),
                           ("s", parts.s, (B, Hkv, n, G, 1))):
        if t.device != parts.o.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous f32 {shape}")
    out = torch.empty((B, Hkv * G, D), dtype=torch.bfloat16,
                      device=parts.o.device)
    rc = _build.lib().lse_merge(
        parts.o.data_ptr(), parts.m.data_ptr(), parts.s.data_ptr(),
        out.data_ptr(), B, Hkv * G, Hkv, D, n, _build.stream_of(out))
    _build.check(rc, "lse_merge")
    LAUNCHES["lse_merge"] += 1
    return out


def flash_decode(q, k, v, lengths=None, *, scale=None, kv_splits=None,
                 layer=None, k_scale=None, v_scale=None,
                 return_partial=False):
    """Single-token attention against a KV cache, split-KV parallel.

    q: [B, Hq, D] bf16; k, v: [B, Hkv, S, D] bf16, or the full stacked
    cache [L, B, Hkv, S, D] with ``layer`` (an int): the kernel offsets its
    pointers by the layer, so no per-layer copy is made. lengths: int32 [B]
    valid prefix per sequence (default S). ``k_scale`` / ``v_scale``: f32
    per-token scales of an int8 / float8_e4m3fn cache, shaped as k without
    its last dim. Returns [B, Hq, D] bf16. ``kv_splits``: None picks the
    split count from S and the SM count.

    ``return_partial``: the un-normalized (o [B, Hq, D], m, s [B, Hq, 1])
    f32 partial, for a merge across ranks (``lse.lse_combine_axis``): the
    per-split partials of ``flash_decode_partials`` (the kernel) folded over
    the split axis by ``lse_combine_stacked`` (plain torch, as the
    reference folds its splits outside the kernel), not normalized."""
    if not kernels_for(q) and not return_partial:
        return flash_decode_ref(q, k, v, lengths, scale=scale,
                                kv_splits=kv_splits or 1, layer=layer,
                                k_scale=k_scale, v_scale=v_scale)
    B, Hq, D = q.shape
    Hkv, S = k.shape[-3], k.shape[-2]
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
    n = kv_splits or (pick_splits(B, Hkv, S, _sm_count(q.device.index or 0))
                      if kernels_for(q) else 1)
    parts = flash_decode_partials(q, k, v, lengths, scale=scale,
                                  n_splits=n, layer=layer, k_scale=k_scale,
                                  v_scale=v_scale)
    if return_partial:
        merged = lse_combine_stacked(parts, axis=2)     # [B, Hkv, G, *]
        return AttnPartial(*(f.reshape(B, Hq, -1) for f in merged))
    return lse_merge(parts)
