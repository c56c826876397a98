"""Split-KV flash decode: single-token attention against the KV cache.

Port of the reference's ``ops/flash_decode.py`` (``flash_decode`` with its
``_decode_kernel`` for GQA and ``_decode_kernel_ht`` for MHA). Two kernels in
``csrc/flash_decode.cu`` carry it:

- ``flash_decode_partials``: grid (B * Hkv, n_splits); a CTA holds the G
  query heads of one KV head as the rows that share each K/V chunk, and
  emits that split's (o, m, s) partial;
- ``lse_merge``: folds the splits with the ``ops/lse.py`` combine and writes
  o / s in bf16.

n_splits depends only on the padded cache length and the SM count, so the
launch needs nothing from the device: ``lengths`` stays on the card, and a
split wholly past a sequence's length emits the LSE identity.
"""

from __future__ import annotations

import functools

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.ops.lse import (
    AttnPartial, lse_combine_stacked, lse_finalize)
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"flash_decode": 0, "lse_merge": 0}

_KEYS_PER_CHUNK = 64       # keys per online-softmax step of the kernel
_MAX_GROUP = 16            # query heads per KV head the kernel takes


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pick_splits(batch: int, n_kv_heads: int, seq: int, sms: int) -> int:
    """Splits per (sequence, KV head): enough CTAs for about two waves of
    the card, each split holding at least one chunk of keys."""
    want = -(-2 * sms // (batch * n_kv_heads))
    return max(1, min(want, -(-seq // _KEYS_PER_CHUNK)))


def _layer_view(k, v, layer):
    """(k, v) of one layer as [B, Hkv, S, D] views, and the layer index."""
    if (k.dim() == 5) != (layer is not None):
        raise ValueError("pass `layer` iff k/v carry a leading layer dim")
    if layer is None:
        return k, v, 0
    layer = int(layer)
    if not 0 <= layer < k.shape[0]:
        raise ValueError(f"layer {layer} out of range [0, {k.shape[0]})")
    return k[layer], v[layer], layer


def _partials_ref(q, k, v, lengths, scale, n_splits):
    """Plain per-split partials: o [B, Hkv, n, G, D], m/s [B, Hkv, n, G, 1]
    f32, splitting S into n spans of ceil(S / n) keys like the kernel."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k.float()) * scale
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    span = -(-S // n_splits)
    os_, ms, ss = [], [], []
    for lo in range(0, span * n_splits, span):
        sc = s[..., lo:lo + span]
        m = sc.amax(-1, keepdim=True) if sc.shape[-1] else torch.full_like(
            s[..., :1], -torch.inf)
        p = torch.where(m == -torch.inf, torch.zeros_like(sc),
                        torch.exp(sc - m))
        os_.append(torch.einsum("bhgs,bhsd->bhgd", p,
                                v[:, :, lo:lo + span].float()))
        ms.append(m)
        ss.append(p.sum(-1, keepdim=True))
    return AttnPartial(torch.stack(os_, 2), torch.stack(ms, 2),
                       torch.stack(ss, 2))


def _merge_ref(parts: AttnPartial, out_dtype) -> torch.Tensor:
    B, Hkv, _, G, D = parts.o.shape
    merged = lse_combine_stacked(parts, axis=2)
    return lse_finalize(merged, out_dtype=out_dtype).reshape(B, Hkv * G, D)


def flash_decode_ref(q, k, v, lengths=None, *, scale=None, kv_splits=1,
                     layer=None):
    """Plain version: per-split (o, m, s) partials in f32, merged with
    ``lse_combine_stacked`` and normalized with ``lse_finalize``. Same
    arguments as ``flash_decode``; returns [B, Hq, D] in q's dtype."""
    k, v, _ = _layer_view(k, v, layer)
    B, _, D = q.shape
    S = k.shape[2]
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
    return _merge_ref(_partials_ref(q, k, v, lengths, scale, kv_splits),
                      q.dtype)


def flash_decode_partials(q, k, v, lengths, *, scale, n_splits, layer=None
                          ) -> AttnPartial:
    """Kernel 1 of ``flash_decode``: the per-split partials,
    o [B, Hkv, n, G, D], m/s [B, Hkv, n, G, 1] f32."""
    kl, vl, li = _layer_view(k, v, layer)
    if not kernels_for(q):
        return _partials_ref(q, kl, vl, lengths, scale, n_splits)
    B, Hkv, S, D = kl.shape
    Bq, Hq, Dq = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous bf16 on {q.device}")
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
    o = torch.empty((B, Hkv, n_splits, G, D), dtype=torch.float32,
                    device=q.device)
    m = torch.empty((B, Hkv, n_splits, G, 1), dtype=torch.float32,
                    device=q.device)
    s = torch.empty_like(m)
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
                 layer=None):
    """Single-token attention against a KV cache, split-KV parallel.

    q: [B, Hq, D] bf16; k, v: [B, Hkv, S, D] bf16, or the full stacked
    cache [L, B, Hkv, S, D] with ``layer`` (an int): the kernel offsets its
    pointers by the layer, so no per-layer copy is made. lengths: int32 [B]
    valid prefix per sequence (default S). Returns [B, Hq, D] bf16.
    ``kv_splits``: None picks the split count from S and the SM count."""
    if not kernels_for(q):
        return flash_decode_ref(q, k, v, lengths, scale=scale,
                                kv_splits=kv_splits or 1, layer=layer)
    B, Hq, D = q.shape
    Hkv, S = k.shape[-3], k.shape[-2]
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
    n = kv_splits or pick_splits(B, Hkv, S, _sm_count(q.device.index or 0))
    parts = flash_decode_partials(q, k, v, lengths, scale=scale,
                                  n_splits=n, layer=layer)
    return lse_merge(parts)
