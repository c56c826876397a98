"""The whole batch-1 decode attention block in one launch: wqkv int8
matvec -> RoPE -> splice of the new token's k / v -> split-KV decode over
the cache -> per-block int8 quantization of o -> W_o int8 matvec.

Port of the reference's ``ops/fused_attention.py`` (``attention_fused``,
its ``_fused_attn_kernel``), with its numerics, not the unfused path's:

- x is the normed hidden state [1, dim] in f32; wqkv's output stays f32;
- q is roped in f32 with 1/sqrt(D) folded into the cos / sin rows;
- k is roped in f32 and rounded to the cache dtype, v is rounded to it;
  the new token enters the attention as those rounded values, at position
  ``lengths[0]``;
- o stays f32 up to its quantization for W_o.

The reference stores W_o in its "wof" column order, a TPU lane trick; the
port keeps W_o in logical order and takes only the shape half of the gate
(``wof_shape_supported``): head_dim 128, Hq * D == 4096, GQA ratio in
{1, 2, 4, 8}, a bf16 or f32 cache. The kernel is in
``csrc/fused_decode.cu``: the layer kernel's attention block alone (one CTA
an SM, a producer warp streaming the CTA's wqkv rows, its K / V tiles and
its W_o rows through a TMA ring; the keys split by ``split_plan`` from
``lengths[0]`` on the card; the last split of a KV head merges it and
quantizes its o once). The caller appends k_new / v_new to its cache: the
function itself writes nothing, like the reference's.

s6 q4_k weights (``quant_matmul``'s opt-in encoding) take the kernel's s6
instance (``fused_attention_s6``, counted under its own key), which
streams and decodes the s6 bytes; on the card wqkv and W_o must share one
encoding. The gate, as the reference's, does not look at the encoding.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
    QuantLinear, _check_q8, _check_ql, _scales, qmatmul_q8_ref)
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"fused_attention": 0, "fused_attention_s6": 0}

# per-(head, split) partials the workspace holds room for
MAX_SPLITS = 64
_CACHE_DTYPES = (torch.bfloat16, torch.float32)
KV_TILE_BYTES = 8192            # K (and V) bytes of one tile of the kernel
ONE_SPLIT_TILES = 8             # a cache of at most this many keeps 1 split
MAX_KV_HEADS = 64               # merge tickets of the kernel
# o's int8 operands (csrc/q8_common.cuh: 48 bytes a 32-block of 4096), as
# f32 words of the workspace
_O_IMAGE_WORDS = 48 * 4096 // 32 // 4
_TICKETS: dict = {}


def split_plan(length: int, S: int, n_kv_heads: int, ctas: int,
               cache_dtype) -> list:
    """The kernel's split of the keys (``csrc/fused_decode.cu``
    ``AttnPlan``) at ``lengths[0] == length``: the keys are the cache's
    first min(length + 1, S) (the new token included), in tiles of
    ``KV_TILE_BYTES`` (32 bf16 / 16 f32 keys); one split up to
    ``ONE_SPLIT_TILES`` tiles, else n = min(ctas // n_kv_heads, tiles,
    MAX_SPLITS), at least 1, splits of whole tiles, balanced. Returns each
    split's key range [k0, k1)."""
    tk = KV_TILE_BYTES // (128 * (4 if cache_dtype == torch.float32 else 2))
    keys = min(length + 1, S)
    tiles = -(-keys // tk)
    n = 1 if tiles <= ONE_SPLIT_TILES else max(
        1, min(ctas // n_kv_heads, tiles, MAX_SPLITS))
    return [(min(tiles * s // n * tk, keys), min(tiles * (s + 1) // n * tk,
                                                  keys))
            for s in range(n)]


def _tickets(device: torch.device) -> torch.Tensor:
    """The kernel's counters, int32 [2 + MAX_KV_HEADS] a device: its grid
    barrier's arrivals and exits and a merge ticket a KV head; zero between
    launches (the last CTA to use one sets it back). Made at the first
    call, which must not be inside a CUDA graph capture. Two streams must
    not run ``attention_fused`` at once."""
    t = _TICKETS.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("attention_fused: call it once outside a CUDA "
                               "graph capture first (its ticket buffer is "
                               "made then)")
        t = _TICKETS[device.index] = torch.zeros(
            2 + MAX_KV_HEADS, dtype=torch.int32, device=device)
    return t


def wof_shape_supported(dim_o: int, ko: int, n_heads: int, n_kv_heads: int,
                        head_dim: int) -> bool:
    """The shape half of the reference's fused-attention gate."""
    if n_kv_heads == 0 or n_heads % n_kv_heads != 0:
        return False
    r = n_heads // n_kv_heads
    return (head_dim == 128 and n_heads % 8 == 0 and 8 % r == 0
            and n_heads * head_dim == 4096 and (dim_o, ko) == (4096, 4096))


def attention_fused_supported(wqkv, wo, n_heads: int, n_kv_heads: int,
                              head_dim: int, cache_dtype) -> bool:
    if not (isinstance(wqkv, QuantLinear) and isinstance(wo, QuantLinear)):
        return False
    if wqkv.fmt != "q4_k" or wo.fmt != "q4_k":
        return False
    if not wof_shape_supported(*wo.array_shape, n_heads, n_kv_heads,
                               head_dim):
        return False
    dim = n_heads * head_dim
    if wqkv.array_shape != ((n_heads + 2 * n_kv_heads) * head_dim, dim):
        return False
    return cache_dtype in _CACHE_DTYPES


def rope_rows(lengths: torch.Tensor, head_dim: int, theta: float,
              scale: float):
    """(C, S2, C * scale, S2 * scale) f32 [D] at position ``lengths[0]``
    (rotate-half: out = x * C + roll(x, D/2) * S2), on lengths' device."""
    d2 = head_dim // 2
    freqs = theta ** (-torch.arange(0, d2, dtype=torch.float32,
                                    device=lengths.device) / d2)
    ang = lengths[:1].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    c, s2 = torch.cat([cos, cos]), torch.cat([-sin, sin])
    return c, s2, c * scale, s2 * scale


def decode_attention_ref(q: torch.Tensor, kn: torch.Tensor, vn: torch.Tensor,
                         k_layer: torch.Tensor, v_layer: torch.Tensor,
                         length: torch.Tensor) -> torch.Tensor:
    """Attention of the (already scaled) q [Hq, D] over the cache rows
    k_layer / v_layer [Hkv, S, D] at positions < length (a 1-element
    tensor, the new token included), with the new token's kn / vn [Hkv, D]
    standing at position length - 1. Returns f32 [Hq, D]."""
    hkv, s, d = k_layer.shape
    pos = torch.arange(s, device=q.device)
    new = (pos == length - 1)[None, :, None]
    kf = torch.where(new, kn.float()[:, None], k_layer.float())
    vf = torch.where(new, vn.float()[:, None], v_layer.float())
    qg = q.reshape(hkv, -1, d)
    sc = torch.einsum("grd,gsd->grs", qg, kf)
    sc = torch.where((pos < length)[None, None], sc, -torch.inf)
    return torch.einsum("grs,gsd->grd", torch.softmax(sc, -1),
                        vf).reshape(-1, d)


def attention_fused_ref(x, wqkv, wo, k_cache, v_cache, lengths, layer, *,
                        n_heads, n_kv_heads, head_dim, rope_theta=10000.0,
                        scale=None):
    """Plain version of ``attention_fused`` (same arguments and results)."""
    nh, nkv, d = n_heads, n_kv_heads, head_dim
    if scale is None:
        scale = float(1.0 / d ** 0.5)
    y = qmatmul_q8_ref(x, wqkv)[0]
    c, s2, cq, s2q = rope_rows(lengths, d, rope_theta, scale)
    q = y[:nh * d].reshape(nh, d)
    k = y[nh * d:(nh + nkv) * d].reshape(nkv, d)
    q = q * cq + torch.roll(q, d // 2, -1) * s2q
    kn = (k * c + torch.roll(k, d // 2, -1) * s2).to(k_cache.dtype)
    vn = y[(nh + nkv) * d:].reshape(nkv, d).to(v_cache.dtype)
    o = decode_attention_ref(q, kn, vn, k_cache[layer, 0], v_cache[layer, 0],
                             lengths[:1] + 1)
    return qmatmul_q8_ref(o.reshape(1, nh * d), wo), kn, vn


def check_cache(k_cache, v_cache, lengths, x, n_heads, n_kv_heads,
                head_dim) -> None:
    """Raise unless the cache is what the fused kernels take: contiguous
    bf16 / f32 [L, 1, Hkv, S, D] on x's device, lengths int32 [1]."""
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != x.device or t.dtype not in _CACHE_DTYPES \
                or t.dim() != 5 or t.shape[1] != 1 \
                or t.shape[2] != n_kv_heads or t.shape[4] != head_dim \
                or not t.is_contiguous() or t.dtype != k_cache.dtype \
                or t.shape != k_cache.shape:
            raise ValueError(f"{name}: need contiguous bf16/f32 [L, 1, "
                             f"{n_kv_heads}, S, {head_dim}] on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if lengths.device != x.device or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (1,):
        raise ValueError("lengths: need int32 [1] on x's device")


def attention_fused(x, wqkv, wo, k_cache, v_cache, lengths, layer, *,
                    n_heads, n_kv_heads, head_dim, rope_theta=10000.0,
                    scale=None):
    """x [1, dim] f32 (the normed hidden); k_cache / v_cache
    [L, 1, Hkv, S, D]; lengths int32 [1], the length BEFORE this token;
    layer: int. Returns (o [1, dim] f32, the attention block's output
    before the residual; k_new, v_new [Hkv, D] in the cache dtype, for the
    caller's append at position lengths[0])."""
    if not kernels_for(x):
        return attention_fused_ref(
            x, wqkv, wo, k_cache, v_cache, lengths, layer, n_heads=n_heads,
            n_kv_heads=n_kv_heads, head_dim=head_dim, rope_theta=rope_theta,
            scale=scale)
    if not attention_fused_supported(wqkv, wo, n_heads, n_kv_heads,
                                     head_dim, k_cache.dtype):
        raise ValueError("attention_fused: weights or cache outside the "
                         "fused gate")
    enc = wqkv.enc
    name = "fused_attention_s6" if enc == "s6" else "fused_attention"
    nq, dim = _check_q8(x, wqkv, name, enc=enc)
    _check_ql(wo, x.device, enc=enc)
    check_cache(k_cache, v_cache, lengths, x, n_heads, n_kv_heads, head_dim)
    L, _, _, S, D = k_cache.shape
    layer = int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    ptrs = [t.data_ptr() for w in (wqkv, wo) for t in (w.qs, *_scales(w))]
    if any(p % 16 for p in ptrs + [x.data_ptr(), k_cache.data_ptr(),
                                   v_cache.data_ptr()]):
        raise ValueError("attention_fused: the kernel copies x, the weights "
                         "and the caches by TMA, which needs them on 16 "
                         "bytes")
    npart = n_heads * MAX_SPLITS * (D + 2)
    ws = torch.empty((nq + npart + _O_IMAGE_WORDS,), dtype=torch.float32,
                     device=x.device)
    o = torch.empty((1, dim), dtype=torch.float32, device=x.device)
    kn = torch.empty((n_kv_heads, D), dtype=k_cache.dtype, device=x.device)
    vn = torch.empty_like(kn)
    rc = getattr(_build.lib(), name)(
        x.data_ptr(), *ptrs, k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), layer, n_heads, n_kv_heads, S,
        int(k_cache.dtype == torch.float32), float(rope_theta), scale,
        ws.data_ptr(), ws[nq:].data_ptr(), ws[nq + npart:].data_ptr(),
        o.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        _tickets(x.device).data_ptr(), _build.stream_of(x))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return o, kn, vn
