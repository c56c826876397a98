"""Whole decoder layers of the batch-1 decode in one launch.

Port of the reference's ``ops/layer_kernel.py`` (``layer_step`` and
``model_step``, its ``_layer_kernel``). One launch runs, per layer: attn
RMSNorm -> the fused attention block's phases (``ops/fused_attention.py``)
-> residual -> MLP RMSNorm -> the fused MLP's phases
(``quant_matmul.mlp_fused``) -> residual. ``layer_step`` runs one layer,
``model_step`` every layer, carrying h in f32 from layer to layer. The
norms are computed in f32 and not rounded (h * rsqrt(mean(h^2) + eps) * w),
as the reference's kernel does.

Weights are not copied. A ``LayerPack`` is a device table of each layer's
weight pointers (wqkv, wo, w_gu, w_down: qs, es, em) next to the layers'
norm weights in f32, and the kernel reads its weights through it. The
reference's ``pack_stream`` / ``build_model_pack`` stacked the weights into
one more copy (~4.4 GB at 7B) because Mosaic wanted one uniform operand.
``pack_layers([layer])`` makes the one-layer table ``layer_step`` takes
(the reference's per-layer ``w_pack``); ``models/llama.build_model_pack``
the all-layer one ``model_step`` takes.

The kernel (``csrc/fused_decode.cu``) writes nothing into the cache; the
caller appends the returned k_new / v_new at position ``lengths[0]``.
"""

from __future__ import annotations

import dataclasses

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.ops.fused_attention import (
    MAX_SPLITS, attention_fused_ref, attention_fused_supported, check_cache)
from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
    QuantLinear, mlp_fused_ref, mlp_fused_supported)
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"layer_step": 0, "model_step": 0}

STREAM = ("wqkv", "wo", "w_gu", "w_down")

# ``phase``: measurement-only variants of the kernel (tools/layer_probe.py),
# the reference's names plus ``no_sync``, passed to the kernel as an int.
# "all" is the production kernel; every other variant gives wrong outputs
# and is timed only. Every variant reads every weight and K / V byte:
# "no_bound" skips the prologues (RMSNorm and activation quantization, the
# merge of the attention splits and o's quantization, the mid's), "no_attn"
# the attention and its merge, "stream" every computation, "only_pack" /
# "only_down" compute only the wqkv, W_o and w_gu phases / the w_down
# phase, "no_sync" drops the grid barriers. The plain version takes "all"
# only.
PHASES = {"all": 0, "no_bound": 1, "no_attn": 2, "stream": 3,
          "only_pack": 4, "only_down": 5, "no_sync": 6}

_BARRIERS: dict = {}
MAX_LAYERS = 256                 # layers of one launch (the kernel's tickets)


def _barrier(device: torch.device) -> torch.Tensor:
    """The kernel's counters, int32 [2 + MAX_LAYERS * 64] a device: its grid
    barrier's arrivals and exits, and a merge ticket a layer and KV head
    (at most 64); zero between launches (the last CTA to use one sets it
    back). Made at the first call, which must not be inside a CUDA graph
    capture. Two streams must not run the layer kernel at once."""
    t = _BARRIERS.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("layer kernel: call it once outside a CUDA "
                               "graph capture first (its barrier counters "
                               "are made then)")
        t = _BARRIERS[device.index] = torch.zeros(
            2 + MAX_LAYERS * 64, dtype=torch.int32, device=device)
    return t


@dataclasses.dataclass
class LayerPack:
    """The weights of ``len(layers)`` consecutive decoder layers as the
    layer kernel reads them: ``ptrs`` int64 [nL, 12] on the weights' device
    (the data pointers of qs, es, em of wqkv, wo, w_gu, w_down), ``norms``
    f32 [nL, 2, dim] (attn_norm, mlp_norm), and the layer dicts themselves,
    which keep the tensors the pointers point into alive. Its layers share
    one shape, so a gate that holds for the first holds for all."""
    layers: list
    ptrs: torch.Tensor
    norms: torch.Tensor


def pack_layers(layers: list) -> LayerPack:
    """Pointer table of ``layers`` (uniform shapes, weights contiguous on
    one device with the dtypes the kernel reads); raises otherwise. One
    layer's pack is the reference's per-layer ``w_pack``, which
    ``layer_step`` takes; all of them ``model_step``'s."""
    dev = layers[0]["wqkv"].qs.device
    for i, lay in enumerate(layers):
        for k in STREAM:
            w, w0 = lay[k], layers[0][k]
            if not isinstance(w, QuantLinear) or w.fmt != "q4_k" \
                    or w.enc != "e" or w.array_shape != w0.array_shape:
                raise ValueError(f"pack_layers: layer {i} {k} is not a q4_k "
                                 "(Q4_K-E) weight shaped as layer 0's")
            for t, dt in ((w.qs, torch.uint8), (w.es, torch.bfloat16),
                          (w.em, torch.bfloat16)):
                if t.device != dev or t.dtype != dt or not t.is_contiguous():
                    raise ValueError(f"pack_layers: layer {i} {k} needs "
                                     f"contiguous {dt} on {dev}")
    table = [[getattr(lay[k], f).data_ptr() for k in STREAM
              for f in ("qs", "es", "em")] for lay in layers]
    if dev.type == "cuda" and any(p % 16 for row in table for p in row):
        raise ValueError("pack_layers: the kernel copies weights by TMA, "
                         "which needs 16-byte aligned qs / es / em")
    ptrs = torch.tensor(table, dtype=torch.int64).to(dev)
    norms = torch.stack([torch.stack([lay["attn_norm"].float(),
                                      lay["mlp_norm"].float()])
                         for lay in layers]).to(dev).contiguous()
    return LayerPack(layers=list(layers), ptrs=ptrs, norms=norms)


def fused_layout_ok(layer: dict, n_heads: int, n_kv_heads: int,
                    head_dim: int, cache_dtype) -> bool:
    """The reference's static gate of the layer kernel, from shapes: q4_k
    wqkv / wo / w_gu / w_down in the "e" encoding (an s6 weight shuts it,
    as in the reference) inside both the fused attention's and the fused
    MLP's gates, w_down back to dim, a bf16 / f32 cache."""
    if any(not isinstance(layer.get(k), QuantLinear) or layer[k].enc != "e"
           for k in STREAM):
        return False
    if not attention_fused_supported(layer["wqkv"], layer["wo"], n_heads,
                                     n_kv_heads, head_dim, cache_dtype):
        return False
    return (mlp_fused_supported(layer["w_gu"], layer["w_down"])
            and layer["w_down"].array_shape[0] == n_heads * head_dim)


def layer_step_supported(layer: dict, n_heads: int, n_kv_heads: int,
                         head_dim: int, cache_dtype) -> bool:
    """``fused_layout_ok`` and the layer's one-layer pack present."""
    pack = layer.get("w_pack")
    return (fused_layout_ok(layer, n_heads, n_kv_heads, head_dim,
                            cache_dtype)
            and isinstance(pack, LayerPack) and len(pack.layers) == 1)


def _rms_f32(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = (h * h).sum(-1, keepdim=True) / h.shape[-1]
    return h * torch.rsqrt(var + eps) * w


def _layers_ref(h, pack, k_cache, v_cache, lengths, layer0, *, n_heads,
                n_kv_heads, head_dim, rope_theta, rms_eps, scale):
    """Plain version of the layer kernel over the pack's layers."""
    h = h.float()
    kns, vns = [], []
    for i, lay in enumerate(pack.layers):
        anorm, mnorm = pack.norms[i]
        o, kn, vn = attention_fused_ref(
            _rms_f32(h, anorm, rms_eps), lay["wqkv"], lay["wo"], k_cache,
            v_cache, lengths, layer0 + i, n_heads=n_heads,
            n_kv_heads=n_kv_heads, head_dim=head_dim, rope_theta=rope_theta,
            scale=scale)
        h2 = h + o
        h = h2 + mlp_fused_ref(_rms_f32(h2, mnorm, rms_eps), lay["w_gu"],
                               lay["w_down"])
        kns.append(kn)
        vns.append(vn)
    return h, torch.stack(kns), torch.stack(vns)


def _dispatch(h, pack, k_cache, v_cache, lengths, layer0, *, n_heads,
              n_kv_heads, head_dim, rope_theta, rms_eps, scale, name, phase):
    if phase not in PHASES:
        raise ValueError(f"{name}: phase {phase!r} is not one of "
                         f"{', '.join(PHASES)}")
    if scale is None:
        scale = float(1.0 / head_dim ** 0.5)
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
              rope_theta=rope_theta, rms_eps=rms_eps, scale=scale)
    if not kernels_for(h):
        if phase != "all":
            raise ValueError(f"{name}: the plain version has no phase "
                             f"{phase!r} (measurement-only, the kernel's)")
        return _layers_ref(h, pack, k_cache, v_cache, lengths, layer0, **kw)
    nl = len(pack.layers)
    if nl > MAX_LAYERS:
        raise ValueError(f"{name}: at most {MAX_LAYERS} layers a launch")
    lay0 = pack.layers[0]
    if not fused_layout_ok(lay0, n_heads, n_kv_heads, head_dim,
                           k_cache.dtype):
        raise ValueError(f"{name}: layers outside the fused gate")
    dim = n_heads * head_dim
    if h.dtype != torch.float32 or tuple(h.shape) != (1, dim) \
            or not h.is_contiguous():
        raise ValueError(f"{name}: h must be contiguous f32 [1, {dim}]")
    if pack.ptrs.device != h.device:
        raise ValueError(f"{name}: the pack lies on {pack.ptrs.device}, "
                         f"h on {h.device}")
    check_cache(k_cache, v_cache, lengths, h, n_heads, n_kv_heads, head_dim)
    if (k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError(f"{name}: the caches must start on 16 bytes (TMA)")
    L, _, _, S, D = k_cache.shape
    if not (0 <= layer0 and layer0 + nl <= L):
        raise ValueError(f"{name}: layers {layer0}..{layer0 + nl - 1} "
                         f"outside the cache's {L}")
    nq = lay0["wqkv"].array_shape[0]
    kd = lay0["w_down"].array_shape[1]
    npart = n_heads * MAX_SPLITS * (D + 2)
    ws = torch.empty((nq + npart + 2 * kd + dim,), dtype=torch.float32,
                     device=h.device)
    hout = torch.empty((1, dim), dtype=torch.float32, device=h.device)
    kn = torch.empty((nl, n_kv_heads, D), dtype=k_cache.dtype,
                     device=h.device)
    vn = torch.empty_like(kn)
    rc = _build.lib().layer_kernel(
        h.data_ptr(), pack.ptrs.data_ptr(), pack.norms.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(), layer0,
        nl, n_heads, n_kv_heads, S, kd,
        int(k_cache.dtype == torch.float32), float(rope_theta), scale,
        float(rms_eps), ws.data_ptr(), ws[nq:].data_ptr(),
        ws[nq + npart:].data_ptr(), ws[nq + npart + 2 * kd:].data_ptr(),
        hout.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        _barrier(h.device).data_ptr(), PHASES[phase], _build.stream_of(h))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return hout, kn, vn


def layer_step(h, w_pack: LayerPack, k_cache, v_cache, lengths, layer, *,
               n_heads, n_kv_heads, head_dim, rope_theta=10000.0,
               rms_eps=1e-5, scale=None, phase="all"):
    """One decoder layer. h [1, dim] f32 (pre-norm hidden, logical
    order); w_pack: ``pack_layers([layer])``; k_cache / v_cache
    [L, 1, Hkv, S, D]; lengths int32 [1], BEFORE this token; layer: the
    cache layer; phase: ``PHASES`` (measurement only). Returns (h_next
    [1, dim] f32, k_new, v_new [Hkv, D])."""
    hn, kn, vn = _dispatch(h, w_pack, k_cache, v_cache, lengths, int(layer),
                           n_heads=n_heads, n_kv_heads=n_kv_heads,
                           head_dim=head_dim, rope_theta=rope_theta,
                           rms_eps=rms_eps, scale=scale, name="layer_step",
                           phase=phase)
    return hn, kn[0], vn[0]


def model_step(h, m_pack: LayerPack, k_cache, v_cache, lengths, *,
               n_heads, n_kv_heads, head_dim, rope_theta=10000.0,
               rms_eps=1e-5, scale=None, phase="all"):
    """Every decoder layer in one launch, h carried in f32 between layers.
    h [1, dim] f32 (the embedded token); phase: ``PHASES`` (measurement
    only). Returns (h_last [1, dim] f32, k_new, v_new [L, Hkv, D]) for the
    caller's cache append."""
    return _dispatch(h, m_pack, k_cache, v_cache, lengths, 0,
                     n_heads=n_heads, n_kv_heads=n_kv_heads,
                     head_dim=head_dim, rope_theta=rope_theta,
                     rms_eps=rms_eps, scale=scale, name="model_step",
                     phase=phase)
