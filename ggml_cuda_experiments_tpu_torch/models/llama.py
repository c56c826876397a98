"""Llama-family model in PyTorch: Q8_0, Q4_0, Q4_K-E or Q6_K-E linears (a
head of another format, e.g. the Q4_K_M mix's Q6_K-E head), a bf16, int8 or
fp8 contiguous KV cache, flash prefill and split-KV decode; greedy or
sampled generation.

Port of the reference's ``models/llama.py``, same function names,
signatures and public layouts (KV cache [L, B, Hkv, S, D]; logits f32).
``_forward``, ``_attention_block``, ``_mlp_block`` and ``_head_logits``
take the reference's branch for every ``ModelConfig`` (``x_quant8``,
``fuse_attn``, ``fuse_mlp``, ``fuse_layer``, ``hperm``), decided from the
same shapes: the batch-1 decode runs ``model_step`` (every layer in one
launch), ``layer_step`` per layer, ``attention_fused`` and ``mlp_fused``,
or the unfused blocks, and the matvecs take int8 activations under
``x_quant8`` (q4_k and q4_0 at (K/32) % 128 == 0). The fused kernels are
q4_k's only, as in the reference: q8_0, q4_0 and q6_k layers always decode
unfused. The prefill takes the fused RoPE + repack kernel
(``ops/prefill_fuse.py``) under the reference's own gate. A quantized cache
(int8 / fp8 with per-token scales) closes the fused attention, the RoPE +
repack kernel and the layer kernel, as in the reference. What differs, on
purpose:

- Weights stay in logical column order: ``w_gu`` stands where the
  reference builds ``w_gu_f``, W_o has no ``wof`` layout, and
  ``permute_hidden_params`` permutes nothing: it attaches the model pack
  (a device table of weight pointers, no copy) that picks ``model_step``.
  So a q6_k head takes the same call with or without ``hperm`` (the
  reference un-permutes the hidden vector for it).
- MoE layers (``models/moe.py``) take the reference's dense dispatch
  in ``_mlp_block``; they have no ``w_gu``, so the fused MLP and the layer
  kernel stay closed for them, and ``quantize_params`` /
  ``permute_hidden_params`` refuse them, as the reference fails there.
- Not ported, and raised, never computed another way: the
  ``x_prepermuted`` argument (no interleaved order exists here).
- PyTorch runs eagerly and the cache is updated IN PLACE: ``prefill`` and
  ``decode_step`` write k, v and lengths of the cache they are given and
  return it. Positions and lengths stay on the device; the only host fetch
  in ``generate`` is the tokens at the end. ``generate_scan`` (the
  reference's ``lax.scan``) replays the decode step as a CUDA graph.
- ``init_weights`` and ``KVCache.create`` build on the card unless a
  device is named.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ggml_cuda_experiments_tpu_torch.models import moe
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.models.sampling import (
    SamplingParams, sample)
from ggml_cuda_experiments_tpu_torch.ops.flash_attention import flash_attention
from ggml_cuda_experiments_tpu_torch.ops.flash_decode import flash_decode
from ggml_cuda_experiments_tpu_torch.ops import layer_kernel
from ggml_cuda_experiments_tpu_torch.ops.fused_attention import (
    attention_fused, attention_fused_supported)
from ggml_cuda_experiments_tpu_torch.ops.prefill_fuse import (
    rope_pack_prefill, rope_tables)
from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
    FORMATS, QuantLinear, mlp_fused, mlp_fused_supported, qmatmul,
    qmatmul_ref, quantize)
from ggml_cuda_experiments_tpu_torch.utils.platform import resolve_device

Params = dict[str, Any]

# The reference's two cutoffs. Up to _QMATVEC_MAX_ROWS rows a linear goes
# through ``qmatmul`` (q8_0 / q4_0 / q4_k: the matvec at one row, the GEMM
# from two; q6_k: its matvecs at one row, else a bf16 dequantize + matmul);
# up to _QPIPE_MAX_ROWS a q8_0 / q4_0 / q4_k linear runs the GEMM too (the
# reference's pipelined GEMM, the same function as its small-batch one, so
# one kernel here); above, and for a q6_k weight above _QMATVEC_MAX_ROWS, f32
# dequantize + torch.matmul, the reference's qmatmul_xla: a plain product,
# no kernel. To be measured again on the H100.
_QMATVEC_MAX_ROWS = 32
_QPIPE_MAX_ROWS = 512


def apply_linear(x: torch.Tensor, w, xq8: bool = False,
                 x_prepermuted: bool = False) -> torch.Tensor:
    """y = x @ W^T for dense [N, K] or QuantLinear weights; x: [..., K].
    ``xq8``: a batch-1 product takes int8 activations where the
    reference's gate allows it (``quant_matmul.qmatmul``)."""
    if x_prepermuted:
        raise NotImplementedError("x_prepermuted: the port keeps logical "
                                  "column order")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QuantLinear):
        rows = x2.shape[0]
        if rows <= _QMATVEC_MAX_ROWS or (rows <= _QPIPE_MAX_ROWS
                                         and w.fmt != "q6_k"):
            y = qmatmul(x2, w, x_quant8=xq8)
        else:
            # the reference's qmatmul_xla: f32 dequantize + a plain matmul
            y = qmatmul_ref(x2, w).to(x.dtype)
    else:
        y = (x2.to(w.dtype).float() @ w.float().T).to(x.dtype)
    return y.reshape(*lead, -1)


def qkv_proj(layer: Params, x: torch.Tensor, cfg: ModelConfig):
    """Query/key/value projections; one fused wqkv weight when present."""
    xq8 = cfg.x_quant8
    if "wqkv" in layer:
        y = apply_linear(x, layer["wqkv"], xq8)
        s1 = cfg.n_heads * cfg.head_dim
        s2 = s1 + cfg.n_kv_heads * cfg.head_dim
        return y[..., :s1], y[..., s1:s2], y[..., s2:]
    return tuple(apply_linear(x, layer[k], xq8) for k in ("wq", "wk", "wv"))


def gate_up_proj(layer: Params, x: torch.Tensor, xq8: bool = False,
                 x_prepermuted: bool = False):
    """Gate/up projections; one fused w_gu weight when present."""
    if "w_gu" in layer:
        y = apply_linear(x, layer["w_gu"], xq8, x_prepermuted)
        h = y.shape[-1] // 2
        return y[..., :h], y[..., h:]
    return (apply_linear(x, layer["w_gate"], xq8, x_prepermuted),
            apply_linear(x, layer["w_up"], xq8, x_prepermuted))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, rotate-half (HF Llama) convention.

    x: [B, T, H, D]; positions: [B, T] int32."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d // 2, dtype=torch.float32,
                                    device=x.device) / (d // 2))
    ang = positions.float()[..., None] * freqs              # [B, T, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Contiguous per-layer KV cache: k, v [n_layers, B, Hkv, S, D] (bf16;
    int8 or float8_e4m3fn when quantized); k_scale, v_scale
    [n_layers, B, Hkv, S] f32 per-token dequantization scales (None for the
    bf16 cache); lengths int32 [B] valid prefix length, on the same
    device."""
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def quant_fmt(self) -> str | None:
        if not self.quantized:
            return None
        return "int8" if self.k.dtype == torch.int8 else "fp8"

    @staticmethod
    def create(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, quantized: bool | str = False,
               device=None) -> "KVCache":
        """``quantized``: False, True / "int8", or "fp8" (a float8_e4m3fn
        payload with the same per-token f32 scales)."""
        device = resolve_device(device)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
        if quantized:
            if quantized not in (True, "int8", "fp8"):
                raise ValueError(f"quantized={quantized!r}: False, True, "
                                 "'int8' or 'fp8'")
            qdt = torch.float8_e4m3fn if quantized == "fp8" else torch.int8
            return KVCache(
                k=torch.zeros(shape, dtype=qdt, device=device),
                v=torch.zeros(shape, dtype=qdt, device=device),
                lengths=lengths,
                k_scale=torch.zeros(shape[:-1], device=device),
                v_scale=torch.zeros(shape[:-1], device=device))
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       lengths=lengths)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A one-byte array as uint8, so index writes take int8 and fp8 alike."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _write_cache_layer(cache: torch.Tensor, li: int, new: torch.Tensor,
                       pos: torch.Tensor, b0: int = 0) -> torch.Tensor:
    """Write new [B, Hkv, T, ...] into the full cache [L, B, Hkv, S, ...]
    at (li, b0 + b, :, pos[b] + t), in place, with one device-side index op
    (pos stays on the device). Serves k / v and their scale arrays."""
    B, _, T = new.shape[:3]
    t = pos[:, None].long() + torch.arange(T, device=pos.device)     # [B, T]
    b = b0 + torch.arange(B, device=pos.device)[:, None].expand(B, T)
    _bytes(cache)[li][b, :, t] = _bytes(new.transpose(1, 2).to(cache.dtype))
    return cache


def _write_kv(cache: "KVCache", li: int, kt: torch.Tensor, vt: torch.Tensor,
              pos: torch.Tensor, b0: int = 0) -> None:
    """Write layer li's fresh K / V [B, Hkv, T, D] at pos into cache rows
    b0 .., quantized per token first when the cache is (the reference's
    _quantize_rowwise)."""
    if cache.quantized:
        for arr, scales, x in ((cache.k, cache.k_scale, kt),
                               (cache.v, cache.v_scale, vt)):
            q, sc = _quantize_rowwise(x, cache.quant_fmt)
            _write_cache_layer(arr, li, q, pos, b0)
            _write_cache_layer(scales, li, sc, pos, b0)
    else:
        _write_cache_layer(cache.k, li, kt, pos, b0)
        _write_cache_layer(cache.v, li, vt, pos, b0)


def _quantize_rowwise(x: torch.Tensor, fmt: str = "int8"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax quantization of [..., D] to int8 (scale amax / 127,
    round half to even, clip to +-127) or float8_e4m3fn (scale amax / 448).
    Returns (values, f32 scales [...]); bit-equal to the reference's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if fmt == "fp8":
        scale = amax / 448.0
        q = (xf / torch.where(scale == 0.0, 1.0, scale)).to(
            torch.float8_e4m3fn)
    else:
        scale = amax / 127.0
        q = torch.clamp(torch.round(xf / torch.where(scale == 0.0, 1.0,
                                                     scale)),
                        -127, 127).to(torch.int8)
    return q, scale[..., 0]


# ---------------------------------------------------------------------------
# transformer blocks
# ---------------------------------------------------------------------------

def _xla_decode_attention(q: torch.Tensor, cache: KVCache, li: int,
                          lengths: torch.Tensor, scale: float
                          ) -> torch.Tensor:
    """The reference's full-read decode attention for small padded caches
    (B == 1, ``cfg.xla_attn_max_cache``): every cached position of layer
    ``li`` read in f32 (dequantized by the per-token scales for an int8 /
    fp8 cache), the positions at or past ``lengths`` masked, one softmax.
    Plain PyTorch, as it is plain XLA in the reference (no Pallas kernel).

    q: [B, Hq, D]; returns [B, Hq, D] f32."""
    k, v = cache.k[li], cache.v[li]                # [B, Hkv, S, D]
    B, Hkv, S, D = k.shape
    Hq = q.shape[1]
    qf = q.reshape(B, Hkv, Hq // Hkv, D).float() * scale
    kf, vf = k.float(), v.float()
    if cache.quantized:
        kf = kf * cache.k_scale[li][..., None]
        vf = vf * cache.v_scale[li][..., None]
    s = torch.einsum("bhrd,bhsd->bhrs", qf, kf)
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    s = torch.where(pos[None, None, None, :] < lengths[:, None, None, None],
                    s, torch.full_like(s, float("-inf")))
    o = torch.einsum("bhrs,bhsd->bhrd", torch.softmax(s, dim=-1), vf)
    return o.reshape(B, Hq, D)


def _append_kv(cache: KVCache, li: int, kn: torch.Tensor, vn: torch.Tensor,
               pos0: torch.Tensor) -> None:
    """Append one token's k / v [Hkv, D] of layer ``li`` at pos0 (B == 1)."""
    _write_cache_layer(cache.k, li, kn[None, :, None, :], pos0)
    _write_cache_layer(cache.v, li, vn[None, :, None, :], pos0)


def row_parallel(x: torch.Tensor, w, xq8: bool = False, mesh=None,
                 reduce_axis: str | None = None) -> torch.Tensor:
    """``apply_linear(x, w)``, psum'd over ``reduce_axis`` when there is one
    (w then holds the rank's K-slice). The partial products are summed in
    f32 and rounded to x's dtype once (the reference psums them in bf16)."""
    if reduce_axis is None:
        return apply_linear(x, w, xq8)
    from ggml_cuda_experiments_tpu_torch.parallel.mesh import psum
    return psum(apply_linear(x.float(), w, xq8), mesh,
                reduce_axis).to(x.dtype)


def _attention_block(layer: Params, cfg: ModelConfig, h: torch.Tensor,
                     cache: KVCache, li: int, positions: torch.Tensor, *,
                     decode: bool, reduce_axis: str | None = None,
                     mesh=None, b0: int = 0, valid: bool | None = None,
                     tables=None):
    """The attention block; returns (its output, the cache, written in
    place).

    ``tables``: the prefill's (C, S2) for the RoPE + repack kernel
    (``prefill_fuse.rope_tables`` at ``positions[0]``), made once by
    ``_forward`` for all its layers; where the kernel's gate opens without
    them, it makes its own.

    ``reduce_axis`` (with ``mesh``): tensor parallelism. cfg then describes
    the rank's shard (heads divided), wq / wk / wv are column-parallel and
    the wo product is psum'd over the axis. ``b0`` / ``valid``: pipeline
    microbatching. h covers cache rows [b0, b0 + B), and ``valid=False``
    (a bubble step) suppresses the cache writes. Either closes the fused
    attention and the RoPE + repack kernel, as in the reference."""
    B, T, _ = h.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    quantized = cache.quantized
    micro = not (b0 == 0 and valid is None)
    x = rms_norm(h, layer["attn_norm"], cfg.rms_eps)
    if (decode and cfg.fuse_attn and not micro and reduce_axis is None
            and B == 1 and T == 1 and not quantized
            and cfg.x_quant8 and "wqkv" in layer
            and attention_fused_supported(layer["wqkv"], layer["wo"], Hq, Hkv,
                                          D, cache.k.dtype)):
        # the whole block in one launch; its k / v go to the cache after
        o, kn, vn = attention_fused(
            x[:, 0].float(), layer["wqkv"], layer["wo"], cache.k, cache.v,
            cache.lengths, li, n_heads=Hq, n_kv_heads=Hkv, head_dim=D,
            rope_theta=cfg.rope_theta)
        _append_kv(cache, li, kn, vn, positions[:, 0])
        return o[:, None].to(h.dtype), cache
    if (not decode and not micro and reduce_axis is None
            and B == 1 and T % 128 == 0 and D == 128
            and "wqkv" in layer and not quantized):
        # the reference's fuse_rope gate: one kernel ropes q / k and
        # repacks q / k / v head-major
        qt, kt, vt = rope_pack_prefill(
            apply_linear(x, layer["wqkv"])[0], positions[0], n_heads=Hq,
            n_kv_heads=Hkv, head_dim=D, rope_theta=cfg.rope_theta,
            tables=tables)
        q = qt.transpose(0, 1)[None]             # [1, T, Hq, D]
        kt, vt = kt[None], vt[None]              # [1, Hkv, T, D]
    else:
        q, k, v = qkv_proj(layer, x, cfg)
        q = rope(q.reshape(B, T, Hq, D), positions, cfg.rope_theta)
        k = rope(k.reshape(B, T, Hkv, D), positions, cfg.rope_theta)
        kt = k.transpose(1, 2)                   # [B, Hkv, T, D]
        vt = v.reshape(B, T, Hkv, D).transpose(1, 2)
    if valid is not False:
        _write_kv(cache, li, kt, vt, positions[:, 0], b0)
    if decode and not micro and B == 1 \
            and cache.k.shape[3] <= cfg.xla_attn_max_cache:
        # the reference's small-cache gate: one full read, no kernel
        o = _xla_decode_attention(q[:, 0], cache, li, cache.lengths + 1,
                                  float(1.0 / D ** 0.5))[:, None]
    elif decode:
        # this layer's rows b0 .. b0 + B (contiguous views, no copy)
        rows = lambda a: None if a is None else a[li, b0:b0 + B]
        o = flash_decode(q[:, 0].contiguous(), rows(cache.k), rows(cache.v),
                         cache.lengths[b0:b0 + B] + 1,
                         k_scale=rows(cache.k_scale),
                         v_scale=rows(cache.v_scale))[:, None]
    else:
        # prefill attends over the fresh bf16 K/V, even for a quantized
        # cache (it starts empty at the prefill)
        o = flash_attention(q.transpose(1, 2).contiguous(), kt.contiguous(),
                            vt.contiguous(), causal=True).transpose(1, 2)
    o = o.reshape(B, T, Hq * D).to(h.dtype)
    return row_parallel(o, layer["wo"], cfg.x_quant8, mesh,
                        reduce_axis), cache


def _mlp_block(layer: Params, cfg: ModelConfig, h: torch.Tensor,
               reduce_axis: str | None = None, expert_axis: str | None = None,
               mesh=None) -> torch.Tensor:
    """The MLP block; ``reduce_axis`` (with ``mesh``): w_gate / w_up
    column-parallel, the w_down product psum'd. A MoE layer (``router``)
    takes ``moe.moe_mlp``, its experts sharded over ``expert_axis`` when
    given; it has nothing to reduce over ``reduce_axis`` (its experts are
    whole on every model rank, as in the reference). The fused MLP has no
    ``reduce_axis`` gate, as in the reference (a tensor-parallel layer has
    no ``w_gu``)."""
    x = rms_norm(h, layer["mlp_norm"], cfg.rms_eps)
    if "router" in layer:
        return moe.moe_mlp(layer, cfg, x, expert_axis=expert_axis,
                           mesh=mesh, xq8=cfg.x_quant8)
    x2 = x.reshape(-1, x.shape[-1])
    if (x2.shape[0] == 1 and cfg.fuse_mlp and "w_gu" in layer
            and mlp_fused_supported(layer["w_gu"], layer["w_down"])):
        # one row (decode, or a 1-token prompt): the whole MLP in one launch
        out = mlp_fused(x2.float(), layer["w_gu"], layer["w_down"])
        if reduce_axis is not None:
            from ggml_cuda_experiments_tpu_torch.parallel.mesh import psum
            out = psum(out, mesh, reduce_axis)
        return out.to(x.dtype).reshape(*x.shape[:-1], -1)
    gate, up = gate_up_proj(layer, x, cfg.x_quant8)
    return row_parallel(F.silu(gate.float()).to(x.dtype) * up,
                        layer["w_down"], cfg.x_quant8, mesh, reduce_axis)


def _layer_kernel_ok(layer: Params, cfg: ModelConfig, cache: KVCache
                     ) -> bool:
    return layer_kernel.fused_layout_ok(layer, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, cache.k.dtype)


def _forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             cache: KVCache, positions: torch.Tensor, *, decode: bool,
             reduce_axis: str | None = None, mesh=None,
             all_logits: bool = False, layer_hook=None
             ) -> tuple[torch.Tensor, KVCache]:
    """The model on tokens [B, T] at ``positions``; ``reduce_axis`` /
    ``mesh``: tensor parallelism (``parallel/tp.py``), which closes the
    layer kernel. Under it the logits are the rank's vocabulary shard.

    ``layer_hook(li, h, b0) -> h``: called on each layer's input (b0 = 0,
    the first batch row h covers), and its result is the layer's input.
    It observes or replaces the hidden state between layers; with a hook
    the model runs layer by layer (not through the whole-model kernel)."""
    h = params["embed"][tokens]                  # [B, T, dim]
    B, T = tokens.shape
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
              rms_eps=cfg.rms_eps)
    use_layer_kernel = (decode and cfg.fuse_layer and cfg.hperm
                        and cfg.x_quant8 and reduce_axis is None
                        and B == 1 and T == 1
                        and not cache.quantized)
    pack = params.get("m_pack")
    # the pack's layers share one shape (build_model_pack), so the
    # reference's gate over every layer is its gate over the first
    if (use_layer_kernel and pack is not None and layer_hook is None
            and _layer_kernel_ok(pack.layers[0], cfg, cache)):
        # every decoder layer in one launch, h in f32 throughout; then one
        # cache append per array
        hm, kn, vn = layer_kernel.model_step(
            h[:, 0].float(), pack, cache.k, cache.v, cache.lengths, **kw)
        pos = positions[:1, 0].long()
        cache.k[:, 0, :, pos] = kn[:, :, None].to(cache.k.dtype)
        cache.v[:, 0, :, pos] = vn[:, :, None].to(cache.v.dtype)
        h = rms_norm(hm[:, None].to(h.dtype), params["final_norm"],
                     cfg.rms_eps)
        return _head_logits(params, cfg, h, cache, tokens, all_logits)
    # the RoPE + repack kernel's tables depend on the positions alone: made
    # once here where its gate (in _attention_block) opens, for every layer
    tables = None
    if (not decode and reduce_axis is None and B == 1 and T % 128 == 0
            and cfg.head_dim == 128 and not cache.quantized
            and any("wqkv" in layer for layer in params["layers"])):
        tables = rope_tables(positions[0], cfg.head_dim, cfg.rope_theta)
    for li, layer in enumerate(params["layers"]):
        if layer_hook is not None:
            h = layer_hook(li, h, 0)
        if use_layer_kernel and layer_kernel.layer_step_supported(
                layer, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                cache.k.dtype):
            h2, kn, vn = layer_kernel.layer_step(
                h[:, 0].float(), layer["w_pack"], cache.k, cache.v,
                cache.lengths, li, **kw)
            _append_kv(cache, li, kn, vn, positions[:, 0])
            h = h2[:, None].to(h.dtype)
            continue
        attn, cache = _attention_block(layer, cfg, h, cache, li, positions,
                                       decode=decode,
                                       reduce_axis=reduce_axis, mesh=mesh,
                                       tables=tables)
        h = h + attn
        h = h + _mlp_block(layer, cfg, h, reduce_axis=reduce_axis,
                           mesh=mesh)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return _head_logits(params, cfg, h, cache, tokens, all_logits)


def _head_logits(params: Params, cfg: ModelConfig, h: torch.Tensor,
                 cache: KVCache, tokens: torch.Tensor, all_logits: bool
                 ) -> tuple[torch.Tensor, KVCache]:
    """Final-norm output ``h`` -> f32 logits; bumps cache lengths."""
    hl = h if all_logits else h[:, -1]
    logits = apply_linear(hl, params["lm_head"], cfg.x_quant8)
    cache.lengths += tokens.shape[1]
    return logits.float(), cache


@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, all_logits: bool = False
            ) -> tuple[torch.Tensor, KVCache]:
    """Process a prompt [B, T]; returns last-position logits ([B, T, V]
    with ``all_logits``) and the filled cache."""
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device).expand(B, T)
    return _forward(params, cfg, tokens, cache, positions, decode=False,
                    all_logits=all_logits)


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """One decode step: tokens [B] -> logits [B, vocab]."""
    positions = cache.lengths[:, None].clone()
    return _forward(params, cfg, tokens[:, None], cache, positions,
                    decode=True)


def generate(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
             steps: int, cache: KVCache | None = None,
             sampling=None, seed: int = 0) -> np.ndarray:
    """Generation via a host loop over ``decode_step``. Greedy by default;
    pass a ``sampling.SamplingParams`` for temperature / top-k / top-p,
    drawn from a ``torch.Generator`` seeded with ``seed`` on the prompt's
    device. Tokens stay on the device until the one fetch at the end."""
    B, T = prompt.shape
    if cache is None:
        cache = KVCache.create(cfg, B, _round_up(T + steps, 256),
                               device=prompt.device)
    gen = torch.Generator(device=prompt.device).manual_seed(seed)
    sampling = sampling or SamplingParams(temperature=0.0)
    logits, cache = prefill(params, cfg, prompt, cache)
    out = []
    tok = sample(logits, gen, sampling)
    for _ in range(steps):
        out.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = sample(logits, gen, sampling)
    return torch.stack(out, dim=1).cpu().numpy()


def capture_graph(step, state: list[torch.Tensor]) -> torch.cuda.CUDAGraph:
    """One call of ``step()`` captured into a ``torch.cuda.CUDAGraph``.

    ``step`` updates tensors in place and fetches nothing to the host.
    It runs once eagerly first, outside capture, so the kernels are built
    and the allocator has the step's blocks; then every tensor of ``state``
    (the small ones the step moves forward: lengths, tokens, output slots)
    is put back as it was and one call is captured. Capture runs nothing,
    so the state is as the caller left it: each ``replay()`` is one step.
    Cache slots past the restored lengths are simply written again."""
    saved = [t.clone() for t in state]
    step()
    for t, s in zip(state, saved):
        t.copy_(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph


def replay_graph(step, n: int, state: list[torch.Tensor]) -> None:
    """Run ``step()`` ``n`` times on the card: ``capture_graph``, then ``n``
    replays. Ends with the stream synchronized, so the graph and its memory
    can go."""
    graph = capture_graph(step, state)
    for _ in range(n):
        graph.replay()
    torch.cuda.current_stream().synchronize()


def greedy_scan_step(params: Params, cfg: ModelConfig, tok: torch.Tensor,
                     cache: KVCache, steps: int):
    """The step ``generate_scan`` repeats, as a closure over device state:
    write ``tok`` [B] into the output at the current slot, one
    ``decode_step``, ``tok`` = its argmax. Returns (step, state: the
    tensors it moves forward, out [B, steps] int32). ``tok`` is updated
    in place."""
    out = torch.empty((tok.shape[0], steps), dtype=torch.int32,
                      device=tok.device)
    slot = torch.zeros((1,), dtype=torch.long, device=tok.device)

    def step():
        out.index_copy_(1, slot, tok[:, None])
        lg, _ = decode_step(params, cfg, tok, cache)
        tok.copy_(torch.argmax(lg, -1))
        slot.add_(1)

    return step, [tok, slot, cache.lengths], out


@torch.no_grad()
def generate_scan(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
                  cache: KVCache, steps: int) -> np.ndarray:
    """Greedy prefill, then ``steps`` greedy decode steps; returns the
    tokens [B, steps] (int32). On the card, ``decode_step`` + argmax is one
    CUDA graph (``replay_graph``) writing static token and output buffers
    on the device, so no step waits on the host; on the CPU the same step
    runs eagerly. The tokens are fetched once, at the end."""
    logits, cache = prefill(params, cfg, prompt, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    step, state, out = greedy_scan_step(params, cfg, tok, cache, steps)
    if prompt.is_cuda:
        replay_graph(step, steps, state)
    else:
        for _ in range(steps):
            step()
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# weight creation / quantization
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def init_weights(cfg: ModelConfig, seed: int = 0, device=None,
                 dtype=torch.bfloat16) -> Params:
    """Random-init dense weights (scaled normal), drawn on ``device`` (the
    card unless named) from a seeded ``torch.Generator``. Quantize with
    ``quantize_params``. The draws
    differ from the reference's NumPy ones; carry its weights across with
    ``models.convert.params_from_jax`` where the two must match."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, hd = cfg.dim, cfg.head_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    def lin(n, k):
        return (normal(n, k) / float(np.sqrt(k))).to(dtype)

    def ones():
        return torch.ones((d,), dtype=dtype, device=device)

    layers = [{
        "wq": lin(cfg.n_heads * hd, d),
        "wk": lin(cfg.n_kv_heads * hd, d),
        "wv": lin(cfg.n_kv_heads * hd, d),
        "wo": lin(d, cfg.n_heads * hd),
        "w_gate": lin(cfg.intermediate, d),
        "w_up": lin(cfg.intermediate, d),
        "w_down": lin(d, cfg.intermediate),
        "attn_norm": ones(),
        "mlp_norm": ones(),
    } for _ in range(cfg.n_layers)]
    return {
        "embed": (normal(cfg.vocab_size, d) * 0.02).to(dtype),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": lin(cfg.vocab_size, d),
    }


_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_params(params: Params, fmt: str, *, quantize_head: bool = True,
                    pad_intermediate: bool = True, fuse: bool = True,
                    head_fmt: str | None = None) -> Params:
    """Quantize every big linear to ``fmt`` (q8_0, q4_0, q4_k or q6_k) on
    its own device (embed and norms stay dense). ``head_fmt``: another
    format for the lm_head (llama.cpp's Q4_K_M mix stores it as Q6_K:
    fmt="q4_k", head_fmt="q6_k"). ``fuse`` stores wq|wk|wv as one ``wqkv`` and
    w_gate|w_up as one ``w_gu``. ``pad_intermediate`` zero-pads the MLP
    intermediate up to a multiple of 4096 when that costs < 15% more bytes
    (7B: 11008 -> 12288), here at quantize time so the step never pads;
    silu(0) * 0 == 0 keeps the padded lanes inert."""
    if fmt not in FORMATS or head_fmt not in (None, *FORMATS):
        raise NotImplementedError(f"fmt {fmt!r} / head_fmt {head_fmt!r}: "
                                  f"the port serves {', '.join(FORMATS)}")
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        if "router" in layer:
            # the reference fails here too (it unpacks a stacked weight)
            raise NotImplementedError(
                "quantize_params: MoE layers are not taken; quantize each "
                "expert with quantize() and stack them with "
                "moe.stack_expert_quant()")
        ql = dict(layer)
        inter = layer["w_gate"].shape[0]
        inter_p = -(-inter // 4096) * 4096
        if not pad_intermediate or inter_p > 1.15 * inter:
            inter_p = inter

        def get(key):
            w = layer[key].float()
            if inter_p != inter:
                if key in ("w_gate", "w_up"):
                    w = F.pad(w, (0, 0, 0, inter_p - inter))
                elif key == "w_down":
                    w = F.pad(w, (0, inter_p - inter))
            return w

        if fuse:
            for key in ("wq", "wk", "wv", "w_gate", "w_up"):
                ql.pop(key)
            ql["wqkv"] = quantize(torch.cat([get("wq"), get("wk"),
                                             get("wv")]), fmt)
            ql["w_gu"] = quantize(torch.cat([get("w_gate"), get("w_up")]),
                                  fmt)
            ql["w_down"] = quantize(get("w_down"), fmt)
            ql["wo"] = quantize(get("wo"), fmt)
        else:
            for key in _LINEAR_KEYS:
                ql[key] = quantize(get(key), fmt)
        out["layers"].append(ql)
    if quantize_head:
        out["lm_head"] = quantize(params["lm_head"].float(), head_fmt or fmt)
    return out


def permute_hidden_params(params: Params, cfg: ModelConfig) -> Params:
    """The reference's deploy layout for the whole-layer kernel
    (``cfg.hperm``). There it gathers embed / norm columns and wo / w_down
    rows into the quant kernels' interleaved lane order; the port's hidden
    state stays in logical order, so nothing is permuted and this only
    attaches the model pack (``build_model_pack``)."""
    if any("router" in layer for layer in params["layers"]):
        raise NotImplementedError("hperm: MoE layers are unsupported, as "
                                  "in the reference")
    return build_model_pack(params, cfg)


def build_model_pack(params: Params, cfg: ModelConfig) -> Params:
    """``params`` with ``"m_pack"``: the device table of every layer's
    weight pointers that ``model_step`` reads (``ops/layer_kernel.py``; no
    weight is copied). As in the reference, a no-op unless every layer has
    Q4_K-E (not s6) wqkv / wo / w_gu / w_down of one shape, with dim and the padded
    intermediate multiples of 4096 (where the reference builds
    ``w_gu_f``)."""
    layers = params["layers"]
    stream = layer_kernel.STREAM

    def ok(lay):
        return (all(isinstance(lay.get(k), QuantLinear)
                    and lay[k].fmt == "q4_k" and lay[k].enc == "e"
                    for k in stream)
                and lay["w_down"].array_shape[1] % 4096 == 0
                and lay["w_gu"].array_shape[1] % 4096 == 0)

    if not layers or not all(ok(lay) for lay in layers):
        return params
    shapes0 = [layers[0][k].array_shape for k in stream]
    if any([lay[k].array_shape for k in stream] != shapes0 for lay in layers):
        return params
    out = dict(params)
    out["m_pack"] = layer_kernel.pack_layers(layers)
    return out
