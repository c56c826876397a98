"""Llama-family model in PyTorch: the batch-1 greedy path with Q4_K-E
linears, a bf16 contiguous KV cache, flash prefill and split-KV decode.

Port of the reference's ``models/llama.py``, same function names,
signatures and public layouts (KV cache [L, B, Hkv, S, D]; logits f32).
What differs, on purpose:

- The port always runs the UNFUSED branch of ``_attention_block`` and
  ``_mlp_block``: it has no fused kernels yet, so ``cfg.fuse_attn``,
  ``cfg.fuse_mlp`` and ``cfg.fuse_layer`` do not apply. RoPE runs as plain
  torch (the reference's fused prefill RoPE kernel is a fusion).
- Weights stay in logical column order: no ``wof``, ``w_gu_f``, ``hperm`` or
  model pack, which exist only because of Mosaic limits.
- Not ported yet, and raised, never computed another way:
  ``cfg.x_quant8``, ``cfg.hperm``, ``cfg.xla_attn_max_cache``, MoE layers, a
  quantized KV cache, ``generate(sampling=...)``.
- PyTorch runs eagerly and the cache is updated IN PLACE: ``prefill`` and
  ``decode_step`` write k, v and lengths of the cache they are given and
  return it. Positions and lengths stay on the device; the only host fetch
  in ``generate`` is the tokens at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.ops.flash_attention import flash_attention
from ggml_cuda_experiments_tpu_torch.ops.flash_decode import flash_decode
from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
    QuantLinear, qmatmul, qmatmul_ref, quantize)

Params = dict[str, Any]

# Up to this many rows a linear runs the fused kernels (the matvec at one
# row, the GEMM from two); above it, dequantize + torch.matmul, the
# reference's qmatmul_xla fallback: a plain product, no kernel. The
# reference's second cutoff (_QMATVEC_MAX_ROWS = 32) chose between two
# Pallas GEMMs that are one kernel here. To be measured again on the H100.
_QPIPE_MAX_ROWS = 512


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.x_quant8:
        raise NotImplementedError("cfg.x_quant8: the int8-activation "
                                  "matvec is not ported yet")
    if cfg.hperm:
        raise NotImplementedError("cfg.hperm: the port stores weights in "
                                  "logical order")
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")
    if cfg.xla_attn_max_cache:
        raise NotImplementedError("cfg.xla_attn_max_cache: only the flash "
                                  "decode path is ported")


def apply_linear(x: torch.Tensor, w, xq8: bool = False,
                 x_prepermuted: bool = False) -> torch.Tensor:
    """y = x @ W^T for dense [N, K] or QuantLinear weights; x: [..., K]."""
    if xq8 or x_prepermuted:
        raise NotImplementedError("x_quant8 / x_prepermuted: not ported")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QuantLinear):
        if x2.shape[0] <= _QPIPE_MAX_ROWS:
            y = qmatmul(x2, w)
        else:
            # the reference's qmatmul_xla: f32 dequantize + a plain matmul
            y = qmatmul_ref(x2, w).to(x.dtype)
    else:
        y = (x2.to(w.dtype).float() @ w.float().T).to(x.dtype)
    return y.reshape(*lead, -1)


def qkv_proj(layer: Params, x: torch.Tensor, cfg: ModelConfig):
    """Query/key/value projections; one fused wqkv weight when present."""
    if "wqkv" in layer:
        y = apply_linear(x, layer["wqkv"])
        s1 = cfg.n_heads * cfg.head_dim
        s2 = s1 + cfg.n_kv_heads * cfg.head_dim
        return y[..., :s1], y[..., s1:s2], y[..., s2:]
    return (apply_linear(x, layer["wq"]), apply_linear(x, layer["wk"]),
            apply_linear(x, layer["wv"]))


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
    """Contiguous per-layer KV cache: k, v [n_layers, B, Hkv, S, D] bf16;
    lengths int32 [B] valid prefix length, on the same device."""
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @staticmethod
    def create(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, quantized: bool | str = False,
               device=None) -> "KVCache":
        if quantized:
            raise NotImplementedError("int8/fp8 KV cache: not ported yet")
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


def _write_cache_layer(cache: torch.Tensor, li: int, new: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """Write new [B, Hkv, T, D] into the full cache [L, B, Hkv, S, D] at
    (li, b, :, pos[b] + t), in place, with one device-side index op (pos
    stays on the device)."""
    B, _, T = new.shape[:3]
    t = pos[:, None].long() + torch.arange(T, device=pos.device)     # [B, T]
    b = torch.arange(B, device=pos.device)[:, None].expand(B, T)
    cache[li][b, :, t] = new.transpose(1, 2).to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# transformer blocks (the unfused branch of the reference)
# ---------------------------------------------------------------------------

def _attention_block(layer: Params, cfg: ModelConfig, h: torch.Tensor,
                     cache: KVCache, li: int, positions: torch.Tensor, *,
                     decode: bool):
    B, T, _ = h.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = rms_norm(h, layer["attn_norm"], cfg.rms_eps)
    q, k, v = qkv_proj(layer, x, cfg)
    q = rope(q.reshape(B, T, Hq, D), positions, cfg.rope_theta)
    k = rope(k.reshape(B, T, Hkv, D), positions, cfg.rope_theta)
    kt = k.transpose(1, 2)                       # [B, Hkv, T, D]
    vt = v.reshape(B, T, Hkv, D).transpose(1, 2)
    pos0 = positions[:, 0]
    _write_cache_layer(cache.k, li, kt, pos0)
    _write_cache_layer(cache.v, li, vt, pos0)
    if decode:
        # the full stacked cache goes in; the kernel offsets by the layer
        o = flash_decode(q[:, 0].contiguous(), cache.k, cache.v,
                         cache.lengths + 1, layer=li)[:, None]
    else:
        # prefill attends over the fresh K/V
        o = flash_attention(q.transpose(1, 2).contiguous(), kt.contiguous(),
                            vt.contiguous(), causal=True).transpose(1, 2)
    o = o.reshape(B, T, Hq * D).to(h.dtype)
    return apply_linear(o, layer["wo"]), cache


def _mlp_block(layer: Params, cfg: ModelConfig, h: torch.Tensor
               ) -> torch.Tensor:
    if "router" in layer:
        raise NotImplementedError("MoE layers are not ported yet")
    x = rms_norm(h, layer["mlp_norm"], cfg.rms_eps)
    gate, up = gate_up_proj(layer, x)
    return apply_linear(F.silu(gate.float()).to(x.dtype) * up,
                        layer["w_down"])


def _forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             cache: KVCache, positions: torch.Tensor, *, decode: bool,
             all_logits: bool = False) -> tuple[torch.Tensor, KVCache]:
    _check_cfg(cfg)
    h = params["embed"][tokens]                  # [B, T, dim]
    for li, layer in enumerate(params["layers"]):
        attn, cache = _attention_block(layer, cfg, h, cache, li, positions,
                                       decode=decode)
        h = h + attn
        h = h + _mlp_block(layer, cfg, h)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return _head_logits(params, cfg, h, cache, tokens, all_logits)


def _head_logits(params: Params, cfg: ModelConfig, h: torch.Tensor,
                 cache: KVCache, tokens: torch.Tensor, all_logits: bool
                 ) -> tuple[torch.Tensor, KVCache]:
    """Final-norm output ``h`` -> f32 logits; bumps cache lengths."""
    hl = h if all_logits else h[:, -1]
    logits = apply_linear(hl, params["lm_head"])
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
             sampling=None) -> np.ndarray:
    """Greedy generation via a host loop over ``decode_step``. Tokens stay
    on the device until the one fetch at the end."""
    if sampling is not None:
        raise NotImplementedError("sampling: only greedy is ported yet")
    B, T = prompt.shape
    if cache is None:
        cache = KVCache.create(cfg, B, _round_up(T + steps, 256),
                               device=prompt.device)
    logits, cache = prefill(params, cfg, prompt, cache)
    out = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for _ in range(steps):
        out.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.stack(out, dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# weight creation / quantization
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def init_weights(cfg: ModelConfig, seed: int = 0, device=None,
                 dtype=torch.bfloat16) -> Params:
    """Random-init dense weights (scaled normal), drawn on ``device`` from a
    seeded ``torch.Generator``. Quantize with ``quantize_params``. The draws
    differ from the reference's NumPy ones; carry its weights across with
    ``models.convert.params_from_jax`` where the two must match."""
    device = torch.device(device or "cpu")
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
    """Quantize every big linear to ``fmt`` on its own device (embed and
    norms stay dense). ``fuse`` stores wq|wk|wv as one ``wqkv`` and
    w_gate|w_up as one ``w_gu``. ``pad_intermediate`` zero-pads the MLP
    intermediate up to a multiple of 4096 when that costs < 15% more bytes
    (7B: 11008 -> 12288), here at quantize time so the step never pads;
    silu(0) * 0 == 0 keeps the padded lanes inert."""
    if fmt != "q4_k" or head_fmt not in (None, "q4_k"):
        raise NotImplementedError(f"fmt {fmt!r} / head_fmt {head_fmt!r}: "
                                  "the port has q4_k only so far")
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        if "router" in layer:
            raise NotImplementedError("MoE layers are not ported yet")
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
        out["lm_head"] = quantize(params["lm_head"].float(), fmt)
    return out
