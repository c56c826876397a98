"""Full-model CPU oracle: a NumPy Llama forward for logits / perplexity
parity checks.

The port's own copy of the JAX package's ``oracle/model.py``: the whole
forward pass in f32 NumPy with full (not online) softmax attention,
dequantizing any quantized weight first, with no cache and no kernel. A
weight may be a NumPy array, a torch tensor (on any device), one of the
port's oracle blocks (``oracle/quant.py``) or the port's ``QuantLinear``
(dequantized by ``ops/quant_matmul.dequantize``, bit-equal to the JAX
package's ``dequantize_jnp`` on the same blocks). A MoE layer runs
``models/moe.moe_mlp_oracle`` (every expert, f32), as the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.oracle import quant as q


def _dense(w) -> np.ndarray:
    """Any linear leaf -> dense f32 [N, K] (or the leaf's own shape)."""
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
        QuantLinear, dequantize)
    if isinstance(w, q.Q8_0):
        return q.dequantize_q8_0(w)
    if isinstance(w, q.Q4_0):
        return q.dequantize_q4_0(w)
    if isinstance(w, q.Q4_K):
        return q.dequantize_q4_k(w)
    if isinstance(w, q.Q6_K):
        return q.dequantize_q6_k(w)
    if isinstance(w, QuantLinear):
        return dequantize(w).cpu().numpy()
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def _rms_norm(x, w, eps):
    var = np.mean(x * x, axis=-1, keepdims=True)
    return x / np.sqrt(var + eps) * w


def _rope(x, positions, theta):
    """Rotate-half RoPE; x [B, T, H, D], positions [B, T]."""
    d = x.shape[-1]
    freqs = theta ** (-np.arange(0, d // 2, dtype=np.float32) / (d // 2))
    ang = positions.astype(np.float32)[..., None] * freqs
    cos = np.cos(ang)[:, :, None, :]
    sin = np.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def forward_logits(params, cfg: ModelConfig, tokens) -> np.ndarray:
    """tokens [B, T] int -> logits [B, T, vocab] f32 (causal, no cache)."""
    tokens = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                        else tokens)
    B, T = tokens.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    r = Hq // Hkv
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    causal = np.tril(np.ones((T, T), bool))

    h = _dense(params["embed"])[tokens]            # [B, T, dim]
    for layer in params["layers"]:
        x = _rms_norm(h, _dense(layer["attn_norm"]), cfg.rms_eps)
        if "wqkv" in layer:
            y = x @ _dense(layer["wqkv"]).T
            s1, s2 = Hq * D, Hq * D + Hkv * D
            qp, kp, vp = y[..., :s1], y[..., s1:s2], y[..., s2:]
        else:
            qp = x @ _dense(layer["wq"]).T
            kp = x @ _dense(layer["wk"]).T
            vp = x @ _dense(layer["wv"]).T
        qh = _rope(qp.reshape(B, T, Hq, D), positions, cfg.rope_theta)
        kh = _rope(kp.reshape(B, T, Hkv, D), positions, cfg.rope_theta)
        vh = vp.reshape(B, T, Hkv, D)

        o = np.empty((B, T, Hq, D), np.float32)
        scale = 1.0 / np.sqrt(D)
        for hq in range(Hq):
            kv = hq // r                           # GQA broadcast
            s = np.einsum("btd,bsd->bts", qh[:, :, hq], kh[:, :, kv])
            s = np.where(causal, s * scale, -np.inf)
            o[:, :, hq] = _softmax(s) @ vh[:, :, kv]
        attn = o.reshape(B, T, Hq * D) @ _dense(layer["wo"]).T
        h = h + attn

        x = _rms_norm(h, _dense(layer["mlp_norm"]), cfg.rms_eps)
        if "router" in layer:                      # MoE
            from ggml_cuda_experiments_tpu_torch.models import moe
            h = h + moe.moe_mlp_oracle(layer, cfg, x)
            continue
        if "w_gu" in layer:
            y = x @ _dense(layer["w_gu"]).T
            half = y.shape[-1] // 2
            g, u = y[..., :half], y[..., half:]
        else:
            g = x @ _dense(layer["w_gate"]).T
            u = x @ _dense(layer["w_up"]).T
        act = g / (1.0 + np.exp(-g)) * u           # SwiGLU
        h = h + act @ _dense(layer["w_down"]).T

    h = _rms_norm(h, _dense(params["final_norm"]), cfg.rms_eps)
    return h @ _dense(params["lm_head"]).T


def perplexity(logits, tokens) -> float:
    """exp(mean NLL) of tokens[t+1] under logits[t] (next-token PPL)."""
    logits = np.asarray(logits, np.float32)
    tokens = np.asarray(tokens)
    lp = logits[:, :-1] - _logsumexp(logits[:, :-1])
    tgt = tokens[:, 1:]
    nll = -np.take_along_axis(lp, tgt[..., None], axis=-1)
    return float(np.exp(nll.mean()))


def _logsumexp(x):
    m = x.max(-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(-1, keepdims=True))
