"""The plain reference: the model's forward pass in f32 PyTorch, TF32 off,
layer by layer so that a model larger than the card's free memory fits,
over the served sequences (prompt and served tokens, teacher-forced).

It imports nothing of the program. It draws the same dense weights from the
seed (``weights``), quantizes them again with the frozen copy of the
quantizer (``quant_ref``) and computes with the dequantized values: the
weights the configuration serves, at f32 everywhere else.

The control is this reference computed in the precision one step below the
configuration's: every linear's input is rounded per 32-block to that
precision (int8 -> int4, bf16 -> fp8 e4m3) before its product.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.lib import quant_ref, weights

# the precision below each stated one, for the control
BELOW = {"f32": "bf16", "bf16": "fp8", "int8": "int4"}


@dataclasses.dataclass
class Judged:
    """One served sequence: the tokens fed (the prompt, then each served
    token but the last), and at each judged position the token served
    there."""
    tokens: np.ndarray
    positions: list[int]
    served: list[int]


def act_round(x: torch.Tensor, prec: str | None) -> torch.Tensor:
    """x [..., K] rounded per 32-block to ``prec`` and back to f32 (None:
    unchanged)."""
    if prec is None:
        return x
    shape = x.shape
    xb = x.reshape(*shape[:-1], shape[-1] // 32, 32)
    amax = xb.abs().amax(-1, keepdim=True)
    if prec == "int4":
        s = torch.where(amax == 0, torch.ones_like(amax), amax / 7.0)
        y = torch.clamp(torch.round(xb / s), -7, 7) * s
    elif prec == "fp8":
        s = torch.where(amax == 0, torch.ones_like(amax), amax / 448.0)
        y = (xb / s).to(torch.float8_e4m3fn).float() * s
    elif prec == "bf16":
        y = xb.to(torch.bfloat16).float()
    else:
        raise ValueError(f"precision {prec!r}")
    return y.reshape(shape)


def _norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE at positions 0.. of x [T, H, D]."""
    t, _, d = x.shape
    freqs = theta ** (-torch.arange(0, d // 2, dtype=torch.float32,
                                    device=x.device) / (d // 2))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _lin(x, w, prec):
    return act_round(x, prec) @ w.T


def _attention(spec, x, w, prec):
    t = x.shape[0]
    hq, hkv, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = _rope(_lin(x, w["wq"], prec).reshape(t, hq, d), spec.rope_theta)
    k = _rope(_lin(x, w["wk"], prec).reshape(t, hkv, d), spec.rope_theta)
    v = _lin(x, w["wv"], prec).reshape(t, hkv, d)
    r = hq // hkv
    k = k.repeat_interleave(r, dim=1).transpose(0, 1)      # [hq, t, d]
    v = v.repeat_interleave(r, dim=1).transpose(0, 1)
    s = q.transpose(0, 1) @ k.transpose(1, 2) / math.sqrt(d)
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = (torch.softmax(s, -1) @ v).transpose(0, 1).reshape(t, hq * d)
    return _lin(o, w["wo"], prec)


def _mlp(x, wg, wu, wd, prec):
    g = _lin(x, wg, prec)
    return _lin(F.silu(g) * _lin(x, wu, prec), wd, prec)


def _layer(spec, h, w, prec):
    h = h + _attention(spec, _norm(h, spec.rms_eps), w, prec)
    x = _norm(h, spec.rms_eps)
    return h + _mlp(x, w["w_gate"], w["w_up"], w["w_down"], prec)


def _layer_weights(spec, seed: int, li: int, device) -> dict:
    return {key: quant_ref.dequant(w, spec.layer_fmt) for key, w in
            weights.draw_layer(spec, seed, li, device).items()}


@torch.no_grad()
def gaps(spec, seed: int, seqs: list[Judged], device,
         control: str | None = None) -> dict:
    """The reference over ``seqs``: at each judged position the gap by
    which the served token's logit lies below the reference's best.
    With ``control``, the same for the token that the control, computed
    in that precision, puts first. Returns {"served": [...], "control":
    [...] or None}, one entry a judged position, in order."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        embed = weights.draw_embed(spec, seed, device)
        hs = [embed[torch.from_numpy(s.tokens).to(device)].float()
              for s in seqs]
        del embed
        hc = [h.clone() for h in hs] if control else None
        for li in range(spec.n_layers):
            w = _layer_weights(spec, seed, li, device)
            hs = [_layer(spec, h, w, None) for h in hs]
            if control:
                hc = [_layer(spec, h, w, control) for h in hc]
            del w
        head = quant_ref.dequant(weights.draw_head(spec, seed, device),
                                 spec.head_fmt)
        served, ctrl = [], []
        for i, s in enumerate(seqs):
            pos = torch.as_tensor(s.positions, device=device)
            ref = _lin(_norm(hs[i][pos], spec.rms_eps), head, None)
            best = ref.max(-1).values
            tok = torch.as_tensor(s.served, device=device)
            served += (best - ref.gather(-1, tok[:, None])[:, 0]).tolist()
            if control:
                lc = _lin(_norm(hc[i][pos], spec.rms_eps), head, control)
                pick = lc.argmax(-1)
                ctrl += (best - ref.gather(-1, pick[:, None])[:, 0]).tolist()
        return {"served": served, "control": ctrl if control else None}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
