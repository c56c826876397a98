"""Bridge from the reference's parameters to the port's.

``params_from_jax`` takes the tree that the reference's
``llama.init_weights(cfg, seed)`` returns, with every leaf given as
``np.asarray(leaf, np.float32)`` (bf16 -> f32 is exact, and no jax or
ml_dtypes is needed here), or ``moe.init_moe_weights``' tree for a MoE
config, and returns the port's dense tree: bf16 embed,
norms and linears by default, or f32 ones (the reference's f32 weights,
kept exact for tests that need f32 end to end). The port's
``quantize_params`` then quantizes it through the same oracle arithmetic as
the reference, so every Q4_K block of the two packages is identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.utils.platform import resolve_device

_LAYER_SHAPES = {
    "wq": lambda c: (c.n_heads * c.head_dim, c.dim),
    "wk": lambda c: (c.n_kv_heads * c.head_dim, c.dim),
    "wv": lambda c: (c.n_kv_heads * c.head_dim, c.dim),
    "wo": lambda c: (c.dim, c.n_heads * c.head_dim),
    "w_gate": lambda c: (c.intermediate, c.dim),
    "w_up": lambda c: (c.intermediate, c.dim),
    "w_down": lambda c: (c.dim, c.intermediate),
    "attn_norm": lambda c: (c.dim,),
    "mlp_norm": lambda c: (c.dim,),
}
# a MoE layer (the reference's ``moe.init_moe_weights``): the router and the
# stacked experts in place of the dense MLP
_MOE_SHAPES = {
    **{k: v for k, v in _LAYER_SHAPES.items()
       if k not in ("w_gate", "w_up", "w_down")},
    "router": lambda c: (c.n_experts, c.dim),
    "w_gate": lambda c: (c.n_experts, _moe_inter(c), c.dim),
    "w_up": lambda c: (c.n_experts, _moe_inter(c), c.dim),
    "w_down": lambda c: (c.n_experts, c.dim, _moe_inter(c)),
}


def _moe_inter(cfg: ModelConfig) -> int:
    return cfg.moe_intermediate or cfg.intermediate


def _leaf(a, shape, device, name, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.float32 or a.shape != tuple(shape):
        raise ValueError(f"{name}: need float32 {tuple(shape)}, got "
                         f"{a.dtype} {a.shape}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None,
                    dtype=torch.bfloat16) -> dict:
    """The reference's dense parameter tree (float32 NumPy leaves) as the
    port's tree of ``dtype`` leaves (bf16 or f32) on ``device`` (the card
    unless named). A MoE config's layers carry ``router`` and the stacked
    experts (the reference's ``moe.init_moe_weights`` tree). Serving takes
    bf16; f32 keeps the reference's weights exact, for checks that hold
    greedy decoding equal token for token (in bf16 the verify pass and the
    decode step may flip near-tied argmaxes)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {dtype}: bfloat16 or float32")
    device = resolve_device(device)
    if len(np_params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(np_params['layers'])} layers, config has "
                         f"{cfg.n_layers}")
    shapes = _MOE_SHAPES if cfg.is_moe else _LAYER_SHAPES
    layers = []
    for i, layer in enumerate(np_params["layers"]):
        if set(layer) != set(shapes):
            raise ValueError(f"layer {i}: keys {sorted(layer)} (a dense, "
                             "unquantized tree is expected)")
        layers.append({k: _leaf(layer[k], shape(cfg), device,
                                f"layer {i} {k}", dtype)
                       for k, shape in shapes.items()})
    return {
        "embed": _leaf(np_params["embed"], (cfg.vocab_size, cfg.dim), device,
                       "embed", dtype),
        "layers": layers,
        "final_norm": _leaf(np_params["final_norm"], (cfg.dim,), device,
                            "final_norm", dtype),
        "lm_head": _leaf(np_params["lm_head"], (cfg.vocab_size, cfg.dim),
                         device, "lm_head", dtype),
    }
