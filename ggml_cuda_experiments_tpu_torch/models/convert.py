"""Bridge from the reference's parameters to the port's.

``params_from_jax`` takes the tree that the reference's
``llama.init_weights(cfg, seed)`` returns, with every leaf given as
``np.asarray(leaf, np.float32)`` (bf16 -> f32 is exact, and no jax or
ml_dtypes is needed here), and returns the port's dense tree: bf16 embed,
norms and linears. The port's ``quantize_params`` then quantizes it through
the same oracle arithmetic as the reference, so every Q4_K block of the two
packages is identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig

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


def _leaf(a, shape, device, name) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.float32 or a.shape != tuple(shape):
        raise ValueError(f"{name}: need float32 {tuple(shape)}, got "
                         f"{a.dtype} {a.shape}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=torch.bfloat16)


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's dense parameter tree (float32 NumPy leaves) as the
    port's bf16 tree on ``device``."""
    if len(np_params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(np_params['layers'])} layers, config has "
                         f"{cfg.n_layers}")
    layers = []
    for i, layer in enumerate(np_params["layers"]):
        if set(layer) != set(_LAYER_SHAPES):
            raise ValueError(f"layer {i}: keys {sorted(layer)} (a dense, "
                             "unquantized tree is expected)")
        layers.append({k: _leaf(layer[k], shape(cfg), device, f"layer {i} {k}")
                       for k, shape in _LAYER_SHAPES.items()})
    return {
        "embed": _leaf(np_params["embed"], (cfg.vocab_size, cfg.dim), device,
                       "embed"),
        "layers": layers,
        "final_norm": _leaf(np_params["final_norm"], (cfg.dim,), device,
                            "final_norm"),
        "lm_head": _leaf(np_params["lm_head"], (cfg.vocab_size, cfg.dim),
                         device, "lm_head"),
    }
