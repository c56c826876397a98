"""Model configurations (Llama family) and named presets.

The port's own copy of the JAX package's ``models/config.py``: the same
fields, defaults and presets, so a configuration means the same model and
picks the same decode branch in both packages.

The megakernel flags keep their meaning: ``x_quant8`` quantizes the
activations of every batch-1 matvec to int8 per 32-block; ``fuse_mlp``,
``fuse_attn`` and ``fuse_layer`` gate the fused batch-1 decode kernels;
``hperm`` asks for the whole-layer kernel's weight layout
(``llama.permute_hidden_params``). In the port's logical column order
``hperm`` permutes nothing: it only selects the layer kernel.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    intermediate: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 4096
    # batch-1 matvecs with per-32-block int8 activations
    x_quant8: bool = False
    # fused batch-1 decode kernels: attention block, MLP, whole layer(s)
    fuse_attn: bool = True
    fuse_mlp: bool = True
    # the whole-layer kernel's layout (built by permute_hidden_params)
    hperm: bool = False
    fuse_layer: bool = True
    # B == 1 decode attention through a plain full read at or below this
    # padded cache length (0: off)
    xla_attn_max_cache: int = 0
    # mixture-of-experts (0 = dense MLP)
    n_experts: int = 0
    n_active_experts: int = 2
    moe_intermediate: int | None = None

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def gqa_ratio(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads

    def num_params(self) -> int:
        """Approximate parameter count (weights only)."""
        d, h = self.dim, self.head_dim
        attn = d * (self.n_heads * h) * 2 + d * (self.n_kv_heads * h) * 2
        if self.is_moe:
            inter = self.moe_intermediate or self.intermediate
            mlp = self.n_experts * (3 * d * inter) + self.n_experts * d
        else:
            mlp = 3 * d * self.intermediate
        per_layer = attn + mlp + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab_size * d + d


PRESETS = {
    "debug": ModelConfig(
        name="debug", vocab_size=512, dim=256, n_layers=2, n_heads=4,
        n_kv_heads=2, intermediate=512, head_dim=64, max_seq_len=512),
    "tinyllama-1.1b": ModelConfig(
        name="tinyllama-1.1b", vocab_size=32000, dim=2048, n_layers=22,
        n_heads=32, n_kv_heads=4, intermediate=5632, head_dim=64,
        max_seq_len=2048),
    "llama2-7b": ModelConfig(
        name="llama2-7b", vocab_size=32000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=32, intermediate=11008, head_dim=128),
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab_size=128256, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, intermediate=14336, head_dim=128,
        rope_theta=500000.0, max_seq_len=8192),
    "llama2-70b": ModelConfig(
        name="llama2-70b", vocab_size=32000, dim=8192, n_layers=80,
        n_heads=64, n_kv_heads=8, intermediate=28672, head_dim=128),
    "moe-debug": ModelConfig(
        name="moe-debug", vocab_size=512, dim=256, n_layers=2, n_heads=4,
        n_kv_heads=2, intermediate=512, head_dim=64, max_seq_len=512,
        n_experts=4, n_active_experts=2),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", vocab_size=32000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, intermediate=14336, head_dim=128,
        rope_theta=1e6, max_seq_len=32768, n_experts=8,
        n_active_experts=2),
}
