"""The work a request needs, counted from the configuration's published
sizes and the traffic alone: the same whatever implements it.

Weights are counted at GGML's block sizes (Q4_K 144 bytes a 256-block, Q6_K
210, bf16 2 bytes a weight) at the published intermediate size, each read
once a step. The cache is read up to the current length and written
once. Operations are 2 a weight a row, plus attention. Norms and
the embedding rows are left out.
"""

from __future__ import annotations

import dataclasses

BYTES_PER_WEIGHT = {"q4_k": 144 / 256, "q6_k": 210 / 256, "q8_0": 34 / 32,
                    "q4_0": 18 / 32, "bf16": 2.0, "f16": 2.0, "f32": 4.0}
KV_BYTES = {"bf16": 2, "f16": 2, "int8": 1, "fp8": 1}

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f16": 989e12, "int8": 1979e12,
              "fp8": 1979e12, "f32": 67e12}


@dataclasses.dataclass(frozen=True)
class Spec:
    """A configuration's published sizes and formats."""
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    intermediate: int
    vocab_size: int
    rope_theta: float
    rms_eps: float
    layer_fmt: str = "q4_k"
    head_fmt: str = "q6_k"
    cache: str = "bf16"
    # the precision of products of one row (decode at batch 1) and of more
    precision_rows1: str = "bf16"
    precision_rows: str = "bf16"

    @classmethod
    def from_config(cls, cfg: dict) -> "Spec":
        hidden = cfg["hidden_size"]
        heads = cfg["num_attention_heads"]
        return cls(
            dim=hidden, n_layers=cfg["num_hidden_layers"], n_heads=heads,
            n_kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg.get("head_dim") or hidden // heads,
            intermediate=cfg["intermediate_size"],
            vocab_size=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
            rms_eps=float(cfg["rms_norm_eps"]),
            layer_fmt=cfg["served"]["layer_fmt"],
            head_fmt=cfg["served"]["head_fmt"],
            cache=cfg["served"]["cache"],
            precision_rows1=cfg["served"]["precision_rows1"],
            precision_rows=cfg["served"]["precision_rows"])

    # -- weights -----------------------------------------------------------
    @property
    def attn_weights(self) -> int:
        d, hd = self.dim, self.head_dim
        return d * hd * (2 * self.n_heads + 2 * self.n_kv_heads)

    @property
    def mlp_weights(self) -> int:
        return 3 * self.dim * self.intermediate

    @property
    def head_weights(self) -> int:
        return self.vocab_size * self.dim

    def layer_bytes(self) -> float:
        return ((self.attn_weights + self.mlp_weights)
                * BYTES_PER_WEIGHT[self.layer_fmt])

    def token_bytes(self) -> float:
        """The bytes of one batch-1 decode step's weights."""
        return (self.n_layers * self.layer_bytes()
                + self.head_weights * BYTES_PER_WEIGHT[self.head_fmt])

    @property
    def kv_bytes_per_pos(self) -> int:
        """K and V of one position in every layer."""
        return (self.n_layers * 2 * self.n_kv_heads * self.head_dim
                * KV_BYTES[self.cache])

    def layer_flops_per_row(self) -> float:
        return 2.0 * (self.attn_weights + self.mlp_weights)

    # -- steps -------------------------------------------------------------
    def decode_step(self, contexts: list[int]) -> tuple[float, float]:
        """(bytes, operations) of one decode step of len(contexts)
        sequences, each with ``contexts[i]`` positions cached before it."""
        rows = len(contexts)
        by = self.token_bytes()
        ops = rows * (self.n_layers * self.layer_flops_per_row()
                      + 2.0 * self.head_weights)
        for c in contexts:
            by += (c + 1) * self.kv_bytes_per_pos
            # q.k and p.v over c + 1 keys, every head of every layer
            ops += self.n_layers * 4.0 * self.n_heads * self.head_dim * (c + 1)
        return by, ops

    def prefill(self, t: int, batch: int = 1) -> tuple[float, float]:
        """(bytes, operations) of a prefill of ``batch`` prompts of ``t``
        tokens; the head at the last position of each only."""
        rows = t * batch
        by = self.token_bytes() + rows * self.kv_bytes_per_pos
        ops = (rows * self.n_layers * self.layer_flops_per_row()
               + batch * 2.0 * self.head_weights
               # causal attention: q.k and p.v over half the t x t square
               + batch * self.n_layers * 2.0 * t * t * self.head_dim
               * self.n_heads)
        return by, ops

    def peak_ops(self, rows: int) -> float:
        prec = self.precision_rows1 if rows == 1 else self.precision_rows
        return PEAK_OPS_S[prec]

    def bound_s(self, nbytes: float, ops: float, rows: int) -> float:
        """The least time the card could take: bytes over HBM bandwidth or
        operations over the peak of the stated precision, the larger."""
        return max(nbytes / PEAK_BYTES_S, ops / self.peak_ops(rows))


def request_bound_s(spec: Spec, prompt: int, steps: int, batch: int = 1
                    ) -> float:
    """The least time of a request that prefills ``batch`` prompts of
    ``prompt`` tokens and serves ``steps`` tokens each: the prefill yields
    the first token, ``steps - 1`` decode steps the rest."""
    t = spec.bound_s(*spec.prefill(prompt, batch), rows=prompt * batch)
    for i in range(steps - 1):
        t += spec.bound_s(*spec.decode_step([prompt + i] * batch), rows=batch)
    return t


def layer_kernel_bytes(spec: Spec, contexts: list[int]) -> float:
    """The bytes a batch-1 step's decoder layers need: every layer's
    weights, and the cache read up to each context and written once."""
    return sum(spec.n_layers * spec.layer_bytes() + (c + 1)
               * spec.kv_bytes_per_pos for c in contexts)


def linears_bound_s(spec: Spec, steps: list[tuple[int, int]]) -> float:
    """The least time of the model's linears (layers and head) over
    ``steps``: (rows, 1 for a prefill's single head row or rows for a
    decode step). Bytes at GGML sizes; operations at the stated
    precision."""
    total = 0.0
    for rows, head_rows in steps:
        by = spec.token_bytes()
        ops = (rows * spec.n_layers * spec.layer_flops_per_row()
               + head_rows * 2.0 * spec.head_weights)
        total += spec.bound_s(by, ops, rows)
    return total
