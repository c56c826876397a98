"""The system under test: the port's model built from the run's draws, and
the two entries a mix drives (``llama.generate_scan`` and
``llama.prefill``).

This is the only module of the benchmark that imports the port.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.lib import traffic, weights


def model_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file: its published
    sizes and the port's flags it names."""
    from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
    hidden, heads = conf["hidden_size"], conf["num_attention_heads"]
    return ModelConfig(
        name=conf["name"], vocab_size=conf["vocab_size"], dim=hidden,
        n_layers=conf["num_hidden_layers"], n_heads=heads,
        n_kv_heads=conf["num_key_value_heads"],
        intermediate=conf["intermediate_size"],
        head_dim=conf.get("head_dim") or hidden // heads,
        rope_theta=float(conf["rope_theta"]),
        rms_eps=float(conf["rms_norm_eps"]),
        max_seq_len=conf["max_position_embeddings"],
        **conf["served"]["port_flags"])


def build(spec, cfg, seed: int, device) -> dict:
    """The served weights, drawn from ``seed`` on ``device`` and quantized
    by the port, one layer at a time so the dense model never has to fit:
    each layer through ``llama.quantize_params`` as a one-layer tree (wq |
    wk | wv fused into ``wqkv``, w_gate | w_up into ``w_gu``, the
    intermediate padded by its rule). Norms are ones, the embedding dense
    bf16, the head in the configuration's head format; then
    ``permute_hidden_params`` where the configuration asks for the layer
    kernel's layout."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import quantize

    def ones():
        return torch.ones((spec.dim,), dtype=torch.bfloat16, device=device)

    layers = []
    for li in range(spec.n_layers):
        layer = {"attn_norm": ones(), "mlp_norm": ones(),
                 **weights.draw_layer(spec, seed, li, device)}
        layers.append(llama.quantize_params(
            {"layers": [layer]}, spec.layer_fmt,
            quantize_head=False)["layers"][0])
    params = {"embed": weights.draw_embed(spec, seed, device),
              "layers": layers, "final_norm": ones(),
              "lm_head": quantize(weights.draw_head(spec, seed, device)
                                  .float(), spec.head_fmt)}
    if cfg.hperm:
        params = llama.permute_hidden_params(params, cfg)
    return params


def serve(params, cfg, req: traffic.Request, device, mix: dict,
          cache_len: int | None = None) -> np.ndarray:
    """One request through the mix's entry on a fresh cache; returns the
    served tokens [batch, max(steps, 1)] on the host.

    ``generate_scan``: prefill, then ``steps`` greedy steps replayed as a
    CUDA graph; the cache sized to prompt + steps rounded up as
    ``generate`` sizes it. ``prefill``: the prompt on a cache of its own
    rounded length, the argmax of the last logits, the first token fetched
    to the host."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    prompt = torch.from_numpy(req.tokens).to(device)
    need = req.prompt_len + req.steps
    cache = llama.KVCache.create(
        cfg, req.batch, cache_len or traffic.round_up(need, mix["cache_round"]),
        device=device)
    if mix["entry"] == "generate_scan":
        return llama.generate_scan(params, cfg, prompt, cache, req.steps)
    if mix["entry"] == "prefill":
        logits, _ = llama.prefill(params, cfg, prompt, cache)
        return torch.argmax(logits, -1)[:, None].cpu().numpy()
    raise ValueError(f"entry {mix['entry']!r}: generate_scan or prefill")


def warm_up(params, cfg, spec, mix: dict, device) -> None:
    """Each prompt length of ``warmup_prompts`` once, the first on a cache
    as long as the mix's longest request needs, with ``warmup_steps``
    served tokens: every branch and buffer size the window takes."""
    longest = max(p + o for p, o in traffic.pairs(mix))
    steps = mix["warmup_steps"] if mix.get("output") is not None else 0
    batch = int(mix.get("batch", 1))
    rng = np.random.default_rng(0)
    for i, t in enumerate(mix["warmup_prompts"]):
        req = traffic.Request(-1, t, steps, rng.integers(
            0, spec.vocab_size, size=(batch, t), dtype=np.int64))
        cache_len = traffic.round_up(longest, mix["cache_round"]) if i == 0 \
            else None
        serve(params, cfg, req, device, mix, cache_len)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()
