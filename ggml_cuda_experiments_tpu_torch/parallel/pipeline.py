"""Pipeline parallelism: layer stages over a ``pipe`` mesh axis.

Port of the reference's ``parallel/pipeline.py``: stage s holds layers
[s * L / P, (s + 1) * L / P) and the same layers of the KV cache; the batch
splits into M microbatches, and at pipeline step t stage s runs microbatch
t - s through its layers and ``ppermute``s the activations to stage s + 1
(GPipe). Bubble steps (t - s outside [0, M)) compute on what they hold,
with their cache writes masked (``valid=False``); only the last stage's
valid steps run the head. Tensor parallelism (``reduce_axis``) and the
sequence-parallel attention block of ``parallel/full.py`` (``seq_axis``,
``attention_block``) compose inside the stage body; ``expert_axis`` is
passed on to the MLP, where a MoE layer (``models/moe.py``) folds the
stage's experts sharded over it.

The reference stacks the layers into arrays with a leading layer dim and
shards that dim; the port keeps the list of per-layer trees, and a stage
takes its slice of the list (no copy).
"""

from __future__ import annotations

import dataclasses

import torch

from ggml_cuda_experiments_tpu_torch.models import llama
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.parallel.mesh import (
    Mesh, axis_index, axis_size, ppermute, psum)


def stack_layers(params: llama.Params) -> llama.Params:
    """The reference's stacked tree. The port's params already hold their
    layers as the list a stage slices, so they come back as they are."""
    return params


def stage_range(n_layers: int, mesh: Mesh, axis_name: str = "pipe"
                ) -> range:
    """The layers of this rank's stage."""
    n, s = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    if n_layers % n:
        raise ValueError(f"{n_layers} layers over {n} stages")
    per = n_layers // n
    return range(s * per, (s + 1) * per)


def shard_params_pp(params: llama.Params, mesh: Mesh,
                    axis_name: str = "pipe") -> llama.Params:
    """This stage's params: its layers; embed, norm and head replicated."""
    r = stage_range(len(params["layers"]), mesh, axis_name)
    return dict(params, layers=params["layers"][r.start:r.stop])


def pp_forward(params: llama.Params, cfg: ModelConfig, tokens: torch.Tensor,
               cache: llama.KVCache, *, decode: bool, n_micro: int,
               mesh: Mesh, axis_name: str = "pipe",
               reduce_axis: str | None = None,
               expert_axis: str | None = None, seq_axis: str | None = None,
               attention_block=None, layer_hook=None
               ) -> tuple[torch.Tensor, llama.KVCache]:
    """Pipelined forward, on every rank: params["layers"] this stage's
    layers, ``cache`` this stage's layers of the cache (written in place).

    tokens: [B, T] (T = 1 for decode), B % n_micro == 0. ``seq_axis``: the
    prefill tokens are also sequence-sharded over it (positions offset per
    shard; the attention must be a sequence-parallel ``attention_block``).
    ``attention_block``: a drop-in for ``llama._attention_block``.
    ``layer_hook(li, h, b0) -> h``: as in ``llama._forward``, on the valid
    steps only, li the layer's index in the whole model. Returns
    (logits [B, vocab], the same on every stage, and the cache)."""
    n_stage, stage = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    B, T = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} % microbatches {n_micro} != 0")
    b = B // n_micro
    layers = params["layers"]
    attn_block = attention_block or llama._attention_block

    if decode:
        positions = cache.lengths[:, None].clone()
        len_inc = 1
    else:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device).expand(B, T)
        if seq_axis is not None:
            # block-contiguous sequence shards: [i * T, (i + 1) * T)
            positions = positions + axis_index(mesh, seq_axis) * T
        len_inc = T * (axis_size(mesh, seq_axis) if seq_axis else 1)

    # only stage 0 feeds embeddings into the pipeline
    h_all = params["embed"][tokens] if stage == 0 else None
    dim, dtype = params["embed"].shape[1], params["embed"].dtype
    vocab = params["lm_head"].shape[0]
    logits_buf = torch.zeros((n_micro, b, vocab), dtype=torch.float32,
                             device=tokens.device)
    carry = torch.zeros((b, T, dim), dtype=dtype, device=tokens.device)
    fwd_perm = [(i, i + 1) for i in range(n_stage - 1)]
    n_steps = n_micro + n_stage - 1

    for t in range(n_steps):
        mb = t - stage                          # this stage's microbatch
        valid = 0 <= mb < n_micro
        b0 = min(max(mb, 0), n_micro - 1) * b
        h = h_all[b0:b0 + b] if stage == 0 else carry
        pos = positions[b0:b0 + b]
        for li, layer in enumerate(layers):
            if layer_hook is not None and valid:
                h = layer_hook(stage * len(layers) + li, h, b0)
            attn, cache = attn_block(layer, cfg, h, cache, li, pos,
                                     decode=decode, reduce_axis=reduce_axis,
                                     mesh=mesh, b0=b0, valid=valid)
            h = h + attn
            h = h + llama._mlp_block(layer, cfg, h, reduce_axis=reduce_axis,
                                     expert_axis=expert_axis, mesh=mesh)
        if valid and stage == n_stage - 1:
            hn = llama.rms_norm(h[:, -1], params["final_norm"], cfg.rms_eps)
            logits_buf[b0 // b] = llama.apply_linear(
                hn, params["lm_head"], cfg.x_quant8).float()
        if t != n_steps - 1:
            carry = ppermute(h, mesh, axis_name, fwd_perm)

    # every stage gets the last stage's logits (only it wrote any)
    logits = psum(logits_buf, mesh, axis_name).reshape(B, vocab)
    cache.lengths += len_inc
    return logits, cache


def make_pp_step(cfg: ModelConfig, mesh: Mesh, params: llama.Params, *,
                 n_micro: int, decode: bool):
    """(this stage's params, step) for a mesh with a ``pipe`` axis;
    step(params, tokens, cache) -> (logits, cache) runs on every rank."""

    @torch.no_grad()
    def step(params, tokens, cache):
        return pp_forward(params, cfg, tokens, cache, decode=decode,
                          n_micro=n_micro, mesh=mesh)

    return shard_params_pp(params, mesh), step


def shard_cache_pp(cache: llama.KVCache, mesh: Mesh) -> llama.KVCache:
    """This stage's layers of a whole-model cache (copies; lengths too)."""
    r = stage_range(cache.k.shape[0], mesh)

    def part(t):
        return None if t is None else t[r.start:r.stop].clone()
    return dataclasses.replace(
        cache, k=part(cache.k), v=part(cache.v),
        lengths=cache.lengths.clone(), k_scale=part(cache.k_scale),
        v_scale=part(cache.v_scale))
