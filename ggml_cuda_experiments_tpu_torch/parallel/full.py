"""The combined 5-axis parallel step: data / pipe / seq / model / expert.

Port of the reference's ``parallel/full.py``: one program on every rank of
a 5-axis mesh composing

    data    batch rows                         (no collectives)
    pipe    layer stages, GPipe microbatches   (parallel/pipeline.py)
    seq     ring attention for prefill, the LSE-merged partial decode
                                               (parallel/ring_attention.py)
    model   Megatron tensor parallelism        (parallel/tp.py)
    expert  MoE experts: the stacked expert weights' leading dim
            (``models/moe.py``: each rank folds its experts, one psum)

Sequence shards are block-contiguous and owner-writes: at prefill seq rank
i stores positions [i * T_loc, (i + 1) * T_loc) at offsets [0, T_loc) of
its cache shard; at decode the new token goes to the LAST seq rank (offset
T_loc + step), every rank computes its (O, M, S) partial and
``lse_combine_axis`` merges them.

A MoE model is sharded as the reference shards it: attention Megatron
over "model", the router replicated, w_gate / w_up / w_down split over
"expert" on their leading (expert) dim and whole on every model rank.

What differs from the reference, which runs only ``moe-debug`` in its test:
for a dense model its ``shard_full_params`` gives w_gate / w_up / w_down
only an "expert" spec, so each model rank runs the whole MLP and the psum
over "model" in ``_mlp_block`` multiplies it by n_model; and it cuts a
fused ``wqkv`` into contiguous row blocks over "model". Here the dense MLP
is Megatron-sharded over "model" like attention (the psum is then right),
and a fused projection with model > 1 is refused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ggml_cuda_experiments_tpu_torch.models import llama, moe
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.parallel import pipeline, tp
from ggml_cuda_experiments_tpu_torch.parallel.mesh import (
    Mesh, all_gather, axis_index, axis_size, psum)
from ggml_cuda_experiments_tpu_torch.parallel.ring_attention import (
    decode_context_parallel, ring_attention)

AXES = ("data", "pipe", "seq", "model", "expert")


def make_full_mesh(n_devices: int, sizes: dict[str, int] | None = None
                   ) -> Mesh:
    """The 5-axis mesh over the group's first ``n_devices`` ranks (the
    rest are no member: ``mesh.coords`` is empty there). Without
    ``sizes``, the prime factors of n are dealt round-robin to (model,
    pipe, seq, expert, data), model first, as the reference does. Every
    rank of the group calls it."""
    if sizes is None:
        sizes = dict.fromkeys(AXES, 1)
        order = ("model", "pipe", "seq", "expert", "data")
        rem, i = n_devices, 0
        while rem > 1:
            for p in (2, 3, 5, 7, 11, 13):
                if rem % p == 0:
                    sizes[order[i % len(order)]] *= p
                    rem //= p
                    i += 1
                    break
            else:
                sizes["data"] *= rem
                rem = 1
    n = int(np.prod([sizes[a] for a in AXES]))
    if n != n_devices or n > dist.get_world_size():
        raise ValueError(f"mesh {sizes} ({n}) over {n_devices} devices, "
                         f"{dist.get_world_size()} ranks")
    return Mesh(np.arange(n).reshape(*(sizes[a] for a in AXES)), AXES)


def _sp_attention_block(seq_axis: str, prefill_t_loc: int):
    """``llama._attention_block`` with sequence / context parallelism over
    ``seq_axis``; ``prefill_t_loc``: the prefill tokens of a seq rank (the
    owner-writes map of the decode appends)."""

    def block(layer, cfg, h, cache, li, positions, *, decode, reduce_axis,
              mesh, b0=0, valid=None):
        if cache.quantized:
            raise NotImplementedError("sequence parallelism: bf16 cache "
                                      "only")
        B, T, _ = h.shape
        Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        n_seq, me = axis_size(mesh, seq_axis), axis_index(mesh, seq_axis)
        last = me == n_seq - 1
        lengths = cache.lengths[b0:b0 + B]
        valid = True if valid is None else valid

        x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
        q, k, v = llama.qkv_proj(layer, x, cfg)
        q = llama.rope(q.reshape(B, T, Hq, D), positions, cfg.rope_theta)
        k = llama.rope(k.reshape(B, T, Hkv, D), positions, cfg.rope_theta)
        kt = k.transpose(1, 2)                  # [B, Hkv, T, D]
        vt = v.reshape(B, T, Hkv, D).transpose(1, 2)

        if decode:
            # owner-writes: the new token goes to the LAST seq rank
            step = lengths - n_seq * prefill_t_loc   # decode steps so far
            store, w_valid = prefill_t_loc + step, valid and last
        else:
            # prefill: each rank stores its own block at offset 0
            store, w_valid = positions[:, 0] - me * prefill_t_loc, valid
        if w_valid:
            llama._write_kv(cache, li, kt, vt, store, b0)

        if decode:
            len_local = torch.clamp(
                prefill_t_loc + (step + 1 if last else 0 * step), 0,
                cache.k.shape[3]).to(torch.int32)
            o = decode_context_parallel(
                q[:, 0].contiguous(), cache.k[li, b0:b0 + B],
                cache.v[li, b0:b0 + B], len_local, mesh,
                seq_axis)[:, None]              # [B, 1, Hq, D]
        else:
            o = ring_attention(q.transpose(1, 2).contiguous(),
                               kt.contiguous(), vt.contiguous(), mesh,
                               seq_axis, causal=True).transpose(1, 2)
        o = o.reshape(B, T, Hq * D).to(h.dtype)
        return llama.row_parallel(o, layer["wo"], cfg.x_quant8, mesh,
                                  reduce_axis), cache

    return block


def full_param_specs(params: llama.Params) -> dict:
    """Per layer leaf, the axes of its dims after the stacked layer dim:
    Megatron over "model" for attention, and for the dense MLP too; a MoE
    model's router replicated and its experts split over "expert" (the
    reference's specs)."""
    moe = ["router" in layer for layer in params["layers"]]
    if any(moe) and not all(moe):
        raise ValueError("a tree mixing MoE and dense layers")
    lspec = {"wq": ("model",), "wk": ("model",), "wv": ("model",),
             "wo": (None, "model"), "w_gate": ("model",),
             "w_up": ("model",), "w_down": (None, "model"),
             "wqkv": (), "w_gu": (), "attn_norm": (), "mlp_norm": ()}
    if any(moe):
        lspec.update(router=(), w_gate=("expert",), w_up=("expert",),
                     w_down=("expert",))
    return dict(embed=(None, None), final_norm=(None,),
                lm_head=(None, None), layers=("pipe", lspec))


def shard_full_params(params: llama.Params, mesh: Mesh, cfg: ModelConfig
                      ) -> tuple[llama.Params, dict]:
    """(this rank's params, the spec tree): its stage's layers, each
    sliced over "model" (attention heads and a dense MLP's intermediate)
    and a MoE layer's experts over "expert"; embed, norms and head
    replicated."""
    specs = full_param_specs(params)
    n, i = axis_size(mesh, "model"), axis_index(mesh, "model")
    n_e, i_e = axis_size(mesh, "expert"), axis_index(mesh, "expert")
    local = pipeline.shard_params_pp(pipeline.stack_layers(params), mesh)
    layers = []
    for layer in local["layers"]:
        if n > 1 and any(k in layer for k in ("wqkv", "w_gu")):
            raise ValueError("a fused wqkv / w_gu cannot be cut over "
                             f"model={n}: pass wq / wk / wv, w_gate / w_up")
        out = {}
        for k, w in layer.items():
            spec = specs["layers"][1][k]
            if spec[:1] == ("expert",):
                w = _expert_shard(w, i_e, n_e)
            elif spec[:1] == ("model",):
                w = tp.shard_rows(w, i, n)
            elif spec[1:2] == ("model",):
                w = tp.shard_quant_linear(w, i, n)
            out[k] = w
        layers.append(out)
    return dict(local, layers=layers), specs


def _expert_shard(w, i: int, n: int):
    """Experts [i * E / n, (i + 1) * E / n) of a stacked expert leaf (a
    dense [E, ...] tensor or a stacked QuantLinear): views, no copy."""
    E = moe.n_local_experts(w)
    if E % n:
        raise ValueError(f"{E} experts over expert={n}")
    return moe._expert_slice(w, slice(i * E // n, (i + 1) * E // n))


def make_full_step(cfg: ModelConfig, mesh: Mesh, *, n_micro: int,
                   prefill_len: int, decode: bool):
    """The 5-axis step, run on every rank with its params and cache
    shards: (params, tokens, cache, layer_hook=None) -> (logits [B, V] on
    every rank, cache). tokens are global: [B] at decode, [B, prefill_len]
    at prefill. ``prefill_len`` (a multiple of the seq size) fixes the
    storage map. ``layer_hook``: ``pipeline.pp_forward``'s, h then the
    rank's data rows and sequence shard."""
    n_seq, n_model = axis_size(mesh, "seq"), axis_size(mesh, "model")
    if prefill_len % n_seq:
        raise ValueError(f"prefill_len {prefill_len} over seq={n_seq}")
    t_loc = prefill_len // n_seq
    lcfg = tp.local_config(cfg, n_model)
    attn = _sp_attention_block("seq", t_loc)

    @torch.no_grad()
    def step(params, tokens, cache, layer_hook=None):
        toks = tp.data_rows(tokens, mesh)
        if decode:
            toks = toks[:, None]
        else:
            s = axis_index(mesh, "seq")
            toks = toks[:, s * t_loc:(s + 1) * t_loc]
        logits, cache = pipeline.pp_forward(
            params, lcfg, toks, cache, decode=decode, n_micro=n_micro,
            mesh=mesh, reduce_axis="model", expert_axis="expert",
            seq_axis="seq", attention_block=attn, layer_hook=layer_hook)
        if not decode:
            # only the last seq rank's logits are the global last token's
            last = axis_index(mesh, "seq") == n_seq - 1
            logits = psum(logits if last else torch.zeros_like(logits),
                          mesh, "seq")
        return all_gather(logits, mesh, "data", dim=0, tiled=True), cache

    return step


def create_full_cache(cfg: ModelConfig, mesh: Mesh, batch: int,
                      max_len: int, dtype=torch.bfloat16, device=None
                      ) -> llama.KVCache:
    """This rank's cache shard: its stage's layers, data rows, model heads
    and seq positions (on the card unless ``device`` is named)."""
    shape = {a: axis_size(mesh, a) for a in AXES}
    for what, total, axis in (("layers", cfg.n_layers, "pipe"),
                              ("batch", batch, "data"),
                              ("max_len", max_len, "seq")):
        if total % shape[axis]:
            raise ValueError(f"{what} {total} over {axis}={shape[axis]}")
    local = dataclasses.replace(tp.local_config(cfg, shape["model"]),
                                n_layers=cfg.n_layers // shape["pipe"])
    return llama.KVCache.create(local, batch // shape["data"],
                                max_len // shape["seq"], dtype,
                                device=device)
