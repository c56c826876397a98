"""Tensor + data parallel model steps over a (data, model) mesh.

Port of the reference's ``parallel/tp.py`` (Megatron sharding with GQA
co-location: each model rank owns n_kv_heads / n_model KV heads with their
whole group of query heads, so attention needs no communication; one psum
after the wo product and one after w_down). Layout per layer (weights
[N, K]):

    wq / wk / wv, w_gate / w_up   column-parallel   ("model", None)
    wo, w_down                    row-parallel      (None, "model"), psum
    lm_head                       column-parallel   logits vocab-sharded
    embed, norms                  replicated
    kv cache                      heads on "model", batch on "data"

What differs from the reference:

- ``shard_params`` returns THIS rank's slice (the reference ``device_put``s
  global arrays with shardings); ``make_tp_step``'s step takes the global
  tokens, runs on every rank, and returns the global logits (gathered over
  model and data, the reference's out spec) and the rank's cache shard.
- The port keeps quantized weights in logical column order, so a K-slice
  at a multiple of the format's block (256 for q4_k, 32 for q8_0 / q4_0)
  is already a valid ``QuantLinear``: ``shard_quant_linear`` slices the
  stored fields and re-encodes nothing. ``quantize_params_sharded``
  quantizes with the port's quantizer on the weights' device (the
  reference's goes through its native library), keeping the reference's
  pad of the MLP intermediate to QK_K * n_model (7B at 2: 11008 -> 11264).
- A fused ``wqkv`` / ``w_gu`` (``quantize_params(fuse=True)``) is refused:
  cut into contiguous row blocks it would hand a rank other heads' rows.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ggml_cuda_experiments_tpu_torch.models import llama
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
    QuantLinear, _block, quantize)
from ggml_cuda_experiments_tpu_torch.oracle.quant import QK_K
from ggml_cuda_experiments_tpu_torch.parallel.mesh import (
    Mesh, all_gather, axis_index, axis_size)

_COL = ("wq", "wk", "wv", "w_gate", "w_up")     # shard N (dim 0)
_ROW = ("wo", "w_down")                          # shard K (dim 1)
_FUSED = ("wqkv", "w_gu")


# ---------------------------------------------------------------------------
# partition specs and per-rank slices
# ---------------------------------------------------------------------------

def param_specs(params: llama.Params) -> llama.Params:
    """The spec tree: per leaf, the mesh axis of each of its dims (None:
    replicated along it)."""
    specs = {"embed": (None, None), "final_norm": (None,),
             "lm_head": ("model", None), "layers": []}
    for i, layer in enumerate(params["layers"]):
        fused = [k for k in _FUSED if k in layer]
        if fused:
            raise ValueError(f"layer {i}: {fused} is a fused projection; "
                             "tensor parallelism takes wq / wk / wv and "
                             "w_gate / w_up (quantize_params(fuse=False) "
                             "or quantize_params_sharded)")
        ls = {k: ("model", None) for k in _COL}
        ls.update({k: (None, "model") for k in _ROW})
        ls.update(attn_norm=(None,), mlp_norm=(None,))
        specs["layers"].append(ls)
    return specs


def _fields(w: QuantLinear):
    return [f.name for f in dataclasses.fields(w)
            if isinstance(getattr(w, f.name), torch.Tensor)]


def shard_rows(w, i: int, n: int):
    """Rows [i * N / n, (i + 1) * N / n) of a dense or quantized [N, K]."""
    rows = w.shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows not divisible by {n}")
    r0, r1 = i * rows // n, (i + 1) * rows // n
    if not isinstance(w, QuantLinear):
        return w[r0:r1].contiguous()
    return dataclasses.replace(
        w, shape=(r1 - r0, w.shape[1]),
        **{f: getattr(w, f)[r0:r1].contiguous() for f in _fields(w)})


def shard_quant_linear(w, i: int, n: int):
    """Columns (the K-slice) [i * K / n, (i + 1) * K / n) of a dense or
    quantized [N, K]. A quantized slice must start and end on a block
    (each stored field is sliced in proportion; nothing is re-encoded)."""
    k = w.shape[1]
    if k % n:
        raise ValueError(f"K = {k} not divisible by {n}")
    k0, k1 = i * k // n, (i + 1) * k // n
    if not isinstance(w, QuantLinear):
        return w[:, k0:k1].contiguous()
    if (k1 - k0) % _block(w.fmt):
        raise ValueError(f"{w.fmt} K-slice of {k1 - k0} is not a multiple "
                         f"of its {_block(w.fmt)}-element block")
    if w.s6:        # its fields hold two halves each: no proportional slice
        raise NotImplementedError("a K-slice of an s6 weight: shard the "
                                  "Q4_K-E encoding")
    out = {}
    for f in _fields(w):
        t = getattr(w, f)
        per = t.shape[1] * (k1 - k0) // k
        out[f] = t[:, i * per:(i + 1) * per].contiguous()
    return dataclasses.replace(w, shape=(w.shape[0], k1 - k0), **out)


def shard_params(params: llama.Params, mesh: Mesh) -> llama.Params:
    """This rank's slice of ``params`` (dense or quantized) along "model",
    by ``param_specs``."""
    specs = param_specs(params)
    n, i = axis_size(mesh, "model"), axis_index(mesh, "model")

    def one(w, spec):
        if spec[0] == "model":
            return shard_rows(w, i, n)
        if len(spec) > 1 and spec[1] == "model":
            return shard_quant_linear(w, i, n)
        return w

    out = {k: one(params[k], specs[k])
           for k in ("embed", "final_norm", "lm_head")}
    out["layers"] = [{k: one(w, s[k]) for k, w in layer.items()}
                     for layer, s in zip(params["layers"], specs["layers"])]
    return out


def quantize_params_sharded(params: llama.Params, fmt: str, n_model: int
                            ) -> llama.Params:
    """Quantize every linear to ``fmt`` for an n_model-way TP run, unfused,
    on the weights' device. The MLP intermediate is zero-padded to a
    multiple of QK_K * n_model, so each w_down K-shard is whole blocks:
    zero columns quantize to zero blocks and silu(0) * 0 == 0 keeps the
    padded lanes inert."""
    gran = QK_K * n_model
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        ls = dict(layer)
        inter = layer["w_gate"].shape[0]
        pad = -(-inter // gran) * gran - inter
        for key in ("wq", "wk", "wv"):
            ls[key] = quantize(layer[key].float(), fmt)
        for key in ("w_gate", "w_up"):
            ls[key] = quantize(F.pad(layer[key].float(), (0, 0, 0, pad)),
                               fmt)
        ls["wo"] = quantize(layer["wo"].float(), fmt)
        ls["w_down"] = quantize(F.pad(layer["w_down"].float(), (0, pad)),
                                fmt)
        out["layers"].append(ls)
    out["lm_head"] = quantize(params["lm_head"].float(), fmt)
    return out


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------

def local_config(cfg: ModelConfig, n_model: int) -> ModelConfig:
    if cfg.n_kv_heads % n_model:
        raise ValueError(f"model axis {n_model} must divide n_kv_heads "
                         f"{cfg.n_kv_heads} (GQA co-location)")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // n_model,
                               n_kv_heads=cfg.n_kv_heads // n_model)


def data_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of x along the "data" axis (dim 0)."""
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by data={n}")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def make_tp_step(cfg: ModelConfig, mesh: Mesh, params: llama.Params, *,
                 decode: bool):
    """The tensor-parallel step, run on every rank with its own params
    shard (``shard_params``) and cache shard (``create_sharded_cache``).

    decode=True:  (params, tokens [B], cache)    -> (logits [B, V], cache)
    decode=False: (params, tokens [B, T], cache) -> (logits [B, V], cache)
    tokens are global; the logits come back whole on every rank. The step
    also takes ``llama._forward``'s ``layer_hook``."""
    param_specs(params)                     # refuses fused projections
    lcfg = local_config(cfg, axis_size(mesh, "model"))

    @torch.no_grad()
    def step(params, tokens, cache, layer_hook=None):
        toks = data_rows(tokens, mesh)
        if decode:
            positions = cache.lengths[:, None].clone()
            toks = toks[:, None]
        else:
            B, T = toks.shape
            positions = torch.arange(T, dtype=torch.int32,
                                     device=toks.device).expand(B, T)
        logits, cache = llama._forward(params, lcfg, toks, cache, positions,
                                       decode=decode, reduce_axis="model",
                                       mesh=mesh, layer_hook=layer_hook)
        logits = all_gather(logits, mesh, "model", dim=-1, tiled=True)
        return all_gather(logits, mesh, "data", dim=0, tiled=True), cache

    return step


def create_sharded_cache(cfg: ModelConfig, mesh: Mesh, batch: int,
                         max_len: int, dtype=torch.bfloat16,
                         device=None) -> llama.KVCache:
    """This rank's cache shard: its data rows and model heads (on the card
    unless ``device`` is named)."""
    n_data = axis_size(mesh, "data")
    if batch % n_data:
        raise ValueError(f"batch {batch} not divisible by data={n_data}")
    return llama.KVCache.create(local_config(cfg, axis_size(mesh, "model")),
                                batch // n_data, max_len, dtype,
                                device=device)
