"""Mixture-of-Experts MLP block with expert parallelism.

Port of the reference's ``models/moe.py``, same names and numerics:

- **Dense dispatch.** Every local expert runs on every token through the
  model's own ``apply_linear`` (so a q4_k expert takes ``q4k_matvec`` at
  one row and ``q4k_gemm`` above), and the router's top-k weights (zero
  for the unselected experts) fold the results in expert order into an
  f32 accumulator, rounded to the input's dtype once. No shape depends on
  the routing and nothing is fetched to the host, so a decode step with
  MoE layers captures into a CUDA graph (``llama.generate_scan``). At
  batch 1 this streams every expert's weights: routing to the chosen
  experts only is a separate optimisation, not taken here.
- **Expert parallelism.** The stacked expert weights carry a leading E dim
  that ``parallel/full.py`` shards over the ``expert`` mesh axis; each rank
  folds its E / n experts (``e0 = axis_index * e_local``) and one ``psum``
  over the axis merges them. The router stays replicated and scores every
  expert.
- Router math in f32: logits ``x.float() @ router.float().T``, softmax,
  threshold at the k-th largest probability, renormalised (Mixtral's
  convention).

Weights per MoE layer (leading dim E = n_experts):
    router          [E, dim]            dense
    w_gate, w_up    [E, inter, dim]     dense or a stacked QuantLinear
    w_down          [E, dim, inter]
A stacked ``QuantLinear`` (``stack_expert_quant``) keeps one expert's
(N, K) as its ``shape`` and a leading E dim on every array;
``_expert_slice`` gives expert e's contiguous 2-D views, which the
kernels take as they are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import QuantLinear
from ggml_cuda_experiments_tpu_torch.utils.platform import resolve_device

_FIELDS = ("qs", "es", "em", "qh", "d")


def _expert_slice(w, e):
    """Expert e's weight from a stacked leaf (dense [E, N, K] tensor or a
    QuantLinear whose arrays carry a leading E dim): views, no copy. ``e``
    an int, or a slice of experts (a shard of the stack, still stacked)."""
    if isinstance(w, QuantLinear):
        return QuantLinear(fmt=w.fmt, shape=w.shape, enc=w.enc, **{
            f: None if getattr(w, f) is None else getattr(w, f)[e]
            for f in _FIELDS})
    return w[e]


def stack_expert_quant(qls: list[QuantLinear]) -> QuantLinear:
    """Stack per-expert QuantLinears into one leading-E container (the form
    ``_expert_slice`` unstacks and the ``expert`` mesh axis shards)."""
    ref = qls[0]
    if any((q.fmt, q.shape, q.enc) != (ref.fmt, ref.shape, ref.enc)
           for q in qls):
        raise ValueError("stack_expert_quant: experts of different formats, "
                         "shapes or encodings: "
                         f"{[(q.fmt, q.shape, q.enc) for q in qls]}")

    def cat(field):
        vals = [getattr(q, field) for q in qls]
        return None if vals[0] is None else torch.stack(vals)

    return QuantLinear(fmt=ref.fmt, shape=ref.shape, enc=ref.enc,
                       **{f: cat(f) for f in _FIELDS})


def n_local_experts(w) -> int:
    return w.qs.shape[0] if isinstance(w, QuantLinear) else w.shape[0]


def router_topk(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k routing weights: softmax over experts, keep the k largest,
    renormalise (Mixtral's convention). logits [..., E] -> weights
    [..., E] with k nonzeros a token (more only where probabilities tie
    at the threshold, as in the reference)."""
    probs = torch.softmax(logits.float(), dim=-1)
    thresh = torch.topk(probs, k, dim=-1).values[..., -1:]
    kept = torch.where(probs >= thresh, probs, torch.zeros_like(probs))
    return kept / kept.sum(-1, keepdim=True)


def moe_mlp(layer, cfg: ModelConfig, x: torch.Tensor, *,
            expert_axis: str | None = None, mesh=None,
            xq8: bool = False) -> torch.Tensor:
    """MoE feed-forward on normalised input x [..., dim].

    ``expert_axis`` (with ``mesh``): the mesh axis the stacked experts are
    sharded over; the router (replicated) still scores every expert, each
    rank folds its local slice, and one psum merges them."""
    from ggml_cuda_experiments_tpu_torch.models import llama

    e_total = cfg.n_experts
    logits = x.float() @ layer["router"].float().T
    weights = router_topk(logits, cfg.n_active_experts)      # [..., E]

    e_local = n_local_experts(layer["w_gate"])
    if expert_axis is not None:
        from ggml_cuda_experiments_tpu_torch.parallel.mesh import axis_index
        e0 = axis_index(mesh, expert_axis) * e_local
    else:
        if e_local != e_total:
            raise ValueError(f"{e_local} local experts vs n_experts="
                             f"{e_total} without an expert axis")
        e0 = 0

    out = torch.zeros((*x.shape[:-1], cfg.dim), dtype=torch.float32,
                      device=x.device)
    for e in range(e_local):
        gate = llama.apply_linear(x, _expert_slice(layer["w_gate"], e), xq8)
        up = llama.apply_linear(x, _expert_slice(layer["w_up"], e), xq8)
        h = F.silu(gate.float()).to(x.dtype) * up.to(x.dtype)
        y = llama.apply_linear(h, _expert_slice(layer["w_down"], e), xq8)
        out = out + weights[..., e0 + e:e0 + e + 1] * y.float()

    if expert_axis is not None:
        from ggml_cuda_experiments_tpu_torch.parallel.mesh import psum
        out = psum(out, mesh, expert_axis)
    return out.to(x.dtype)


def init_moe_weights(cfg: ModelConfig, seed: int = 0, device=None,
                     dtype=torch.bfloat16):
    """Random MoE model weights (router + stacked experts per layer) drawn
    on ``device`` (the card unless named) from seeded ``torch.Generator``s;
    the attention weights are ``llama.init_weights``'. The draws differ
    from the reference's NumPy ones; carry its weights across with
    ``models.convert.params_from_jax`` where the two must match."""
    from ggml_cuda_experiments_tpu_torch.models import llama

    device = resolve_device(device)
    params = llama.init_weights(cfg, seed=seed, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed + 17)
    inter = cfg.moe_intermediate or cfg.intermediate
    E, d = cfg.n_experts, cfg.dim

    def lin(*shape):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w / float(np.sqrt(shape[-1]))).to(dtype)

    for layer in params["layers"]:
        for key in ("w_gate", "w_up", "w_down"):
            layer.pop(key)
        layer["router"] = lin(E, d)
        layer["w_gate"] = lin(E, inter, d)
        layer["w_up"] = lin(E, inter, d)
        layer["w_down"] = lin(E, d, inter)
    return params


def moe_mlp_oracle(layer, cfg: ModelConfig, x) -> np.ndarray:
    """NumPy dense reference: full softmax / top-k routing, every expert
    evaluated, f32 throughout (the CPU oracle for tests). Any weight leaf
    the oracle forward takes, stacked, is accepted."""
    from ggml_cuda_experiments_tpu_torch.oracle.model import _dense

    xf = np.asarray(x, np.float32)
    logits = xf @ _dense(layer["router"]).T
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    k = cfg.n_active_experts
    thresh = np.sort(probs, axis=-1)[..., -k][..., None]
    kept = np.where(probs >= thresh, probs, 0.0)
    weights = kept / kept.sum(-1, keepdims=True)

    out = np.zeros_like(xf)
    for ei in range(cfg.n_experts):
        wg, wu, wd = (_dense(_expert_slice(layer[key], ei))
                      for key in ("w_gate", "w_up", "w_down"))
        g = xf @ wg.T
        h = (g / (1 + np.exp(-g))) * (xf @ wu.T)
        out += weights[..., ei:ei + 1] * (h @ wd.T)
    return out
