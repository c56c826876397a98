"""The MoE layer across gloo ranks on the CPU, against the JAX package's
single-device model: the three distributed tests of the JAX package that
run ``moe-debug``, on the same weights (carried across by
``params_from_jax``), at their tolerances.

- tests/test_moe.py::test_expert_parallel_matches_single: ``moe_mlp`` with
  its 4 experts split over a 4-rank ``expert`` axis (one expert a rank,
  one psum) against the single-device JAX ``moe_mlp`` on [2, 4, dim], f32,
  2e-4.
- tests/test_pipeline.py::test_pp_moe_compose: ``moe-debug`` at 4 layers
  over 4 pipeline stages, 2 microbatches, bf16 weights: prefill logits
  within atol 6e-2 of the JAX single-device prefill (that test's bound:
  bf16 sums in another order through 4 MoE layers).
- tests/test_full.py::test_full_step_matches_single at its two sizes with
  expert = 2, (data, pipe, seq, model, expert) = (2, 1, 1, 2, 2) and
  (1, 2, 1, 2, 2): ``make_full_step`` prefill + 2 greedy decode steps on
  f32 weights and caches against JAX ``prefill`` / ``decode_step``, 2e-4.

One ``run_spmd`` of 8 ranks runs every case (a 4-rank case on the first 4,
as the JAX meshes take the first n devices). No jax at the top of this
module (the ranks import it)."""

import dataclasses

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.models import convert, llama, moe
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.parallel import full, pipeline
from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd

CFG = PRESETS["moe-debug"]
PP_CFG = dataclasses.replace(CFG, n_layers=4)
FULL_CFG = dataclasses.replace(CFG, n_layers=2)
B, T, S = 4, 8, 64
FULL_SIZES = [dict(data=2, pipe=1, seq=1, model=2, expert=2),
              dict(data=1, pipe=2, seq=1, model=2, expert=2)]


def _ep(np_params, x):
    mesh = pm.Mesh(np.arange(4), ("expert",))
    if not mesh.coords:
        return None
    params = convert.params_from_jax(np_params, CFG, device="cpu",
                                     dtype=torch.float32)
    i = pm.axis_index(mesh, "expert")
    layer = {k: w[i:i + 1] if k in ("w_gate", "w_up", "w_down") else w
             for k, w in params["layers"][0].items()}
    return moe.moe_mlp(layer, CFG, torch.from_numpy(x), expert_axis="expert",
                       mesh=mesh)


def _pp(np_params, prompt):
    mesh = pm.Mesh(np.arange(4), ("pipe",))
    if not mesh.coords:
        return None
    params = convert.params_from_jax(np_params, PP_CFG, device="cpu")
    sp, step = pipeline.make_pp_step(PP_CFG, mesh,
                                     pipeline.stack_layers(params),
                                     n_micro=2, decode=False)
    cache = pipeline.shard_cache_pp(
        llama.KVCache.create(PP_CFG, B, S, device="cpu"), mesh)
    logits, _ = step(sp, torch.from_numpy(prompt), cache)
    return logits


def _full(np_params, prompt, sizes):
    mesh = full.make_full_mesh(int(np.prod(list(sizes.values()))), sizes)
    if not mesh.coords:
        return None
    params = convert.params_from_jax(np_params, FULL_CFG, device="cpu",
                                     dtype=torch.float32)
    sparams, _ = full.shard_full_params(params, mesh, FULL_CFG)
    pre = full.make_full_step(FULL_CFG, mesh, n_micro=2, prefill_len=T,
                              decode=False)
    dec = full.make_full_step(FULL_CFG, mesh, n_micro=2, prefill_len=T,
                              decode=True)
    cache = full.create_full_cache(FULL_CFG, mesh, B, S, dtype=torch.float32,
                                   device="cpu")
    logits, cache = pre(sparams, torch.from_numpy(prompt), cache)
    got = [logits]
    tok = torch.argmax(logits, -1)
    for _ in range(2):
        logits, cache = dec(sparams, tok, cache)
        got.append(logits)
        tok = torch.argmax(logits, -1)
    return {"logits": torch.stack(got),
            "experts": moe.n_local_experts(sparams["layers"][0]["w_gate"])}


def _rank(ep_args, pp_args, full_args):
    out = {"ep": _ep(*ep_args), "pp": _pp(*pp_args)}
    for i, sizes in enumerate(FULL_SIZES):
        out[f"full{i}"] = _full(*full_args, sizes)
    return out


@pytest.fixture(scope="module")
def ranks():
    import jax
    import jax.numpy as jnp
    from ggml_cuda_experiments_tpu.models import llama as jl
    from ggml_cuda_experiments_tpu.models import moe as jm
    rng = np.random.default_rng(1234)
    to_np = lambda p: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), p)
    want = {}
    # expert parallelism (tests/test_moe.py, seed 5)
    p_ep = jm.init_moe_weights(CFG, seed=5, dtype=jnp.float32)
    x = rng.normal(size=(2, 4, CFG.dim)).astype(np.float32)
    want["ep"] = np.asarray(jm.moe_mlp(p_ep["layers"][0], CFG,
                                       jnp.asarray(x)))
    # pipeline (tests/test_pipeline.py, seed 2, bf16 weights)
    p_pp = jm.init_moe_weights(PP_CFG, seed=2)
    prompt_pp = rng.integers(0, CFG.vocab_size, (B, T)).astype(np.int64)
    logits, _ = jl.prefill(p_pp, PP_CFG, jnp.asarray(prompt_pp, jnp.int32),
                           jl.KVCache.create(PP_CFG, B, S))
    want["pp"] = np.asarray(logits)
    # the 5-axis step (tests/test_full.py, seed 0, f32)
    p_full = jm.init_moe_weights(FULL_CFG, seed=0, dtype=jnp.float32)
    prompt = rng.integers(0, CFG.vocab_size, (B, T)).astype(np.int64)
    cache = jl.KVCache.create(FULL_CFG, B, S, dtype=jnp.float32)
    logits, cache = jl.prefill(p_full, FULL_CFG,
                               jnp.asarray(prompt, jnp.int32), cache)
    seq = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(2):
        logits, cache = jl.decode_step(p_full, FULL_CFG, tok, cache)
        seq.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want["full"] = np.stack(seq)
    return want, run_spmd(
        _rank, 8, "gloo", "cpu", timeout=300,
        args=((to_np(p_ep), x), (to_np(p_pp), prompt_pp),
              (to_np(p_full), prompt)))


def test_expert_parallel_matches_single(ranks):
    want, outs = ranks
    for r, o in enumerate(outs):
        assert (o["ep"] is None) == (r >= 4)
        if o["ep"] is not None:
            np.testing.assert_allclose(o["ep"].numpy(), want["ep"],
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"rank {r}")


def test_pp_moe_compose(ranks):
    want, outs = ranks
    for r, o in enumerate(outs):
        assert (o["pp"] is None) == (r >= 4)
        if o["pp"] is not None:
            np.testing.assert_allclose(o["pp"].float().numpy(), want["pp"],
                                       atol=6e-2, err_msg=f"rank {r}")


@pytest.mark.parametrize("i", range(len(FULL_SIZES)),
                         ids=["2-1-1-2-2", "1-2-1-2-2"])
def test_full_step_matches_single(ranks, i):
    want, outs = ranks
    for r, o in enumerate(outs):
        got = o[f"full{i}"]
        assert got["experts"] == CFG.n_experts // 2      # split over expert
        for step, (g, w) in enumerate(zip(got["logits"].numpy(),
                                          want["full"])):
            np.testing.assert_allclose(
                g, w, rtol=2e-4, atol=2e-4,
                err_msg=f"step {step} sizes={FULL_SIZES[i]} rank {r}")
