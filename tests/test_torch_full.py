"""The 5-axis (data, pipe, seq, model, expert) step over gloo ranks on the
CPU: ``make_full_mesh``'s factorization, and the port's ``make_full_step``
prefill + 2 greedy decode steps against the JAX single-device ``prefill`` /
``decode_step`` in f32 at tests/test_full.py's tolerance (2e-4), for a
dense debug config at (data, pipe, seq, model) = (1, 2, 2, 2), (2, 1, 1, 2)
and (1, 2, 1, 2), expert 1 (the JAX test's own sizes, which run
``moe-debug``, are held in tests/test_torch_moe_parallel.py). One ``run_spmd``
of 8 ranks runs the three sizes in turn (a 4-rank size on the first 4, as
the JAX mesh takes the first n devices). No jax at the top of this module
(the ranks import it)."""

import dataclasses

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.parallel import full
from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd

TCFG = dataclasses.replace(PRESETS["debug"], n_layers=2)
B, T, S = 4, 8, 64
SIZES = [dict(data=1, pipe=2, seq=2, model=2, expert=1),
         dict(data=2, pipe=1, seq=1, model=2, expert=1),
         dict(data=1, pipe=2, seq=1, model=2, expert=1)]


def _rank(np_params, prompt):
    out = {"default": dict(full.make_full_mesh(8).shape)}
    params = convert.params_from_jax(np_params, TCFG, device="cpu",
                                     dtype=torch.float32)
    for i, sizes in enumerate(SIZES):
        n = int(np.prod(list(sizes.values())))
        mesh = full.make_full_mesh(n, sizes)
        if not mesh.coords:              # not in this mesh
            continue
        sparams, _ = full.shard_full_params(params, mesh, TCFG)
        pre = full.make_full_step(TCFG, mesh, n_micro=2,
                                  prefill_len=T, decode=False)
        dec = full.make_full_step(TCFG, mesh, n_micro=2,
                                  prefill_len=T, decode=True)
        cache = full.create_full_cache(TCFG, mesh, B, S,
                                       dtype=torch.float32, device="cpu")
        logits, cache = pre(sparams, torch.from_numpy(prompt), cache)
        got = [logits]
        tok = torch.argmax(logits, -1)
        for _ in range(2):
            logits, cache = dec(sparams, tok, cache)
            got.append(logits)
            tok = torch.argmax(logits, -1)
        out[i] = torch.stack(got)
    return out


@pytest.fixture(scope="module")
def ranks():
    import jax
    import jax.numpy as jnp
    from ggml_cuda_experiments_tpu.models import llama as jl
    from ggml_cuda_experiments_tpu.models.config import ModelConfig
    cfg = ModelConfig(**dataclasses.asdict(TCFG))
    params = jl.init_weights(cfg, seed=0, dtype=jnp.float32)
    prompt = np.random.default_rng(1234).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int64)
    cache = jl.KVCache.create(cfg, B, S, dtype=jnp.float32)
    logits, cache = jl.prefill(params, cfg, jnp.asarray(prompt, jnp.int32),
                               cache)
    want = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(2):
        logits, cache = jl.decode_step(params, cfg, tok, cache)
        want.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       params)
    return np.stack(want), run_spmd(_rank, 8, "gloo", "cpu", timeout=300,
                                    args=(np_params, prompt))


def test_make_full_mesh_factorization(ranks):
    _, outs = ranks
    for o in outs:
        assert o["default"] == dict(data=1, pipe=2, seq=2, model=2,
                                    expert=1)
    assert full.AXES == ("data", "pipe", "seq", "model", "expert")


@pytest.mark.parametrize("i", range(len(SIZES)),
                         ids=["1-2-2-2", "2-1-1-2", "1-2-1-2"])
def test_full_step_matches_single(ranks, i):
    want, outs = ranks
    n = int(np.prod(list(SIZES[i].values())))
    for r, o in enumerate(outs):
        assert (i in o) == (r < n)
        if i in o:
            for step, (g, w) in enumerate(zip(o[i].numpy(), want)):
                np.testing.assert_allclose(
                    g, w, rtol=2e-4, atol=2e-4,
                    err_msg=f"step {step} sizes={SIZES[i]} rank {r}")


def test_refusals():
    """MoE layers take the reference's specs (router replicated, experts
    over "expert"), dense layers keep the MLP over "model"; a tree mixing
    the two is refused."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    params = llama.init_weights(TCFG, seed=0, device="cpu")
    dense = full.full_param_specs(params)["layers"][1]
    assert dense["w_gate"] == ("model",) and dense["w_down"] == (None, "model")
    moe_layer = dict(params["layers"][0], router=torch.zeros(4, 256))
    moe = full.full_param_specs(dict(params, layers=[moe_layer]))
    assert moe["layers"][1]["router"] == ()
    for key in ("w_gate", "w_up", "w_down"):
        assert moe["layers"][1][key] == ("expert",)
    assert moe["layers"][1]["wq"] == ("model",)
    with pytest.raises(ValueError, match="mixing"):
        full.full_param_specs(dict(params, layers=[moe_layer,
                                                   params["layers"][1]]))


def _jax_full_prefill(params, cfg, prompt, sizes):
    import jax.numpy as jnp
    from ggml_cuda_experiments_tpu.parallel import full as jfull
    mesh = jfull.make_full_mesh(int(np.prod(list(sizes.values()))), sizes)
    sp, ps = jfull.shard_full_params(params, mesh, cfg)
    pre = jfull.make_full_step(cfg, mesh, ps, n_micro=2, prefill_len=T,
                               decode=False)
    got, _ = pre(sp, prompt, jfull.create_full_cache(
        cfg, mesh, B, S, dtype=jnp.float32))
    return np.asarray(got)


def test_reference_faults_the_port_does_not_inherit():
    """The JAX 5-axis step on a DENSE model at model = 2: (1) every model
    rank runs the whole MLP and ``_mlp_block`` psums it, so the result is
    the single-device model with the MLP output doubled; (2) a fused
    ``wqkv`` is cut into contiguous row blocks (rank 0 all of q, rank 1
    k and v), so the fused model differs from the unfused one. The port
    (test_full_step_matches_single) equals the single-device model."""
    import jax.numpy as jnp
    from ggml_cuda_experiments_tpu.models import llama as jl
    from ggml_cuda_experiments_tpu.models.config import ModelConfig
    cfg = ModelConfig(**dataclasses.asdict(TCFG))
    params = jl.init_weights(cfg, seed=0, dtype=jnp.float32)
    prompt = jnp.asarray(np.random.default_rng(1234).integers(
        0, cfg.vocab_size, (B, T)), jnp.int32)
    sizes = SIZES[1]
    got = _jax_full_prefill(params, cfg, prompt, sizes)
    want, _ = jl.prefill(params, cfg, prompt,
                         jl.KVCache.create(cfg, B, S, dtype=jnp.float32))
    want = np.asarray(want)
    assert np.abs(got - want).max() > 0.1 * np.abs(want).max()
    doubled = dict(params, layers=[dict(lay, w_down=lay["w_down"] * 2)
                                   for lay in params["layers"]])
    want2, _ = jl.prefill(doubled, cfg, prompt,
                          jl.KVCache.create(cfg, B, S, dtype=jnp.float32))
    np.testing.assert_allclose(got, np.asarray(want2), rtol=2e-4, atol=2e-4)
    fused = dict(params, layers=[
        {**{k: v for k, v in lay.items() if k not in ("wq", "wk", "wv")},
         "wqkv": jnp.concatenate([lay["wq"], lay["wk"], lay["wv"]])}
        for lay in params["layers"]])
    got_f = _jax_full_prefill(fused, cfg, prompt, sizes)
    assert np.abs(got_f - got).max() > 0.1 * np.abs(got).max()
