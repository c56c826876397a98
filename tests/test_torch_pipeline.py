"""Pipeline parallelism over 2 gloo ranks (stages) on the CPU: the port's
``make_pp_step`` / ``pp_forward`` against the single-device model, as
tests/test_pipeline.py holds the JAX pipeline: the debug preset at 4
layers, batch 4, prefill logits within 2e-2 (elementwise, rtol = atol,
that test's form) of the port's single-device ``prefill`` at 1, 2 and 4
microbatches and each stage's cache layers within 2e-2 * max|k| (a
microbatch of one row takes other f32 matmul blocking than the whole
batch: one bf16 key in 131072 lands 1.4e-3 past the elementwise form at 4
microbatches), lengths equal; 3 greedy decode
steps at 2 microbatches with tokens equal to the single-device greedy
tokens. Every output is also held against the JAX single-device model at
the port's model bound against JAX, 2e-2 * max|ref| (bf16 sums in another
order part the two implementations by up to ~1.5% of max elementwise, on
one device too), and the greedy tokens equal JAX's. ``test_pp_moe_compose``
is in tests/test_torch_moe_parallel.py. One ``run_spmd`` computes every
port case; no jax at the top of this module (the ranks import it)."""

import dataclasses

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.models import convert, llama
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
from ggml_cuda_experiments_tpu_torch.parallel import pipeline
from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd

TCFG = dataclasses.replace(PRESETS["debug"], n_layers=4)
B, T, S = 4, 8, 64


def _rank(np_pre, prompt_pre, np_dec, prompt_dec):
    mesh = pm.Mesh(np.arange(2), ("pipe",))
    out = {"stage": pm.axis_index(mesh, "pipe")}
    t = torch.from_numpy
    params = convert.params_from_jax(np_pre, TCFG, device="cpu")
    cache = llama.KVCache.create(TCFG, B, S, device="cpu")
    logits, cache = llama.prefill(params, TCFG, t(prompt_pre), cache)
    out["single"] = (logits, cache.k)
    for n_micro in (1, 2, 4):
        sp, step = pipeline.make_pp_step(
            TCFG, mesh, pipeline.stack_layers(params), n_micro=n_micro,
            decode=False)
        cache = pipeline.shard_cache_pp(
            llama.KVCache.create(TCFG, B, S, device="cpu"), mesh)
        logits, cache = step(sp, t(prompt_pre), cache)
        out[f"prefill_{n_micro}"] = (logits, cache.k, cache.lengths)
    # prefill + 3 greedy decode steps at 2 microbatches
    params = convert.params_from_jax(np_dec, TCFG, device="cpu")
    stacked = pipeline.stack_layers(params)
    sp, pre = pipeline.make_pp_step(TCFG, mesh, stacked, n_micro=2,
                                    decode=False)
    _, dec = pipeline.make_pp_step(TCFG, mesh, stacked, n_micro=2,
                                   decode=True)
    cache = pipeline.shard_cache_pp(
        llama.KVCache.create(TCFG, B, S, device="cpu"), mesh)
    logits, cache = pre(sp, t(prompt_dec), cache)
    toks, steps = [], []
    tok = torch.argmax(logits, -1)
    for _ in range(3):
        toks.append(tok)
        logits, cache = dec(sp, tok[:, None], cache)
        steps.append(logits)
        tok = torch.argmax(logits, -1)
    out["decode"] = (torch.stack(toks), torch.stack(steps))
    cache = llama.KVCache.create(TCFG, B, S, device="cpu")
    logits, cache = llama.prefill(params, TCFG, t(prompt_dec), cache)
    toks = []
    for _ in range(3):
        toks.append(torch.argmax(logits, -1))
        logits, cache = llama.decode_step(params, TCFG, toks[-1], cache)
    out["single_toks"] = torch.stack(toks)
    return out


@pytest.fixture(scope="module")
def ranks():
    import jax
    import jax.numpy as jnp
    from ggml_cuda_experiments_tpu.models import llama as jl
    from ggml_cuda_experiments_tpu.models.config import ModelConfig
    cfg = ModelConfig(**dataclasses.asdict(TCFG))
    rng = np.random.default_rng(1234)
    to_np = lambda p: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), p)
    # the JAX test's prefill case (seed 0) and decode case (seed 1)
    p0 = jl.init_weights(cfg, seed=0)
    prompt0 = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int64)
    want, want_cache = jl.prefill(p0, cfg, jnp.asarray(prompt0, jnp.int32),
                                  jl.KVCache.create(cfg, B, S))
    p1 = jl.init_weights(cfg, seed=1)
    prompt1 = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int64)
    cache = jl.KVCache.create(cfg, B, S)
    logits, cache = jl.prefill(p1, cfg, jnp.asarray(prompt1, jnp.int32),
                               cache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want_toks, want_logits = [], []
    for _ in range(3):
        want_toks.append(np.asarray(tok))
        logits, cache = jl.decode_step(p1, cfg, tok, cache)
        want_logits.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    ref = dict(prefill=np.asarray(want),
               cache_k=np.asarray(want_cache.k.astype(jnp.float32)),
               lengths=np.asarray(want_cache.lengths),
               toks=np.stack(want_toks), logits=np.stack(want_logits))
    return ref, run_spmd(_rank, 2, "gloo", "cpu", timeout=300,
                         args=(to_np(p0), prompt0, to_np(p1), prompt1))


def _near(got, want, tol=2e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pp_prefill_matches_single(ranks, n_micro):
    ref, outs = ranks
    single, single_k = outs[0]["single"]
    for o in outs:
        logits, k, lengths = o[f"prefill_{n_micro}"]
        np.testing.assert_allclose(logits.numpy(), single.numpy(),
                                   rtol=2e-2, atol=2e-2)
        _near(logits, ref["prefill"])
        np.testing.assert_array_equal(lengths.numpy(), ref["lengths"])
    # the stages' cache layers concatenate to the single-device cache
    k = torch.cat([o[f"prefill_{n_micro}"][1] for o in outs], 0).float()
    _near(k, single_k.float())
    _near(k, ref["cache_k"])


def test_pp_decode_matches_single(ranks):
    ref, outs = ranks
    for o in outs:
        toks, logits = o["decode"]
        np.testing.assert_array_equal(toks.numpy(),
                                      o["single_toks"].numpy())
        np.testing.assert_array_equal(toks.numpy(), ref["toks"])
        _near(logits, ref["logits"])
    assert [o["stage"] for o in outs] == [0, 1]
