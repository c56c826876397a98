"""Tensor + data parallelism over 4 gloo ranks on the CPU, a (data=2,
model=2) mesh: the port's ``make_tp_step`` prefill and decode against the
JAX single-device ``prefill`` / ``decode_step`` at tests/test_tp.py's
tolerance (5e-2): the debug preset dense (bf16), in q8_0 (the port's
``quantize_params_sharded`` against the JAX package's globally encoded
``quantize_params``), and in q4_k on a debug-like shape whose row-parallel
K-shards are whole 256-blocks (dim 512, heads 8/4: wo's K-shard 256).
The decode steps take the JAX prefill's argmax. One ``run_spmd`` computes
every port case; no jax at the top of this module (the ranks import it)."""

import dataclasses

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models.config import (
    PRESETS as TPRESETS)
from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
from ggml_cuda_experiments_tpu_torch.parallel import tp
from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd

TCFG = TPRESETS["debug"]            # 4 q heads, 2 kv heads, dim 256
TCFG4 = dataclasses.replace(TCFG, name="debug-q4k", dim=512, n_heads=8,
                            n_kv_heads=4, intermediate=1024)


def _cfg_jax(tcfg):
    from ggml_cuda_experiments_tpu.models.config import ModelConfig
    return ModelConfig(**dataclasses.asdict(tcfg))


def _run_case(cfg, np_params, fmt, toks, next_tok):
    """Prefill then one decode step through make_tp_step on this rank."""
    mesh = pm.make_mesh(model=2, data=2)
    params = convert.params_from_jax(np_params, cfg, device="cpu")
    if fmt:
        params = tp.quantize_params_sharded(params, fmt, n_model=2)
    sparams = tp.shard_params(params, mesh)
    cache = tp.create_sharded_cache(cfg, mesh, toks.shape[0], 256,
                                    device="cpu")
    pre = tp.make_tp_step(cfg, mesh, sparams, decode=False)
    dec = tp.make_tp_step(cfg, mesh, sparams, decode=True)
    lp, cache = pre(sparams, torch.from_numpy(toks), cache)
    lengths = cache.lengths.clone()
    ld, cache = dec(sparams, torch.from_numpy(next_tok), cache)
    return {"prefill": lp, "decode": ld, "lengths": lengths,
            "cache_lengths": cache.lengths, "cache_k": cache.k.shape}


def _rank(cases):
    mesh = pm.make_mesh(model=2, data=2)
    out = {"shape": dict(mesh.shape), "axes": mesh.axis_names,
           "coords": dict(mesh.coords)}
    for name, (cfg, np_params, fmt, toks, nxt) in cases.items():
        out[name] = _run_case(cfg, np_params, fmt, toks, nxt)
    return out


def _jax_case(cfg_t, seed, fmt, rng):
    """(numpy params, tokens, JAX prefill logits, next tokens, JAX decode
    logits) on the single device."""
    import jax
    import jax.numpy as jnp
    from ggml_cuda_experiments_tpu.models import llama
    cfg = _cfg_jax(cfg_t)
    params = llama.init_weights(cfg, seed=seed)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 8)).astype(np.int32)
    jp = llama.quantize_params(params, fmt) if fmt else params
    cache = llama.KVCache.create(cfg, 2, 256)
    lp, cache = llama.prefill(jp, cfg, jnp.asarray(toks), cache)
    nxt = jnp.argmax(lp, -1).astype(jnp.int32)
    ld, _ = llama.decode_step(jp, cfg, nxt, cache)
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       params)
    return (np_params, toks.astype(np.int64), np.asarray(lp),
            np.asarray(nxt).astype(np.int64), np.asarray(ld))


@pytest.fixture(scope="module")
def ranks():
    rng = np.random.default_rng(1234)
    jax_side = {"dense": _jax_case(TCFG, 5, None, rng),
                "q8_0": _jax_case(TCFG, 5, "q8_0", rng),
                "q4_k": _jax_case(TCFG4, 7, "q4_k", rng)}
    cases = {name: ((TCFG4 if name == "q4_k" else TCFG), j[0],
                    None if name == "dense" else name, j[1], j[3])
             for name, j in jax_side.items()}
    return jax_side, run_spmd(_rank, 4, "gloo", "cpu", timeout=300,
                              args=(cases,))


def _close(got, want, tol=5e-2):
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_mesh_construction(ranks):
    _, outs = ranks
    for r, o in enumerate(outs):
        assert o["shape"] == {"data": 2, "model": 2}
        assert o["axes"] == ("data", "model")
        assert o["coords"] == {"data": r // 2, "model": r % 2}


@pytest.mark.parametrize("case", ["dense", "q8_0", "q4_k"])
def test_tp_prefill_matches_single(ranks, case):
    jax_side, outs = ranks
    for o in outs:                  # the whole logits on every rank
        _close(o[case]["prefill"], jax_side[case][2])
        assert o[case]["lengths"].tolist() == [8]   # the rank's data row


@pytest.mark.parametrize("case", ["dense", "q8_0", "q4_k"])
def test_tp_decode_matches_single(ranks, case):
    jax_side, outs = ranks
    for o in outs:
        _close(o[case]["decode"], jax_side[case][4])
        assert o[case]["cache_lengths"].tolist() == [9]


def test_tp_cache_is_the_ranks_shard(ranks):
    _, outs = ranks
    # [L, B / data, Hkv / model, S, D]
    assert outs[0]["dense"]["cache_k"] == (2, 1, 1, 256, 64)
    assert outs[0]["q4_k"]["cache_k"] == (2, 1, 2, 256, 64)


def test_local_config_divisibility():
    with pytest.raises(ValueError):
        tp.local_config(TCFG, 3)
    lc = tp.local_config(TCFG, 2)
    assert lc.n_heads == 2 and lc.n_kv_heads == 1


def test_fused_projections_refused():
    from ggml_cuda_experiments_tpu_torch.models import llama
    params = llama.init_weights(TCFG, seed=0, device="cpu")
    fused = llama.quantize_params(params, "q8_0", fuse=True)
    with pytest.raises(ValueError, match="fused"):
        tp.param_specs(fused)


def test_quant_shards_are_block_slices():
    """A row-parallel K-slice of a logical-order QuantLinear is a valid
    QuantLinear whose product is that K-slice's (nothing re-encoded), and
    quantize_params_sharded pads the intermediate to QK_K * n_model."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    w = torch.randn(64, 1024, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 1024, generator=torch.Generator().manual_seed(1))
    for fmt in ("q4_k", "q8_0", "q4_0"):
        ql = qm.quantize(w, fmt)
        whole = qm.qmatmul_ref(x, ql)
        parts = [qm.qmatmul_ref(x[:, i * 512:(i + 1) * 512],
                                tp.shard_quant_linear(ql, i, 2))
                 for i in range(2)]
        assert torch.allclose(parts[0] + parts[1], whole, atol=1e-4)
    with pytest.raises(ValueError, match="block"):
        tp.shard_quant_linear(qm.quantize(w[:, :768], "q4_k"), 0, 2)
    params = llama.init_weights(TCFG, seed=0, device="cpu")
    q = tp.quantize_params_sharded(params, "q4_0", 4)
    assert q["layers"][0]["w_gate"].shape == (1024, 256)     # 512 -> 1024
    assert q["layers"][0]["w_down"].shape == (256, 1024)
