"""Context parallelism over gloo ranks on the CPU: the port's
``ring_attention`` (causal and not), ``ulysses_attention``,
``decode_context_parallel`` and ``lse_combine_axis`` against the JAX
single-device kernels they must equal (as tests/test_ring_attention.py
holds the JAX ring), at that test's shapes and tolerance 2e-3; and the
mesh collectives (psum, pmax, ppermute, all_gather, all_to_all) on known
values.

One ``run_spmd`` of 4 ranks computes every case (the module fixture); the
JAX side runs in this process, Pallas interpreted. This module imports no
jax at the top: the ranks import it to find their function, and must stay
jax-free (asserted)."""

import sys

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.ops import lse as tlse
from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
from ggml_cuda_experiments_tpu_torch.parallel import ring_attention as ra
from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd

N = 4


def _inputs():
    rng = np.random.default_rng(1234)
    ring = [rng.normal(size=(1, 4, 512, 64)).astype(np.float32)
            for _ in range(3)]
    uly = [rng.normal(size=(1, 8, 512, 64)).astype(np.float32)
           for _ in range(3)]
    dec = [rng.normal(size=(2, 8, 64)).astype(np.float32)] + [
        rng.normal(size=(2, 4, 1024, 64)).astype(np.float32)
        for _ in range(2)]
    lengths = np.array([300, 1024], np.int32)  # sequence 0 in shards 0-1
    parts = [rng.normal(size=(N, 3, 5, 16)).astype(np.float32),
             rng.normal(size=(N, 3, 5, 1)).astype(np.float32),
             rng.uniform(0.5, 2.0, size=(N, 3, 5, 1)).astype(np.float32)]
    parts[1][1] = -np.inf                 # rank 1 holds no key: identity
    parts[2][1] = 0.0
    parts[0][1] = 0.0
    return dict(ring=ring, uly=uly, dec=dec, lengths=lengths, parts=parts)


def _rank(inp):
    """Every port case on this rank; returns its shards and results."""
    mesh = pm.Mesh(np.arange(N), ("ctx",))
    me = pm.axis_index(mesh, "ctx")
    t = torch.from_numpy
    out = {}
    s_loc = 512 // N
    sl = slice(me * s_loc, (me + 1) * s_loc)
    for causal in (False, True):
        q, k, v = (t(a[:, :, sl].copy()) for a in inp["ring"])
        out[f"ring_{causal}"] = ra.ring_attention(q, k, v, mesh, "ctx",
                                                  causal=causal)
        q, k, v = (t(a[:, :, sl].copy()) for a in inp["uly"])
        out[f"ulysses_{causal}"] = ra.ulysses_attention(q, k, v, mesh, "ctx",
                                                        causal=causal)
    q, k, v = inp["dec"]
    d_loc = 1024 // N
    ds = slice(me * d_loc, (me + 1) * d_loc)
    lens = np.clip(inp["lengths"] - me * d_loc, 0, d_loc).astype(np.int32)
    out["decode"] = ra.decode_context_parallel(
        t(q), t(k[:, :, ds].copy()), t(v[:, :, ds].copy()), t(lens), mesh,
        "ctx", kv_splits=2)
    o, m, s = (t(a[me]) for a in inp["parts"])
    out["combine"] = tlse.lse_combine_axis(tlse.AttnPartial(o, m, s), mesh,
                                           "ctx")
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * me
    out["psum"] = pm.psum(x.to(torch.bfloat16), mesh, "ctx")
    out["pmax"] = pm.pmax(x, mesh, "ctx")
    out["ppermute"] = pm.ppermute(x, mesh, "ctx", [(0, 1), (1, 2), (2, 3)])
    out["all_gather"] = pm.all_gather(x, mesh, "ctx", dim=1, tiled=True)
    out["all_to_all"] = pm.all_to_all(x.reshape(3, 4, 1).expand(3, 4, 4),
                                      mesh, "ctx", 1, 2)
    out["jax_loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib")
                               or m.split(".")[0] ==
                               "ggml_cuda_experiments_tpu")
    return out


@pytest.fixture(scope="module")
def ranks():
    inp = _inputs()
    return inp, run_spmd(_rank, N, "gloo", "cpu", timeout=240, args=(inp,))


def _close(got, want, tol=2e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{err} > {tol} * {scale}"


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_single(ranks, causal):
    from ggml_cuda_experiments_tpu.ops.flash_attention import flash_attention
    import jax.numpy as jnp
    inp, outs = ranks
    want = flash_attention(*map(jnp.asarray, inp["ring"]), causal=causal)
    got = torch.cat([o[f"ring_{causal}"] for o in outs], dim=2)
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_single(ranks, causal):
    from ggml_cuda_experiments_tpu.ops.flash_attention import flash_attention
    import jax.numpy as jnp
    inp, outs = ranks
    want = flash_attention(*map(jnp.asarray, inp["uly"]), causal=causal)
    got = torch.cat([o[f"ulysses_{causal}"] for o in outs], dim=2)
    _close(got, want)


def test_decode_context_parallel_matches_single(ranks):
    from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
    import jax.numpy as jnp
    inp, outs = ranks
    want = flash_decode(*map(jnp.asarray, inp["dec"]),
                        jnp.asarray(inp["lengths"]))
    for o in outs:                        # the same on every rank
        _close(o["decode"], want)
    assert all(torch.equal(o["decode"], outs[0]["decode"]) for o in outs)


def test_lse_combine_axis_matches_jax_fold(ranks):
    """The pmax + psum merge of four ranks' partials (one the identity)
    against the JAX package's lse_combine_stacked over the same four."""
    from ggml_cuda_experiments_tpu.ops.lse import (
        AttnPartial, lse_combine_stacked)
    import jax.numpy as jnp
    inp, outs = ranks
    want = lse_combine_stacked(AttnPartial(*map(jnp.asarray, inp["parts"])))
    for o in outs:
        for got, w in zip(o["combine"], want):
            _close(got, w, tol=1e-5)


def test_mesh_collectives(ranks):
    _, outs = ranks
    xs = [torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * r
          for r in range(N)]
    for r, o in enumerate(outs):
        assert o["psum"].dtype == torch.bfloat16
        assert torch.equal(o["psum"].float(), sum(xs).to(torch.bfloat16)
                           .float())
        assert torch.equal(o["pmax"], xs[-1])
        # (0,1),(1,2),(2,3): rank 0 is no destination and gets zeros
        want = xs[r - 1] if r else torch.zeros_like(xs[0])
        assert torch.equal(o["ppermute"], want)
        assert torch.equal(o["all_gather"], torch.cat(xs, dim=1))
        # block j of dim 1 to rank j; received blocks joined along dim 2
        want = torch.stack([xs[j][:, r:r + 1].expand(3, 4)
                            for j in range(N)], 0)
        assert torch.equal(o["all_to_all"],
                           want.permute(1, 0, 2).reshape(3, 1, 16))


def test_ranks_import_no_jax(ranks):
    _, outs = ranks
    assert all(o["jax_loaded"] == [] for o in outs), outs[0]["jax_loaded"]
