"""Collective matmul over 8 gloo ranks on the CPU: the port's ``matmul_ag``,
``matmul_rs`` and ``sp_mlp_block`` against the plain products, the
monolithic collectives and the JAX functions under ``shard_map`` on the 8
virtual devices of tests/conftest.py, at tests/test_collective_matmul.py's
shapes and tolerances (1e-4 to 1e-6; 1e-5 where a torch product meets an
XLA one); and tests/test_multidevice_reduce.py's range-sharded sum of 8M
elements, psum'd against the host (rel 1e-5) and against the host merge
of the ranks' partials (1e-6). One ``run_spmd`` computes every port case.
No jax at the top of this module: the ranks import it."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ggml_cuda_experiments_tpu_torch.parallel import collective_matmul as cm
from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd

B, K, N = 32, 64, 48          # per rank Bs = 4, N_loc = 6
R = 8
N_SUM = 1 << 23               # the reduction test's 8M elements


def _sum_data():
    return np.random.default_rng(7).random(N_SUM).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(1234)
    x = rng.normal(size=(B, K)).astype(np.float32)
    w = rng.normal(size=(N, K)).astype(np.float32)
    d, inter, t = 32, 64, 16
    mlp = [rng.normal(size=(t, d)),
           rng.normal(size=(inter, d)) / np.sqrt(d),
           rng.normal(size=(inter, d)) / np.sqrt(d),
           rng.normal(size=(d, inter)) / np.sqrt(inter)]
    mlp = [a.astype(np.float32) for a in mlp]
    return x, w, mlp


def _rank(x, w, mlp):
    mesh = pm.Mesh(np.arange(R), ("model",))
    i = pm.axis_index(mesh, "model")
    t = torch.from_numpy

    def rows(a):
        n = a.shape[0] // R
        return t(a[i * n:(i + 1) * n].copy())

    def cols(a):
        n = a.shape[1] // R
        return t(a[:, i * n:(i + 1) * n].copy())

    out = {"ag": cm.matmul_ag(rows(x), rows(w), mesh, "model"),
           "rs": cm.matmul_rs(cols(x), cols(w), mesh, "model")}
    xg = pm.all_gather(rows(x), mesh, "model", dim=0, tiled=True)
    out["ag_mono"] = xg @ rows(w).T
    part = cols(x) @ cols(w).T
    out["rs_mono"] = pm.psum(part, mesh, "model")[i * 4:(i + 1) * 4]
    xs, wg, wu, wd = mlp
    out["sp"] = cm.sp_mlp_block(rows(xs), rows(wg), rows(wu), cols(wd),
                                mesh, "model")
    g, u = t(xs) @ rows(wg).T, t(xs) @ rows(wu).T
    out["rep"] = pm.psum((F.silu(g) * u) @ cols(wd).T, mesh, "model")
    # the range-sharded sum: this rank's partial, and its psum
    part = t(rows(_sum_data()).numpy().sum(keepdims=True))
    out["partial"] = part
    out["psum_total"] = pm.psum(part, mesh, "model")
    return out


@pytest.fixture(scope="module")
def ranks():
    x, w, mlp = _inputs()
    return (x, w, mlp), run_spmd(_rank, R, "gloo", "cpu", timeout=240,
                                 args=(x, w, mlp))


def _jax_ring(fn, in_specs, out_spec, *arrays):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()), ("model",))
    f = jax.jit(functools.partial(
        jax.shard_map, mesh=mesh, in_specs=tuple(P(*s) for s in in_specs),
        out_specs=P(*out_spec))(fn))
    return np.asarray(f(*arrays))


def _cat(outs, key):
    return torch.cat([o[key] for o in outs], 0).numpy()


def test_matmul_ag_matches_gather_then_dot(ranks):
    (x, w, _), outs = ranks
    got = torch.cat([o["ag"] for o in outs], 1).numpy()   # N_loc columns
    np.testing.assert_allclose(got, x @ w.T, rtol=1e-5, atol=1e-5)


def test_matmul_ag_vs_monolithic_allgather(ranks):
    _, outs = ranks
    for o in outs:
        np.testing.assert_allclose(o["ag"].numpy(), o["ag_mono"].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_matmul_ag_vs_jax_ring(ranks):
    from ggml_cuda_experiments_tpu.parallel import collective_matmul as jcm
    (x, w, _), outs = ranks
    want = _jax_ring(lambda xs, ws: jcm.matmul_ag(xs, ws, "model"),
                     [("model",), ("model",)], (None, "model"), x, w)
    got = torch.cat([o["ag"] for o in outs], 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_matmul_rs_matches_dot_then_reduce(ranks):
    (x, w, _), outs = ranks
    np.testing.assert_allclose(_cat(outs, "rs"), x @ w.T, rtol=1e-4,
                               atol=1e-4)


def test_matmul_rs_vs_monolithic_psum_scatter(ranks):
    (x, w, _), outs = ranks
    np.testing.assert_allclose(_cat(outs, "rs"), _cat(outs, "rs_mono"),
                               rtol=1e-5, atol=1e-5)


def test_matmul_rs_vs_jax_ring(ranks):
    from ggml_cuda_experiments_tpu.parallel import collective_matmul as jcm
    (x, w, _), outs = ranks
    want = _jax_ring(lambda xs, ws: jcm.matmul_rs(xs, ws, "model"),
                     [(None, "model"), (None, "model")], ("model", None),
                     x, w)
    np.testing.assert_allclose(_cat(outs, "rs"), want, rtol=1e-5,
                               atol=1e-5)


def test_sp_mlp_matches_replicated_psum(ranks):
    (_, _, mlp), outs = ranks
    np.testing.assert_allclose(_cat(outs, "sp"), outs[0]["rep"].numpy(),
                               rtol=2e-5, atol=2e-5)


def test_sp_mlp_vs_jax(ranks):
    from ggml_cuda_experiments_tpu.parallel import collective_matmul as jcm
    (_, _, mlp), outs = ranks
    want = _jax_ring(
        lambda xs, a, b, c: jcm.sp_mlp_block(xs, a, b, c, "model"),
        [("model",), ("model", None), ("model", None), (None, "model")],
        ("model",), *mlp)
    np.testing.assert_allclose(_cat(outs, "sp"), want, rtol=2e-5,
                               atol=2e-5)


def test_psum_reduction_matches_host(ranks):
    _, outs = ranks
    want = float(np.sum(_sum_data(), dtype=np.float64))
    for o in outs:
        got = float(o["psum_total"][0])
        assert abs(got - want) / abs(want) < 1e-5


def test_host_merge_agrees_with_collective(ranks):
    _, outs = ranks
    per_rank = np.array([float(o["partial"][0]) for o in outs])
    assert per_rank.shape == (R,)
    host_merged = float(per_rank.sum(dtype=np.float64))
    np.testing.assert_allclose(float(outs[0]["psum_total"][0]), host_merged,
                               rtol=1e-6)
