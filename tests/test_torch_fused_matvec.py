"""The port's int8-activation matvec and fused MLP (plain versions, on the
CPU) against the JAX package's ``qmatmul(x_quant8=True)`` and
``mlp_fused`` (Pallas, interpret mode); and the port's own copies of what
it used to import from the JAX package.

Tolerances: the activation operands are bit-equal (same arithmetic); the
matvec 1e-3 * max (both quantize identically, only the f32 fold order
differs); the fused MLP 5e-3 * max (the JAX package's bound for its fused
kernels: an f32 ulp in the mid before its int8 quantization may move one
step)."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models.config import PRESETS as JPRESETS
from ggml_cuda_experiments_tpu.oracle import quant as jref
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.oracle import quant as tref
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm

REPO = Path(__file__).resolve().parents[1]


def _w(seed, n, k, scale=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k)) * (scale or k ** -0.5)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(64, 1024), (8, 4096)])
def test_oracle_copy_bit_equal(shape):
    w = _w(0, *shape)
    w[0, :64] = 0.0                       # a zero block: the np_div rule
    w[1, :256] = 0.25                     # a constant superblock
    a, b = jref.quantize_q4_k(w), tref.quantize_q4_k(w)
    for f in ("qs", "sc", "mn", "d", "dmin"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.shape == b.shape
    assert np.array_equal(jref.dequantize_q4_k(a), tref.dequantize_q4_k(b))


def test_from_oracle_takes_either_oracle():
    w = _w(1, 32, 512)
    a = tqm.from_oracle(jref.quantize_q4_k(w), device="cpu")
    b = tqm.from_oracle(tref.quantize_q4_k(w), device="cpu")
    for f in ("qs", "es", "em"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_config_copy_matches():
    assert set(PRESETS) == set(JPRESETS)
    for name, cfg in PRESETS.items():
        assert vars(cfg) == vars(JPRESETS[name]), name


@pytest.mark.parametrize("k", [4096, 12288])
def test_activation_operands_bit_equal(k):
    """quantize_activations_q8 against the JAX dispatch's per-block
    operands (device byte-lane order mapped back to logical blocks)."""
    x = np.random.default_rng(2).normal(size=(1, k)).astype(np.float32)
    x[0, 32:64] = 0.0                     # an all-zero block: scale 1
    xp = np.asarray(jqm.permute_activations(jnp.asarray(x)))[0]
    kb, kh, segs = k // 32, k // 2, jqm._n_segs(k)
    xl, xh = jnp.asarray(xp[:kh]), jnp.asarray(xp[kh:])
    aq, sa = jqm._quant_rows_blockwise(xl - xh / 16.0, kb, segs)
    bq, sb = jqm._quant_rows_blockwise(xh / 16.0, kb, segs)
    # byte lane j of block beta: (t, beta) with the blocks in perm32 order
    if segs > 1:
        lanes = np.asarray(aq).reshape(segs, 16, 128).transpose(0, 2, 1)
        blanes = np.asarray(bq).reshape(segs, 16, 128).transpose(0, 2, 1)
        lanes, blanes = lanes.reshape(kb, 16), blanes.reshape(kb, 16)
    else:
        lanes = np.asarray(aq).reshape(16, kb).T
        blanes = np.asarray(bq).reshape(16, kb).T
    order = np.argsort(jqm._perm32(k))
    got_a, got_b, sc = tqm.quantize_activations_q8(torch.from_numpy(x))
    assert np.array_equal(got_a.numpy(), lanes[order])
    assert np.array_equal(got_b.numpy(), blanes[order])
    assert np.array_equal(sc[2].numpy(), np.asarray(sa)[order])
    assert np.array_equal(sc[3].numpy(), np.asarray(sb)[order])


@pytest.mark.parametrize("k", [4096, 12288])
def test_q8_matvec_matches_jax(k):
    t = jref.quantize_q4_k(_w(3, 640, k))
    x = np.random.default_rng(4).normal(size=(1, k)).astype(np.float32)
    want = jqm.qmatmul(jnp.asarray(x), jqm.from_oracle(t), use_vpu=True,
                       x_quant8=True)
    got = tqm.qmatmul(torch.from_numpy(x), tqm.from_oracle(t, device="cpu"),
                      x_quant8=True)
    assert _rel(got.numpy(), want) < 1e-3


@pytest.mark.parametrize("k,rows", [(2048, 1), (4096, 3)])
def test_q8_gate_keeps_the_exact_route(k, rows):
    """Outside the reference's gate (K/32 % 128, B == 1) x_quant8 changes
    nothing: the exact matvec or the GEMM run, as in the JAX package."""
    ql = tqm.from_oracle(jref.quantize_q4_k(_w(5, 96, k)), device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(rows, k)).astype(np.float32))
    assert torch.equal(tqm.qmatmul(x, ql, x_quant8=True), tqm.qmatmul(x, ql))
    assert tqm.q8_matvec_supported(ql) == (k % 4096 == 0)


@pytest.mark.parametrize("kd", [4096, 8192])
def test_mlp_fused_matches_jax(kd):
    kg, nd = 4096, 256
    wg, wu, wd = _w(7, kd, kg, 1 / 64), _w(8, kd, kg, 1 / 64), _w(9, nd, kd,
                                                                   1 / 64)
    jgu = jqm.quantize(jqm.reorder_gu_rows(wg, wu), "q4_k")
    jd = jqm.quantize(wd, "q4_k")
    tgu = tqm.quantize(torch.from_numpy(np.concatenate([wg, wu])))
    td = tqm.quantize(torch.from_numpy(wd))
    assert jqm.mlp_fused_supported(jgu, jd) and tqm.mlp_fused_supported(tgu,
                                                                        td)
    x = np.random.default_rng(10).normal(size=(1, kg)).astype(np.float32)
    want = jqm.mlp_fused(jqm.permute_activations(jnp.asarray(x)), jgu, jd)
    got = tqm.mlp_fused(torch.from_numpy(x), tgu, td)
    assert got.shape == (1, nd)
    assert _rel(got.numpy(), want) < 5e-3


def test_mlp_fused_gate():
    def ql(n, k):
        qs = torch.empty(n, k // 2, dtype=torch.uint8)
        es = torch.empty(n, k // 32, dtype=torch.bfloat16)
        return tqm.QuantLinear("q4_k", (n, k), qs, es, es)
    assert tqm.mlp_fused_supported(ql(24576, 4096), ql(4096, 12288))
    assert not tqm.mlp_fused_supported(ql(24576, 8192), ql(8192, 12288))
    assert not tqm.mlp_fused_supported(ql(22016, 4096), ql(4096, 11008))
    assert not tqm.mlp_fused_supported(ql(24576, 4096), torch.zeros(1))


def _run(args, **env):
    return subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **env})


def test_port_imports_nothing_of_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import importlib, pkgutil, ggml_cuda_experiments_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = [m for m in sys.modules if m == 'ggml_cuda_experiments_tpu' "
        "or m.startswith('ggml_cuda_experiments_tpu.') or m == 'jax']\n"
        "assert not bad, bad\n"
        "assert 'ggml_cuda_experiments_tpu_torch.ops.layer_kernel' in mods\n"
        "print('imported', len(mods))\n")
    r = _run([sys.executable, "-I", "-c", code, str(REPO)])
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout


def test_entry_points_take_the_card_by_default():
    """Without a device argument the entry points build on the card, so
    without one they raise (require_cuda) instead of falling to the CPU."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from ggml_cuda_experiments_tpu_torch.models import llama, engine\n"
        "from ggml_cuda_experiments_tpu_torch.models.config import PRESETS\n"
        "from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm\n"
        "from ggml_cuda_experiments_tpu_torch.oracle import quant\n"
        "import numpy as np\n"
        "cfg = PRESETS['debug']\n"
        "t = quant.quantize_q4_k(np.zeros((8, 256), np.float32))\n"
        "calls = [lambda: llama.init_weights(cfg),\n"
        "         lambda: llama.KVCache.create(cfg, 1, 64),\n"
        "         lambda: engine.PagedKVPool.create(cfg, 4, 16),\n"
        "         lambda: qm.from_oracle(t)]\n"
        "for c in calls:\n"
        "    try:\n"
        "        c()\n"
        "    except RuntimeError as e:\n"
        "        assert 'is_available() is False' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('built without a card')\n"
        "assert llama.KVCache.create(cfg, 1, 64, device='cpu').k.is_cpu\n"
        "print('ok')\n")
    r = _run([sys.executable, "-I", "-c", code, str(REPO)],
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr
    assert "ok" in r.stdout
