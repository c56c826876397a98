"""The q4_k stage ladder (``ops/probes.py``: its plain versions on the CPU)
against the JAX package's probe kernels in interpret mode, loaded from the
JAX tools as they are (``tools/exp_q4.py``, ``tools/exp_q4_r2.py``), at
512 rows and K = 4096.

The JAX tools parse ``sys.argv`` and set JAX's config when imported, so
they are loaded with ``--cpu`` as their argv and the compilation cache put
back at once (nothing is written into the checkout). ``exp_q4.pack_xor8``
is stale against the JAX package, which now stores q4_k bytes already
XOR-8 packed as int8 (``qs ^ 0x80`` overflows int8): the tests give it the
stored bytes, as the tool's own fix would.

Both sides get the same weight and x: JAX its interleaved ``quantize`` and
``permute_activations(x)``, the port ``quantize`` in logical order; the
oracle blocks are the same, so every rung sums the same terms in another
order. Tolerances: f32 rungs 1e-3 * max against JAX (1e-4 * max against
the port's kernels on the card); bf16 2e-2 * max; the floor, on the very
same bytes, 1e-5 * max (its int32 word sums exact, es + em f32 sums in
another order); full_pre and ``q4k_q8_matvec``'s plain versions bitwise.
"""

import functools
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.ops import probes
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
from ggml_cuda_experiments_tpu_torch.tools import exp_q4, exp_q4_r2, shape_probe

_TOOLS = Path(__file__).resolve().parent.parent / "tools"
N, K, BN = 512, 4096, 256


def load_jax_tool(name: str):
    """A JAX tool module loaded with ``--cpu`` as its argv, JAX's
    compilation cache put back as it was right after."""
    argv, cache = sys.argv, jax.config.jax_compilation_cache_dir
    sys.argv = [f"{name}.py", "--cpu"]
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                      _TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


JQ4 = load_jax_tool("exp_q4")
JR2 = load_jax_tool("exp_q4_r2")


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(11)
    w = (rng.normal(size=(N, K)) / np.sqrt(K)).astype(np.float32)
    x = rng.normal(size=(1, K)).astype(np.float32)
    jql = jqm.quantize(w, "q4_k")
    xp = jqm.permute_activations(jnp.asarray(x))
    return SimpleNamespace(w=w, x=torch.from_numpy(x), jql=jql, xp=xp,
                           ql=qm.quantize(torch.from_numpy(w), "q4_k"))


def _close(got: torch.Tensor, want, tol: float):
    want = np.asarray(want, np.float64).reshape(1, -1)
    got = got.double().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _port(mode, o):
    return probes.ladder(mode, probes.act_operands(mode, o.x), o.x, o.ql)


@pytest.mark.parametrize("mode,int8_ops,tol", [
    ("chunk", True, 1e-3), ("chunk32", False, 1e-3)])
def test_chunk_rungs_match_the_jax_chunk_kernel(monkeypatch, operands, mode,
                                                int8_ops, tol):
    monkeypatch.setattr(JQ4, "pack_xor8", lambda ql: ql.qs)
    want = JQ4.make_chunk(operands.jql, BN, int8_ops, N)(operands.xp)
    _close(_port(mode, operands), want, tol)


@pytest.mark.parametrize("mode,tol", [
    ("ponly", 1e-3), ("loonly", 1e-3), ("nochunk", 1e-3), ("floorhi", 1e-3),
    ("bf16", 2e-2)])
def test_probe_rungs_match_the_jax_probe_kernel(monkeypatch, operands, mode,
                                                tol):
    monkeypatch.setattr(JQ4, "pack_xor8", lambda ql: ql.qs)
    want = JQ4.make_probe(operands.jql, BN, mode, N)(operands.xp)
    _close(_port(mode, operands), want, tol)


def test_floor_matches_the_jax_floor_kernel_on_the_same_bytes(operands):
    ql = operands.ql
    same = SimpleNamespace(
        qs=ql.qs.numpy(),
        es=jnp.asarray(ql.es.float().numpy(), jnp.bfloat16),
        em=jnp.asarray(ql.em.float().numpy(), jnp.bfloat16))
    want = JQ4.make_floor(same, BN, N)(jnp.asarray(operands.x.numpy()))
    _close(probes.floor(operands.x, ql), want, 1e-5)


@pytest.mark.parametrize("mode,kernel,kw", [
    ("dma", "k_dma", {}), ("zponly", "k_zponly", {}),
    ("zlonly", "k_zlonly", {}), ("full", "k_full", {}),
    ("noand", "k_noand", {}), ("cols256", "k_cols256", {"sel_cols": 256}),
    ("split_f32", "k_split_f32", {"split_af": True}),
    ("full", "k_onedot", {"onedot": True}),
    ("full", "k_onedot_sub", {"onedot": True, "nsub": 2}),
    ("full", "k_subtile", {"nsub": 2})])
def test_r2_rungs_match_the_jax_ladder(operands, mode, kernel, kw):
    kw = dict(kw)
    kern = getattr(JR2, kernel)
    if "nsub" in kw:
        kern = functools.partial(kern, nsub=kw.pop("nsub"), bn=BN)
    want = JR2.run_variant(kern, operands.jql, operands.xp, BN, **kw)
    _close(_port(mode, operands), want, 1e-3)


def test_full_pre_equals_q4k_q8_matvec_and_the_jax_chunk8(operands):
    o = operands
    got = probes.full_pre(o.x, o.ql)
    assert torch.equal(got, qm.q4k_q8_matvec(o.x, o.ql))
    assert torch.equal(probes.q8_prep(o.x), exp_q4_r2.prep(o.x))
    want = jqm.qmatmul(jnp.asarray(o.x.numpy()), o.jql, use_vpu=True,
                       x_quant8=True)
    _close(got, want, 1e-3)


def test_pack_xor8_gives_the_bytes_the_jax_package_stores(operands):
    """The port's pack of its own bytes equals the JAX q4_k qs under the
    interleave: JAX byte s * 128 + r holds logical block perm32[r]'s byte
    s, the port's byte 16 perm32[r] + s."""
    p = probes.pack_xor8(operands.ql.qs).numpy()
    perm32 = np.asarray(jqm._perm32(K))
    s, r = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    cols = (16 * perm32[r] + s).reshape(-1)
    np.testing.assert_array_equal(np.asarray(operands.jql.qs), p[:, cols])


def test_act_operands_layouts(operands):
    x = operands.x
    for mode in probes.MODES:
        act = probes.act_operands(mode, x)
        assert act.dtype == torch.uint8 and act.numel() == probes.act_bytes(
            mode, K)
    aq, bq, sc = qm.quantize_activations_q8(x.reshape(-1))
    a8 = probes.act_operands("full", x)
    assert torch.equal(a8[:K // 2].view(torch.int8).reshape(-1, 16), aq)
    assert torch.equal(a8[K:].view(torch.float32).reshape(4, -1), sc)


@pytest.mark.parametrize("tool,argv", [
    (exp_q4, ["--cpu", "--check"]),
    (exp_q4_r2, ["--cpu", "--check", "--probes",
                 "dma,zponly,zlonly,full,noand,cols256,split,onedot,"
                 "onedot_sub,subtile,full_pre"]),
    (shape_probe, ["--cpu", "--shapes", "wo,wdown"])])
def test_tools_cpu_check_passes(tool, argv):
    assert tool.main(argv) == 0


def test_ladder_refuses_a_wrong_operand_block(operands):
    with pytest.raises(ValueError, match="operand block"):
        probes.ladder("full", probes.act_operands("chunk", operands.x),
                      operands.x, operands.ql)
