"""The q6_k head's probe rungs and the Mosaic probes (``ops/probes.py``,
``ops/mosaic_probes.py``: their plain versions on the CPU) against the JAX
package's tools, loaded as they are: ``tools/q6_probe.py``'s module-level
``_probe_kernel`` wrapped in a ``pallas_call`` of its own in interpret mode
(the tool builds its call inside a closure over its random operands), on
the very same operands at 1024 rows (its row subtiles are 2 x 512), and
``tools/probe_mosaic_r3.py``'s probes, each of which checks its own kernel
exactly against NumPy, beside the port's probe on the same input.

The JAX tools set JAX's compilation cache when imported; it is put back at
once, so nothing is written into the checkout. Tolerances: the stream rung
1e-5 * max (its int8 sums exact, the es sum in another f32 order); bits2
and the nib rungs 1e-3 * max (integer products exact, f32 folds in another
order); the Mosaic probes exact.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
from ggml_cuda_experiments_tpu_torch.ops import probes
from ggml_cuda_experiments_tpu_torch.tools import probe_mosaic_r3, q6_probe

_TOOLS = Path(__file__).resolve().parent.parent / "tools"
ROWS = 1024


def load_jax_tool(name: str):
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


JQ6 = load_jax_tool("q6_probe")
JMOSAIC = load_jax_tool("probe_mosaic_r3")


@pytest.fixture(scope="module")
def operands():
    return q6_probe.draw_operands(ROWS, np.random.default_rng(3),
                                  torch.device("cpu"))


def _jax_rung(mode, t):
    """The JAX rung's kernel body on the port's operands (interpret)."""
    def j(name, dtype=None):
        a = t[name]
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        return jnp.asarray(a, dtype or a.dtype)
    bn = JQ6.BN
    call = pl.pallas_call(
        functools.partial(JQ6._probe_kernel, mode=mode),
        out_shape=jax.ShapeDtypeStruct((1, ROWS), jnp.float32),
        grid=(ROWS // bn,),
        in_specs=[pl.BlockSpec((JQ6.KH, 256), lambda n: (0, 0)),
                  pl.BlockSpec((JQ6.KH, 256), lambda n: (0, 0)),
                  pl.BlockSpec((4, JQ6.KQ4), lambda n: (0, 0)),
                  pl.BlockSpec((bn, JQ6.KH), lambda n: (n, 0)),
                  pl.BlockSpec((bn, JQ6.KQ4), lambda n: (n, 0)),
                  pl.BlockSpec((bn, JQ6.KB6), lambda n: (n, 0))],
        out_specs=pl.BlockSpec((1, bn), lambda n: (0, n)),
        interpret=True)
    return np.asarray(call(j("ea"), j("eb"), j("xc"), j("qs"), j("qh"),
                           j("es", jnp.bfloat16)))


@pytest.mark.parametrize("mode,tol", [("stream", 1e-5), ("bits2", 1e-3),
                                      ("nib_global", 1e-3),
                                      ("nib_seg", 1e-3)])
def test_q6_rungs_match_the_jax_probe_kernel(operands, mode, tol):
    want = _jax_rung(mode, operands)
    got = q6_probe.rung(mode, operands)(
        (operands["qs"], operands["qh"], operands["es"])).double().numpy()
    assert got.shape == want.shape == (1, ROWS)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_q6_nib_lhs_layouts(operands):
    qs = operands["qs"]
    hi4 = (qs.to(torch.int32) // 16 + 8).to(torch.int8)   # floor(p/16) + 8
    g = probes.q6_nib_lhs(qs, False)
    assert torch.equal(g, torch.cat([qs, hi4], 1))
    s = probes.q6_nib_lhs(qs, True)
    assert torch.equal(s[:, :1024], qs[:, :1024])
    assert torch.equal(s[:, 1024:2048], hi4[:, :1024])
    assert torch.equal(s[:, 2048:3072], qs[:, 1024:])
    assert int(hi4.min()) == 0 and int(hi4.max()) == 15


def test_q6_probe_cpu_runs():
    assert q6_probe.main(["--cpu", "--variants",
                          "stream,cur,nib_global,nib_seg,bits2"]) == 0


@pytest.mark.parametrize("jax_probe,port_probe", [
    ("probe_transpose_dot", "probe_transpose_dot"),
    ("probe_lane_concat", "probe_lane_concat"),
    ("probe_roll64", "probe_roll64"),
    ("probe_dyn_sublane", "probe_dyn_sublane"),
    ("probe_lane_extract", "probe_lane_extract"),
    ("probe_read_output_ref", "probe_read_output_ref"),
    ("probe_call_overhead", "probe_call_overhead")])
def test_mosaic_probes_pass_as_the_jax_ones_do(jax_probe, port_probe):
    assert getattr(JMOSAIC, jax_probe)() is True
    assert getattr(probe_mosaic_r3, port_probe)(torch.device("cpu"))


def test_mosaic_probes_on_other_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(32, 128)).astype(np.float32)
    e = rng.normal(size=(32, 16)).astype(np.float32)
    np.testing.assert_allclose(
        mp.transpose_dot(torch.from_numpy(x), torch.from_numpy(e)).numpy(),
        x.T @ e, rtol=1e-5, atol=1e-5)
    out, kept = mp.read_output(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), x * np.float32(3) + 1)
    np.testing.assert_array_equal(kept.numpy(), x * np.float32(3))
    np.testing.assert_array_equal(mp.tiny_call(torch.from_numpy(x)).numpy(),
                                  x * np.float32(1.0001))


# dyn_sublane at the shapes its kernel splits on: a float a thread (C % 4
# != 0) and a slice of more than 1,024 float4s. The JAX probe has one fixed
# shape, so the port is held to its oracle, x * 2.0, exactly.
@pytest.mark.parametrize("shape", [(16, 3), (64, 1000)])
def test_dyn_sublane_at_the_kernel_paths(shape):
    x = np.random.default_rng(shape[1]).normal(size=shape).astype(np.float32)
    got = mp.dyn_sublane(torch.from_numpy(x))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), x * np.float32(2.0))


def test_probe_mosaic_tool_cpu_runs(capsys):
    assert probe_mosaic_r3.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(": OK") == 7 and "not measured" in out
