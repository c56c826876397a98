"""The port's ``stage_pad``, ``grid_sum`` and ``lane_reduce`` (their plain
versions on the CPU) against the JAX package's own Pallas kernels for them,
which live in its tests (``tests/test_dma.py::_stage``,
``tests/test_reductions.py::grid_sum`` / ``lane_reduce``, interpret mode),
loaded from those files as they are. Exact, except the f32 sums: the
grid sum at 1e-6 of the summed magnitudes, the row sums at rtol 1e-6 as
the JAX test holds them."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.ops import primitives as pr

_TESTS = Path(__file__).resolve().parent


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  _TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DMA = _load("test_dma")
RED = _load("test_reductions")


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_stage_pad_equals_the_jax_stage(dtype, seed):
    x = np.random.default_rng(seed).normal(size=(DMA.ROWS, DMA.D)).astype(
        np.float32)
    want = np.asarray(DMA._stage(jnp.asarray(x, dtype)).astype(jnp.float32))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = pr.stage_pad(torch.from_numpy(x).to(tdtype), DMA.DPAD)
    assert got.shape == (DMA.ROWS, DMA.DPAD) and got.dtype == tdtype
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("r,d,dpad", [(300, 77, 96), (5, 128, 128)])
def test_stage_pad_other_shapes(r, d, dpad):
    x = torch.randn((r, d), generator=torch.Generator().manual_seed(r))
    got = pr.stage_pad(x, dpad)
    assert torch.equal(got[:, :d], x) and not got[:, d:].any()


def test_grid_sum_int_is_exact_and_equals_jax(rng):
    x = rng.integers(-1000, 1000, size=(64, 128)).astype(np.int32)
    got = pr.grid_sum(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(RED.grid_sum(jnp.asarray(x))) == int(x.sum())


@pytest.mark.parametrize("shape", [(64, 128), (256, 40)])
def test_grid_sum_f32_matches_jax(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    got = float(pr.grid_sum(torch.from_numpy(x)))
    want = float(RED.grid_sum(jnp.asarray(x)))
    assert abs(got - want) <= 1e-6 * float(np.abs(x).sum())


# The shapes that the kernel's flat stream splits on: n * d odd (a scalar
# tail), one CTA's chunk and less (8 x 37), several CTAs with a tail
# (1024 x 129). n stays a multiple of 8: the JAX kernel's 8-row grid drops
# any rows past it.
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("shape", [(8, 37), (1024, 129)])
def test_grid_sum_at_the_kernel_paths_equals_jax(rng, shape, dtype):
    if dtype == np.int32:
        x = rng.integers(-1000, 1000, size=shape).astype(np.int32)
    else:
        x = rng.normal(size=shape).astype(np.float32)
    got = pr.grid_sum(torch.from_numpy(x))
    want = RED.grid_sum(jnp.asarray(x))
    assert got.shape == () and got.dtype == torch.from_numpy(x).dtype
    if dtype == np.int32:
        assert int(got) == int(want) == int(x.astype(np.int64).sum())
    else:
        assert abs(float(got) - float(want)) <= 1e-6 * float(np.abs(x).sum())


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_grid_sum_of_one_row_equals_numpy(rng, dtype):
    x = (rng.integers(-1000, 1000, size=(1, 37)) if dtype == np.int32
         else rng.normal(size=(1, 37))).astype(dtype)
    got = pr.grid_sum(torch.from_numpy(x))
    want = x.astype(np.float64).sum()
    if dtype == np.int32:
        assert int(got) == int(want)
    else:
        assert abs(float(got) - want) <= 1e-6 * float(np.abs(x).sum())


def test_lane_reduce_matches_jax(rng):
    x = rng.normal(size=(8, 128)).astype(np.float32)
    mx, sm = pr.lane_reduce(torch.from_numpy(x))
    jmx, jsm = RED.lane_reduce(jnp.asarray(x))
    assert mx.shape == sm.shape == (8, 1)
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
    np.testing.assert_array_equal(mx.numpy()[:, 0], x.max(axis=1))
    np.testing.assert_allclose(sm.numpy(), np.asarray(jsm), rtol=1e-6)
    np.testing.assert_allclose(sm.numpy()[:, 0], x.sum(axis=1), rtol=1e-6)


def test_lane_reduce_bf16_keeps_its_dtype(rng):
    x = torch.from_numpy(rng.normal(size=(33, 77)).astype(np.float32))
    mx, sm = pr.lane_reduce(x.bfloat16())
    assert mx.dtype == sm.dtype == torch.bfloat16
    assert torch.equal(mx.float(), x.bfloat16().float().amax(1, keepdim=True))
    assert torch.equal(sm, x.bfloat16().float().sum(1, keepdim=True)
                       .bfloat16())


def test_plain_versions_raise_on_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        pr.stage_pad(torch.zeros((4, 130)))               # D > dpad
    with pytest.raises(ValueError):
        pr.grid_sum(torch.zeros((4, 4), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        pr.lane_reduce(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        pr.lane_reduce(torch.zeros((4,)))                 # 1-D
