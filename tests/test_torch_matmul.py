"""The port's ``matmul`` (its plain version on the CPU) against the JAX
``matmul`` (Pallas, interpret mode on the CPU), on the JAX tests' cases
(``tests/test_matmul.py``): f32 at 1e-4, bf16 operands against JAX's f32
output at 1e-3, int8 -> int32 bitwise, the three transpose combos, the
batch-1 matvec, and the default output dtype of each input dtype."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.ops.matmul import matmul as jmatmul
from ggml_cuda_experiments_tpu_torch.ops import matmul as tmm
from ggml_cuda_experiments_tpu_torch.utils.harness import assert_close

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16, torch.int8: jnp.int8,
        torch.int32: jnp.int32}


def _both(a, b, tdtype=torch.float32, **kw):
    """(port result, JAX result as NumPy) on the same NumPy operands."""
    jkw = dict(kw)
    if "out_dtype" in jkw and jkw["out_dtype"] is not None:
        jkw["out_dtype"] = _JNP[jkw["out_dtype"]]
    want = jmatmul(jnp.asarray(a, _JNP[tdtype]), jnp.asarray(b, _JNP[tdtype]),
                   **jkw)
    got = tmm.matmul(torch.from_numpy(a).to(tdtype),
                     torch.from_numpy(b).to(tdtype), **kw)
    return got, want


@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 512, 384),
                                   (64, 200, 136)])
def test_f32_matches_jax(rng, shape):
    m, k, n = shape
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    got, want = _both(a, b)
    assert got.dtype == torch.float32
    assert_close(got, np.asarray(want), atol=1e-4, rtol=1e-4,
                 name="f32 matmul vs JAX")


def test_bf16_matches_jax_f32_output(rng):
    m, k, n = 128, 512, 256
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    got, want = _both(a, b, torch.bfloat16, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert_close(got, np.asarray(want), atol=1e-3, rtol=1e-3,
                 name="bf16 matmul vs JAX")


def test_int8_is_bitwise_equal_to_jax(rng):
    m, k, n = 64, 256, 128
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    got, want = _both(a, b, torch.int8, out_dtype=torch.int32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))


@pytest.mark.parametrize("ta,tb", [(False, True), (True, False), (True, True)])
def test_transpose_combos_match_jax(rng, ta, tb):
    m, k, n = 64, 128, 192
    a = rng.normal(size=(k, m) if ta else (m, k)).astype(np.float32)
    b = rng.normal(size=(n, k) if tb else (k, n)).astype(np.float32)
    got, want = _both(a, b, transpose_a=ta, transpose_b=tb)
    assert got.shape == (m, n)
    assert_close(got, np.asarray(want), atol=1e-4, rtol=1e-4,
                 name=f"matmul ta={ta} tb={tb}")


def test_tall_skinny_matvec_matches_jax(rng):
    a = rng.normal(size=(1, 2048)).astype(np.float32)
    b = rng.normal(size=(2048, 512)).astype(np.float32)
    got, want = _both(a, b, block_m=8)
    assert_close(got, np.asarray(want), atol=1e-3, rtol=1e-3, name="matvec")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8])
def test_default_out_dtype_is_jax_s(rng, dtype):
    m, k, n = 16, 64, 40
    if dtype == torch.int8:
        a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
        b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    else:
        a = rng.normal(size=(m, k)).astype(np.float32)
        b = rng.normal(size=(k, n)).astype(np.float32)
    got, want = _both(a, b, dtype)
    assert got.dtype == tmm.default_out_dtype(dtype)
    assert _JNP[got.dtype] == want.dtype
    # both round the f32 (int32) sum to the output dtype: one ulp apart at
    # most where the sums' orders differ
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= (
        0 if dtype == torch.int8 else 2e-2 * np.abs(want).max())


def test_block_sizes_do_not_change_the_result(rng):
    a = torch.from_numpy(rng.normal(size=(70, 300)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(300, 45)).astype(np.float32))
    ref = tmm.matmul(a, b)
    for bm, bn, bk in ((8, 128, 128), (256, 256, 512), (32, 16, 64)):
        assert torch.equal(tmm.matmul(a, b, block_m=bm, block_n=bn,
                                      block_k=bk), ref)


def test_plain_version_raises_on_what_matmul_does_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        tmm.matmul(x, torch.zeros((9, 3)))                # K mismatch
    with pytest.raises(ValueError):
        tmm.matmul(x, torch.zeros((8, 3), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tmm.matmul(x.to(torch.int8), torch.zeros((8, 3), dtype=torch.int8),
                   out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tmm.matmul(x.double(), torch.zeros((8, 3), dtype=torch.float64))
