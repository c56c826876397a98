"""The port's C++ block-quant codec (``utils/native.py``, built from its own
``csrc/native/`` copy) against the port's NumPy oracle and the JAX
package's ``utils/native``: quantize and dequantize bit for bit in Q8_0,
Q4_0, Q4_K and Q6_K, at every thread count, and its blocks taken by
``from_oracle`` as the oracle's are."""

import dataclasses

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.oracle import quant as jax_quant
from ggml_cuda_experiments_tpu.utils import native as jax_native
from ggml_cuda_experiments_tpu_torch.oracle import quant as q
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
from ggml_cuda_experiments_tpu_torch.utils import native

FMTS = ["q8_0", "q4_0", "q4_k", "q6_k"]
ORACLE = {"q8_0": (q.quantize_q8_0, q.dequantize_q8_0),
          "q4_0": (q.quantize_q4_0, q.dequantize_q4_0),
          "q4_k": (q.quantize_q4_k, q.dequantize_q4_k),
          "q6_k": (q.quantize_q6_k, q.dequantize_q6_k)}


def _fields(t) -> dict:
    return {f.name: np.asarray(getattr(t, f.name))
            for f in dataclasses.fields(t) if f.name != "shape"}


def _assert_same(a, b, what):
    assert type(a).__name__ == type(b).__name__, what
    assert tuple(a.shape) == tuple(b.shape), what
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys(), what
    for name in fb:
        assert fa[name].dtype == fb[name].dtype, f"{what}.{name} dtype"
        assert np.array_equal(fa[name], fb[name]), (
            f"{what}.{name} differs at "
            f"{np.argwhere(fa[name] != fb[name])[:4]}")


def _x(rng, shape=(32, 1024)):
    x = rng.normal(size=shape).astype(np.float32) * 3
    x[0] = 0.0                     # exact zeros, tiny and huge values
    x[1, :32] = 1e-8
    x[2, :32] = 1e4
    return x


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_bit_equal_to_the_oracle_and_jax(rng, fmt):
    x = _x(rng)
    got = native.quantize(x, fmt)
    _assert_same(got, ORACLE[fmt][0](x), f"{fmt} vs the port's oracle")
    want = jax_native.quantize(x, fmt)
    for name, arr in _fields(got).items():
        assert np.array_equal(arr, np.asarray(getattr(want, name))), (
            f"{fmt}.{name} vs the JAX native codec")


@pytest.mark.parametrize("fmt", FMTS)
def test_dequantize_bit_equal_to_the_oracle_and_jax(rng, fmt):
    # a leading batch axis: the codec works on [..., K]
    t = ORACLE[fmt][0](rng.normal(size=(2, 8, 512)).astype(np.float32))
    got = native.dequantize(t)
    assert got.dtype == np.float32 and got.shape == (2, 8, 512)
    assert np.array_equal(got, ORACLE[fmt][1](t))
    # the same blocks in the JAX oracle's dataclass
    jt = getattr(jax_quant, type(t).__name__)(**_fields(t), shape=t.shape)
    assert np.array_equal(got, jax_native.dequantize(jt))


@pytest.mark.parametrize("fmt", FMTS)
def test_thread_counts_give_the_same_bits(rng, fmt):
    """The rows split over threads: 1, 3 (an uneven split of 37 rows) and
    more threads than rows give one answer."""
    x = _x(rng, (37, 512))
    one = native.quantize(x, fmt, threads=1)
    for threads in (3, 64):
        _assert_same(native.quantize(x, fmt, threads=threads), one,
                     f"{fmt} at {threads} threads")
        assert np.array_equal(native.dequantize(one, threads=threads),
                              native.dequantize(one, threads=1))
    # a row alone gives that row's blocks
    _assert_same(native.quantize(x[5:6], fmt),
                 ORACLE[fmt][0](x[5:6]), f"{fmt} one row")


@pytest.mark.parametrize("fmt", FMTS)
def test_from_oracle_takes_the_codecs_blocks(rng, fmt):
    w = rng.normal(size=(64, 512)).astype(np.float32)
    got = qm.from_oracle(native.quantize(w, fmt), device="cpu")
    want = qm.from_oracle(ORACLE[fmt][0](w), device="cpu")
    assert got.fmt == want.fmt == fmt
    for name in ("qs", "d", "es", "em", "qh"):
        a, b = getattr(got, name, None), getattr(want, name, None)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


def test_bad_arguments_raise():
    x = np.zeros((2, 96), np.float32)
    with pytest.raises(ValueError, match="multiple of 256"):
        native.quantize(x, "q4_k")
    with pytest.raises(ValueError, match="fmt"):
        native.quantize(np.zeros((2, 256), np.float32), "q5_k")
    with pytest.raises(TypeError, match="none of"):
        native.dequantize(np.zeros((2, 256), np.float32))
