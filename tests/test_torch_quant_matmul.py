"""Port's Q4_K-E container and matmul plain versions against the JAX
package: the torch quantizer against the oracle, dequantization against
``dequantize_jnp``, and ``qmatmul`` (plain, on the CPU) against the JAX
``qmatmul`` running its Pallas kernels in interpret mode.

Tolerances: the quantizer and dequantization are bit-exact; the B = 1
exact-f32 fold 1e-4 * max (tests/test_quant_matmul.py::
test_qmatmul_chunk_exact_fold); the bf16 GEMM paths 2e-2 * max
(test_qmatmul_fused_bf16_default, test_qmatmul_pipelined)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.oracle import quant as quant_ref
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm


def _weight(seed, n, k):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 512), (8, 4096)])
def test_quantize_bit_equal_to_oracle(shape):
    w = _weight(0, *shape)
    w[0, :64] = 0.0                       # zero blocks: the np_div rule
    w[1, :256] = 0.25                     # constant superblock
    t = quant_ref.quantize_q4_k(w)
    got = tqm.quantize(torch.from_numpy(w))
    want = tqm.from_oracle(t)
    for f in ("qs", "es", "em"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert np.array_equal(got.qs.numpy(), t.qs)
    es, em = jqm.q4_k_effective(t)
    assert np.array_equal(got.es.float().numpy(), es.astype(np.float32))
    assert np.array_equal(got.em.float().numpy(), em.astype(np.float32))


@pytest.mark.parametrize("layout", ["std", "wof"])
def test_dequant_bit_equal_to_dequantize_jnp(layout):
    t = quant_ref.quantize_q4_k(_weight(1, 64, 512))
    want = np.asarray(jqm.dequantize_jnp(jqm.from_oracle(t, layout=layout)))
    got = tqm.dequantize(tqm.from_oracle(t)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [4096, 256])   # _chunk_kernel, _vpu2_kernel
def test_matvec_matches_jax(k):
    n = 256
    t = quant_ref.quantize_q4_k(_weight(2, n, k))
    x = np.random.default_rng(3).normal(size=(1, k)).astype(np.float32)
    want = np.asarray(jqm.qmatmul(jnp.asarray(x), jqm.from_oracle(t)))
    got = tqm.qmatmul(torch.from_numpy(x), tqm.from_oracle(t)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-4 * scale


@pytest.mark.parametrize("batch,pipelined", [(16, False), (64, True)])
def test_gemm_matches_jax(batch, pipelined):
    """B=16 reaches _mxu_kernel, B=64 with pipelined _pipe_sub_kernel."""
    n, k = 256, 1024
    t = quant_ref.quantize_q4_k(_weight(4, n, k))
    x = np.random.default_rng(5).normal(size=(batch, k)).astype(np.float32)
    want = np.asarray(jqm.qmatmul(jnp.asarray(x), jqm.from_oracle(t),
                                  pipelined=pipelined))
    got = tqm.qmatmul(torch.from_numpy(x), tqm.from_oracle(t)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-2 * scale


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the kernel wrappers run their plain versions and
    launch nothing."""
    t = quant_ref.quantize_q4_k(_weight(6, 32, 512))
    ql = tqm.from_oracle(t)
    x = torch.from_numpy(
        np.random.default_rng(7).normal(size=(3, 512)).astype(np.float32))
    before = dict(tqm.LAUNCHES)
    y1 = tqm.q4k_matvec(x[:1], ql)
    y2 = tqm.q4k_gemm(x.to(torch.bfloat16), ql)
    assert tqm.LAUNCHES == before
    assert torch.equal(y1, tqm.qmatmul_ref(x[:1], ql, torch.float32))
    assert torch.equal(y2, tqm.qmatmul_ref(x, ql, torch.bfloat16))
    assert ql.nbytes == 32 * 256 + 2 * 32 * 16 * 2


def test_other_formats_raise():
    with pytest.raises(NotImplementedError):
        tqm.quantize(torch.zeros((8, 256)), "q8_0")
    with pytest.raises(NotImplementedError):
        tqm.from_oracle(quant_ref.quantize_q8_0(np.zeros((8, 256),
                                                         np.float32)))
