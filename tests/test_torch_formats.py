"""The port's Q8_0 and Q4_0 formats against the JAX package: the port's own
oracle copies against the JAX oracle (Q4_0's +v / -v ties included), the
device quantizer against the oracle, dequantization against
``dequantize_jnp``, every JAX route of each format (Pallas in interpret
mode) against the port's plain versions, and which kernel wrapper each
route reaches (spies on the CPU, where a wrapper runs its plain version).

Tolerances: the oracle, the quantizer and dequantization bit-exact. Per
route, against the JAX ``qmatmul`` of the same oracle blocks:
- q8_0 at B = 1, repeat-aligned K/32 (``_mxu_kernel``): 1e-4 * max, since
  the port reproduces its rounding (sum of bf16(x) * bf16(q d) in f32; only
  the order of the f32 sum differs);
- q4_0's exact-f32 matvecs (``_chunk_kernel``, ``_vpu2_kernel``): 1e-4 *
  max (tests/test_quant_matmul.py::test_qmatmul_chunk_exact_fold);
- K = 5632 (``_vpu_e_kernel``, which rounds bf16(q x) where the port keeps
  f32 or rounds bf16(q d)): 2e-2 * max (test_qmatvec_vpu_any_k);
- q4_0 under x_quant8 (``_chunk8_kernel``): 1e-3 * max, its int8 operands
  reproduced exactly (tests/test_torch_fused_matvec.py) and only f32 sums
  in another order;
- 2-8 rows (``use_vpu=True``: ``_vpu_e_kernel``, default: ``_mxu_kernel``)
  and the pipelined GEMM at 64 and 512 rows: 2e-2 * max
  (test_qmatvec_vpu_batched, test_qmatmul_pipelined)."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.oracle import quant as jquant
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.oracle import quant as tquant
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm

FMTS = ("q8_0", "q4_0")
QUANT = {"q8_0": "quantize_q8_0", "q4_0": "quantize_q4_0"}
DEQUANT = {"q8_0": "dequantize_q8_0", "q4_0": "dequantize_q4_0"}


def _weight(seed, n, k):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)


def _with_ties(w):
    """Rows whose 32-blocks tie +v and -v for the largest |x| (either sign
    first), an all-zero block, a constant block and one outlier."""
    w = w.copy()
    w[0, :32] = 0.01
    w[0, 3], w[0, 20] = 0.5, -0.5           # + first
    w[1, 32:64] = -0.02
    w[1, 40], w[1, 41] = -0.25, 0.25        # - first
    w[2, :32] = 0.0
    w[3, :32] = 0.125
    w[4, 40] = 8.0
    return w


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"err {err} vs {tol} * {scale}"


@pytest.mark.parametrize("fmt", FMTS)
def test_port_oracle_equals_the_jax_oracle(fmt):
    w = _with_ties(_weight(0, 8, 512))
    got = getattr(tquant, QUANT[fmt])(w)
    want = getattr(jquant, QUANT[fmt])(w)
    for f in ("qs", "d"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert got.shape == want.shape
    assert got.bits_per_weight == want.bits_per_weight
    assert np.array_equal(getattr(tquant, DEQUANT[fmt])(got),
                          getattr(jquant, DEQUANT[fmt])(want))
    if fmt == "q4_0":                   # the ties kept the first one's sign
        assert want.d[0, 0] < 0 and want.d[1, 1] > 0


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("k", [96, 1024, 5632])
def test_quantize_bit_equal_to_oracle(fmt, k):
    w = _with_ties(_weight(1, 16, k))
    t = getattr(jquant, QUANT[fmt])(w)
    got = tqm.quantize(torch.from_numpy(w), fmt)
    want = tqm.from_oracle(t, device="cpu")
    assert got.fmt == want.fmt == fmt and got.es is None and got.em is None
    for f in ("qs", "d"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert np.array_equal(got.qs.numpy(), t.qs)
    assert got.d.dtype == torch.float16
    assert np.array_equal(got.d.float().numpy(), t.d)
    assert got.array_shape == (16, k)
    per_weight = 1.0625 if fmt == "q8_0" else 0.5625      # GGML's own sizes
    assert got.nbytes == 16 * k * per_weight


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("k", [1024, 5632, 8192])
def test_dequant_bit_equal_to_dequantize_jnp(fmt, k):
    """Global (K = 1024, 5632) and segment-local (K = 8192) layouts of the
    JAX package; the port's logical order has one."""
    t = getattr(jquant, QUANT[fmt])(_with_ties(_weight(2, 16, k)))
    want = np.asarray(jqm.dequantize_jnp(jqm.from_oracle(t)))
    got = tqm.dequantize(tqm.from_oracle(t, device="cpu")).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, getattr(jquant, DEQUANT[fmt])(t))


def test_from_oracle_takes_both_oracles_and_refuses_other_widths():
    w = _weight(3, 8, 256)
    for mod in (jquant, tquant):
        assert tqm.from_oracle(mod.quantize_q8_0(w), device="cpu").fmt == "q8_0"
        assert tqm.from_oracle(mod.quantize_q4_0(w), device="cpu").fmt == "q4_0"
    t = jquant.quantize_q4_0(w)
    t.qs = t.qs.view(np.int8)              # Q4_0's width, Q8_0's dtype
    with pytest.raises(ValueError):
        tqm.from_oracle(t, device="cpu")


def _pair(fmt, seed, n, k, rows):
    t = getattr(jquant, QUANT[fmt])(_weight(seed, n, k))
    x = np.random.default_rng(seed + 1).normal(size=(rows, k)).astype(
        np.float32)
    return jqm.from_oracle(t), tqm.from_oracle(t, device="cpu"), x


@pytest.mark.parametrize("fmt,k,kw,tol", [
    ("q8_0", 4096, {}, 1e-4),                       # _mxu_kernel, B = 1
    ("q8_0", 1024, {}, 1e-4),                       # the same, K/32 = 32
    ("q4_0", 4096, {}, 1e-4),                       # _chunk_kernel
    ("q4_0", 1024, {}, 1e-4),                       # _vpu2_kernel
    ("q8_0", 5632, {}, 2e-2),                       # _vpu_e_kernel
    ("q4_0", 5632, {}, 2e-2),                       # _vpu_e_kernel
    ("q4_0", 4096, {"x_quant8": True}, 1e-3),       # _chunk8_kernel
], ids=["q8_0-mxu-4096", "q8_0-mxu-1024", "q4_0-chunk", "q4_0-vpu2",
        "q8_0-vpu_e", "q4_0-vpu_e", "q4_0-chunk8"])
def test_matvec_routes_match_jax(fmt, k, kw, tol):
    jw, tw, x = _pair(fmt, 4, 256, k, 1)
    want = np.asarray(jqm.qmatmul(jnp.asarray(x), jw, **kw))
    got = tqm.qmatmul(torch.from_numpy(x), tw, **kw)
    _close(got, want, tol)


@pytest.mark.parametrize("fmt", ("q8_0", "q4_0", "q4_k"))
@pytest.mark.parametrize("batch", [2, 5, 8])
@pytest.mark.parametrize("use_vpu", [True, None], ids=["vpu", "default"])
def test_small_batch_routes_match_jax(fmt, batch, use_vpu):
    """``use_vpu=True`` (the JAX test's _vpu_e_kernel loop at B 2-8) and
    the default dispatch (_mxu_kernel, x padded to 8 rows): the port's
    bf16 GEMM either way."""
    if fmt == "q4_k":
        t = jquant.quantize_q4_k(_weight(5, 128, 1024))
        jw, tw = jqm.from_oracle(t), tqm.from_oracle(t, device="cpu")
        x = np.random.default_rng(6).normal(size=(batch, 1024)).astype(
            np.float32)
    else:
        jw, tw, x = _pair(fmt, 5, 128, 1024, batch)
    want = np.asarray(jqm.qmatmul(jnp.asarray(x), jw, use_vpu=use_vpu))
    got = tqm.qmatmul(torch.from_numpy(x), tw)
    _close(got, want, 2e-2)
    assert torch.equal(got, tqm.qmatmul_ref(torch.from_numpy(x), tw,
                                            torch.bfloat16))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("rows", [64, 512])
def test_pipelined_gemm_matches_jax(fmt, rows):
    """The JAX prefill GEMM (``pipelined=True``: _pipe_sub_kernel)."""
    jw, tw, x = _pair(fmt, 7, 256, 1024, rows)
    want = np.asarray(jqm.qmatmul(jnp.asarray(x), jw, pipelined=True))
    got = tqm.qmatmul(torch.from_numpy(x), tw)
    _close(got, want, 2e-2)


# (fmt, rows, K, x_quant8) -> the wrapper qmatmul must call
ROUTES = [
    ("q8_0", 1, 4096, False, "q80_matvec"),
    ("q8_0", 1, 4096, True, "q80_matvec"),        # q8_0 ignores x_quant8
    ("q8_0", 1, 5632, False, "q80_matvec"),
    ("q8_0", 8, 4096, False, "q80_gemm"),
    ("q8_0", 64, 1024, True, "q80_gemm"),
    ("q4_0", 1, 4096, False, "q40_matvec"),
    ("q4_0", 1, 4096, True, "q40_q8_matvec"),
    ("q4_0", 1, 2048, True, "q40_matvec"),        # (K/32) % 128 != 0
    ("q4_0", 1, 5632, True, "q40_matvec"),
    ("q4_0", 2, 4096, True, "q40_gemm"),
    ("q4_0", 512, 1024, False, "q40_gemm"),
    ("q4_k", 1, 4096, True, "q4k_q8_matvec"),
    ("q4_k", 1, 2048, True, "q4k_matvec"),
    ("q4_k", 8, 1024, False, "q4k_gemm"),
    # the GEMM's route edges (gemm_route: stream to 32 rows, tc above)
    ("q8_0", 5, 1024, False, "q80_gemm"),
    ("q8_0", 33, 1024, False, "q80_gemm"),
    ("q4_0", 32, 1024, False, "q40_gemm"),
    ("q4_0", 128, 1024, False, "q40_gemm"),
    ("q4_k", 2, 1024, True, "q4k_gemm"),
    ("q4_k", 33, 1024, False, "q4k_gemm"),
]
WRAPPERS = ("q80_matvec", "q40_matvec", "q40_q8_matvec", "q80_gemm",
            "q40_gemm", "q4k_matvec", "q4k_q8_matvec", "q4k_gemm")


@pytest.mark.parametrize("fmt,rows,k,xq8,wrapper", ROUTES,
                         ids=[f"{r[0]}-B{r[1]}-K{r[2]}{'-xq8' if r[3] else ''}"
                              for r in ROUTES])
def test_dispatch_reaches_the_format_wrapper(fmt, rows, k, xq8, wrapper,
                                             monkeypatch):
    calls = collections.Counter()
    for name in WRAPPERS:
        fn = getattr(tqm, name)
        monkeypatch.setattr(tqm, name, lambda *a, name=name, fn=fn: (
            calls.update([name]), fn(*a))[1])
    w = tqm.quantize(torch.from_numpy(_weight(8, 64, k)), fmt)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(rows, k)).astype(np.float32))
    before = dict(tqm.LAUNCHES)
    y = tqm.qmatmul(x, w, x_quant8=xq8)
    assert y.shape == (rows, 64) and y.dtype == torch.float32
    assert calls == {wrapper: 1}
    assert tqm.LAUNCHES == before                 # CPU tensors: no launch


def test_wrappers_take_plain_versions_on_cpu():
    w8 = tqm.quantize(torch.from_numpy(_weight(10, 32, 4096)), "q8_0")
    w4 = tqm.quantize(torch.from_numpy(_weight(10, 32, 4096)), "q4_0")
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(3, 4096)).astype(np.float32))
    before = dict(tqm.LAUNCHES)
    assert torch.equal(tqm.q80_matvec(x[:1], w8),
                       tqm.qmatmul_ref(x[:1], w8, torch.bfloat16))
    assert torch.equal(tqm.q40_matvec(x[:1], w4),
                       tqm.qmatmul_ref(x[:1], w4, torch.float32))
    assert torch.equal(tqm.q40_q8_matvec(x[:1], w4),
                       tqm.qmatmul_q8_ref(x[:1], w4))
    for fn, w in ((tqm.q80_gemm, w8), (tqm.q40_gemm, w4)):
        xb = x.to(torch.bfloat16)
        assert torch.equal(fn(xb, w), tqm.qmatmul_ref(xb, w, torch.bfloat16))
    assert tqm.LAUNCHES == before


def test_q4_0_int8_matvec_is_q4_k_with_es_d_em_8d():
    """The q4_0 int8-activation plain version is the q4_k one with
    es = d and em = 8 d (the JAX _chunk8_kernel's q4_0 scales)."""
    w4 = tqm.quantize(torch.from_numpy(_weight(12, 48, 4096)), "q4_0")
    d = w4.d.float()
    as_k = tqm.QuantLinear("q4_k", w4.shape, w4.qs, es=d, em=8.0 * d)
    x = torch.from_numpy(np.random.default_rng(13).normal(
        size=(1, 4096)).astype(np.float32))
    assert torch.equal(tqm.qmatmul_q8_ref(x, w4), tqm.qmatmul_q8_ref(x, as_k))
    _close(tqm.qmatmul_q8_ref(x, w4), tqm.qmatmul_ref(x, w4), 2e-2)
