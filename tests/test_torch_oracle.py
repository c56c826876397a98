"""The port's oracles and harness against the JAX package's, on the same
NumPy inputs: ``oracle/attention.py`` and ``utils/harness.py`` bit-equal
(the operand rounding through ``torch.bfloat16`` / NumPy's float16 equals
``ml_dtypes``'s on signed zeros, subnormals, ties and infinities), the
int8 / fp8 per-row codecs bit-equal (``torch.float8_e4m3fn`` against
``ml_dtypes.float8_e4m3fn``), ``oracle/model.py``'s ``forward_logits`` on
the debug preset in f32, q8_0 and q4_k within 1e-6 * max (both are NumPy
over the same dequantized weights; the port's weights come through
``params_from_jax``), and the perplexity math."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jllama
from ggml_cuda_experiments_tpu.models.config import PRESETS as JPRESETS
from ggml_cuda_experiments_tpu.oracle import attention as jatt
from ggml_cuda_experiments_tpu.oracle import model as jom
from ggml_cuda_experiments_tpu.oracle import quant as jquant
from ggml_cuda_experiments_tpu.utils import harness as jharness
from ggml_cuda_experiments_tpu_torch import oracle as toracle
from ggml_cuda_experiments_tpu_torch.models import llama as tllama
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.models.convert import params_from_jax
from ggml_cuda_experiments_tpu_torch.oracle import attention as tatt
from ggml_cuda_experiments_tpu_torch.oracle import model as tom
from ggml_cuda_experiments_tpu_torch.oracle import quant as tquant
from ggml_cuda_experiments_tpu_torch.utils import harness as tharness


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# f32 values that probe the narrow types' rounding: signed zeros, f32 and
# bf16 / fp16 subnormals, exact ties (to even, both ways), values one ulp
# off a tie, the largest finite values, overflow and infinities
_EDGES = np.array([
    0.0, -0.0, 1e-45, -1e-45, 1e-40, 9.2e-41, 1.1754942e-38, 1e-39,
    5.9604645e-08, 2.9802322e-08, 8.940697e-08, 6.1035156e-05, 3e-05,
    1.0, -1.0, 1.00390625, 1.01171875, -1.00390625, 1.0039063, 1.0039062,
    1.00048828125, 1.00146484375, 2049.0, 2051.0, 3.3895314e38,
    3.3961776e38, 3.4028235e38, 65504.0, 65519.0, 65520.0, 70000.0,
    np.inf, -np.inf, 0.1, -7.3, 123.456, 448.0, 464.0, 0.001953125,
    0.0009765625, 0.00146484375], np.float32)


@pytest.mark.parametrize("narrow", ["bfloat16", "float16"])
def test_round_through_is_ml_dtypes_s(narrow):
    rng = np.random.default_rng(5)
    x = np.concatenate([_EDGES, rng.normal(size=4096).astype(np.float32),
                        (rng.normal(size=1024) * 1e-38).astype(np.float32)])
    want = jatt._round_through(x, getattr(jnp, narrow))
    for dtype in (getattr(torch, narrow), narrow, getattr(jnp, narrow)):
        got = tatt._round_through(x, dtype)
        assert got.dtype == np.float32
        assert np.array_equal(_bits(got), _bits(want)), dtype
    assert np.array_equal(_bits(tatt._round_through(x, None)), _bits(x))


@pytest.mark.parametrize("operand_dtype", [None, "bfloat16", "float16"])
def test_mulmat_ref_is_bit_equal(rng, operand_dtype):
    a = rng.normal(size=(24, 40)).astype(np.float32)
    b = rng.normal(size=(32, 40)).astype(np.float32)
    mask = np.where(rng.random((24, 32)) < 0.2, -np.inf, 0.0).astype(
        np.float32)
    jdt = None if operand_dtype is None else getattr(jnp, operand_dtype)
    for kw in (dict(b_transposed=True), dict(b_transposed=True, scale=0.125,
                                             mask=mask)):
        got = tatt.mulmat_ref(a, b, operand_dtype=operand_dtype, **kw)
        want = jatt.mulmat_ref(a, b, operand_dtype=jdt, **kw)
        assert np.array_equal(_bits(got), _bits(want))
    got = tatt.mulmat_ref(a, b.T.copy(), operand_dtype=operand_dtype)
    want = jatt.mulmat_ref(a, b.T.copy(), operand_dtype=jdt)
    assert np.array_equal(_bits(got), _bits(want))


def test_softmaxes_are_bit_equal(rng):
    x = (rng.normal(size=(6, 50)) * 4).astype(np.float32)
    assert np.array_equal(_bits(tatt.softmax_ref(x)),
                          _bits(jatt.softmax_ref(x)))
    got, want = tatt.online_softmax_ref(x[0]), jatt.online_softmax_ref(x[0])
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("causal,masked,operand_dtype", [
    (False, False, None), (True, False, None), (False, True, None),
    (True, False, "bfloat16")])
def test_attention_ref_is_bit_equal(rng, causal, masked, operand_dtype):
    q = rng.normal(size=(2, 4, 5, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 9, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 9, 16)).astype(np.float32)
    mask = (np.where(rng.random((1, 1, 5, 9)) < 0.3, -1e9, 0.0).astype(
        np.float32) if masked else None)
    jdt = None if operand_dtype is None else getattr(jnp, operand_dtype)
    got = tatt.attention_ref(q, k, v, mask=mask, causal=causal,
                             operand_dtype=operand_dtype)
    want = jatt.attention_ref(q, k, v, mask=mask, causal=causal,
                              operand_dtype=jdt)
    assert got.shape == (2, 4, 5, 16)
    assert np.array_equal(_bits(got), _bits(want))


def test_oracle_package_re_exports_as_jax_does():
    assert toracle.attention_ref is tatt.attention_ref
    assert toracle.mulmat_ref is tatt.mulmat_ref
    assert toracle.softmax_ref is tatt.softmax_ref
    assert toracle.online_softmax_ref is tatt.online_softmax_ref
    assert toracle.quant_ref is tquant


def test_harness_matches_jax(rng):
    a = rng.normal(size=(7, 9)).astype(np.float32)
    b = a + (rng.normal(size=(7, 9)) * 1e-3).astype(np.float32)
    assert tharness.max_abs_diff(a, b) == jharness.max_abs_diff(a, b)
    assert tharness.diff_report("x", a, b) == jharness.diff_report("x", a, b)
    tharness.assert_close(a, b, atol=1e-2, rtol=0)
    for mod in (tharness, jharness):
        with pytest.raises(AssertionError) as exc:
            mod.assert_close(a, b, atol=1e-6, rtol=0, name="tight")
        msg = str(exc.value)
        assert msg.startswith(jharness.diff_report("tight", a, b))
    with pytest.raises(AssertionError):
        tharness.assert_close(np.full(3, np.nan), np.zeros(3))


def test_int8_rowwise_is_bit_equal(rng):
    x = (rng.normal(size=(3, 5, 64)) * 3).astype(np.float32)
    x[0, 0] = 0.0                                   # an all-zero row
    tq, ts = tquant.quantize_int8_rowwise(x)
    jq, js = jquant.quantize_int8_rowwise(x)
    assert tq.dtype == np.int8 and np.array_equal(tq, jq)
    assert np.array_equal(_bits(ts), _bits(js))
    assert np.array_equal(_bits(tquant.dequantize_int8_rowwise(tq, ts)),
                          _bits(jquant.dequantize_int8_rowwise(jq, js)))


def test_fp8_rounding_is_ml_dtypes_s():
    rng = np.random.default_rng(6)
    x = np.concatenate([_EDGES[np.abs(_EDGES) <= 464],
                        rng.normal(size=2048).astype(np.float32) * 50,
                        (rng.normal(size=512) * 2e-3).astype(np.float32),
                        np.float32(2.0) ** -np.arange(6, 11, dtype=np.float32)
                        * np.float32(1.5)])
    got = tquant.to_fp8_e4m3fn(x)
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    assert np.array_equal(got, want)
    assert np.array_equal(_bits(tquant.fp8_e4m3fn_to_f32(got)),
                          _bits(want.view(ml_dtypes.float8_e4m3fn)
                                .astype(np.float32)))


def test_fp8_rowwise_is_bit_equal(rng):
    x = (rng.normal(size=(4, 6, 128)) * 2).astype(np.float32)
    x[1, 2] = 0.0
    tq, ts = tquant.quantize_fp8_rowwise(x)
    jq, js = jquant.quantize_fp8_rowwise(x)
    assert tq.dtype == np.uint8 and np.array_equal(tq, jq.view(np.uint8))
    assert np.array_equal(_bits(ts), _bits(js))
    assert tquant.FP8_MAX == jquant.FP8_MAX
    assert np.array_equal(_bits(tquant.dequantize_fp8_rowwise(tq, ts)),
                          _bits(jquant.dequantize_fp8_rowwise(jq, js)))


def _f32_tree(p):
    return {k: ([{kk: np.asarray(vv, np.float32) for kk, vv in layer.items()}
                 for layer in v] if k == "layers" else np.asarray(v, np.float32))
            for k, v in p.items()}


@pytest.mark.parametrize("fmt", ["f32", "q8_0", "q4_k"])
def test_forward_logits_matches_the_jax_oracle(fmt):
    """Both oracles on the same weights: the JAX package's tree (quantized
    by its quantize_params) and the port's (params_from_jax, quantized by
    the port's quantize_params)."""
    jp = jllama.init_weights(JPRESETS["debug"], seed=1, as_numpy=True)
    cfg = PRESETS["debug"]
    tp = params_from_jax(_f32_tree(jp), cfg, device="cpu")
    if fmt == "f32":
        jparams, tparams = _f32_tree(jp), tp
    else:
        jparams = jllama.quantize_params(jp, fmt)
        tparams = tllama.quantize_params(tp, fmt)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = jom.forward_logits(jparams, JPRESETS["debug"], tokens)
    got = tom.forward_logits(tparams, cfg, torch.from_numpy(tokens))
    assert got.shape == (2, 12, cfg.vocab_size) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert tom.perplexity(got, tokens) == pytest.approx(
        jom.perplexity(want, tokens), rel=1e-6)


def test_forward_logits_takes_oracle_blocks_and_refuses_moe():
    cfg = dataclasses.replace(PRESETS["debug"], n_layers=1)
    dense = tllama.init_weights(cfg, seed=3, device="cpu")
    tokens = np.arange(6)[None]
    want = tom.forward_logits(dense, cfg, tokens)
    head = dict(dense, lm_head=tquant.quantize_q8_0(
        dense["lm_head"].float().numpy()))
    got = tom.forward_logits(head, cfg, tokens)
    assert np.abs(got - want).max() < 0.05 * np.abs(want).max()
    # a MoE layer runs moe_mlp_oracle, as the JAX oracle does
    from ggml_cuda_experiments_tpu_torch.models import moe as tmoe
    mcfg = dataclasses.replace(PRESETS["moe-debug"], n_layers=1)
    moe = tmoe.init_moe_weights(mcfg, seed=3, device="cpu",
                                dtype=torch.float32)
    np_moe = {k: v.numpy() for k, v in moe.items() if k != "layers"}
    np_moe["layers"] = [{k: v.numpy() for k, v in moe["layers"][0].items()}]
    want = jom.forward_logits(np_moe, dataclasses.replace(
        JPRESETS["moe-debug"], n_layers=1), tokens)
    got = tom.forward_logits(moe, mcfg, tokens)
    assert got.shape == want.shape == (1, 6, mcfg.vocab_size)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_perplexity_math():
    """As tests/test_oracle_model.py:52-65, and equal to the JAX one."""
    V = 64
    logits = np.zeros((1, 10, V), np.float32)
    tokens = np.arange(10, dtype=np.int64)[None] % V
    assert tom.perplexity(logits, tokens) == pytest.approx(V, rel=1e-5)
    logits2 = np.full((1, 10, V), -100.0, np.float32)
    for t in range(10):
        logits2[0, t, (t + 1) % V] = 100.0
    assert tom.perplexity(logits2, np.arange(10)[None] % V) == \
        pytest.approx(1.0, abs=1e-5)
    rl = np.random.default_rng(4).normal(size=(2, 9, V)).astype(np.float32)
    rt = np.random.default_rng(5).integers(0, V, (2, 9))
    assert tom.perplexity(rl, rt) == jom.perplexity(rl, rt)
