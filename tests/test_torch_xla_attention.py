"""``cfg.xla_attn_max_cache``: the reference's full-read decode attention for
small padded caches (``_xla_decode_attention``, plain XLA there, plain
PyTorch here), against the JAX ``decode_step`` with the gate open, on the
CPU.

The debug preset in q4_k (the same blocks in both packages), unfused, with
``xla_attn_max_cache`` = 256 and a cache of 256 positions, on a bf16 and
an int8 cache: prefill of 8 tokens and 6 greedy decode steps, logits
within 2e-2 * max (tests/test_torch_llama.py's model bound) and greedy
tokens equal. The port's flash_decode is replaced by one that raises, so
the gate must have taken every decode step; a cache past the setting
takes flash_decode again. ``_xla_decode_attention`` alone is held against
the JAX function on the same cache within 1e-6 * max."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig

CFG = dataclasses.replace(PRESETS["debug"], fuse_mlp=False, fuse_attn=False,
                          fuse_layer=False, xla_attn_max_cache=256)
TCFG = ModelConfig(**dataclasses.asdict(CFG))
S = 256


@pytest.fixture(scope="module")
def params():
    jp = jl.init_weights(CFG, seed=4)
    np_tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    tp = convert.params_from_jax(np_tree, TCFG, device="cpu")
    return jl.quantize_params(jp, "q4_k"), tl.quantize_params(tp, "q4_k")


def _no_flash_decode(*a, **k):
    raise AssertionError("flash_decode ran under the xla_attn_max_cache gate")


@pytest.mark.parametrize("quantized", [False, "int8"], ids=["bf16", "int8"])
def test_decode_matches_jax(params, monkeypatch, quantized):
    jq, tq = params
    prompt = np.random.default_rng(5).integers(
        0, CFG.vocab_size, (1, 8)).astype(np.int32)
    jc = jl.KVCache.create(CFG, 1, S, quantized=quantized)
    tc = tl.KVCache.create(TCFG, 1, S, quantized=quantized, device="cpu")
    jlog, jc = jl.prefill(jq, CFG, jnp.asarray(prompt), jc)
    tlog, tc = tl.prefill(tq, TCFG, torch.from_numpy(prompt).long(), tc)
    monkeypatch.setattr(tl, "flash_decode", _no_flash_decode)
    for step in range(7):
        j, t = np.asarray(jlog), tlog.numpy()
        err, scale = np.abs(t - j).max(), np.abs(j).max()
        assert err <= 2e-2 * scale, (step, err, scale)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
        assert np.array_equal(np.asarray(jtok), ttok.numpy()), step
        if step == 6:
            break
        jlog, jc = jl.decode_step(jq, CFG, jtok, jc)
        tlog, tc = tl.decode_step(tq, TCFG, ttok, tc)
    # past the setting the flash decode path runs again
    big = tl.KVCache.create(TCFG, 1, 2 * S, device="cpu")
    tl.prefill(tq, TCFG, torch.from_numpy(prompt).long(), big)
    with pytest.raises(AssertionError, match="xla_attn_max_cache"):
        tl.decode_step(tq, TCFG, ttok, big)


@pytest.mark.parametrize("quantized", [False, "int8", "fp8"])
def test_xla_decode_attention_matches_jax(quantized):
    """The function alone on a GQA cache with random contents: layer 1 of
    2, length 77 of 128 (the padded positions hold values the mask must
    hide)."""
    rng = np.random.default_rng(6)
    cfg = dataclasses.replace(CFG, n_heads=8, n_kv_heads=2)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tc = tl.KVCache.create(tcfg, 1, 128, quantized=quantized, device="cpu")
    kv = rng.normal(size=(2, 1, 2, 128, 64)).astype(np.float32)
    if quantized:
        q8 = rng.integers(-127, 128, size=tc.k.shape).astype(np.int8)
        tc.k.copy_(torch.from_numpy(q8).to(tc.k.dtype))
        tc.v.copy_(torch.from_numpy(-q8).to(tc.v.dtype))
        sc = rng.uniform(0.001, 0.02, size=tc.k_scale.shape)
        tc.k_scale.copy_(torch.from_numpy(sc.astype(np.float32)))
        tc.v_scale.copy_(torch.from_numpy(sc[..., ::-1].astype(np.float32)))
    else:
        tc.k.copy_(torch.from_numpy(kv).to(torch.bfloat16))
        tc.v.copy_(torch.from_numpy(kv[::-1].copy()).to(torch.bfloat16))
    lengths = torch.tensor([77], dtype=torch.int32)
    q = rng.normal(size=(1, 8, 64)).astype(np.float32)
    got = tl._xla_decode_attention(torch.from_numpy(q), tc, 1, lengths,
                                   0.125).numpy()

    def j(t):
        if t is None:
            return None
        if t.dtype == torch.float8_e4m3fn:
            return jnp.asarray(t.float().numpy()).astype(jnp.float8_e4m3fn)
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())

    jc = jl.KVCache(k=j(tc.k), v=j(tc.v), lengths=j(tc.lengths),
                    k_scale=j(tc.k_scale), v_scale=j(tc.v_scale))
    want = np.asarray(jl._xla_decode_attention(
        jnp.asarray(q), jc, 1, jnp.asarray([77], jnp.int32), 0.125))
    assert got.shape == want.shape == (1, 8, 64)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
