"""Q8_0, Q4_0 and Q6_K layers at llama2-7b's widths through the port's
``generate`` path against the JAX package's: dim 4096, MHA 32/32, the
intermediate padded 11008 -> 12288 as both packages pad it, two layers, the
vocabulary cut to 512. Both packages on the CPU: JAX's Pallas kernels run
interpreted, the port's wrappers take their plain versions.

The configurations: the preset's (no fused kernel takes these formats, so
the decode runs unfused: one matvec per linear) and bench.py's (x_quant8 +
``permute_hidden_params``: no model pack is built, so again unfused, with
int8 activations on every q4_0 linear and the head, while q8_0 ignores
x_quant8 and q6_k runs its hybrid matvec in both). The routes are recorded
through the port's kernel wrappers and asserted per wrapper and K.

Tolerances: logits within 2e-2 * max (3e-2 in bench.py's configuration,
tests/test_torch_q6k.py's bounds), greedy tokens exact; seed 7 is free of
ties (JAX's top-2 logit gap >= 0.1 at every step of every case,
asserted)."""

import collections
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
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm

SEED = 7
L, STEPS, PROMPT = 2, 3, 8
CFG = dataclasses.replace(PRESETS["llama2-7b"], n_layers=L, vocab_size=512,
                          max_seq_len=512)
WRAPPERS = ("q80_matvec", "q40_matvec", "q40_q8_matvec", "q80_gemm",
            "q40_gemm", "q4k_matvec", "q4k_q8_matvec", "q4k_gemm",
            "q6k_matvec", "q6k_q8_matvec")


def _port(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def dense():
    jp = jl.init_weights(CFG, seed=SEED, as_numpy=True)
    return jp, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


@pytest.fixture(scope="module")
def quantized(dense):
    """fmt -> (JAX params, port params) in that format, made once a module:
    the cases of one format (its configurations) share them, and one
    format is alive at a time (the cases run in format order)."""
    jp, dn = dense
    held = {}

    def get(fmt):
        if fmt not in held:
            held.clear()
            tp = convert.params_from_jax(dn, _port(CFG), device="cpu")
            held[fmt] = (jl.quantize_params(jp, fmt),
                         tl.quantize_params(tp, fmt))
        return held[fmt]

    return get


def _want(fmt, config):
    """Wrapper launches (by name, K) of an 8-token prefill and STEPS decode
    steps: the prefill's 8 rows take the GEMM (q6_k: the dense bf16
    route, no wrapper), the head's one row and every decode linear the
    format's matvec."""
    ks = {"wqkv": 4096, "wo": 4096, "w_gu": 4096, "w_down": 12288}
    matvec = {"q8_0": "q80_matvec", "q4_0": "q40_matvec",
              "q6_k": "q6k_q8_matvec"}[fmt]
    if fmt == "q4_0" and config == "bench":
        matvec = "q40_q8_matvec"
    want = collections.Counter()
    for k in ks.values():
        want[(matvec, k)] += L * STEPS
        if fmt != "q6_k":
            want[(fmt.replace("_", "") + "_gemm", k)] += L
    want[(matvec, 4096)] += 1 + STEPS                   # the head
    return want


@pytest.mark.parametrize("fmt,config", [
    ("q8_0", "preset"), ("q8_0", "bench"), ("q4_0", "preset"),
    ("q4_0", "bench"), ("q6_k", "preset")],
    ids=["q8_0-preset", "q8_0-bench", "q4_0-preset", "q4_0-bench",
         "q6_k-preset"])
def test_generate_7b_width_matches_jax(quantized, fmt, config, monkeypatch):
    jq, tq = quantized(fmt)
    flags = {} if config == "preset" else dict(x_quant8=True, hperm=True)
    jc = dataclasses.replace(CFG, **flags)
    tc = _port(jc)
    assert tq["layers"][0]["w_down"].array_shape == (4096, 12288)
    assert "w_gu" in jq["layers"][0]                 # no w_gu_f: unfused
    if config == "bench":
        jq = jax.device_put(jl.permute_hidden_params(jq, jc))
        tq = tl.permute_hidden_params(tq, tc)
        assert "m_pack" not in jq and "m_pack" not in tq
    calls = collections.Counter()
    for name in WRAPPERS:
        fn = getattr(tqm, name)
        monkeypatch.setattr(tqm, name, lambda x, w, name=name, fn=fn: (
            calls.update([(name, w.array_shape[1])]), fn(x, w))[1])

    prompt = np.random.default_rng(SEED).integers(
        1, CFG.vocab_size, size=(1, PROMPT)).astype(np.int32)
    jcache = jl.KVCache.create(jc, 1, 256)
    tcache = tl.KVCache.create(tc, 1, 256, device="cpu")
    jlog, jcache = jl.prefill(jq, jc, jnp.asarray(prompt), jcache)
    tlog, tcache = tl.prefill(tq, tc, torch.from_numpy(prompt), tcache)
    jlogs, tlogs = [np.asarray(jlog)], [tlog.numpy()]
    for _ in range(STEPS):
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
        assert int(jtok[0]) == int(ttok[0])
        jlog, jcache = jl.decode_step(jq, jc, jtok, jcache)
        tlog, tcache = tl.decode_step(tq, tc, ttok, tcache)
        jlogs.append(np.asarray(jlog))
        tlogs.append(tlog.numpy())
    j, t = np.stack(jlogs), np.stack(tlogs)
    top2 = np.sort(j, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() >= 0.1
    assert np.array_equal(j.argmax(-1), t.argmax(-1))
    err, scale = np.abs(t - j).max(), np.abs(j).max()
    tol = 2e-2 if config == "preset" else 3e-2
    assert err <= tol * scale, f"err {err} vs {tol} * {scale}"
    assert calls == _want(fmt, config), calls
