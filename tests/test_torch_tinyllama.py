"""TinyLlama-1.1B's shape (dim 2048, GQA 32/4, head_dim 64, intermediate
5632) through the port's ``generate`` against the JAX package's, at full
width with two layers and the vocabulary cut to 512, q4_k layers and a q6_k
head (the Q4_K_M mix). Both packages on the CPU: JAX's Pallas kernels run
interpreted, the port's wrappers take their plain versions.

The branches are the reference's, recorded through the port's kernel
wrappers: no fused kernel at dim 2048 (tests/test_torch_fused_gates.py), no
RoPE + repack kernel at head_dim 64, the exact matvec wherever x_quant8's
gate ((K/32) % 128) is closed, w_down at K = 5632 (K/32 = 176, which the
reference's repeat-aligned kernels do not take and quantize_params does not
pad: 8192 > 1.15 * 5632) through ``q4k_matvec`` at one row (the reference's
any-K ``_vpu_e_kernel``) and ``q4k_gemm`` from two (its bf16
``qmatmul_xla``, the same function), and the [512, 2048] q6_k head through
the exact-f32 ``q6k_matvec`` (its ``_chunk6_kernel``). Logits within
2e-2 * max (tests/test_torch_llama.py's model bound), greedy tokens exact;
seed 4 is free of ties (JAX's top-2 logit gap >= 0.125, asserted)."""

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
from ggml_cuda_experiments_tpu_torch.models.config import (
    ModelConfig, PRESETS as TPRESETS)
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm

CUT = dict(n_layers=2, vocab_size=512)
TINY = dataclasses.replace(PRESETS["tinyllama-1.1b"], **CUT)
STEPS = 3
PROMPT = 8


def _port(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def models():
    jp = jl.init_weights(TINY, seed=4, as_numpy=True)
    dense = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    jq = jl.quantize_params(jp, "q4_k", head_fmt="q6_k")
    tq = tl.quantize_params(convert.params_from_jax(
        dense, _port(TINY), device="cpu"), "q4_k", head_fmt="q6_k")
    return jq, tq


def test_quantized_tree_has_the_reference_shapes(models):
    jq, tq = models
    assert _port(TINY) == dataclasses.replace(TPRESETS["tinyllama-1.1b"],
                                              **CUT)
    lay = tq["layers"][0]
    assert lay["w_down"].array_shape == (2048, 5632)        # no pad
    assert lay["w_gu"].array_shape == (2 * 5632, 2048)
    assert lay["wqkv"].array_shape == ((32 + 2 * 4) * 64, 2048)
    assert tq["lm_head"].fmt == "q6_k" and jq["lm_head"].fmt == "q6_k"
    assert "w_gu" in jq["layers"][0]                        # no w_gu_f
    assert "m_pack" not in tl.permute_hidden_params(
        tq, _port(dataclasses.replace(TINY, x_quant8=True, hperm=True)))


@pytest.mark.parametrize("flags", [{}, {"x_quant8": True}],
                         ids=["preset", "x_quant8"])
def test_generate_matches_jax(models, flags, monkeypatch):
    jq, tq = models
    jc = dataclasses.replace(TINY, **flags)
    tc = _port(jc)
    calls = collections.Counter()

    def spy(owner, name, key):
        fn = getattr(owner, name)

        def wrapped(*a, **kw):
            calls[key(*a)] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, wrapped)

    for name in ("q4k_matvec", "q4k_gemm", "q4k_q8_matvec", "q6k_matvec",
                 "q6k_q8_matvec"):
        spy(tqm, name, lambda x, w, name=name: (name, w.array_shape[1],
                                                x.shape[0] > 1))
    for name in ("rope_pack_prefill", "attention_fused", "mlp_fused"):
        spy(tl, name, lambda *a, name=name: (name,))

    prompt = np.random.default_rng(4).integers(
        1, TINY.vocab_size, size=(1, PROMPT)).astype(np.int32)
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
    assert (top2[..., 1] - top2[..., 0]).min() >= 0.125
    assert np.array_equal(j.argmax(-1), t.argmax(-1))
    err, scale = np.abs(t - j).max(), np.abs(j).max()
    assert err <= 2e-2 * scale, f"err {err} vs 2e-2 * {scale}"

    L = TINY.n_layers
    assert calls == {
        # per layer: wqkv, wo, w_gu at K = 2048 and w_down at K = 5632
        ("q4k_gemm", 2048, True): 3 * L,
        ("q4k_gemm", 5632, True): L,
        ("q4k_matvec", 2048, False): 3 * L * STEPS,
        ("q4k_matvec", 5632, False): L * STEPS,
        # the head: the prompt's last row, then once per step
        ("q6k_matvec", 2048, False): 1 + STEPS}, calls
