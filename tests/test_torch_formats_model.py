"""Q8_0 and Q4_0 through the port's model paths against the JAX package's:
TinyLlama-1.1B's shape (dim 2048, GQA 32/4, head_dim 64, intermediate
5632: w_down at K = 5632, which neither package pads, 8192 > 1.15 * 5632)
through ``generate`` at two layers and a 512 vocabulary, and the ``Engine``
on Q4_0 weights over an int8 page pool (the JAX package's serving stack of
tests/test_engine.py, on one device). Both packages on the CPU: JAX's Pallas
kernels run interpreted, the port's wrappers take their plain versions.

The routes are recorded through the port's kernel wrappers: the prompt's
rows take the format's GEMM, every one-row product its exact matvec, at
K = 2048 and 5632 alike, and x_quant8 changes nothing here (its gate,
(K/32) % 128 == 0, is closed at both widths). Logits within 2e-2 * max
(tests/test_torch_llama.py's model bound), greedy tokens exact; seed 4 is
free of ties (JAX's top-2 logit gap >= 0.1, asserted). The engines are
token-exact against each other and the port's own ``generate`` on a bf16
cache agrees with the int8-pool engine on the first token of every
request (the pool's quantization may part later tokens)."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import engine as je
from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models import engine as te
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm

TINY = dataclasses.replace(PRESETS["tinyllama-1.1b"], n_layers=2,
                           vocab_size=512)
SEED, STEPS, PROMPT = 4, 3, 8
WRAPPERS = ("q80_matvec", "q40_matvec", "q40_q8_matvec", "q80_gemm",
            "q40_gemm", "q4k_matvec", "q4k_q8_matvec", "q4k_gemm")


def _port(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def tiny():
    jp = jl.init_weights(TINY, seed=SEED, as_numpy=True)
    tp = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), _port(TINY), device="cpu")
    return {fmt: (jl.quantize_params(jp, fmt), tl.quantize_params(tp, fmt))
            for fmt in ("q8_0", "q4_0")}


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
@pytest.mark.parametrize("flags", [{}, {"x_quant8": True}],
                         ids=["preset", "x_quant8"])
def test_tinyllama_generate_matches_jax(tiny, fmt, flags, monkeypatch):
    jq, tq = tiny[fmt]
    jc = dataclasses.replace(TINY, **flags)
    tc = _port(jc)
    lay = tq["layers"][0]
    assert lay["w_down"].array_shape == (2048, 5632)       # no pad
    assert {w.fmt for w in lay.values()
            if isinstance(w, tqm.QuantLinear)} == {fmt}
    calls = collections.Counter()
    for name in WRAPPERS:
        fn = getattr(tqm, name)
        monkeypatch.setattr(tqm, name, lambda x, w, name=name, fn=fn: (
            calls.update([(name, w.array_shape[1])]), fn(x, w))[1])

    prompt = np.random.default_rng(SEED).integers(
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
    assert (top2[..., 1] - top2[..., 0]).min() >= 0.1
    assert np.array_equal(j.argmax(-1), t.argmax(-1))
    err, scale = np.abs(t - j).max(), np.abs(j).max()
    assert err <= 2e-2 * scale, f"err {err} vs 2e-2 * {scale}"

    L = TINY.n_layers
    tag = fmt.replace("_", "")
    assert calls == {
        # per layer: wqkv, wo, w_gu at K = 2048 and w_down at K = 5632
        (f"{tag}_gemm", 2048): 3 * L,
        (f"{tag}_gemm", 5632): L,
        # the head: the prompt's last row, then once per step
        (f"{tag}_matvec", 2048): 3 * L * STEPS + 1 + STEPS,
        (f"{tag}_matvec", 5632): L * STEPS}, calls


def test_q4_0_engine_int8_pool_matches_jax():
    """The Engine on Q4_0 weights over an int8 pool (3 ragged requests
    through 4 slots, each step's batch on ``q40_gemm``), token-exact
    against the JAX Engine."""
    cfg = dataclasses.replace(PRESETS["debug"], fuse_mlp=False,
                              fuse_attn=False, fuse_layer=False)
    tcfg = _port(cfg)
    jp = jl.init_weights(cfg, seed=13)
    tp = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), tcfg, device="cpu")
    jq = jl.quantize_params(jp, "q4_0")
    tq = tl.quantize_params(tp, "q4_0")
    assert tq["lm_head"].fmt == tq["layers"][0]["wqkv"].fmt == "q4_0"
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 12, 9)]
    kw = dict(max_batch=4, page_size=32, n_pages=64, max_seq_len=256)
    gemm = tqm.q40_gemm
    rows = collections.Counter()

    def counted(x, w):
        rows[x.shape[0]] += 1
        return gemm(x, w)

    outs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tqm, "q40_gemm", counted)
        for eng in (te.Engine(tq, tcfg, quantized_kv="int8", **kw),
                    je.Engine(jq, cfg, quantized_kv=True, **kw)):
            rids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
            done = eng.run_to_completion()
            outs.append([done[r] for r in rids])
    assert outs[0] == outs[1]
    assert rows[4] > 0                     # batched decode steps, 4 slots
    first = [tl.generate(tq, tcfg, torch.tensor([p]), 1)[0, 0] for p in
             prompts]
    assert [o[0] for o in outs[0]] == first
