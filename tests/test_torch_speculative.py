"""Port's speculative decoding and chunked verify / prefill against the JAX
package, on the CPU at the ``debug`` size.

``chunk_step`` / ``prefill_chunked`` on the same bf16 weights as the JAX
functions: logits and cache within 2e-2 * max (tests/test_speculative.py's
2e-2, taken of the largest value as the port's other model tests take it:
the two packages round bf16 at other places) and lengths equal. The
lossless property in f32, the only dtype where it is exact (bf16 flips
near-tied argmaxes between the verify kernel and the decode kernel): on the
JAX package's f32 weights, carried across with
``params_from_jax(dtype=torch.float32)``, the port's ``speculative_generate``
and ``speculative_scan`` (eager here) emit exactly the port's greedy
``generate`` stream, and in one case JAX ``speculative_generate``'s tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models import speculative as jspec
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models import speculative as tspec
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig

CFG = PRESETS["debug"]
TCFG = ModelConfig(**dataclasses.asdict(CFG))
F32 = torch.float32


def _port_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _port_params(jparams, cfg, dtype=torch.bfloat16):
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    return convert.params_from_jax(tree, _port_cfg(cfg), device="cpu",
                                   dtype=dtype)


@pytest.fixture(scope="module")
def bf16_pair():
    jp = jl.init_weights(CFG, seed=0)
    return jp, _port_params(jp, CFG)


@pytest.fixture(scope="module")
def f32_models():
    """(name -> (JAX params, port params, JAX cfg)) for the drafts of the
    JAX tests: the target itself, another model of its shape, and a
    1-layer one."""
    small = dataclasses.replace(CFG, n_layers=1, name="draft")
    out = {}
    for name, cfg, seed in (("target", CFG, 0), ("different", CFG, 99),
                            ("small", small, 7)):
        jp = jl.init_weights(cfg, seed=seed, dtype=jnp.float32)
        out[name] = (jp, _port_params(jp, cfg, F32), cfg)
    return out


def _prompt(seed, n=8):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (1, n))


def _close(got, want, tol=2e-2):
    """Within tol * max|want|: bf16 logits and caches of two packages (or
    of two kernels) part by a few bf16 ulps of the largest values."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"err {err} vs {tol} * {scale}"


def test_chunk_step_matches_jax(bf16_pair):
    """Two windows (8 tokens over an empty cache, then 3 over that prefix)
    through both packages: logits, k / v and lengths."""
    jp, tp = bf16_pair
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 11))
    jc = jl.KVCache.create(CFG, 2, 64)
    tc = tl.KVCache.create(TCFG, 2, 64, device="cpu")
    for a, b in ((0, 8), (8, 11)):
        jlog, jc = jspec.chunk_step(jp, CFG, jnp.asarray(toks[:, a:b],
                                                         jnp.int32), jc)
        tlog, tc = tspec.chunk_step(tp, TCFG, torch.from_numpy(toks[:, a:b]),
                                    tc)
        assert tlog.dtype == F32 and tlog.shape == (2, b - a, CFG.vocab_size)
        _close(tlog.numpy(), jlog)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    _close(tc.k.float().numpy(), np.asarray(jc.k, np.float32))
    _close(tc.v.float().numpy(), np.asarray(jc.v, np.float32))


def test_prefill_chunked_matches_jax(bf16_pair):
    jp, tp = bf16_pair
    toks = _prompt(1, 16)
    want, jc = jspec.prefill_chunked(jp, CFG, jnp.asarray(toks, jnp.int32),
                                     jl.KVCache.create(CFG, 1, 64), chunk=4)
    got, tc = tspec.prefill_chunked(
        tp, TCFG, torch.from_numpy(toks),
        tl.KVCache.create(TCFG, 1, 64, device="cpu"), chunk=4)
    _close(got.numpy(), want)
    assert tc.lengths.tolist() == [16] == np.asarray(jc.lengths).tolist()
    _close(tc.k.float().numpy(), np.asarray(jc.k, np.float32))


@pytest.mark.parametrize("fmt", [None, "q4_k"])
def test_chunk_step_after_prefix_equals_decode(bf16_pair, fmt):
    """A window over a non-empty cache == decoding its tokens one by one
    (dense weights, and q4_k: the GEMM at M = 3 against the matvec)."""
    tp = bf16_pair[1] if fmt is None else tl.quantize_params(bf16_pair[1],
                                                             fmt)
    prompt = torch.from_numpy(_prompt(2))
    extra = torch.from_numpy(_prompt(3, 3)).to(torch.int32)
    c1 = tl.KVCache.create(TCFG, 1, 64, device="cpu")
    tl.prefill(tp, TCFG, prompt, c1)
    want = [tl.decode_step(tp, TCFG, extra[:, i], c1)[0] for i in range(3)]
    c2 = tl.KVCache.create(TCFG, 1, 64, device="cpu")
    tl.prefill(tp, TCFG, prompt, c2)
    got, c2 = tspec.chunk_step(tp, TCFG, extra, c2)
    for i in range(3):
        _close(got[0, i].numpy(), want[i][0].numpy())
    assert c2.lengths.tolist() == c1.lengths.tolist() == [11]
    tspec.rewind(c2, 2)
    assert c2.lengths.tolist() == [9]


def _draft(f32_models, kind):
    jp, tp, cfg = f32_models[{"same": "target", "tiny": "small",
                              "smaller": "small"}.get(kind, kind)]
    return jp, tp, cfg


def _greedy(tp, prompt, steps):
    return tl.generate(tp, TCFG, torch.from_numpy(prompt), steps,
                       cache=tl.KVCache.create(TCFG, 1, 256, F32,
                                               device="cpu"))


@pytest.mark.parametrize("kind,gamma", [
    ("same", 3), ("different", 4), ("different", 1), ("tiny", 2)])
def test_speculative_equals_greedy(f32_models, kind, gamma):
    _, tparams, _ = f32_models["target"]
    _, dparams, dcfg = _draft(f32_models, kind)
    prompt, steps = _prompt(4), 12
    want = _greedy(tparams, prompt, steps)
    got, stats = tspec.speculative_generate(
        tparams, TCFG, dparams, _port_cfg(dcfg), torch.from_numpy(prompt),
        steps, gamma=gamma, cache_dtype=F32)
    np.testing.assert_array_equal(got, want, err_msg=str(stats))
    assert got.dtype == np.int32 and stats["verify_calls"] >= 1
    if kind == "same":
        assert stats["accepted"] >= 0.9 * stats["drafted"], stats


@pytest.mark.parametrize("kind,gamma", [
    ("same", 3), ("different", 4), ("smaller", 2)])
def test_speculative_scan_equals_greedy(f32_models, kind, gamma):
    """The window scan (eager on the CPU) emits exactly the greedy stream."""
    _, tparams, _ = f32_models["target"]
    _, dparams, dcfg = _draft(f32_models, kind)
    dcfg = _port_cfg(dcfg)
    prompt, steps, windows = torch.from_numpy(_prompt(5)), 18, 8
    want = _greedy(tparams, prompt.numpy(), steps)[0].tolist()
    tcache = tl.KVCache.create(TCFG, 1, 256, F32, device="cpu")
    dcache = tl.KVCache.create(dcfg, 1, 256, F32, device="cpu")
    tlogits, tcache = tl.prefill(tparams, TCFG, prompt, tcache)
    tl.prefill(dparams, dcfg, prompt, dcache)
    cur = torch.argmax(tlogits, -1).to(torch.int32)
    toks, counts, cur2, tcache, dcache = tspec.speculative_scan(
        tparams, TCFG, dparams, dcfg, cur, tcache, dcache, gamma=gamma,
        windows=windows)
    assert toks.shape == (windows, gamma + 1) and counts.shape == (windows,)
    stream = [int(cur[0])]
    for w in range(windows):
        stream.extend(toks[w, :counts[w]].tolist())
    n = min(len(stream), steps)
    assert n >= windows + 1
    assert stream[:n] == want[:n], (kind, stream[:n], want[:n])
    assert int(cur2[0]) == stream[-1]
    assert tcache.lengths.tolist() == [8 + int(counts.sum())]
    assert dcache.lengths.tolist() == tcache.lengths.tolist()
    if kind == "same":
        assert int(counts.min()) == gamma + 1


def test_speculative_generate_matches_jax(f32_models):
    """The port's tokens and acceptance counters equal JAX
    ``speculative_generate``'s, f32 weights and cache on both sides."""
    jt, tparams, _ = f32_models["target"]
    jd, dparams, dcfg = f32_models["different"]
    prompt, steps, gamma = _prompt(6), 10, 3
    want, jstats = jspec.speculative_generate(
        jt, CFG, jd, dcfg, jnp.asarray(prompt, jnp.int32), steps,
        gamma=gamma, cache_dtype=jnp.float32)
    got, stats = tspec.speculative_generate(
        tparams, TCFG, dparams, _port_cfg(dcfg), torch.from_numpy(prompt),
        steps, gamma=gamma, cache_dtype=F32)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == jstats


def test_generate_scan_equals_generate(bf16_pair):
    tp = bf16_pair[1]
    prompt = torch.from_numpy(_prompt(7))
    want = tl.generate(tp, TCFG, prompt, 6)
    got = tl.generate_scan(tp, TCFG, prompt,
                           tl.KVCache.create(TCFG, 1, 256, device="cpu"), 6)
    assert got.shape == (1, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_quantized_cache_raises(bf16_pair):
    cache = tl.KVCache.create(TCFG, 1, 64, quantized="int8", device="cpu")
    with pytest.raises(ValueError, match="unquantized"):
        tspec.chunk_step(bf16_pair[1], TCFG,
                         torch.zeros((1, 2), dtype=torch.long), cache)


def test_spec_bench_measures_on_the_cpu(bf16_pair):
    """The tool's measuring functions at the debug size (q4_k): windows of
    draft = target (the stream of the longer run is speculative_scan's)
    and of a truncated draft, the plain per-token cost, the teacher-forced
    acceptance (the whole target as its own draft: every position agrees
    but near-ties) and the break-even arithmetic."""
    from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb
    tp = tl.quantize_params(bf16_pair[1], "q4_k")
    prompt = torch.from_numpy(_prompt(8, 16))
    secs, counts, stream = sb.window_cost(tp, TCFG, tp, TCFG, prompt, 2, 1,
                                          3, max_len=256)
    assert np.isfinite(secs) and counts.shape == (3,)
    assert counts.min() >= 1 and counts.max() <= 3
    assert len(stream) == 1 + counts.sum()
    tcache = tl.KVCache.create(TCFG, 1, 256, device="cpu")
    dcache = tl.KVCache.create(TCFG, 1, 256, device="cpu")
    cur = torch.argmax(tl.prefill(tp, TCFG, prompt, tcache)[0], -1)
    tl.prefill(tp, TCFG, prompt, dcache)
    toks, want, *_ = tspec.speculative_scan(tp, TCFG, tp, TCFG, cur, tcache,
                                            dcache, gamma=2, windows=3)
    np.testing.assert_array_equal(counts, want.numpy())
    assert stream[1:] == [t for row, n in zip(toks.tolist(), want.tolist())
                          for t in row[:n]]
    dp, dcfg = sb.truncated(tp, TCFG, 1)
    assert dcfg.n_layers == 1 and dp["lm_head"] is tp["lm_head"]
    _, counts, _ = sb.window_cost(tp, TCFG, dp, dcfg, prompt, 3, 1, 2,
                                  max_len=256)
    assert counts.min() >= 1 and counts.max() <= 4
    assert np.isfinite(sb.plain_per_token(tp, TCFG, prompt, max_len=256))
    acc = sb.teacher_forced_acceptance(tp, TCFG, tp, TCFG, prompt,
                                       n_eval=24, max_len=256)
    assert 0.9 <= acc <= 1.0
    assert sb.break_even(2.0, 1.0, 4) == pytest.approx(0.52)
    assert sb.break_even(10.0, 1.0, 4) is None
    assert sb.speedup(5.0, 1.0, 2.0) == 2.5
