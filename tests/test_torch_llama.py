"""Port's Llama model against the JAX package (both on the CPU; JAX's
Pallas kernels run interpreted, the port's wrappers take their plain
versions).

These tests pin the unfused branch (fuse_mlp / fuse_attn / fuse_layer
off) in both packages; tests/test_torch_fused_*.py hold the fused batch-1
decode branches. Weights come from the JAX
``init_weights`` and cross with ``params_from_jax``; both packages then
quantize through the oracle's arithmetic, so every Q4_K block is identical
(asserted below) and the logits differ only by summation order and bf16
rounding: bound 2e-2 * max, as tests/test_model.py holds decode against
prefill. Greedy tokens must match exactly."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models import engine as te
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models.config import (
    ModelConfig as TModelConfig, PRESETS as TPRESETS)
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm
from ggml_cuda_experiments_tpu_torch.utils.tensor_io import load_tensor

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "golden_debug.tensor"
UNFUSED = dict(fuse_mlp=False, fuse_attn=False, fuse_layer=False)
DEBUG = dataclasses.replace(PRESETS["debug"], **UNFUSED)
# one layer at full 7B width: _chunk_kernel, _decode_kernel_ht and the
# 11008 -> 12288 intermediate pad
ONE_LAYER_7B = dataclasses.replace(PRESETS["llama2-7b"], n_layers=1,
                                   vocab_size=512, **UNFUSED)


def _port(cfg):
    """The port's ModelConfig with the same fields as the JAX one."""
    return TModelConfig(**dataclasses.asdict(cfg))


TDEBUG = _port(DEBUG)


def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _both(cfg, seed):
    """(JAX quantized tree, port quantized tree) from the same weights."""
    jp = jl.init_weights(cfg, seed=seed)
    tp = convert.params_from_jax(_np_tree(jp), _port(cfg), device="cpu")
    return jl.quantize_params(jp, "q4_k"), tl.quantize_params(tp, "q4_k")


@pytest.fixture(scope="module")
def debug_params():
    return _both(DEBUG, 7)


@pytest.fixture(scope="module")
def params_7b():
    return _both(ONE_LAYER_7B, 11)


def _assert_close(got, want, tol=2e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"err {err} vs {tol} * {scale}"


def _greedy_pair(jq, tq, cfg, prompt, steps):
    """Prefill + ``steps`` greedy decode steps in both packages; returns the
    stacked logits and tokens of each."""
    tcfg = _port(cfg)
    jc = jl.KVCache.create(cfg, prompt.shape[0], 256)
    tc = tl.KVCache.create(tcfg, prompt.shape[0], 256, device="cpu")
    jlog, jc = jl.prefill(jq, cfg, jnp.asarray(prompt), jc)
    tlog, tc = tl.prefill(tq, tcfg, torch.from_numpy(prompt), tc)
    jout, tout = [np.asarray(jlog)], [tlog.numpy()]
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1).to(torch.int32)
    jtoks, ttoks = [np.asarray(jtok)], [ttok.numpy()]
    for _ in range(steps):
        jlog, jc = jl.decode_step(jq, cfg, jtok, jc)
        tlog, tc = tl.decode_step(tq, tcfg, ttok, tc)
        jout.append(np.asarray(jlog))
        tout.append(tlog.numpy())
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
        jtoks.append(np.asarray(jtok))
        ttoks.append(ttok.numpy())
    return (np.stack(jout), np.stack(tout), np.stack(jtoks),
            np.stack(ttoks))


def test_params_from_jax_is_bit_exact():
    jp = _np_tree(jl.init_weights(DEBUG, seed=5))
    tp = convert.params_from_jax(jp, TDEBUG, device="cpu")
    for key in ("embed", "final_norm", "lm_head"):
        assert tp[key].dtype == torch.bfloat16
        assert np.array_equal(tp[key].float().numpy(), jp[key]), key
    for jlay, tlay in zip(jp["layers"], tp["layers"]):
        assert set(jlay) == set(tlay)
        for key in jlay:
            assert np.array_equal(tlay[key].float().numpy(), jlay[key]), key


def test_params_from_jax_checks_shapes():
    jp = _np_tree(jl.init_weights(DEBUG, seed=5))
    with pytest.raises(ValueError):                  # layer count
        convert.params_from_jax(jp, dataclasses.replace(TDEBUG, n_layers=1),
                                device="cpu")
    with pytest.raises(ValueError):                  # widths
        convert.params_from_jax(jp, dataclasses.replace(TDEBUG, dim=512),
                                device="cpu")


def test_quantized_tree_dequant_bit_equal_debug(debug_params):
    jq, tq = debug_params
    pairs = [(jq["lm_head"], tq["lm_head"])]
    for jlay, tlay in zip(jq["layers"], tq["layers"]):
        pairs += [(jlay[k], tlay[k]) for k in ("wqkv", "wo", "w_gu",
                                               "w_down")]
    for jw, tw in pairs:
        assert np.array_equal(tqm.dequantize(tw).numpy(),
                              np.asarray(jqm.dequantize_jnp(jw)))


def test_quantized_tree_dequant_bit_equal_7b_width(params_7b):
    """Includes the padded 12288-wide MLP; the JAX tree stores gate/up rows
    in w_down's interleaved order (w_gu_f), the port in logical order."""
    jq, tq = params_7b
    jlay, tlay = jq["layers"][0], tq["layers"][0]
    for k in ("wqkv", "wo", "w_down"):
        assert np.array_equal(tqm.dequantize(tlay[k]).numpy(),
                              np.asarray(jqm.dequantize_jnp(jlay[k]))), k
    assert tlay["w_down"].shape == (4096, 12288)
    gu = tqm.dequantize(tlay["w_gu"]).numpy()
    p = jqm._perm(12288)
    want = np.asarray(jqm.dequantize_jnp(jlay["w_gu_f"]))
    assert np.array_equal(np.concatenate([gu[:12288][p], gu[12288:][p]]),
                          want)
    assert np.array_equal(tqm.dequantize(tq["lm_head"]).numpy(),
                          np.asarray(jqm.dequantize_jnp(jq["lm_head"])))


def test_debug_prefill_and_decode_match_jax(debug_params):
    jq, tq = debug_params
    prompt = np.random.default_rng(3).integers(
        0, DEBUG.vocab_size, size=(1, 8)).astype(np.int32)
    jlog, tlog, jtok, ttok = _greedy_pair(jq, tq, DEBUG, prompt, steps=4)
    _assert_close(tlog, jlog)
    assert np.array_equal(ttok, jtok)


def test_7b_width_one_layer_matches_jax(params_7b):
    jq, tq = params_7b
    prompt = np.random.default_rng(4).integers(
        0, ONE_LAYER_7B.vocab_size, size=(1, 8)).astype(np.int32)
    jlog, tlog, _, _ = _greedy_pair(jq, tq, ONE_LAYER_7B, prompt, steps=2)
    _assert_close(tlog, jlog)


def test_reproduces_golden_file():
    """tests/data/golden_debug.tensor: seed 1234, prompt 1..8, q4_k."""
    want, name = load_tensor(GOLDEN)
    want = want.numpy()
    assert name.startswith("debug_q4k_seed1234")
    cfg = TPRESETS["debug"]
    params = tl.quantize_params(convert.params_from_jax(
        _np_tree(jl.init_weights(PRESETS["debug"], seed=1234)), cfg,
        device="cpu"), "q4_k")
    cache = tl.KVCache.create(cfg, 1, 256, device="cpu")
    logits, cache = tl.prefill(params, cfg,
                               torch.arange(1, 9, dtype=torch.int32)[None],
                               cache)
    got = [logits.numpy()]
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(want.shape[0] - 1):
        logits, cache = tl.decode_step(params, cfg, tok, cache)
        got.append(logits.numpy())
        tok = torch.argmax(logits, -1).to(torch.int32)
    got = np.concatenate(got, axis=0)
    assert np.array_equal(np.argmax(got, -1), np.argmax(want, -1))
    _assert_close(got, want)


def test_decode_matches_prefill():
    """logits(prefill t0..tN) == logits(prefill t0..tN-1, decode tN) on the
    port alone: cache writes, RoPE positions and lengths at once."""
    params = tl.quantize_params(tl.init_weights(TDEBUG, seed=3, device="cpu"),
                                "q4_k")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, DEBUG.vocab_size, size=(2, 8)).astype(np.int64))
    full, _ = tl.prefill(params, TDEBUG, toks,
                         tl.KVCache.create(TDEBUG, 2, 256, device="cpu"))
    cache = tl.KVCache.create(TDEBUG, 2, 256, device="cpu")
    _, cache = tl.prefill(params, TDEBUG, toks[:, :-1], cache)
    inc, cache = tl.decode_step(params, TDEBUG, toks[:, -1], cache)
    assert cache.lengths.tolist() == [8, 8]
    _assert_close(inc.numpy(), full.numpy())


def test_layer_hook_sees_and_forces_each_layer_input():
    """``_forward``'s layer_hook gets every layer's input and its result is
    what the layer takes: an identity hook changes nothing, and handing
    the last layer another run's input gives that run's logits."""
    params = tl.quantize_params(tl.init_weights(TDEBUG, seed=3, device="cpu"),
                                "q4_k")
    rng = np.random.default_rng(6)
    a, b = (torch.from_numpy(rng.integers(0, DEBUG.vocab_size, size=(1, 8)))
            for _ in range(2))
    pos = torch.arange(8, dtype=torch.int32)[None]

    def run(toks, hook=None):
        cache = tl.KVCache.create(TDEBUG, 1, 256, device="cpu")
        return tl._forward(params, TDEBUG, toks, cache, pos, decode=False,
                           layer_hook=hook)[0]

    seen = {}
    got = run(a, lambda li, h, b0: seen.setdefault(li, h))
    assert sorted(seen) == list(range(TDEBUG.n_layers))
    assert torch.equal(seen[0], params["embed"][a])
    assert torch.equal(got, run(a))
    last = TDEBUG.n_layers - 1
    forced = run(b, lambda li, h, b0: seen[li] if li == last else h)
    assert torch.equal(forced, got) and not torch.equal(forced, run(b))


def test_generate_is_deterministic_greedy():
    params = tl.quantize_params(tl.init_weights(TDEBUG, seed=2, device="cpu"),
                                "q4_k")
    prompt = torch.arange(1, 9)[None]
    out1 = tl.generate(params, TDEBUG, prompt, steps=5)
    out2 = tl.generate(params, TDEBUG, prompt, steps=5)
    assert out1.shape == (1, 5) and np.array_equal(out1, out2)
    assert ((out1 >= 0) & (out1 < DEBUG.vocab_size)).all()


@pytest.mark.parametrize("case", ["native_scheduler", "x_prepermuted",
                                  "hperm_moe"])
def test_unported_options_raise(case):
    params = tl.quantize_params(tl.init_weights(TDEBUG, seed=1, device="cpu"),
                                "q4_k")
    # the native scheduler is ported; what it does not take (chunked
    # prefill, as in the reference) raises ValueError
    err = ValueError if case == "native_scheduler" else NotImplementedError
    with pytest.raises(err):
        if case == "x_prepermuted":
            tl.apply_linear(torch.zeros((1, 256)), params["lm_head"],
                            x_prepermuted=True)
        elif case == "hperm_moe":
            moe = dict(params, layers=[dict(params["layers"][0],
                                            router=torch.zeros(4, 256))])
            tl.permute_hidden_params(moe, TDEBUG)
        else:
            te.Engine(params, TDEBUG, max_batch=2, page_size=32, n_pages=8,
                      max_seq_len=64, scheduler="native", prefill_chunk=32)


def _run(args, **env):
    return subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **env})


def test_port_package_never_imports_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); before = set(sys.modules)\n"
        "import importlib, pkgutil, ggml_cuda_experiments_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules\n"
        "assert 'ggml_cuda_experiments_tpu_torch.models.llama' in mods\n"
        "new = ['parallel.' + m for m in ('mesh', 'launch', 'ring_attention',"
        " 'tp', 'collective_matmul', 'pipeline', 'full', 'multihost')]\n"
        "new += ['tools.multihost_run', 'models.moe']\n"
        "new += ['utils.' + m for m in ('gguf', 'tokenizer', 'tensor_io',"
        " 'loader')]\n"
        "assert all(p.__name__ + '.' + m in mods for m in new), new\n"
        "from ggml_cuda_experiments_tpu_torch.parallel import launch\n"
        "ckpt = tuple(p.__name__ + '.utils.' + m for m in ('gguf', "
        "'tokenizer', 'tensor_io', 'loader'))\n"
        "ranks = launch.run_spmd(launch.loaded_modules, 2, 'gloo', 'cpu', 120,"
        " args=ckpt)\n"
        "for got in ranks:\n"
        "    bad = [m for m in got if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'ml_dtypes', 'ggml_cuda_experiments_tpu')]\n"
        "    assert not bad, bad\n"
        "    assert 'ggml_cuda_experiments_tpu_torch.parallel.multihost' in got\n"
        "    assert all(m in got for m in ckpt), ckpt\n"
        "print('imported', len(mods))\n")
    r = _run([sys.executable, "-I", "-c", code, str(REPO)])
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout


def test_chip_smoke_fails_without_a_gpu():
    r = _run([sys.executable, "chip_smoke.py"], CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "is_available() is False" in r.stderr
