"""The kernel lab's tools on the CPU (``--cpu``: the plain versions).

- ``kernel_test`` passes at a small GQA shape, split-KV, single-pass and
  on an int8 cache, and fails (exit 1) at ``--tol 0``.
- ``gemm_bench --cpu`` runs every case once at tiny sizes and checks the
  hand GEMM's result against the library's (it times nothing there); on a
  machine with no card its default run refuses to start.
- ``perplexity --cpu --model debug`` gives the JAX pipeline's numbers on
  the same seeded weights (JAX ``llama.prefill(all_logits=True)`` and the
  JAX oracle's ``perplexity``), within ``tests/test_oracle_model.py``'s
  bounds: f32 logits within 2e-3, quantized PPL within 2% and the largest
  logit difference under 0.35; and it passes against its own oracle.
- ``perplexity --gguf`` on a Q4_K_M-style file of the debug model passes,
  with the logits of the same weights quantized in-process.
- ``fa_tiles`` (the flash-attention kernel's tile variants) finds the two
  lines it replaces, and refuses to start without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jllama
from ggml_cuda_experiments_tpu.models.config import PRESETS as JPRESETS
from ggml_cuda_experiments_tpu.oracle import model as jom
from ggml_cuda_experiments_tpu_torch.models import llama as tllama
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm
from ggml_cuda_experiments_tpu_torch.tools import (
    fa_tiles, gemm_bench, kernel_test, perplexity)
from ggml_cuda_experiments_tpu_torch.utils import gguf as tgguf

_SMALL = ["--cpu", "--kv-size", "256", "--heads", "8", "--kv-heads", "2",
          "--head-dim", "64", "--kv-splits", "4"]


@pytest.mark.parametrize("mode", [[], ["--no-kv-parallel"],
                                  ["--quantized-kv"], ["--batch", "2"]])
def test_kernel_test_passes(capsys, mode):
    assert kernel_test.main(_SMALL + mode) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "not measured" in out
    assert "max_abs_diff" in out


def test_kernel_test_fails_above_its_tolerance(capsys):
    assert kernel_test.main(_SMALL + ["--tol", "0"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_gemm_bench_on_the_cpu(capsys):
    assert gemm_bench.main(["--cpu", "--sizes", "64,96"]) == 0
    out = capsys.readouterr().out
    assert out.count("time not measured") == 8
    assert "TFLOP/s" not in out
    assert gemm_bench.main(["--cpu", "--sizes", "64",
                            "--library-only"]) == 0
    assert capsys.readouterr().out.count("time not measured") == 2


def test_gemm_bench_needs_a_card_to_time():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gemm_bench.main(["--sizes", "64"])


def test_fa_tiles_variant_source():
    """``fa_tiles`` builds its variants by replacing the kernel's FA_WARPS
    and FA_STAGES lines: both are found, once each, and replaced."""
    src = fa_tiles.variant_source(8, 2)
    assert "constexpr int FA_WARPS = 8;" in src
    assert "constexpr int FA_STAGES = 2;" in src
    assert all(a not in src for a in fa_tiles.ANCHORS)


def test_fa_tiles_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fa_tiles.main(["--variants", "4x3"])


def _jax_tree(p, dtype):
    """The port's dense tree as the JAX package takes it (NumPy leaves)."""
    conv = lambda t: np.asarray(t.float().numpy()).astype(dtype)
    return {k: ([{kk: conv(vv) for kk, vv in layer.items()} for layer in v]
                if k == "layers" else conv(v)) for k, v in p.items()}


def _jax_prefill(params, tokens, dtype):
    cfg = JPRESETS["debug"]
    cache = jllama.KVCache.create(cfg, tokens.shape[0], 64, dtype=dtype)
    logits, _ = jllama.prefill(params, cfg, jnp.asarray(tokens), cache,
                               all_logits=True)
    return np.asarray(logits, np.float32)


def test_perplexity_f32_matches_the_jax_pipeline():
    cfg = PRESETS["debug"]
    r = perplexity.run(cfg, "f32", 12, 2, 0, torch.device("cpu"))
    dense, _ = perplexity.weights(cfg, "f32", 0, "cpu")
    want = _jax_prefill(_jax_tree(dense, np.float32), r["tokens"],
                        jnp.float32)
    np.testing.assert_allclose(r["logits"], want, rtol=2e-3, atol=2e-3)
    assert r["ppl"] == pytest.approx(jom.perplexity(want, r["tokens"]),
                                     rel=1e-3)
    assert r["rel"] < 1e-3


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
def test_perplexity_quantized_matches_the_jax_pipeline(capsys, fmt):
    args = ["--cpu", "--model", "debug", "--fmt", fmt, "--tokens", "32",
            "--seed", "1"]
    assert perplexity.main(args) == 0
    assert "PASS" in capsys.readouterr().out
    cfg = PRESETS["debug"]
    r = perplexity.run(cfg, fmt, 32, 1, 1, torch.device("cpu"),
                       skip_oracle=True)
    dense, _ = perplexity.weights(cfg, fmt, 1, "cpu")
    jparams = jllama.quantize_params(_jax_tree(dense, jnp.bfloat16), fmt)
    want = _jax_prefill(jparams, r["tokens"], jnp.bfloat16)
    ppl_jax = jom.perplexity(want, r["tokens"])
    assert abs(r["ppl"] - ppl_jax) / ppl_jax < 0.02, (r["ppl"], ppl_jax)
    assert np.abs(r["logits"] - want).max() < 0.35


def test_perplexity_gguf(tmp_path, capsys):
    """A Q4_K_M-style file of the debug model (the port's export): the tool
    passes against its oracle, and its logits are those of the same
    weights quantized in-process (the loader adds nothing)."""
    cfg = PRESETS["debug"]
    dense = tllama.init_weights(cfg, seed=1, device="cpu")
    path = str(tmp_path / "debug.gguf")
    tgguf.export_llama(path, dense, cfg)
    args = ["--cpu", "--gguf", path, "--tokens", "32", "--seed", "1"]
    assert perplexity.main(args) == 0
    assert "PASS" in capsys.readouterr().out
    fmt = lambda name: tgguf.q4_k_m_format(name, cfg.n_layers)
    direct = {"embed": tqm.dequantize(tqm.quantize(dense["embed"], "q4_k"),
                                      torch.bfloat16),
              "final_norm": dense["final_norm"],
              "lm_head": tqm.quantize(dense["lm_head"], fmt("output.weight")),
              "layers": [{k: w if w.dim() == 1 else tqm.quantize(
                  w, fmt(f"blk.{i}.{_GGUF_NAMES[k]}.weight"))
                  for k, w in layer.items()}
                  for i, layer in enumerate(dense["layers"])]}
    loaded, lcfg = tgguf.load_gguf(path, device="cpu")
    got = perplexity.run(lcfg, "gguf", 32, 1, 1, torch.device("cpu"),
                         skip_oracle=True, params=loaded)
    want = perplexity.run(lcfg, "gguf", 32, 1, 1, torch.device("cpu"),
                          skip_oracle=True, params=direct)
    assert np.array_equal(got["logits"], want["logits"])


_GGUF_NAMES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v",
               "wo": "attn_output", "w_gate": "ffn_gate", "w_up": "ffn_up",
               "w_down": "ffn_down"}
