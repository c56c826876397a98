"""The tools' GCTC weight cache (``profile_decode.cached_params``) on the
CPU at the ``debug`` size: the default file's key (model, format,
encoding, seed, the port's logical layout; never the JAX tools' name), a
build then a load giving a bit-equal tree and identical decode logits, and
the tools that take their weights through it."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.models import llama
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import QuantLinear
from ggml_cuda_experiments_tpu_torch.tools import bench
from ggml_cuda_experiments_tpu_torch.tools import engine_bench as eb
from ggml_cuda_experiments_tpu_torch.tools import profile_decode as pd
from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb

CFG = dataclasses.replace(PRESETS["debug"], x_quant8=True)


def test_the_key_changes_with_model_format_encoding_and_seed():
    base = pd.ckpt_path("llama2-7b", "q4_k", "e", 0)
    others = [pd.ckpt_path("tinyllama-1.1b", "q4_k", "e", 0),
              pd.ckpt_path("llama2-7b", "q8_0", "e", 0),
              pd.ckpt_path("llama2-7b", "q4_k", "s6", 0),
              pd.ckpt_path("llama2-7b", "q4_k", "e", 1)]
    assert len({base, *others}) == 5
    for p in (base, *others):
        assert "+logical" in p.name and p.suffix == ".gctc"
        assert p.parent == pd.CKPT_DIR
        assert not p.name.startswith("bench_ckpt_")      # the JAX tools'
        assert str(p) != "/tmp/bench_ckpt_llama2-7b_q4_k_v6.gctc"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _assert_bit_equal(got, want):
    a, b = dict(_leaves(got)), dict(_leaves(want))
    assert list(a) == list(b)
    for name, w in b.items():
        g = a[name]
        if isinstance(w, QuantLinear):
            assert isinstance(g, QuantLinear), name
            assert (g.fmt, g.shape, g.enc) == (w.fmt, w.shape, w.enc), name
            for f in ("qs", "d", "es", "em", "qh"):
                x, y = getattr(g, f), getattr(w, f)
                assert (x is None) == (y is None), (name, f)
                if y is not None:
                    assert x.dtype == y.dtype and torch.equal(x, y), (name, f)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name


def _logits(params):
    cache = llama.KVCache.create(CFG, 1, 64, device="cpu")
    logits, cache = llama.prefill(params, CFG, torch.ones(
        (1, 4), dtype=torch.int64), cache)
    return llama.decode_step(params, CFG, torch.argmax(logits, -1), cache)[0]


def test_a_build_then_a_load_give_the_same_tree_and_logits(tmp_path,
                                                           capsys):
    path = tmp_path / "debug.gctc"
    built = pd.cached_params(CFG, "q4_k", 5, "cpu", ckpt=path)
    assert "built from seed 5" in capsys.readouterr().out and path.exists()
    assert not list(tmp_path.glob("*.tmp"))
    loaded = pd.cached_params(CFG, "q4_k", 5, "cpu", ckpt=path)
    assert f"loaded from {path}" in capsys.readouterr().out
    _assert_bit_equal(loaded, built)
    _assert_bit_equal(built, pd.quantize_model(
        llama.init_weights(CFG, seed=5, device="cpu"), "q4_k"))
    assert torch.equal(_logits(loaded), _logits(built))


def test_the_tools_take_their_weights_through_the_cache(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.setattr(pd, "CKPT_DIR", Path(tmp_path))
    # spec_bench: each model's default file, seed 0
    first, cfg = sb.load("debug", "cpu")
    assert cfg.x_quant8 and "built from seed 0" in capsys.readouterr().out
    assert pd.ckpt_path("debug", "q4_k", "e", 0).exists()
    again, _ = sb.load("debug", "cpu")
    assert "loaded from" in capsys.readouterr().out
    _assert_bit_equal(again, first)
    # engine_bench: --ckpt
    path = tmp_path / "engine.gctc"
    args = eb.parse(["--model", "debug", "--ckpt", str(path), "--seed", "2"])
    params, cfg = eb.build_params(args, "cpu")
    assert path.exists() and cfg.x_quant8
    assert "built from seed 2" in capsys.readouterr().out
    # profile_decode's modes: --ckpt names the model's file
    args = pd.parse(["--model", "debug", "--ckpt", str(path), "--seed", "2"])
    again = pd.cached_params(pd.config("debug"), args.fmt, args.seed, "cpu",
                             ckpt=args.ckpt)
    _assert_bit_equal(again, params)


@pytest.mark.parametrize("parse", [
    eb.parse, pd.parse, lambda argv: bench._parser().parse_args(argv)])
def test_ckpt_defaults_to_the_keyed_file(parse):
    assert parse([]).ckpt is None
    assert parse(["--ckpt", "w.gctc"]).ckpt == "w.gctc"
