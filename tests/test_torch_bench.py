"""The port's benchmark entry (``tools/bench.py``) and its measuring
protocols (``utils/bench.py``) on the CPU: the pair protocol's rejection,
median and clamp on synthetic times (bench.py's ``roofline_pct``), the
inner-count marginal and the L2 rotation; the weight-stream bytes of a
decoded token against bench.py's ``_layer_stream`` rule applied to the JAX
package's params of the same configuration; the entry's inputs (bench.py's
NumPy draws) and fold; and the entry and the tools refusing to time
anything without a card (their ``--cpu`` runs the plain versions).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jllama
from ggml_cuda_experiments_tpu.models.config import PRESETS as JPRESETS
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.models import llama
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
from ggml_cuda_experiments_tpu_torch.tools import (
    bench, exp_q4, exp_q4_r2, membench, probe_mosaic_r3, q6_probe,
    roofline_sweep, shape_probe)
from ggml_cuda_experiments_tpu_torch.utils import bench as ub

PEAK = 3.35e12


def _times(pcts, inner=64, dbytes=62.9e6):
    """time_pair() giving pairs whose marginal is each of ``pcts`` (% of
    PEAK), in order; a pct of None gives a negative marginal."""
    seq = iter(pcts)

    def time_pair():
        p = next(seq)
        per = -1e-6 if p is None else dbytes / (p / 100 * PEAK)
        return 1e-3, 1e-3 + per * inner
    return time_pair


def test_pair_pct_is_the_size_marginal_rate():
    # 62.9 MB more in 18.78 us a call: 100% of 3.35 TB/s
    assert ub.pair_pct(0.0, 64 * 62.9e6 / PEAK, 64, 62.9e6, PEAK) == \
        pytest.approx(100.0)
    assert ub.pair_pct(2e-3, 1e-3, 64, 62.9e6, PEAK) == float("inf")


def test_pair_protocol_rejects_and_takes_the_median():
    pcts = [50.0, 120.0, 60.0, None, 55.0, 70.0, 65.0]
    pct, valid, rejected = ub.pair_protocol(_times(pcts), 64, 62.9e6, PEAK,
                                            n_pairs=5, min_valid=3)
    # after 5 pairs (3 valid) it stops; 120% and a negative marginal are
    # rejected; the median of [50, 55, 60]
    assert valid == pytest.approx([50.0, 60.0, 55.0])
    assert len(rejected) == 2 and rejected[0] == pytest.approx(120.0)
    assert pct == pytest.approx(55.0)


def test_pair_protocol_measures_again_until_min_valid():
    pcts = [101.0] * 6 + [40.0, 42.0, 44.0, 46.0]
    pct, valid, rejected = ub.pair_protocol(_times(pcts), 64, 62.9e6, PEAK,
                                            n_pairs=4, min_valid=3)
    assert len(rejected) == 6 and len(valid) == 3
    assert pct == pytest.approx(42.0)


def test_pair_protocol_clamps_when_nothing_is_valid():
    pct, valid, rejected = ub.pair_protocol(
        _times([130.0, None, 150.0]), 64, 62.9e6, PEAK, n_pairs=1,
        min_valid=1)
    assert valid == [] and len(rejected) == 3
    assert pct == 100.0                        # bench.py's clamp into [0, 100]
    assert ub.median_pct([], [-5.0]) == 0.0
    assert ub.median_pct([], []) == 0.0
    assert ub.median_pct([3.0, 1.0, 2.0, 4.0], []) == 3.0


def test_inner_marginal_and_rotation():
    assert ub.inner_marginal(1.0, 3.0, 32, 160) == pytest.approx(2 / 128)
    with pytest.raises(ValueError):
        ub.inner_marginal(1.0, 2.0, 8, 8)
    # the 8192-row q4_k weight (21.0 MB) needs 8 copies past the L2, the
    # 32768-row one (83.9 MB) 2
    assert ub.copies_for(8192 * 2560) == 8 and ub.copies_for(32768 * 2560) == 2
    made = ub.rotating(lambda i: i, 100 * 2**20)
    assert made == [0, 1]


def test_timers_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ub.capture(lambda i: None, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    for tool in (exp_q4, exp_q4_r2, shape_probe, roofline_sweep, q6_probe,
                 probe_mosaic_r3, membench):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])


def test_the_entry_takes_bench_py_s_draws_and_fold():
    w, x0 = bench.draws(0, 64)
    rng = np.random.default_rng(0)
    want = (rng.normal(size=(64, 4096)) / np.sqrt(4096)).astype(np.float32)
    np.testing.assert_array_equal(w, want)
    np.testing.assert_array_equal(
        x0, rng.normal(size=(1, 4096)).astype(np.float32))
    y = torch.arange(3 * 4096, dtype=torch.float32)[None]
    got = bench.fold(y)
    assert torch.equal(got, y[:, :4096] * 0.03 + y[:, 4096:8192] * 0.03)
    ql = qm.quantize(torch.from_numpy(w), "q4_k")
    part, copy = bench.rows(ql, 16), bench.copy_of(ql)
    assert part.array_shape == (16, 4096) and part.shape == (16, 4096)
    assert copy.qs.data_ptr() != ql.qs.data_ptr()
    assert torch.equal(copy.qs, ql.qs) and torch.equal(copy.em, ql.em)
    # a chain starts from x0 at every call(0) and carries x after it
    seen = []
    call = bench.chained(lambda x, w: seen.append(x) or torch.cat(
        [x, x], 1), [ql], torch.ones((1, 4096)))
    call(0), call(1), call(0)
    assert torch.equal(seen[1], torch.full((1, 4096), 0.06))
    assert torch.equal(seen[2], torch.ones((1, 4096)))


def _jax_stream_bytes(params):
    """bench.py:209-221, the rule as bench.py applies it (the embed is a
    lookup, not a stream)."""
    def leaf_bytes(leaf):
        return getattr(leaf, "nbytes", 0)

    def layer_stream(layer):
        if "w_pack" in layer:
            drop = {"wqkv", "wo", "w_gu_f", "w_gate", "w_up"}
            layer = {k: v for k, v in layer.items() if k not in drop}
        return sum(leaf_bytes(l) for l in jax.tree.leaves(layer))

    return (sum(layer_stream(l) for l in params["layers"])
            + sum(leaf_bytes(l) for l in jax.tree.leaves(
                [params["lm_head"], params["final_norm"]])))


@pytest.mark.parametrize("name,hperm", [("debug", True), ("debug", False),
                                        ("small", True)])
def test_stream_bytes_follow_bench_py_s_rule(name, hperm):
    if name == "small":          # an intermediate padded 3840 -> 4096
        jcfg = dataclasses.replace(JPRESETS["debug"], dim=512,
                                   intermediate=3840, vocab_size=384)
        cfg = dataclasses.replace(PRESETS["debug"], dim=512,
                                  intermediate=3840, vocab_size=384)
    else:
        jcfg, cfg = JPRESETS[name], PRESETS[name]
    jp = jllama.quantize_params(
        jllama.init_weights(jcfg, seed=0, as_numpy=True), "q4_k")
    tp = llama.quantize_params(llama.init_weights(cfg, seed=0, device="cpu"),
                               "q4_k")
    if hperm:
        jp = jllama.permute_hidden_params(jp, jcfg)
        tp = llama.permute_hidden_params(tp, cfg)
    assert bench.stream_bytes(tp) == _jax_stream_bytes(jp)
    # the layers' linears, norms, the head and the final norm, no more
    assert bench.stream_bytes(tp) > tp["lm_head"].nbytes


def test_decode_bench_gates_name_their_path_on_the_cpu():
    cfg = dataclasses.replace(PRESETS["debug"], x_quant8=True)
    params = llama.quantize_params(
        llama.init_weights(cfg, seed=0, device="cpu"), "q4_k")
    # no launches on the CPU (the plain versions): the path names nothing
    assert bench.decode_path(params, cfg, "cpu") == {}
    assert bench.decode_config("llama2-7b").x_quant8
    assert not bench.decode_config("llama2-7b", exact=True).x_quant8


@pytest.mark.parametrize("argv", [["--cpu"], ["--cpu", "--decode"],
                                  ["--cpu", "--decode", "--model=llama3-8b"]])
def test_the_entry_runs_its_plain_versions_with_cpu(argv, capsys):
    assert bench.main(argv) == 0
    out = capsys.readouterr()
    assert out.out == ""                       # no JSON line: no time
    assert "not measured" in out.err
    if "--model=llama3-8b" in argv:
        assert "llama3-8b measured only on the card" in out.err


def test_decode_takes_the_presets_one_card_holds(capsys):
    """--model takes llama3-8b, as JAX bench.py takes any preset, but not
    llama2-70b: decode_bench builds the dense model whole (~138 GB)."""
    assert bench.decode_config("llama3-8b").x_quant8
    assert bench.decode_config("llama3-8b").rope_theta == 5e5
    with pytest.raises(SystemExit):
        bench.main(["--cpu", "--decode", "--model=llama2-70b"])
    assert "invalid choice" in capsys.readouterr().err


def test_roofline_sweep_variants():
    for v in ("base", "full", "cta1", "cta3", "stream"):
        assert callable(roofline_sweep.variant(v))
    assert roofline_sweep.variant("bn8192") is None


def test_membench_cpu_and_its_interleave_is_the_jax_one():
    assert membench.main(["--cpu", "--strides"]) == 0
    for k in (96, 4096, 8192, 12288, 2048):
        np.testing.assert_array_equal(membench.interleave_perm(k),
                                      np.asarray(jqm._perm(k)))


def test_trace_writes_a_chrome_trace(tmp_path):
    with bench.traced(str(tmp_path)):
        torch.ones(8) + 1
    assert (tmp_path / "bench_trace.json").stat().st_size > 0
