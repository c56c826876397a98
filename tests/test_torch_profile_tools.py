"""The serving profiles (``tools/profile_decode.py``, with the prefill
marginal, and ``tools/engine_bench.py``) on the CPU: their ``--cpu`` plans
and bounds, their argument checks, and the machinery that needs no card
(the host-time wrappers and their self times, the prefill variants, the
calls annotated with their bounds). No time here is a device metric."""

import dataclasses

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.models import engine, llama
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.tools import engine_bench as eb
from ggml_cuda_experiments_tpu_torch.tools import profile_decode as pd
from ggml_cuda_experiments_tpu_torch.utils.device_info import card_spec


def _out(capsys, tool, argv):
    assert tool.main(["--cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert "time not measured" in out
    return out


def test_profile_decode_plan_at_batch_1(capsys):
    out = _out(capsys, pd, ["--model", "llama2-7b"])
    # 12288 x 4096 q4_k (0.625 bytes a weight) + x and y, at 3.35 TB/s
    assert "linear wqkv   [ 12288 x   4096] x1 a layer: bound     9.40 us " \
           "(bytes, int8)" in out
    assert "linear w_down [  4096 x  12288]" in out      # 11008 padded
    assert "fused attention + fused MLP" in out
    assert "flash_decode at length 1024: bound     5.01 us" in out


def test_profile_decode_plan_at_batch_8(capsys):
    out = _out(capsys, pd, ["--model", "llama2-7b", "--batch", "8",
                            "--cache", "512"])
    assert "GEMM stream route" in out
    assert "linear w_gu   [ 24576 x   4096] x1 a layer: bound    18.92 us " \
           "(bytes, bf16)" in out
    assert "flash_decode at length 512: bound    20.07 us" in out
    assert "step (the components' bounds, attention at 64): 1.419 ms" in out


def test_profile_decode_plan_of_the_prefill_marginal(capsys):
    out = _out(capsys, pd, ["--model", "llama2-7b", "--prefill", "512"])
    assert "layer marginal over 16 -> 32 layers" in out
    # 2 T (sum N K) + 2 T^2 Hq D at 989 TFLOP/s
    assert "full    : bound 0.2280 ms a layer (operations; 225.5 GFLOP" in out
    for mode in pd.MODES:
        assert f"  {mode:8s}: bound" in out
    assert "non-layer (0 layers)" in out


@pytest.mark.parametrize("argv", [["--batch", "0"], ["--batch", "33"],
                                  ["--cache", "100"], ["--prefill", "100"],
                                  ["--model", "gpt-2"], ["--fmt", "q5_k"]])
def test_profile_decode_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit):
        pd.main(["--cpu", *argv])


def test_engine_bench_plan(capsys):
    out = _out(capsys, eb, ["--int8-kv", "--pages", "96", "--max-seq-len",
                            "1024", "--native-sched"])
    pool = engine.PagedKVPool.create(PRESETS["llama2-7b"], 96, 64, "int8",
                                     device="meta").nbytes
    assert f"pool {pool} bytes" in out and "native scheduler" in out
    assert "3 pairs of 24 and 8 requests" in out
    for part in ("admission", "upload", "decode step", "linears",
                 "fetch to host"):
        assert part in out
    # the JAX tool's max_seq_len: prompt + gen up to a whole page
    assert eb.parse(["--prompt", "70", "--gen", "64"]).max_seq_len == 192


@pytest.mark.parametrize("argv", [["--native-sched", "--window", "16"],
                                  ["--native-sched", "--prefill-chunk", "64"],
                                  ["--batch", "0"], ["--pairs", "0"]])
def test_engine_bench_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit):
        eb.main(["--cpu", *argv])


def test_part_timer_takes_children_out_of_their_parents(monkeypatch):
    clock = iter(range(100))
    monkeypatch.setattr(eb.time, "perf_counter", lambda: next(clock))
    timer = eb.PartTimer()
    inner = timer.wrap("linears", lambda: None)

    def step():
        inner()
        inner()

    timer.wrap("decode step", step)()
    # step: 0 -> 5; the two linears 1 -> 2 and 3 -> 4 inside it
    assert timer.seconds == {"decode step": 3, "decode step/linears": 2}
    assert timer.calls == {"decode step": 1, "decode step/linears": 2}


@pytest.fixture(scope="module")
def debug_params():
    cfg = dataclasses.replace(PRESETS["debug"], x_quant8=True)
    return cfg, llama.quantize_params(
        llama.init_weights(cfg, seed=0, device="cpu"), "q4_k")


@pytest.mark.parametrize("scheduler, window", [("python", 1),
                                               ("python", 4),
                                               ("native", 1)])
def test_host_parts_count_the_engines_steps(debug_params, scheduler, window):
    cfg, params = debug_params
    kw = dict(max_batch=4, page_size=16, n_pages=40, max_seq_len=64,
              quantized_kv="int8", scheduler=scheduler,
              decode_window=window, prefill_chunk=None)
    saved = (engine._paged_decode_step, llama.apply_linear,
             engine.Engine._admit, torch.Tensor.cpu)
    r = eb.host_parts(params, cfg, kw, 4, 20, 12)
    # every wrapper taken off again
    assert saved == (engine._paged_decode_step, llama.apply_linear,
                     engine.Engine._admit, torch.Tensor.cpu)
    assert "cpu" not in torch.Tensor.__dict__
    assert r["tokens"] == 4 * 12 and r["prefills"] == 4
    # 11 decode steps after the prefill's first token, in windows or not
    assert r["decode_steps"] == 11
    assert r["calls"]["decode step/linears"] == 11 * (4 * cfg.n_layers + 1)
    assert r["calls"]["prefill/linears"] == 4 * (4 * cfg.n_layers + 1)
    assert r["calls"]["fetch to host"] >= 1
    assert (r["calls"].get("completion (native)", 0) > 0) == \
        (scheduler == "native")
    assert 0 < sum(r["parts_ms"].values()) <= r["wall_ms"]


def test_the_full_prefill_variant_is_the_models_prefill(debug_params):
    cfg, params = debug_params
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (1, 32)))

    def cache():
        return llama.KVCache.create(cfg, 1, 256, device="cpu")

    want = torch.argmax(llama.prefill(params, cfg, tokens, cache())[0], -1)
    got = pd.prefill_variant(params, cfg, tokens, cache(), cfg.n_layers,
                             "full")
    assert torch.equal(got, want)
    for mode in pd.MODES:
        for n in (0, 1, cfg.n_layers):
            assert pd.prefill_variant(params, cfg, tokens, cache(), n,
                                      mode).shape == (1,)


def test_annotated_calls_carry_their_bounds(debug_params):
    """Each of the model's ops runs inside a profiler range named by its
    bound; the linears' bounds are ``linear_bound`` of their shapes."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params = debug_params
    spec = card_spec("H100")
    with pd.annotated(spec), profile(activities=[ProfilerActivity.CPU]) \
            as prof:
        llama.prefill(params, cfg, torch.ones((1, 16), dtype=torch.int64),
                      llama.KVCache.create(cfg, 1, 256, device="cpu"))
    assert llama.apply_linear.__name__ == "apply_linear"   # restored
    calls = [e.name[len(pd.BOUND_TAG):].split(" ", 1) for e in
             prof.events() if e.name.startswith(pd.BOUND_TAG)]
    ops = {op for _, op in calls}
    assert {"apply_linear", "rms_norm", "rope",
            "flash_attention", "_write_kv"} <= ops, ops
    got = sorted(float(us) for us, op in calls if op == "apply_linear")
    lay = params["layers"][0]
    want = []
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        n, k = lay[name].shape
        want.append(1e3 * pd.linear_bound(spec, n, k, lay[name].nbytes, 16,
                                          "bf16")[0])
    head = params["lm_head"]
    want = want * cfg.n_layers + [1e3 * pd.linear_bound(
        spec, *head.shape, head.nbytes, 1, "int8")[0]]
    assert len(got) == len(want)
    assert all(any(abs(g - w) < 1e-6 for w in want) for g in got)
