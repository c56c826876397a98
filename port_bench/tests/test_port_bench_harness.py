"""CPU dry runs of the harness on tiny cells added as files: the harness
takes additions without an edit, judges the served tokens against the
reference, and comes out not correct when the timed path is broken or when
the control stands in for it."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_fixture as bf
import run
from ggml_cuda_experiments_tpu_torch.models import llama


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bf.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", list(bf.CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_added_cell_runs(root, cell, trace):
    rc, res = bf.run_cell(root, cell, trace=trace)
    assert rc == 0 and res["correct"], res
    assert res["failed"] == 0 and res["attempted"] >= 1
    names = set(res["metrics"])
    assert list(res)[-1] == "checks"
    if trace:
        # the added metric is found by its name; a CPU run reads no device
        assert res["metrics"]["served_requests"]["value"] >= 1
        assert "weights_s" in names and "mfu_pct.decode" not in names
        assert res["device"]["busy_s"] == 0.0
    else:
        assert "setup_s" in names
        assert names & {"decode_tok_s", "ttft_p50_ms"}


def _faulty(monkeypatch, fault):
    """Break the timed path underneath the harness."""
    if fault == "token_altered":
        orig = llama.greedy_scan_step

        def greedy_scan_step(params, cfg, tok, cache, steps):
            step, state, out = orig(params, cfg, tok, cache, steps)

            def bad():
                step()
                tok.add_(1).remainder_(cfg.vocab_size)
            return bad, state, out
        monkeypatch.setattr(llama, "greedy_scan_step", greedy_scan_step)
    elif fault == "answer_altered":
        orig = llama.prefill

        def prefill(*a, **k):
            logits, cache = orig(*a, **k)
            return torch.roll(logits, 1, -1), cache
        monkeypatch.setattr(llama, "prefill", prefill)
    elif fault == "state_unchanged":
        orig = llama.decode_step

        def decode_step(params, cfg, tokens, cache):
            frozen = llama.KVCache(cache.k.clone(), cache.v.clone(),
                                   cache.lengths.clone())
            return orig(params, cfg, tokens, frozen)
        monkeypatch.setattr(llama, "decode_step", decode_step)
    elif fault == "half_batch":
        orig = llama.decode_step

        def decode_step(params, cfg, tokens, cache):
            logits, cache = orig(params, cfg, tokens, cache)
            h = logits.shape[0] // 2
            logits[h:] = logits[:logits.shape[0] - h].clone()
            return logits, cache
        monkeypatch.setattr(llama, "decode_step", decode_step)


# (cell, fault): each fault a cell can have; one chip, so no exchange
# between chips to leave out
FAULTS = [("tiny.chat", "token_altered"), ("tiny.chat", "state_unchanged"),
          ("tiny.batch4", "token_altered"), ("tiny.batch4", "half_batch"),
          ("tiny.batch4", "state_unchanged"),
          ("tiny.prefill", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_path_is_not_correct(root, monkeypatch, cell, fault):
    _faulty(monkeypatch, fault)
    rc, res = bf.run_cell(root, cell, seconds=0.5)
    assert rc == 0
    assert not res["correct"], res["checks"]
    assert [c for c in res["checks"].values() if c["value"] > c["limit"]]


def _served(cell, seed, n=None):
    """The cell's first ``n`` requests (twice the judged sample, in whole
    blocks) served in order, as a window would finish them: the sample
    judged is then the same on any host, however fast."""
    import itertools

    from port_bench.lib import system, traffic
    bench = run.Bench(cell, seed, torch.device("cpu"))
    k = int(bench.mix["points"])
    n = n or traffic.round_up(2 * int(bench.mix["judged_requests"]), k)
    reqs = itertools.islice(traffic.requests(bench.mix, seed,
                                             bench.spec.vocab_size), n)
    done, outs = [], []
    for req in reqs:
        outs.append(system.serve(bench.params, bench.cfg, req, bench.device,
                                 bench.mix))
        done.append((req, 0.0, 0.0))
    bench.free()
    return bench, done, outs


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.prefill", "tiny.batch4"])
def test_control_reads_above_the_limit(root, cell):
    """The reference one precision below the configuration's, in the
    program's place, fails the tiny cells' limits on three seeds by the
    comparison a run makes (``run.decide``); the sound program passes it.
    The full-size cells' control is read on the chip (``calibrate.py``)."""
    from port_bench.lib import judge
    c = run.Cell(root, cell)
    for seed in (11, 2**31 + 5, 9_876_543_210):
        bench, done, outs = _served(c, seed)
        r = run.judge(bench, done, outs,
                      judge.control_precision(bench.spec, bench.mix))
        limits = c.limits()
        assert run.decide(limits, r, 0)[1], (seed, r)
        assert not run.decide(limits, r["control"], 0)[1], (seed, r)


def test_no_result_without_the_port(root, tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.path.insert(0, 'port_bench'); import run; "
            "from pathlib import Path; "
            "sys.exit(run.main(['--workload', 'tiny.chat', '--seed', '1', "
            "'--seconds', '1'], require_cuda=False, root=Path('.').resolve()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "ggml_cuda_experiments_tpu_torch" in out.stderr


def test_no_result_without_a_card(root):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "tiny.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_judged_sample_holds_the_longest(root):
    from port_bench.lib import judge, traffic
    mix = json.loads((root / "port_bench" / "traffic" / "tinychat.json")
                     .read_text())
    reqs = [traffic.Request(i, 8 + i, s, np.zeros((1, 8 + i), np.int64))
            for i, s in enumerate([4, 9, 5, 6, 7, 4, 5, 8, 6])]
    done = [(r, np.arange(r.steps)[None]) for r in reqs]
    seqs = judge.sample(done, mix, seed=3)
    assert len(seqs) == mix["judged_requests"]
    assert len(seqs[0].served) == 9 and seqs[0].positions[0] == 8 + 1 - 1
    again = judge.sample(done, mix, seed=3)
    assert [s.served for s in again] == [s.served for s in seqs]
