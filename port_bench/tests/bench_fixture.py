"""A throwaway copy of the benchmark with tiny cells, for CPU dry runs.

``make_copy(tmp)`` copies ``port_bench/`` into ``tmp``, adds a tiny
configuration, three tiny mixes and a metric of its own as new files, and
writes a ``BENCHMARK.json`` that names them: additions made the way a
later change makes them, with no existing file edited.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "port_bench"))
sys.path.insert(0, str(REPO))

import run  # noqa: E402

TINY = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64,
            vocab_size=512)
# cell: (configuration, mix, limits). The limits sit between what the tiny
# cells' sound CPU runs read (widest gap at most 0.03, mean gap at most
# 0.0012, on ten seeds) and what their controls and faults read (widest at
# least 0.63 for int4 and 0.09 for fp8, mean at least 0.0046 for fp8, a
# few units for a wrong token). The prefill compares the mean, as the
# full-size prefill cell does.
CELLS = {"tiny.chat": ("tiny", "tinychat", {"widest_logit_gap": 0.3}),
         "tiny.prefill": ("tiny", "tinyprefill", {"mean_logit_gap": 0.003}),
         "tiny.batch4": ("tiny", "tinybatch4", {"widest_logit_gap": 0.06})}


def _json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_copy(tmp: Path) -> Path:
    pb = tmp / "port_bench"
    shutil.copytree(REPO / "port_bench", pb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    conf = json.loads((pb / "configs" / "mistral-7b.json").read_text())
    _json(pb / "configs" / "tiny.json", {**conf, "name": "tiny", **TINY})
    chat = json.loads((pb / "traffic" / "chat.json").read_text())
    _json(pb / "traffic" / "tinychat.json", {
        **chat, "prompt": {"dist": "log_uniform", "min": 8, "max": 32},
        "output": {"dist": "log_uniform", "min": 4, "max": 8}, "points": 4,
        "warmup_prompts": [32, 8], "warmup_steps": 2, "traced_requests": 4,
        "judged_requests": 6})
    pf = json.loads((pb / "traffic" / "prefill.json").read_text())
    _json(pb / "traffic" / "tinyprefill.json", {
        **pf, "prompt": {"dist": "log_normal", "median": 16, "sigma": 0.8,
                         "min": 4, "max": 40},
        "points": 4, "warmup_prompts": [40, 8], "traced_requests": 4,
        "judged_requests": 48})
    _json(pb / "traffic" / "tinybatch4.json", {
        **chat, "batch": 4, "prompt": {"dist": "fixed", "value": 8},
        "output": {"dist": "fixed", "value": 6}, "points": 1,
        "warmup_prompts": [8], "warmup_steps": 2, "traced_requests": 1,
        "judged_requests": 12})
    (pb / "metrics" / "served_requests.py").write_text(
        '"""Requests the traced window served."""\n\n\n'
        "def read(ctx):\n    return float(len(ctx.traced))\n")
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["configs"] += [
        {"name": n, "source": "tiny", "file": f"port_bench/configs/{n}.json",
         "reduced": [], "why": "CPU dry run"} for n in ("tiny",)]
    for name, (c, t, limits) in CELLS.items():
        man["workloads"].append({"name": name, "config": c, "traffic": t,
                                 "chips": 1, "why": "CPU dry run"})
        _json(pb / "limits" / f"{name}.json",
              {"limits": limits})
    decode = ["tiny.chat", "tiny.batch4"]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" not in m:
            continue
        if m["name"].startswith("ttft") or m["name"].endswith(".prefill"):
            m["workloads"].append("tiny.prefill")
        elif m["name"] in ("decode_tok_s", "kernels_per_token",
                           "device_idle_pct.decode", "mfu_pct.decode"):
            m["workloads"] += decode
    man["per_layer"].append({
        "name": "served_requests", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "entry", "moves": "setup_s"})
    _json(tmp / "BENCHMARK.json", man)
    return tmp


def run_cell(root: Path, cell: str, seed: int = 3_000_000_019,
             seconds: float = 1.0, trace: int = 0) -> tuple[int, dict | None]:
    """One CPU dry run in this process: (exit code, the result line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)],
                      require_cuda=False, root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
