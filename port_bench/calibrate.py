#!/usr/bin/env python3
"""The readings a cell's limit is set from, several seeds in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control 1]

For each seed: the cell's set-up, a window at the cell's own load (whole
blocks of the mix, as a run's), and the widest and the mean logit gap of
the served tokens against the reference (the lower readings); with
``--control 1`` also those of the tokens the control, the reference one
precision below the configuration's, puts first (the upper readings). Each
side is held to the cell's ``limits/<cell>.json`` by ``run.decide``, the
comparison a run makes, and its ``correct`` printed: the program's should
read true, the control's false. One JSON line a seed. The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NUMBERS = ("widest_logit_gap", "mean_logit_gap")


def _summary(gaps: list[float]) -> dict:
    """How many judged tokens the reference ranks below its first, and the
    gaps' upper quantiles."""
    if not gaps:
        return {}
    xs = sorted(gaps)
    at = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
    return {"n": len(xs), "nonzero": sum(x > 0 for x in xs),
            "p50": at(0.5), "p90": at(0.9), "p99": at(0.99), "max": xs[-1],
            "mean": sum(xs) / len(xs)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "port_bench"))
    import torch

    import run
    from port_bench.lib import judge

    run._cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = run.Cell(ROOT, args.workload)
    limits = cell.limits()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        bench = run.Bench(cell, seed, device)
        t0, done, outs, _ = bench.window(args.seconds, False)
        bench.free()
        ctl = judge.control_precision(bench.spec, bench.mix) \
            if args.control else None
        t_ref = time.perf_counter()
        r = run.judge(bench, done, outs, ctl)
        ref_s = time.perf_counter() - t_ref
        bad = run.check_answers(done, outs, bench.spec.vocab_size)
        checks, correct = run.decide(limits, r, bad)
        line = {"workload": args.workload, "seed": seed,
                "served": {k: r[k] for k in NUMBERS}, "correct": correct,
                "checks": checks, "judged": r["judged"],
                "requests": len(done),
                "served_gaps": _summary(r["gaps"]["served"]),
                "tokens_s": sum(max(q.steps, 1) * q.batch for q, _, _ in done)
                / (done[-1][2] - t0),
                "reference_s": ref_s}
        if ctl:
            # the control in the program's place: its answers are right in
            # shape, so only the numbers compared can fail it
            c_checks, c_correct = run.decide(limits, r["control"], 0)
            line.update(control=ctl, control_readings=r["control"],
                        control_correct=c_correct, control_checks=c_checks,
                        control_gaps=_summary(r["gaps"]["control"]))
        line["seed_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del bench
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
