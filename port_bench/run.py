#!/usr/bin/env python3
"""The port's benchmark: one cell of ``BENCHMARK.json``, one process.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration (``port_bench/configs``), mix
(``port_bench/traffic``), limit (``port_bench/limits``) and metric readers
(``port_bench/metrics``), all found by the names in ``BENCHMARK.json``;
draws the weights and the traffic from the seed; warms up; serves the mix
in a closed loop for ``--seconds``; judges a sample of the served tokens
against the plain reference; prints one JSON line. ``--trace 1`` puts
``torch.profiler`` over the mix's first ``traced_requests`` requests and
prints the per-layer metrics instead of the end-to-end ones.

Exits non-zero, printing no result, where there is no CUDA device (or
fewer than the cell asks for), where the port is missing, and where a JAX
module is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "ggml_cuda_experiments_tpu")


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / "port_bench" / sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Cell:
    """One cell's files, found by name from the manifest."""

    def __init__(self, root: Path, name: str):
        self.root = root
        self.manifest = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.cell = cells[name]
        conf = {c["name"]: c for c in self.manifest["configs"]}[
            self.cell["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        self.mix = json.loads((root / "port_bench" / "traffic"
                               / f"{self.cell['traffic']}.json").read_text())

    def metrics(self, trace: bool) -> list[dict]:
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[key]
                if self.name in m.get("workloads", [self.name])]

    def limits(self) -> dict:
        return json.loads((self.root / "port_bench" / "limits"
                           / f"{self.name}.json").read_text())["limits"]


class Bench:
    """The system built for one seed, and the window it serves."""

    def __init__(self, cell: Cell, seed: int, device):
        import torch

        from port_bench.lib import system, work
        self.cell, self.seed, self.device = cell, seed, device
        self.spec = work.Spec.from_config(cell.config)
        self.cfg = system.model_config(cell.config)
        self.mix = cell.mix
        t = system.now()
        self.params = system.build(self.spec, self.cfg, seed, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.weights_s = system.now() - t
        system.warm_up(self.params, self.cfg, self.spec, self.mix, device)

    def window(self, seconds: float, trace: bool):
        """Serve the mix in a closed loop, one request after another, until
        ``seconds`` have passed and the block in flight has completed, so
        the window holds whole blocks of the mix's points. Returns (t0,
        [(request, start, end)], [served tokens], trace events)."""
        import torch

        from port_bench.lib import system, traffic
        from port_bench.lib.trace import WINDOW_SPAN
        reqs = traffic.requests(self.mix, self.seed, self.spec.vocab_size)
        n_traced = int(self.mix["traced_requests"]) if trace else 0
        prof = span = undo = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            undo = _span_linears()
            prof.start()
            span = torch.profiler.record_function(WINDOW_SPAN)
            span.__enter__()
        block = int(self.mix["points"])
        done, outs = [], []
        t0 = system.now()
        while (not done or system.now() - t0 < seconds
               or len(done) % block or len(done) < n_traced):
            req = next(reqs)
            ts = system.now()
            outs.append(system.serve(self.params, self.cfg, req, self.device,
                                     self.mix))
            done.append((req, ts, system.now()))
            if prof is not None and len(done) == n_traced:
                span.__exit__(None, None, None)
                prof.stop()
                undo()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        events = None
        if prof is not None:
            from port_bench.lib import trace as tr
            events = tr.from_profiler(prof)
        return t0, done, outs, events

    def free(self) -> None:
        import torch
        self.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _span_linears():
    """Wrap the port's ``llama.apply_linear`` in the benchmark's span for
    the traced requests, so their eager linears' kernels are attributed
    (a graph's replays are attributed by kernel name). Returns the undo."""
    import torch

    from ggml_cuda_experiments_tpu_torch.models import llama
    from port_bench.lib.trace import LINEAR_SPAN
    orig = llama.apply_linear

    def apply_linear(*a, **k):
        with torch.profiler.record_function(LINEAR_SPAN):
            return orig(*a, **k)

    llama.apply_linear = apply_linear

    def undo():
        llama.apply_linear = orig
    return undo


def check_answers(done, outs, vocab: int) -> int:
    """Answers of the wrong shape or with a token outside the vocabulary."""
    bad = 0
    for (req, _, _), out in zip(done, outs):
        shape = (req.batch, max(req.steps, 1))
        if (getattr(out, "shape", None) != shape or out.min() < 0
                or out.max() >= vocab):
            bad += 1
    return bad


def judge(bench: Bench, done, outs, control: str | None = None) -> dict:
    """The reference's gaps over a sample of the served sequences, and the
    numbers a limit can hold (``judge.readings``)."""
    from port_bench.lib import judge as jd
    from port_bench.lib import reference
    seqs = jd.sample([(r, o) for (r, _, _), o in zip(done, outs)], bench.mix,
                     bench.seed)
    g = reference.gaps(bench.spec, bench.seed, seqs, bench.device, control)
    return {**jd.readings(g), "sequences": len(seqs), "gaps": g}


def decide(limits: dict, reading: dict, bad: int) -> tuple[dict, bool]:
    """Each number the cell's limits name, beside its limit, and whether
    every one holds: (checks, correct)."""
    checks = {name: {"value": reading[name], "limit": limit}
              for name, limit in limits.items()}
    checks["wrong_answers"] = {"value": bad, "limit": 0}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def jax_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None, require_cuda: bool = True, root: Path = ROOT) -> int:
    args = parse(argv)
    _cache_dirs(root)
    if str(root) not in sys.path[:1]:
        sys.path.insert(0, str(root))
    import torch

    from port_bench.lib import context, trace as tr

    cell = Cell(root, args.workload)
    chips = int(cell.cell["chips"])
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        device = torch.device("cuda", 0)
    elif require_cuda:
        log(f"no result: the cell asks for {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 2
    else:
        device = torch.device("cpu")
    limits = cell.limits()
    bench = Bench(cell, args.seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s (weights {bench.weights_s:.3f} s)")

    t0, done, outs, events = bench.window(args.seconds, bool(args.trace))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bench.free()
    view = tr.TraceView(events) if events is not None else None
    del events

    ctx = context.Context(spec=bench.spec, mix=bench.mix, setup_s=setup_s,
                          weights_s=bench.weights_s, t0=t0, done=done,
                          traced=[r for r, _, _ in
                                  done[:int(bench.mix["traced_requests"])]],
                          view=view)
    log(f"window: {len(done)} requests, {ctx.served_tokens([r for r, _, _ in done])}"
        f" served tokens, {done[-1][2] - t0:.3f} s to the last completion; "
        f"latency samples {len(done)}")

    metrics, patterns = {}, []
    for m in cell.metrics(bool(args.trace)):
        reader = context.load_reader(root, m["name"])
        patterns += getattr(reader, "PATTERNS", [])
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = check_answers(done, outs, bench.spec.vocab_size)
    reading = judge(bench, done, outs)
    checks, correct = decide(limits, reading, bad)

    result = {"correct": correct, "attempted": len(done), "failed": bad,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": chips if device.type == "cuda" else 0,
                         "memory_peak_bytes": int(peak)}}
    if view is not None:
        result["device"].update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = view.breakdown()
        log("kernels no metric's pattern matched (name, s): "
            + json.dumps(view.unmatched(patterns)))
    result["checks"] = checks

    found = jax_loaded()
    if found:
        log(f"no result: JAX modules loaded in this process: {found}")
        return 3
    log(f"judged {reading['judged']} served tokens of "
        f"{reading['sequences']} sequences")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
