"""The serving engine's throughput and where its host time goes: the port's
counterpart of the JAX package's ``tools/engine_bench.py``, with its flags.

    python -m ggml_cuda_experiments_tpu_torch.tools.engine_bench \\
        [--model llama2-7b] [--fmt q4_k] [--batch 8] [--prompt 64] \\
        [--gen 64] [--pages 128] [--page-size 64] [--max-seq-len N] \\
        [--int8-kv] [--native-sched] [--window 1] [--prefill-chunk C] \\
        [--pairs 3] [--ckpt PATH] [--trace DIR] [--root DIR] [--tag new]
    python -m ggml_cuda_experiments_tpu_torch.tools.engine_bench --cpu

Random weights from ``--seed`` (``init_weights``, quantized to ``--fmt`` on
the card, through the GCTC cache ``--ckpt``: ``profile_decode.
cached_params``) in the JAX tool's configuration (``x_quant8``). One ``Engine`` a
run (``--batch`` slots, a pool of ``--pages`` pages of ``--page-size``,
``max_seq_len`` the JAX tool's rule unless ``--max-seq-len``), requests of
``--prompt`` random tokens generating ``--gen`` each. It measures:

- **steady-state generated tok/s**: the marginal of 3 x batch requests
  less batch (each run to completion between device syncs on the host
  clock), in ``--pairs`` pairs whose order alternates, after one warm-up
  run; the median of the pairs' rates (the smoke's phase 6 protocol);
- **TTFT** on an idle engine: admission, the prefill and the first token
  on the host (median of 5);
- **pool bytes**, and **peak device memory** over the measurement;
- **the device's busy share** of the engine's steps: a few ``step()``
  calls timed on the host clock, the next as many under ``torch.profiler``
  (device time by kernel);
- **the host time of a step by part**, from one run of ``--batch``
  requests with the Engine's methods and the functions its steps call
  wrapped from here (``host_parts``; nothing in the Engine is changed):
  admission, release, completion, the uploads (``_upload``), the device
  steps' launches (prefill; decode step, split into its linears, paged
  attention, KV writes, RoPE, norms and the rest), the decode loop,
  sampling, the token gathers and the fetches to the host (``.cpu()``,
  ``int()``: these wait for the device). Self times: a part nested in
  another is not counted in it. The wrapped run is not the timed one.

The card's name and power limit come first, one JSON line of every number
last. ``--trace DIR`` writes a ``torch.profiler`` Chrome trace of one more
run of ``--batch`` requests. ``--root DIR`` runs this file against the
package of the checkout at DIR (a parent unpacked by ``git archive``), for
parent / change pairs in one call. ``--cpu`` checks the arguments and
prints the plan (pool bytes, requests, tokens) and times nothing. Without
``--cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

TTFT_RUNS = 5
# (label, module key, attribute): the functions host_parts wraps. Module
# keys: "engine" (models/engine.py), "Engine" (its class), "llama"
# (models/llama.py), "Tensor" (torch.Tensor). Parts named after a device
# step are split by the step they ran in ("decode step/linears").
WRAPPED = (
    ("scheduler step", "Engine", "step"),
    ("admission", "Engine", "_admit"),
    ("completion (native)", "Engine", "_native_done"),
    ("release", "Engine", "_release"),
    ("first token", "Engine", "_finish_prefill"),
    ("token gather", "Engine", "_collect_device"),
    ("upload", "engine", "_upload"),
    ("prefill", "engine", "_paged_prefill"),
    ("prefill", "engine", "_paged_prefill_chunk"),
    ("decode step", "engine", "_paged_decode_step"),
    ("decode loop", "engine", "_paged_decode_window"),
    ("sampling", "engine", "sample"),
    ("paged attention", "engine", "paged_decode"),
    ("kv write", "engine", "_write_kv"),
    ("linears", "llama", "apply_linear"),
    ("rope", "llama", "rope"),
    ("norms", "llama", "rms_norm"),
    ("fetch to host", "Tensor", "cpu"),
    ("fetch to host", "Tensor", "__int__"),
)
SUB_PARTS = ("paged attention", "kv write", "linears", "rope", "norms")


def log(*a):
    print(*a, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--fmt", default="q4_k")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--pages", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="default: prompt + gen rounded up to a page")
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--native-sched", action="store_true")
    ap.add_argument("--window", type=int, default=1)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", metavar="PATH", default=None,
                    help="the GCTC weight cache (default: "
                    "profile_decode.ckpt_path's keyed file)")
    ap.add_argument("--trace", metavar="DIR", default=None)
    ap.add_argument("--root", default=None,
                    help="run against the package of the checkout at DIR")
    ap.add_argument("--tag", default="new")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    if args.model not in PRESETS:
        ap.error(f"--model: one of {', '.join(PRESETS)}")
    if min(args.batch, args.prompt, args.gen, args.pages, args.page_size,
           args.window, args.pairs) < 1:
        ap.error("batch, prompt, gen, pages, page-size, window and pairs "
                 "are at least 1")
    if args.native_sched and (args.window > 1 or args.prefill_chunk):
        ap.error("--native-sched takes neither --window > 1 nor "
                 "--prefill-chunk (the native scheduler's limits)")
    if args.max_seq_len is None:
        ps = args.page_size
        args.max_seq_len = -(-(args.prompt + args.gen) // ps) * ps
    return args


def engine_kw(args) -> dict:
    """The ``Engine`` keywords of the command line."""
    return dict(max_batch=args.batch, page_size=args.page_size,
                n_pages=args.pages, max_seq_len=args.max_seq_len,
                quantized_kv="int8" if args.int8_kv else False,
                scheduler="native" if args.native_sched else "python",
                decode_window=args.window, prefill_chunk=args.prefill_chunk)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prompts(cfg, n: int, length: int, g: torch.Generator) -> list:
    return [torch.randint(1, cfg.vocab_size, (length,), generator=g).tolist()
            for _ in range(n)]


def serve(params, cfg, kw, prompts, gen) -> tuple[int, float]:
    """All ``prompts`` through a fresh engine to completion: (tokens
    generated, seconds from the first request to the last token, between
    device syncs). The engine is made before the clock starts and
    collected after it stops (its steps hold it in reference cycles, so
    without a collection dead engines' pools pile up on the card)."""
    from ggml_cuda_experiments_tpu_torch.models import engine
    dev = params["embed"].device
    eng = engine.Engine(params, cfg, **kw)
    _sync(dev)
    t0 = time.perf_counter()
    for p in prompts:
        eng.add_request(p, max_new_tokens=gen)
    out = eng.run_to_completion()
    _sync(dev)
    secs = time.perf_counter() - t0
    del eng
    gc.collect()
    return sum(len(v) for v in out.values()), secs


def steady_rate(params, cfg, kw, batch: int, prompt: int, gen: int,
                pairs: int = 3, seed: int = 0, warmup: bool = True) -> dict:
    """Generated tok/s at steady state: the marginal of 3 x batch requests
    less batch, ``pairs`` pairs in alternating order after a warm-up run
    (unless ``warmup`` is False: a caller that ran the engine already),
    the median of their rates."""
    g = torch.Generator().manual_seed(seed)

    def timed(n):
        return serve(params, cfg, kw, _prompts(cfg, n, prompt, g), gen)

    if warmup:
        timed(batch)
    rates, runs = [], []
    for rep in range(pairs):
        order = (batch, 3 * batch) if rep % 2 == 0 else (3 * batch, batch)
        got = {n: timed(n) for n in order}
        (ts, ss), (tb, sb) = got[batch], got[3 * batch]
        rates.append((tb - ts) / (sb - ss))
        runs.append({"small": [ts, ss], "big": [tb, sb],
                     "order": list(order)})
        log(f"    pair {rep}: {tb} tokens in {sb:.3f} s less {ts} in "
            f"{ss:.3f} s -> {rates[-1]:.2f} tok/s")
    return {"tok_s": statistics.median(rates), "pair_rates": rates,
            "pairs": runs}


def ttft_ms(params, cfg, kw, prompt: int, gen: int, seed: int = 0,
            runs: int = TTFT_RUNS) -> list:
    """Time to first token on an idle engine, ``runs`` times: the request's
    admission, its prefill and its first token on the host (a fresh engine
    each run, made before the clock starts)."""
    from ggml_cuda_experiments_tpu_torch.models import engine
    dev = params["embed"].device
    g = torch.Generator().manual_seed(seed + 1)
    out = []
    for p in _prompts(cfg, runs, prompt, g):
        eng = engine.Engine(params, cfg, **kw)
        _sync(dev)
        t0 = time.perf_counter()
        eng.add_request(p, max_new_tokens=gen)
        eng._admit()
        while eng.prefilling:                  # a prompt in chunks
            eng._prefill_step(eng.prefilling[0])
        req = eng.running[0]
        first = (int(eng._tokens_dev[req.slot]) if eng._defer
                 else req.generated[0])
        out.append((time.perf_counter() - t0) * 1e3)
        del eng, first
        gc.collect()
    return out


class PartTimer:
    """Self time and calls of wrapped functions on the host clock: a call
    nested in another wrapped call is taken out of its parent's time."""

    def __init__(self):
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self._stack = []                   # [label, start, children]

    def _label(self, part: str) -> str:
        if part in SUB_PARTS:
            for label, _, _ in reversed(self._stack):
                if label in ("prefill", "decode step"):
                    return f"{label}/{part}"
        return part

    def wrap(self, part: str, fn):
        def call(*a, **kw):
            frame = [self._label(part), time.perf_counter(), 0.0]
            self._stack.append(frame)
            try:
                return fn(*a, **kw)
            finally:
                self._stack.pop()
                dt = time.perf_counter() - frame[1]
                self.seconds[frame[0]] += dt - frame[2]
                self.calls[frame[0]] += 1
                if self._stack:
                    self._stack[-1][2] += dt
        return call


@contextlib.contextmanager
def wrapped(timer: PartTimer):
    """``WRAPPED`` replaced by ``timer``'s wrappers while the block runs
    (names a checkout lacks are skipped)."""
    from ggml_cuda_experiments_tpu_torch.models import engine, llama
    owners = {"engine": engine, "Engine": engine.Engine, "llama": llama,
              "Tensor": torch.Tensor}
    saved = []                  # (owner, name, its own attribute or None)
    try:
        for part, key, name in WRAPPED:
            owner = owners[key]
            fn = getattr(owner, name, None)
            if fn is None:
                continue
            own = owner.__dict__.get(name) if isinstance(owner, type) \
                else fn
            saved.append((owner, name, own))
            setattr(owner, name, timer.wrap(part, fn))
        yield
    finally:
        for owner, name, own in reversed(saved):
            if own is None:             # inherited: drop the wrapper
                delattr(owner, name)
            else:
                setattr(owner, name, own)


def host_parts(params, cfg, kw, batch: int, prompt: int, gen: int,
               seed: int = 0) -> dict:
    """One run of ``batch`` requests with the host time split by part
    (``PartTimer`` self times, ms in all and ms a decode step), beside the
    run's wall time and its count of device steps."""
    g = torch.Generator().manual_seed(seed + 2)
    prompts = _prompts(cfg, batch, prompt, g)
    timer = PartTimer()
    with wrapped(timer):
        toks, secs = serve(params, cfg, kw, prompts, gen)
    steps = timer.calls["decode step"]
    parts = {k: 1e3 * v for k, v in sorted(timer.seconds.items(),
                                           key=lambda kv: -kv[1])}
    rest = 1e3 * secs - sum(parts.values())
    return {"wall_ms": 1e3 * secs, "tokens": toks, "decode_steps": steps,
            "prefills": timer.calls["prefill"], "parts_ms": parts,
            "calls": dict(timer.calls), "unwrapped_ms": rest,
            "per_decode_step_ms": {k: v / max(steps, 1)
                                   for k, v in parts.items()}}


def busy_share(params, cfg, kw, batch: int, prompt: int, gen: int,
               seed: int = 0) -> dict:
    """The device's busy share of the engine's steps: after the first step
    (admission, prefills, the first decode), ``n`` steps of ``batch``
    running requests on the host clock, then ``n`` more under
    ``torch.profiler``: their device time over the unprofiled wall (the
    profiler's own host cost stretches the wall it sees). ``n`` covers
    16 decode steps."""
    from torch.profiler import ProfilerActivity, profile
    from ggml_cuda_experiments_tpu_torch.models import engine
    dev = params["embed"].device
    g = torch.Generator().manual_seed(seed + 3)
    eng = engine.Engine(params, cfg, **kw)
    for p in _prompts(cfg, batch, prompt, g):
        eng.add_request(p, max_new_tokens=gen)
    n = max(1, 16 // kw.get("decode_window", 1))
    eng.step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    _sync(dev)
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        _sync(dev)
    steps = n * kw.get("decode_window", 1)
    kernels = kernel_rows(prof, steps)
    busy = steps * sum(r["device_us"] for r in kernels)
    eng.run_to_completion()
    del eng
    gc.collect()
    return {"steps": n, "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / wall_us, "kernels_per_decode_step": kernels}


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_rows(prof, per: int) -> list:
    """The device kernels of a profile by device time: us and launches per
    ``per`` (a decode step, a prefill)."""
    rows = [{"kernel": e.key, "device_us": _dev_us(e) / per,
             "launches": e.count / per}
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]
    return sorted(rows, key=lambda r: -r["device_us"])


def measure(params, cfg, kw, batch: int, prompt: int, gen: int,
            pairs: int = 3, seed: int = 0, tag: str = "new",
            trace: str | None = None, warmup: bool = True) -> dict:
    """Every number of the tool for one configuration on the card."""
    from ggml_cuda_experiments_tpu_torch.models import engine
    from ggml_cuda_experiments_tpu_torch.utils.bench import _need_card
    dev = params["embed"].device
    _need_card("engine_bench")
    name = (f"{tag} {kw['scheduler']} W={kw['decode_window']}"
            + (f" chunk={kw['prefill_chunk']}" if kw.get("prefill_chunk")
               else ""))
    pool = engine.PagedKVPool.create(cfg, kw["n_pages"], kw["page_size"],
                                     kw["quantized_kv"], device="meta")
    torch.cuda.reset_peak_memory_stats(dev)
    log(f"== engine_bench {name}: batch {batch}, prompt {prompt}, gen {gen}, "
        f"pool {kw['n_pages']} x {kw['page_size']} "
        f"({pool.quant_fmt or 'bf16'}, {pool.nbytes} bytes), max_seq_len "
        f"{kw['max_seq_len']}")
    steady = steady_rate(params, cfg, kw, batch, prompt, gen, pairs, seed,
                         warmup)
    log(f"  {name}: {steady['tok_s']:.2f} generated tok/s at steady state "
        f"(median of {pairs} marginal rates, {3 * batch} requests less "
        f"{batch})")
    ttft = ttft_ms(params, cfg, kw, prompt, gen, seed)
    log(f"  {name}: TTFT at {prompt} tokens (idle engine) p50 "
        f"{statistics.median(ttft):.2f} ms, all "
        f"{[round(t, 2) for t in ttft]}")
    parts = host_parts(params, cfg, kw, batch, prompt, gen, seed)
    log(f"  {name}: host time by part, one run of {batch} requests: wall "
        f"{parts['wall_ms']:.1f} ms, {parts['decode_steps']} decode steps, "
        f"{parts['prefills']} prefills; ms in all (ms a decode step):")
    for k, v in parts["parts_ms"].items():
        log(f"    {k:28s} {v:10.2f} ({v / max(parts['decode_steps'], 1):8.3f})"
            f"  calls {parts['calls'][k]}")
    log(f"    {'not wrapped':28s} {parts['unwrapped_ms']:10.2f}")
    busy = busy_share(params, cfg, kw, batch, prompt, gen, seed)
    log(f"  {name}: {busy['steps']} engine steps: wall {busy['wall_ms']:.2f}"
        f" ms, device busy {busy['busy_ms']:.2f} ms "
        f"({100 * busy['busy_share']:.1f}%); by kernel, a decode step:")
    for r in busy["kernels_per_decode_step"][:8]:
        log(f"    {r['device_us']:9.1f} us {r['launches']:7.1f} launches  "
            f"{r['kernel'][:70]}")
    if trace:
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(trace, exist_ok=True)
        g = torch.Generator().manual_seed(seed + 4)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve(params, cfg, kw, _prompts(cfg, batch, prompt, g), gen)
        path = os.path.join(trace, f"engine_trace_{tag}_{kw['scheduler']}"
                            f"_w{kw['decode_window']}.json")
        prof.export_chrome_trace(path)
        log(f"  trace written to {path}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  {name}: peak device memory {peak / 2**30:.2f} GiB")
    return {"tag": tag, "config": {**kw, "batch": batch, "prompt": prompt,
                                   "gen": gen},
            "steady": steady, "ttft_ms": ttft, "pool_bytes": pool.nbytes,
            "peak_bytes": peak, "host_parts": parts, "busy": busy}


def build_params(args, dev):
    """The JAX tool's weights: ``init_weights(seed)`` quantized to
    ``--fmt`` on the card through the GCTC cache ``--ckpt``
    (``profile_decode.cached_params``), configuration ``x_quant8``."""
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.tools.profile_decode import (
        cached_params)
    cfg = dataclasses.replace(PRESETS[args.model], x_quant8=True)
    return cached_params(cfg, args.fmt, args.seed, dev,
                         ckpt=args.ckpt), cfg


def plan(args) -> int:
    from ggml_cuda_experiments_tpu_torch.models import engine
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    cfg = PRESETS[args.model]
    kw = engine_kw(args)
    pool = engine.PagedKVPool.create(cfg, args.pages, args.page_size,
                                     kw["quantized_kv"], device="meta")
    b = args.batch
    print(f"device: cpu (the plan; time not measured)\n"
          f"{args.model} {args.fmt} x_quant8, {kw['scheduler']} scheduler, "
          f"window {args.window}, prefill chunk {args.prefill_chunk}; "
          f"{b} slots, {args.pages} pages of {args.page_size} "
          f"({pool.quant_fmt or 'bf16'}): pool {pool.nbytes} bytes; "
          f"max_seq_len {args.max_seq_len}\n"
          f"steady: {args.pairs} pairs of {3 * b} and {b} requests of "
          f"{args.prompt} tokens, {args.gen} generated each: "
          f"{2 * b * args.gen} tokens a pair's marginal; TTFT p50 of "
          f"{TTFT_RUNS}; host parts over {b} requests: "
          + ", ".join(dict.fromkeys(p for p, _, _ in WRAPPED)))
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    if args.cpu:
        return plan(args)
    if args.root:
        env = dict(os.environ, PYTHONPATH=str(Path(args.root).resolve()))
        rest, it = [], iter(argv if argv is not None else sys.argv[1:])
        for a in it:
            if a == "--root":
                next(it)
            elif not a.startswith("--root="):
                rest.append(a)
        return subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               *rest], env=env).returncode
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = require_cuda()
    log(card_line())
    params, cfg = build_params(args, dev)
    out = measure(params, cfg, engine_kw(args), args.batch, args.prompt,
                  args.gen, args.pairs, args.seed, args.tag, args.trace)
    print(json.dumps({"engine_bench": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
