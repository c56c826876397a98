"""The port's benchmark entry: bench.py's metrics, measured on the card.

    python -m ggml_cuda_experiments_tpu_torch.tools.bench [--trace DIR]
    python -m ggml_cuda_experiments_tpu_torch.tools.bench --decode
        [--model=tinyllama-1.1b|llama2-7b|llama3-8b] [--exact] [--no-hperm]
        [--ckpt PATH]
    python -m ggml_cuda_experiments_tpu_torch.tools.bench --cpu [--decode]

Prints ONE JSON line on stdout, with bench.py's keys; context lines (the
card's name and power limit, each benched kernel's registers, shared memory
and grid, the q8_0 rate, the pairs) go to stderr.

**The kernel metric** (the default): the % of HBM of the q4_k
int8-activation matvec (``q4k_q8_matvec``, bench.py's ``qmatmul(use_vpu,
x_quant8)``) as a size marginal, beside q8_0 (``q80_matvec``) and the
achievable ceiling: the stream floor (``ops/probes.py`` ``floor``) on the
same operands. bench.py's inputs, its own NumPy draws (``default_rng(0)``:
w [32768, 4096] / sqrt(K), then x0 [1, 4096]), quantized by the port's
quantizer, which is bit-equal to the oracle, so the bytes are the JAX
bench's bytes (q8_0 excepted: the port keeps GGML's fp16 d, 4,352 B a row
at K = 4096, where the JAX package widens d to f32, 4,608 B). Each size
(8192 and 32768 rows) is a chain of 64 calls with bench.py's
elementwise fold between them (y[:, :K] * 0.03 + y[:, K:2K] * 0.03 is the
next x), cycling through copies of the weight that together pass the 50 MB
L2 (the 8192-row q4_k weight is 21.0 MB: one copy alone would be read from
the L2), captured once into a CUDA graph and replayed between CUDA events.
The two chains are timed back to back as a pair; a pair's marginal rate
outside (0, 100] % of HBM is rejected and measured again; the metric is
the median of the valid pairs (``utils/bench.py`` ``pair_protocol``).
``value`` is the q4_k %, ``ceiling_pct`` the floor's, ``pct_of_achievable``
their ratio and ``vs_baseline`` value / 85.

**--decode** (bench.py ``decode_bench``): ``init_weights(seed=0)``,
``quantize_params(.., "q4_k")`` through the GCTC cache ``--ckpt``
(``profile_decode.cached_params``: loaded where the file exists, else
built and saved), the configuration ``x_quant8`` (off with
``--exact``) and ``permute_hidden_params`` (off with ``--no-hperm``;
without its model pack, as at tinyllama's dim of 2048, the gates pick
another path, named on stderr). tok/s at batch 1 is the marginal of 8 and
40 replays of one captured ``greedy_scan_step`` after a 16-token prompt of
ones (``tools/spec_bench.py`` ``plain_per_token``); TTFT the median of 5
runs of a 512-token prompt: prefill, argmax, the first decode step and its
argmax, between CUDA events, with no graph capture in it; batch 8 the same
marginal at batch 8 over a 512-slot cache. ``vs_baseline`` is the tok/s
over 0.85 of the weight-stream bound: the bytes a decoded token streams
(``stream_bytes``, bench.py's ``_layer_stream`` rule) at the card's HBM
rate.

``--cpu`` runs the plain versions at a small size (no time: a CPU time is
no device metric) and prints no JSON line. ``--trace DIR`` writes a
``torch.profiler`` Chrome trace of the measured region into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import torch

K = 4096
N_SMALL = 8192
N_BIG = 32768
INNER = 64
TARGET_PCT = 85.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def draws(seed: int = 0, n: int = N_BIG, k: int = K):
    """bench.py's inputs: w [n, k] / sqrt(k) then x0 [1, k], f32, from
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    x0 = rng.normal(size=(1, k)).astype(np.float32)
    return w, x0


def rows(ql, n: int):
    """The first ``n`` rows of a quantized weight (views)."""
    kw = {f: getattr(ql, f)[:n] for f in ("qs", "es", "em", "qh", "d")
          if getattr(ql, f) is not None}
    return dataclasses.replace(ql, shape=(n, ql.shape[1]), **kw)


def copy_of(ql):
    """A copy of ``ql`` in fresh memory."""
    kw = {f: getattr(ql, f).clone() for f in ("qs", "es", "em", "qh", "d")
          if getattr(ql, f) is not None}
    return dataclasses.replace(ql, **kw)


def fold(y: torch.Tensor, k: int = K) -> torch.Tensor:
    """bench.py's elementwise fold of one call's y [1, N >= 2K] into the
    next call's x [1, K]."""
    return (y[:, :k] * 0.03 + y[:, k:2 * k] * 0.03).float()


def chained(fn, weights, x0: torch.Tensor, k: int = K):
    """call(i): one link of the chain, fn(x, weights[i % len]) then the
    fold, x carried from link to link; call(0) starts again from x0."""
    state = [x0]

    def call(i):
        x = x0 if i == 0 else state[0]
        state[0] = fold(fn(x, weights[i % len(weights)]), k)

    return call


def _matvec(fmt: str):
    from ggml_cuda_experiments_tpu_torch.ops import probes
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    if fmt == "floor":
        return probes.floor
    if fmt == "q4_k":
        return lambda x, w: qm.qmatmul(x, w, x_quant8=True)
    return qm.qmatmul


def roofline(name: str, fn, ql_big, x0: torch.Tensor, inner: int = INNER,
             n_pairs: int = 13, min_valid: int = 7, small: int = N_SMALL):
    """% of HBM of ``fn(x, w)`` as bench.py measures it: the size marginal
    between ``small`` rows and all of ``ql_big``'s, interleaved pairs of
    captured chains (``pair_protocol``), weights rotated past the L2.
    Returns (pct, details)."""
    from ggml_cuda_experiments_tpu_torch.utils import bench as ub
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_spec
    spec = card_spec()
    if spec is None:
        raise RuntimeError("no published peaks for this card")
    graphs, nbytes, copies = {}, {}, {}
    for n in (small, ql_big.shape[0]):
        base = rows(ql_big, n)
        # the copies live as long as the graph that reads them
        copies[n] = ub.rotating(lambda i: copy_of(base), base.nbytes)
        graphs[n] = ub.capture(chained(fn, copies[n], x0), inner)
        nbytes[n] = base.nbytes
    s, b = small, ql_big.shape[0]
    dbytes = nbytes[b] - nbytes[s]
    pct, valid, rejected = ub.pair_protocol(
        lambda: (ub.replay_seconds(graphs[s]), ub.replay_seconds(graphs[b])),
        inner, dbytes, spec.hbm_bytes_per_s, n_pairs, min_valid)
    gbs = pct / 100 * spec.hbm_bytes_per_s / 1e9
    us = dbytes / (gbs * 1e3) if gbs > 0 else float("inf")
    log(f"{name}: {us:.2f} us per call of the marginal {dbytes / 1e6:.1f} MB"
        f" ({b} - {s} rows; {len(copies[s])} / {len(copies[b])} rotated "
        "copies), "
        f"{gbs:.1f} GB/s of {spec.hbm_bytes_per_s / 1e9:.0f} ({pct:.2f}% of "
        f"HBM)\n  pairs valid={[round(p, 2) for p in sorted(valid)]} "
        f"rejected={[round(p, 2) for p in rejected]}")
    return pct, {"pct": pct, "us_per_marginal_call": us, "gbytes_per_s": gbs,
                 "valid": valid, "rejected": rejected, "dbytes": dbytes,
                 "copies": [len(copies[s]), len(copies[b])], "inner": inner}


def kernel_report(k: int = K) -> dict:
    """bench.py's ``vmem_report`` counterpart: registers, shared memory and
    grid of each benched kernel at the benched rows, from the runtime;
    ``q80_matvec``'s grid and split from its wrapper's plan
    (``q80_plan``), the others' one row a warp."""
    from ggml_cuda_experiments_tpu_torch.ops import probes
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    out = {}
    for name, info in (("q80_matvec", probes.kernel_info("q80_matvec", k)),
                       ("q4k_q8_matvec",
                        probes.kernel_info("q4k_q8_matvec", k)),
                       ("ladder floor", probes.ladder_info("floor", k))):
        cap = info["ctas_per_sm"] * info["sms"]
        for n in (N_SMALL, N_BIG):
            if name == "q80_matvec":
                splits, stages, grid = qm.q80_plan(n, k, info["sms"])
                plan = f", {splits} split(s), {stages} stages"
            else:
                grid, plan = min(-(-n // (info["threads"] // 32)), cap), ""
            log(f"{name} N={n} K={k}: {info['threads']} threads, "
                f"{info['regs']} registers, {info['local_bytes']} B local, "
                f"shared {info['static_smem']} B static + "
                f"{info['dynamic_smem']} B dynamic, {info['ctas_per_sm']} "
                f"CTAs/SM resident, grid {grid}{plan}")
        out[name] = info
    return out


def kernel_metric(dev, seed: int = 0, pairs=(4, 13, 5),
                  min_valid=(3, 7, 3)) -> dict:
    """bench.py's default run on the card: q8_0, q4_k and the stream-only
    ceiling, each a size marginal. Returns the JSON line's numbers and the
    details."""
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    w, x0 = draws(seed)
    x = torch.from_numpy(x0).to(dev)
    wd = torch.from_numpy(w).to(dev)
    qls = {fmt: qm.quantize(wd, fmt) for fmt in ("q8_0", "q4_k")}
    del wd
    res = {}
    for (key, name, fmt, qfmt), np_, mv in zip(
            (("q8_0", "q8_0", "q8_0", "q8_0"), ("q4_k", "q4_k", "q4_k", "q4_k"),
             ("ceiling", "stream-only ceiling (floor rung)", "floor",
              "q4_k")), pairs, min_valid):
        ql = qls[qfmt]
        log(f"{name}: {qfmt} [{N_BIG}, {K}], {ql.nbytes / N_BIG:.0f} B a row")
        res[key] = roofline(name, _matvec(fmt), ql, x, INNER, np_, mv)[1]
    pct, ceil = res["q4_k"]["pct"], res["ceiling"]["pct"]
    res["line"] = {
        "metric": f"q4_k dequant-matvec HBM roofline "
                  f"({torch.cuda.get_device_name(0)})",
        "value": round(pct, 2), "unit": "% of peak HBM BW",
        "vs_baseline": round(pct / TARGET_PCT, 4),
        "ceiling_pct": round(ceil, 2),
        "pct_of_achievable": round(100.0 * pct / ceil, 2) if ceil else None}
    log(f"q4_k median: {pct:.2f}% (q8_0: {res['q8_0']['pct']:.2f}%; "
        f"stream-only ceiling {ceil:.2f}% -> "
        f"{res['line']['pct_of_achievable']}% of achievable)")
    return res


# ---------------------------------------------------------------------------
# --decode
# ---------------------------------------------------------------------------

def _nbytes(v) -> int:
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    if isinstance(v, qm.QuantLinear):
        return v.nbytes
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return 0


def stream_bytes(params) -> int:
    """The weight bytes one decoded token streams, bench.py's rule
    (``_layer_stream``): every tensor of every layer (the quantized linears
    at their stored size and the norms), the head and the final norm; the
    embedding is a row lookup, not a stream. bench.py drops a layer's
    wqkv / wo / w_gu_f where a ``w_pack`` holds copies of them; the port's
    packs (``m_pack``, ``w_pack``) hold pointers to the same weights, not
    copies, so they add nothing and drop nothing."""
    return (sum(_nbytes(v) for layer in params["layers"]
                for v in layer.values())
            + _nbytes(params["lm_head"]) + _nbytes(params["final_norm"]))


def decode_path(params, cfg, dev) -> dict:
    """The kernels one eager decode step launches (the path the gates pick),
    after a 16-token prefill."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    tables = _launch_tables()
    cache = llama.KVCache.create(cfg, 1, 256, device=dev)
    logits, cache = llama.prefill(params, cfg, torch.ones(
        (1, 16), dtype=torch.int64, device=dev), cache)
    before = _snapshot(tables)
    llama.decode_step(params, cfg, torch.argmax(logits, -1), cache)
    after = _snapshot(tables)
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _launch_tables():
    from ggml_cuda_experiments_tpu_torch.ops import (
        flash_attention, flash_decode, fused_attention, layer_kernel,
        paged_attention, prefill_fuse, quant_matmul)
    return (quant_matmul.LAUNCHES, flash_decode.LAUNCHES,
            flash_attention.LAUNCHES, prefill_fuse.LAUNCHES,
            paged_attention.LAUNCHES, fused_attention.LAUNCHES,
            layer_kernel.LAUNCHES)


def _snapshot(tables) -> dict:
    return {k: v for t in tables for k, v in t.items()}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def ttft_seconds(params, cfg, dev, plen: int = 512, runs: int = 5,
                 max_len: int = 1024) -> list:
    """Time to first token, ``runs`` times: prefill of ``plen`` ones, the
    argmax, one decode step and its argmax, between CUDA events (a fresh
    cache each run, made before the clock starts; no graph capture)."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.utils.bench import _need_card
    _need_card("ttft_seconds")
    prompt = torch.ones((1, plen), dtype=torch.int64, device=dev)
    out = []
    for _ in range(runs):
        cache = llama.KVCache.create(cfg, 1, max_len, device=dev)
        _sync(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = llama.prefill(params, cfg, prompt, cache)
        tok = torch.argmax(logits, -1)
        logits, cache = llama.decode_step(params, cfg, tok, cache)
        torch.argmax(logits, -1)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 1e3)
        del cache
    return out


def decode_config(model: str, exact: bool = False):
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    return dataclasses.replace(PRESETS[model], x_quant8=not exact)


def decode_bench(model: str = "tinyllama-1.1b", params=None, dev=None,
                 exact: bool = False, hperm: bool = True, seed: int = 0,
                 steps=(8, 40), ckpt=None) -> dict:
    """bench.py's ``--decode`` on the card. ``params``: the q4_k weights of
    ``model`` (when None, ``seed``'s through the GCTC cache ``ckpt``:
    ``profile_decode.cached_params``). Returns tok/s at batch 1, the
    TTFTs, batch-8 tok/s, the stream bytes, the bound and the JSON line."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb
    from ggml_cuda_experiments_tpu_torch.tools.profile_decode import (
        cached_params)
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_spec
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = require_cuda() if dev is None else torch.device(dev)
    cfg = decode_config(model, exact)
    if params is None:
        log(f"{model} q4_k: {cfg.num_params() / 1e9:.2f}B params from seed "
            f"{seed}")
        params = cached_params(cfg, "q4_k", seed, dev, ckpt=ckpt)
    if hperm:
        params = llama.permute_hidden_params(params, cfg)
        cfg = dataclasses.replace(cfg, hperm=True)
        log(f"  hperm: model pack {'built' if 'm_pack' in params else 'not '
            'built (the gates are shut at this shape)'} (--no-hperm to "
            "disable)")
    nbytes = stream_bytes(params)
    log(f"  weight stream: {nbytes / 1e9:.4f} GB/token "
        f"({nbytes * 8 / cfg.num_params():.2f} bits/weight incl. dense "
        "head/norms)")
    path = decode_path(params, cfg, dev)
    log(f"  decode path (launches of one eager step): {path}")
    prompt = torch.ones((1, 16), dtype=torch.int64, device=dev)
    s_tok = sb.plain_per_token(params, cfg, prompt, max_len=1024)
    tok_s = 1.0 / s_tok
    log(f"{model} q4_k decode: {tok_s:.1f} tok/s ({s_tok * 1e3:.3f} "
        f"ms/token, batch 1; marginal of {steps[0]} and {steps[1]} replays "
        "of one captured step)")
    ttfts = ttft_seconds(params, cfg, dev)
    p50 = sorted(ttfts)[len(ttfts) // 2]
    log(f"{model} q4_k TTFT (512-token prompt, p50 of {len(ttfts)}): "
        f"{p50 * 1e3:.2f} ms (all: {[round(t * 1e3, 2) for t in ttfts]})")
    s8 = sb.plain_per_token(params, cfg, torch.ones(
        (8, 16), dtype=torch.int64, device=dev), max_len=512)
    log(f"{model} q4_k decode batch 8: {8 / s8:.1f} tok/s total "
        f"({s8 * 1e3:.3f} ms/step)")
    spec = card_spec()
    target = 0.85 * spec.hbm_bytes_per_s / nbytes
    log(f"decode target: 0.85 * weight-stream bound = {target:.1f} tok/s "
        f"(bound {spec.hbm_bytes_per_s / nbytes:.1f})")
    return {"model": model, "tok_s": tok_s, "ms_per_token": s_tok * 1e3,
            "ttft_ms": [t * 1e3 for t in ttfts], "ttft_p50_ms": p50 * 1e3,
            "batch8_tok_s": 8 / s8, "stream_bytes": nbytes,
            "bound_tok_s": spec.hbm_bytes_per_s / nbytes,
            "target_tok_s": target, "path": path,
            "line": {"metric": f"{model} q4_k decode throughput (batch 1)",
                     "value": round(tok_s, 2), "unit": "tokens/s/chip",
                     "vs_baseline": round(tok_s / target, 4)}}


# ---------------------------------------------------------------------------
# --cpu: the plain versions at a small size
# ---------------------------------------------------------------------------

def cpu_check(decode: bool, model: str) -> int:
    """The entry's paths through the plain versions on the CPU, at 512 rows
    and the debug model: no time is measured."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    dev = torch.device("cpu")
    if decode:
        cfg = dataclasses.replace(PRESETS["debug"], x_quant8=True)
        params = llama.quantize_params(
            llama.init_weights(cfg, seed=0, device=dev), "q4_k")
        log(f"--cpu --decode: {model} measured only on the card; the debug "
            f"model's stream is {stream_bytes(params)} bytes a token, one "
            f"step launches {decode_path(params, cfg, dev) or 'nothing'} "
            "(plain versions); time not measured")
        return 0
    w, x0 = draws(0, 512)
    x = torch.from_numpy(x0)
    for fmt in ("q8_0", "q4_k", "floor"):
        ql = qm.quantize(torch.from_numpy(w), "q4_k" if fmt == "floor"
                         else fmt)
        y = _matvec(fmt)(x, ql)
        log(f"{fmt}: one call on [512, {K}] -> {tuple(y.shape)} (plain "
            "version); time not measured")
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode", action="store_true")
    # llama2-70b is left out: decode_bench builds the dense model whole
    # (~138 GB in bf16), more than one card holds
    ap.add_argument("--model", default="tinyllama-1.1b",
                    choices=("tinyllama-1.1b", "llama2-7b", "llama3-8b"))
    ap.add_argument("--exact", action="store_true",
                    help="--decode without x_quant8")
    ap.add_argument("--no-hperm", action="store_true",
                    help="--decode without permute_hidden_params")
    ap.add_argument("--ckpt", metavar="PATH", default=None,
                    help="--decode: the GCTC weight cache (default: "
                    "profile_decode.ckpt_path's keyed file)")
    ap.add_argument("--trace", metavar="DIR", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions at a small size; no time")
    return ap


@contextlib.contextmanager
def traced(trace_dir):
    """``--trace``: a torch.profiler Chrome trace of the block."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    path = os.path.join(trace_dir, "bench_trace.json")
    prof.export_chrome_trace(path)
    log(f"trace written to {path}")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cpu:
        return cpu_check(args.decode, args.model)
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {card_line()}")
    with traced(args.trace):
        if args.decode:
            line = decode_bench(args.model, dev=dev, exact=args.exact,
                                hperm=not args.no_hperm,
                                ckpt=args.ckpt)["line"]
        else:
            kernel_report()
            line = kernel_metric(dev)["line"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
