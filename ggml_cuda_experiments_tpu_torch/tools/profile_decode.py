"""A decode step's and a prefill's time by component, each beside its bound:
the port's counterpart of the JAX package's ``tools/profile_decode.py``
(with its flags and its configuration, ``x_quant8``) and, under
``--prefill T``, of its ``tools/prefill_marginal.py``.

    python -m ggml_cuda_experiments_tpu_torch.tools.profile_decode \\
        [--model tinyllama-1.1b] [--fmt q4_k] [--cache 1024] [--batch 1]
        [--trace DIR]
    python -m ggml_cuda_experiments_tpu_torch.tools.profile_decode \\
        --model llama2-7b --prefill 512 [--reps 3]
    python -m ggml_cuda_experiments_tpu_torch.tools.profile_decode --cpu \\
        [--batch 8] [--prefill 512]

Random weights from ``--seed`` (``init_weights``), quantized to ``--fmt``
on the card. **Decode** (``--batch B`` rows): the step is bench.py's, a
``greedy_scan_step`` after a 16-token prompt of ones into a cache of
``--cache`` slots; at batch 1 the configuration's gates take the fused
attention and MLP kernels, at batch 8 every linear takes the dequantizing
GEMM's stream route (``gemm_route``), as bench.py's batch-8 step does.
Components, each the inner-count marginal of a chain of 8 and 40 calls
captured in CUDA graphs (``utils/bench.py::chain_marginal``) that cycles
through the model's distinct layers (and copies, where they are too few to
pass the 50 MB L2, ``rotating``):

- each linear shape (``apply_linear`` at B rows: wqkv, wo, w_gu, w_down)
  times its count a layer, and the head;
- ``flash_decode`` at lengths 64 and ``--cache`` (K / V copies rotated);
- the full step, eager (CUDA events around 8 and 40 eager steps, their
  marginal) and as one graph (``llama.capture_graph``: 8 and 40 replays);
- the glue: the graph's step less the components (attention at 64).

Every component's bound is ``CardSpec.bound_ms`` of the bytes it moves
(weights, activations, the valid K / V) and its operations. Then a
``torch.profiler`` table of 4 eager steps: each call of the model's ops
(``ANNOTATED``: the linears, attention, norms, RoPE, the cache writes) runs
in a range named by its bound, so the step's device time splits by op
(the kernels inside its ranges, their launches, the calls' bounds; the
kernels outside every range are PyTorch's glue between the ops) and by
kernel (device us, launches; the bound on the longest kernel of each
call); then the device's busy time, and the host gaps (the eager step
less the busy time).

**Prefill** (``--prefill T``, ``prefill_marginal.py``): eager prefills of
T tokens on the host clock between device syncs (the least of ``--reps``):
the layer marginal t(L) - t(L / 2) over distinct-weight layers for the
block ablations ``full`` (the real layer), ``attn`` (the attention block),
``mlp`` (the MLP block), ``attn_mat`` (the wqkv and wo GEMMs alone) and
``mlp_mat`` (the w_gu and w_down GEMMs, no SiLU), each beside its bound;
the non-layer tail from a 0-layer prefill (embed, final norm, head,
argmax); then one ``llama.prefill`` (TTFT's path) under
``torch.profiler``: wall, device busy and its kernels.

The card's name and power limit come first, one JSON line last.
``--cpu`` checks the arguments, prints the plan and its bounds at the
H100's rates, and times nothing. Without ``--cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch

LINEARS = ("wqkv", "wo", "w_gu", "w_down")
MODES = ("full", "attn", "mlp", "attn_mat", "mlp_mat")
PROMPT = 16                     # bench.py's decode prompt (ones)
CHAIN = (8, 40)                 # calls of the two chains of a marginal
PROFILED_STEPS = 4
# bytes a weight of each format in the port's containers (ops/quant_matmul)
BYTES_PER_WEIGHT = {"q4_k": 0.625, "q4_0": 0.5625, "q8_0": 1.0625,
                    "q6_k": 0.875}
BOUND_TAG = "bound_us="          # the annotation that carries a call's bound


def log(*a):
    print(*a, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tinyllama-1.1b")
    ap.add_argument("--fmt", default="q4_k", choices=sorted(BYTES_PER_WEIGHT))
    ap.add_argument("--cache", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prefill", type=int, default=0, metavar="T",
                    help="the prefill marginal at T tokens instead")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="DIR", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    if args.model not in PRESETS:
        ap.error(f"--model: one of {', '.join(PRESETS)}")
    if not 1 <= args.batch <= 32:
        ap.error("--batch in [1, 32] (the GEMM's stream route)")
    if args.cache < 128 or args.cache % 64:
        ap.error("--cache: a multiple of 64, at least 128")
    if args.prefill < 0 or args.prefill % 16 or args.reps < 1:
        ap.error("--prefill: a multiple of 16; --reps >= 1")
    return args


def config(model: str):
    """The JAX tool's configuration: the preset with int8 activations."""
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    return dataclasses.replace(PRESETS[model], x_quant8=True)


def padded_intermediate(cfg) -> int:
    """``quantize_params``' rule: up to a multiple of 4096 where that costs
    under 15% more (7B: 11008 -> 12288)."""
    inter = cfg.intermediate
    p = -(-inter // 4096) * 4096
    return inter if p > 1.15 * inter else p


def linear_shapes(cfg) -> list:
    """(name, N, K) of a layer's fused linears, as ``quantize_params``
    stores them."""
    d, hd, ip = cfg.dim, cfg.head_dim, padded_intermediate(cfg)
    return [("wqkv", (cfg.n_heads + 2 * cfg.n_kv_heads) * hd, d),
            ("wo", d, cfg.n_heads * hd), ("w_gu", 2 * ip, d),
            ("w_down", d, ip)]


def kind_of(batch: int, fmt: str, xq8: bool) -> str:
    """The operations' type: int8 for the batch-1 int8-activation matvec
    (q4 formats under x_quant8), bf16 tensor cores otherwise."""
    return "int8" if batch == 1 and xq8 and fmt in ("q4_k", "q4_0") \
        else "bf16"


def linear_bound(spec, n: int, k: int, wbytes: float, batch: int,
                 kind: str) -> tuple[float, str]:
    """The least ms of y [B, N] = x [B, K] W^T: the weight and x read once,
    y written once (bf16), 2 B N K operations."""
    return spec.bound_ms(wbytes + 2 * batch * (k + n), 2 * batch * n * k,
                         kind)


def attention_bound(spec, cfg, batch: int, length: int
                    ) -> tuple[float, str]:
    """One layer's decode attention over ``length`` valid bf16 keys: K and
    V read once, q read and o written once; 4 B Hq len D operations."""
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return spec.bound_ms(2 * 2 * batch * hkv * length * d
                         + 2 * 2 * batch * hq * d,
                         4 * batch * hq * length * d, "bf16")


def _spec_or_h100(cpu: bool):
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_spec
    spec = card_spec("H100") if cpu else card_spec()
    if spec is None:
        raise RuntimeError("no published peaks for this card")
    return spec


# ---------------------------------------------------------------------------
# --cpu: the plan
# ---------------------------------------------------------------------------

def plan(args) -> int:
    cfg = config(args.model)
    spec = _spec_or_h100(True)
    B, L = args.batch, cfg.n_layers
    bpw = BYTES_PER_WEIGHT[args.fmt]
    kind = kind_of(B, args.fmt, cfg.x_quant8)
    print(f"device: cpu (the plan and its bounds at the {spec.name}'s "
          "rates; time not measured)")
    if args.prefill:
        return plan_prefill(args, cfg, spec, bpw)
    path = ("fused attention + fused MLP a layer" if B == 1
            else "every linear on the GEMM stream route")
    print(f"{args.model} {args.fmt} x_quant8, batch {B}, {L} layers, cache "
          f"{args.cache}: {path}")
    total = 0.0
    for name, n, k in linear_shapes(cfg):
        ms, by = linear_bound(spec, n, k, n * k * bpw, B, kind)
        total += ms * L
        print(f"  linear {name:6s} [{n:6d} x {k:6d}] x1 a layer: bound "
              f"{1e3 * ms:8.2f} us ({by}, {kind})")
    ms, by = linear_bound(spec, cfg.vocab_size, cfg.dim,
                          cfg.vocab_size * cfg.dim * bpw, B, kind)
    total += ms
    print(f"  head [{cfg.vocab_size} x {cfg.dim}] x1 a step: bound "
          f"{1e3 * ms:8.2f} us ({by})")
    for length in (64, args.cache):
        ms, by = attention_bound(spec, cfg, B, length)
        print(f"  flash_decode at length {length}: bound {1e3 * ms:8.2f} us"
              f" a layer ({by})")
        if length == 64:
            total += ms * L
    print(f"  step (the components' bounds, attention at 64): "
          f"{total:.3f} ms; chains of {CHAIN[0]} and {CHAIN[1]} calls, a "
          f"profiler table of {PROFILED_STEPS} eager steps")
    return 0


def prefill_flops(cfg, T: int, mode: str) -> tuple[float, float]:
    """(weight bytes, operations) of one prefill layer in ``mode``: the
    GEMMs' 2 T N K and the causal attention's 2 T^2 Hq D."""
    shapes = {name: (n, k) for name, n, k in linear_shapes(cfg)}
    names = {"full": LINEARS, "attn": ("wqkv", "wo"), "attn_mat":
             ("wqkv", "wo"), "mlp": ("w_gu", "w_down"),
             "mlp_mat": ("w_gu", "w_down")}[mode]
    weights = sum(shapes[n][0] * shapes[n][1] for n in names)
    ops = 2 * T * weights
    if mode in ("full", "attn"):
        ops += 2 * T * T * cfg.n_heads * cfg.head_dim
    return weights, ops


def plan_prefill(args, cfg, spec, bpw) -> int:
    T, L = args.prefill, cfg.n_layers
    print(f"{args.model} {args.fmt} x_quant8, prefill of {T} tokens, "
          f"{L} layers: layer marginal over {L // 2} -> {L} layers, "
          f"{args.reps} reps each")
    for mode in MODES:
        w, ops = prefill_flops(cfg, T, mode)
        ms, by = spec.bound_ms(w * bpw, ops, "bf16")
        print(f"  {mode:8s}: bound {ms:.4f} ms a layer ({by}; "
              f"{ops / 1e9:.1f} GFLOP, {w * bpw / 1e6:.1f} MB of weights)")
    ms, by = spec.bound_ms(cfg.vocab_size * cfg.dim * bpw
                           + 2 * T * cfg.dim, 2 * cfg.vocab_size * cfg.dim,
                           "bf16")
    print(f"  non-layer (0 layers): bound {ms:.4f} ms ({by})")
    return 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def build_params(cfg, fmt: str, seed: int, dev):
    from ggml_cuda_experiments_tpu_torch.models import llama
    t0 = time.perf_counter()
    params = llama.quantize_params(
        llama.init_weights(cfg, seed=seed, device=dev), fmt)
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    log(f"{cfg.name} {fmt} weights ready in {time.perf_counter() - t0:.1f} s")
    return params


def _cycle(items, nbytes_each: float) -> list:
    """``items`` (distinct weights), extended by copies of them until the
    cycle streams past the L2."""
    from ggml_cuda_experiments_tpu_torch.tools.bench import copy_of
    from ggml_cuda_experiments_tpu_torch.utils.bench import copies_for
    out = list(items)
    need = copies_for(nbytes_each)
    while len(out) < need:
        out.append(copy_of(items[len(out) % len(items)]))
    return out


def _marginal_us(call) -> float:
    from ggml_cuda_experiments_tpu_torch.utils.bench import chain_marginal
    return 1e6 * chain_marginal(call, *CHAIN)


def _row(rows, name, us, bound_ms, by, count=1, **extra):
    row = {"component": name, "us": us, "count": count,
           "bound_us": 1e3 * bound_ms, "bound_by": by,
           "pct_of_bound": 100 * 1e3 * bound_ms / us if us > 0 else None,
           **extra}
    rows.append(row)
    pct = f"{row['pct_of_bound']:5.1f}%" if row["pct_of_bound"] else "   - "
    log(f"  {name:34s} {us:9.2f} us x{count:<3d} bound {1e3 * bound_ms:8.2f}"
        f" us ({by}) {pct} of its time")
    return row


@torch.no_grad()
def decode_components(params, cfg, dev, batch: int, cache: int) -> dict:
    """The decode step's components and the step itself (see the module
    docstring); returns the rows, the step's times and its bound."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops.flash_decode import flash_decode
    from ggml_cuda_experiments_tpu_torch.utils.bench import rotating
    spec = _spec_or_h100(False)
    B, L = batch, cfg.n_layers
    xq8 = cfg.x_quant8
    layers = params["layers"]
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    log(f"== profile_decode: {cfg.name} batch {B}, {L} layers, cache "
        f"{cache}, x_quant8 {xq8}")
    comp_ms = {"linear": 0.0, "head": 0.0}
    t_linears = 0.0
    for name in LINEARS:
        w0 = layers[0][name]
        n, k = w0.shape
        ws = _cycle([lay[name] for lay in layers], w0.nbytes)
        x = torch.randn((B, k), generator=g, device=dev).to(torch.bfloat16)
        us = _marginal_us(lambda i: llama.apply_linear(x, ws[i % len(ws)],
                                                       xq8))
        kind = kind_of(B, w0.fmt, xq8)
        ms, by = linear_bound(spec, n, k, w0.nbytes, B, kind)
        _row(rows, f"linear {name} [{n} x {k}]", us, ms, by, 1,
             weight_bytes=w0.nbytes, kind=kind, copies=len(ws))
        t_linears += us * L
        comp_ms["linear"] += ms * L
    head = params["lm_head"]
    heads = _cycle([head], head.nbytes)
    x = torch.randn((B, cfg.dim), generator=g, device=dev).to(torch.bfloat16)
    us_head = _marginal_us(lambda i: llama.apply_linear(
        x, heads[i % len(heads)], xq8))
    ms, by = linear_bound(spec, *head.shape, head.nbytes, B,
                          kind_of(B, head.fmt, xq8))
    _row(rows, f"head [{head.shape[0]} x {head.shape[1]}]", us_head, ms, by)
    comp_ms["head"] = ms
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((B, hq, d), generator=g, device=dev).to(torch.bfloat16)
    attn_us = {}
    for length in (64, cache):
        kv = rotating(lambda i: tuple(
            torch.randn((B, hkv, cache, d), generator=g, device=dev
                        ).to(torch.bfloat16) for _ in range(2)),
            2 * 2 * B * hkv * length * d)
        lens = torch.full((B,), length, dtype=torch.int32, device=dev)
        attn_us[length] = _marginal_us(lambda i: flash_decode(
            q, *kv[i % len(kv)], lens))
        ms, by = attention_bound(spec, cfg, B, length)
        _row(rows, f"flash_decode at length {length}", attn_us[length], ms,
             by, L, copies=len(kv))
        del kv
    torch.cuda.empty_cache()
    step = step_times(params, cfg, dev, B, cache)
    # the step's bound: every weight once, the K / V rows at the marginal's
    # mean length, one token's operations at B rows
    mean_len = PROMPT + sum(CHAIN) // 2
    step_ms = comp_ms["linear"] + comp_ms["head"] + L * attention_bound(
        spec, cfg, B, mean_len)[0]
    _row(rows, "step (eager)", step["eager_us"], step_ms, "bytes")
    _row(rows, "step (one graph)", step["graph_us"], step_ms, "bytes")
    glue = step["graph_us"] - (t_linears + us_head + L * attn_us[64])
    _row(rows, "glue (graph step less the above)", glue, 0.0, "-")
    log(f"  sum of the linears {t_linears / 1e3:.3f} ms + head "
        f"{us_head / 1e3:.3f} ms + attention {L * attn_us[64] / 1e3:.3f} ms "
        f"(at 64) = {(t_linears + us_head + L * attn_us[64]) / 1e3:.3f} ms "
        f"of a {step['graph_us'] / 1e3:.3f} ms graph step "
        f"({B * 1e6 / step['graph_us']:.1f} tok/s); eager "
        f"{step['eager_us'] / 1e3:.3f} ms")
    table = step_profile(params, cfg, dev, B, cache)
    return {"batch": B, "layers": L, "cache": cache, "rows": rows,
            "step": step, "step_bound_ms": step_ms, "profile": table}


def _greedy_step(params, cfg, dev, B: int, cache: int):
    from ggml_cuda_experiments_tpu_torch.models import llama
    kv = llama.KVCache.create(cfg, B, cache, device=dev)
    logits, kv = llama.prefill(params, cfg, torch.ones(
        (B, PROMPT), dtype=torch.int64, device=dev), kv)
    tok = torch.argmax(logits, -1).to(torch.int32)
    step, state, _ = llama.greedy_scan_step(params, cfg, tok, kv, CHAIN[1])
    return step, state


@contextlib.contextmanager
def clock_samples(out: list, every_ms: int = 50):
    """``nvidia-smi``'s SM clock (MHz) and power draw (W) of card 0,
    sampled every ``every_ms`` while the block runs, appended to ``out``;
    the sampler is stopped when the block ends (none where nvidia-smi is
    missing)."""
    import subprocess
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", f"--loop-ms={every_ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        proc = None
    try:
        yield
    finally:
        if proc is not None:
            proc.terminate()
            try:
                text = proc.communicate(timeout=10)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                text = proc.communicate()[0]
            for line in text.splitlines():
                try:
                    mhz, watts = (float(v) for v in line.split(","))
                except ValueError:
                    continue
                out.append((mhz, watts))


@torch.no_grad()
def step_times(params, cfg, dev, B: int, cache: int) -> dict:
    """us a step, eager and as one captured graph (``llama.capture_graph``):
    each the marginal of runs of 8 and 40 steps from one saved state
    between CUDA events, the faster of two runs; beside each, the host's
    time to issue the run (its calls or its replays) and, for the graph,
    the SM clock and power sampled meanwhile."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    step, state = _greedy_step(params, cfg, dev, B, cache)
    saved = [t.clone() for t in state]

    def timed(call):
        """{n: (device s, host s to issue)} of n calls, the faster run."""
        out = {}
        for n in CHAIN:
            best = (float("inf"), 0.0)
            for _ in range(2):
                for t, s in zip(state, saved):
                    t.copy_(s)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize(dev)
                start.record()
                t0 = time.perf_counter()
                for _ in range(n):
                    call()
                host = time.perf_counter() - t0
                end.record()
                end.synchronize()
                best = min(best, (start.elapsed_time(end) / 1e3, host))
            out[n] = best
        return out

    def per_step(t, i):
        return 1e6 * (t[CHAIN[1]][i] - t[CHAIN[0]][i]) / (CHAIN[1] - CHAIN[0])

    eager = timed(step)
    for t, s in zip(state, saved):
        t.copy_(s)
    graph = llama.capture_graph(step, state)
    clocks = []
    with clock_samples(clocks):
        replays = timed(graph.replay)
    out = {"eager_us": per_step(eager, 0), "eager_host_us": per_step(eager, 1),
           "graph_us": per_step(replays, 0),
           "graph_host_us": per_step(replays, 1),
           "clock_samples": len(clocks)}
    log(f"  the host issues an eager step in {out['eager_host_us']:.1f} us, a "
        f"replay in {out['graph_host_us']:.1f} us")
    if clocks:
        import statistics
        out["sm_mhz"] = statistics.median(c for c, _ in clocks)
        out["power_w"] = statistics.median(w for _, w in clocks)
        log(f"  during the graph replays: SM clock {out['sm_mhz']:.0f} MHz, "
            f"power {out['power_w']:.1f} W (median of {len(clocks)} "
            "nvidia-smi samples)")
    return out


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _call_bound_us(spec, name: str, a: tuple, kw: dict, length) -> float:
    """The bound (us) of one call of the model's op ``name``, from its
    arguments (shapes, weights) and, for decode attention, the keys the
    step reads (``length()``: the cache length before the token)."""
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import QuantLinear
    if name == "apply_linear":
        x, w = a[0], a[1]
        xq8 = a[2] if len(a) > 2 else kw.get("xq8", False)
        rows, k = x.numel() // x.shape[-1], x.shape[-1]
        n = w.shape[0]
        wb = w.nbytes if isinstance(w, QuantLinear) else \
            w.numel() * w.element_size()
        ms = linear_bound(spec, n, k, wb, rows,
                          kind_of(rows, getattr(w, "fmt", ""), xq8))[0]
    elif name == "mlp_fused":
        w_gu, w_down = a[1], a[2]
        ms = spec.bound_ms(w_gu.nbytes + w_down.nbytes,
                           2 * (w_gu.shape[0] * w_gu.shape[1]
                                + w_down.shape[0] * w_down.shape[1]),
                           "int8")[0]
    elif name == "attention_fused":
        wqkv, wo, kc = a[1], a[2], a[3]
        hq, d = kw["n_heads"], kw["head_dim"]
        n = length() + 1
        kv = 2 * kc.shape[2] * n * d * kc.element_size()
        ms = spec.bound_ms(wqkv.nbytes + wo.nbytes + kv,
                           2 * (wqkv.shape[0] * wqkv.shape[1]
                                + wo.shape[0] * wo.shape[1])
                           + 4 * hq * n * d, "int8")[0]
    elif name == "flash_decode":
        q, k = a[0], a[1]
        B, hq, d = q.shape
        n = length() + 1
        ms = spec.bound_ms(2 * B * k.shape[1] * n * d * k.element_size()
                           + 4 * q.numel(), 4 * B * hq * n * d, "bf16")[0]
    elif name == "flash_attention":
        q, k = a[0], a[1]
        B, hq, t, d = q.shape
        sk = k.shape[2]
        frac = 0.5 if kw.get("causal") and t == sk else 1.0
        ms = spec.bound_ms(2 * (2 * q.numel() + 2 * k.numel()),
                           4 * B * hq * t * sk * d * frac, "bf16")[0]
    elif name in ("_write_kv", "_append_kv"):
        # the fresh K and V read, written into the cache in its dtype
        cache, kt, vt = a[0], a[2], a[3]
        n = kt.numel() + vt.numel()
        ms = spec.bound_ms(n * (kt.element_size()
                                + cache.k.element_size()), 0, "bf16")[0]
    else:               # rms_norm, rope, rope_pack_prefill: x in, x out
        x = a[0]
        ms = spec.bound_ms(2 * x.numel() * x.element_size()
                           + a[1].numel() * a[1].element_size(), 0,
                           "bf16")[0]
    return 1e3 * ms


ANNOTATED = ("apply_linear", "mlp_fused", "attention_fused", "flash_decode",
             "flash_attention", "rope_pack_prefill", "rms_norm", "rope",
             "_write_kv", "_append_kv")


@contextlib.contextmanager
def annotated(spec, length=lambda: 0):
    """The model's ops (``ANNOTATED``, as ``models/llama.py`` calls them)
    wrapped in a ``torch.profiler.record_function`` named by the call's
    bound and the op ("bound_us=<us> <op>"): on the device's timeline the
    range spans the kernels the call launched."""
    from torch.profiler import record_function
    from ggml_cuda_experiments_tpu_torch.models import llama
    saved = {n: getattr(llama, n) for n in ANNOTATED}

    def wrap(name, fn):
        def call(*a, **kw):
            us = _call_bound_us(spec, name, a, kw, length)
            with record_function(f"{BOUND_TAG}{us:.6f} {name}"):
                return fn(*a, **kw)
        return call

    try:
        for n, fn in saved.items():
            setattr(llama, n, wrap(n, fn))
        yield
    finally:
        for n, fn in saved.items():
            setattr(llama, n, fn)


def _span(e) -> tuple[float, float]:
    return e.time_range.start, e.time_range.end


def attribute(prof, per: int) -> tuple[list, list]:
    """The profile's device time a ``per`` (steps, prefills) by kernel and
    by op. Each annotated range (``annotated``) takes the kernels inside
    it: its op's row gets their time and launches and the call's bound,
    and the longest of them carries that bound in the kernel table (the
    others inside none). Kernels outside every range make the op row
    "not annotated" (PyTorch's glue between the ops), with no bound. The
    ranges themselves, CUDA rows of ``key_averages()``, are no kernels."""
    import bisect
    dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    ranges = sorted((e for e in dev if e.name.startswith(BOUND_TAG)),
                    key=lambda e: _span(e)[0])
    kernels = sorted((e for e in dev if not e.name.startswith(BOUND_TAG)),
                     key=lambda e: _span(e)[0])
    starts = [_span(k)[0] for k in kernels]
    kbound, ops, claimed = {}, {}, set()
    for r in ranges:
        a, b = _span(r)
        us, op = r.name[len(BOUND_TAG):].split(" ", 1)
        inside = []
        for i in range(bisect.bisect_left(starts, a), len(kernels)):
            if starts[i] > b:
                break
            if _span(kernels[i])[1] <= b and i not in claimed:
                inside.append(i)
        row = ops.setdefault(op, {"op": op, "device_us": 0.0,
                                  "launches": 0, "calls": 0,
                                  "bound_us": 0.0})
        row["calls"] += 1
        row["bound_us"] += float(us)
        if not inside:
            continue
        claimed.update(inside)
        row["device_us"] += sum(_span(kernels[i])[1] - _span(kernels[i])[0]
                                for i in inside)
        row["launches"] += len(inside)
        top = max(inside, key=lambda i: _span(kernels[i])[1]
                  - _span(kernels[i])[0])
        kbound[kernels[top].name] = kbound.get(kernels[top].name, 0.0) \
            + float(us)
    rest = [kernels[i] for i in range(len(kernels)) if i not in claimed]
    ops["not annotated"] = {
        "op": "not annotated", "calls": 0, "bound_us": None,
        "device_us": sum(_span(k)[1] - _span(k)[0] for k in rest),
        "launches": len(rest)}
    op_rows = []
    for row in ops.values():
        row = dict(row, device_us=row["device_us"] / per,
                   launches=row["launches"] / per, calls=row["calls"] / per)
        if row["bound_us"] is not None:
            row["bound_us"] /= per
        op_rows.append(row)
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or _dev_us(e) <= 0 \
                or e.key.startswith(BOUND_TAG):
            continue
        b = kbound.get(e.key)
        rows.append({"kernel": e.key, "device_us": _dev_us(e) / per,
                     "launches": e.count / per,
                     "bound_us": None if b is None else b / per})
    return (sorted(rows, key=lambda r: -r["device_us"]),
            sorted(op_rows, key=lambda r: -r["device_us"]))


def _log_ops(ops, unit: str) -> None:
    for r in ops:
        b = "       -" if r["bound_us"] is None else f"{r['bound_us']:8.1f}"
        log(f"    {r['device_us']:9.1f} us {r['launches']:6.1f} launches "
            f"{r['calls']:5.1f} calls bound {b} us/{unit}  {r['op']}")


def _log_table(rows, unit: str, n: int = 14) -> None:
    for r in rows[:n]:
        b = "       -" if r["bound_us"] is None else f"{r['bound_us']:8.1f}"
        log(f"    {r['device_us']:9.1f} us {r['launches']:6.1f} launches "
            f"bound {b} us/{unit}  {r['kernel'][:64]}")


def _profile(fn, spec, length=lambda: 0):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with annotated(spec, length), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


@torch.no_grad()
def step_profile(params, cfg, dev, B: int, cache: int,
                 trace: str | None = None) -> dict:
    """``torch.profiler`` over ``PROFILED_STEPS`` eager steps: the kernel
    table a step, device busy a step, and the host gaps beside the eager
    step (CUDA events, unprofiled)."""
    spec = _spec_or_h100(False)
    step, state = _greedy_step(params, cfg, dev, B, cache)
    for _ in range(2):
        step()
    # the same steps unprofiled, for the eager time they take
    saved = [t.clone() for t in state]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(PROFILED_STEPS):
        step()
    torch.cuda.synchronize(dev)
    eager_us = 1e6 * (time.perf_counter() - t0) / PROFILED_STEPS
    for t, s in zip(state, saved):
        t.copy_(s)
    length = [PROMPT + 2]                   # the cache before each step

    def run():
        for _ in range(PROFILED_STEPS):
            step()
            length[0] += 1

    prof, wall = _profile(run, spec, lambda: length[0])
    rows, ops = attribute(prof, PROFILED_STEPS)
    busy = sum(r["device_us"] for r in rows)
    log(f"  {PROFILED_STEPS} eager steps under torch.profiler: device busy "
        f"{busy:.1f} us a step, {sum(r['launches'] for r in rows):.0f} "
        f"launches a step; the step {eager_us:.1f} us eager (unprofiled), "
        f"so host gaps {eager_us - busy:.1f} us a step "
        f"({100 * busy / eager_us:.1f}% busy); profiled wall "
        f"{1e6 * wall / PROFILED_STEPS:.1f} us a step")
    log("  by op (each call's kernels, its bound):")
    _log_ops(ops, "step")
    log("  by kernel:")
    _log_table(rows, "step")
    if trace:
        os.makedirs(trace, exist_ok=True)
        path = os.path.join(trace, f"decode_b{B}_trace.json")
        prof.export_chrome_trace(path)
        log(f"  trace written to {path}")
    return {"busy_us": busy, "eager_us": eager_us,
            "host_gap_us": eager_us - busy, "kernels": rows, "ops": ops}


# -- the prefill marginal ---------------------------------------------------

@torch.no_grad()
def prefill_variant(params, cfg, tokens, cache, n_layers: int, mode: str):
    """``prefill_marginal.py``'s prefill: the first ``n_layers`` layers in
    ``mode``, then the final norm, the head and the argmax."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops.prefill_fuse import rope_tables
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device).expand(B, T)
    h = params["embed"][tokens]
    tables = None
    if mode in ("full", "attn") and T % 128 == 0 and cfg.head_dim == 128:
        tables = rope_tables(positions[0], cfg.head_dim, cfg.rope_theta)
    s1 = cfg.n_heads * cfg.head_dim
    for li in range(n_layers):
        layer = params["layers"][li]
        if mode in ("full", "attn"):
            attn, _ = llama._attention_block(layer, cfg, h, cache, li,
                                             positions, decode=False,
                                             tables=tables)
            h = h + attn
        elif mode == "attn_mat":
            x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
            y = llama.apply_linear(x, layer["wqkv"], cfg.x_quant8)
            o = y[..., :s1] + 1e-6 * y[..., s1:].sum()
            h = h + llama.apply_linear(o, layer["wo"], cfg.x_quant8)
        if mode in ("full", "mlp"):
            h = h + llama._mlp_block(layer, cfg, h)
        elif mode == "mlp_mat":
            x = llama.rms_norm(h, layer["mlp_norm"], cfg.rms_eps)
            y = llama.apply_linear(x, layer["w_gu"], cfg.x_quant8)
            kd = y.shape[-1] // 2
            h = h + llama.apply_linear(y[..., kd:] + 1e-6 * y[..., :kd],
                                       layer["w_down"], cfg.x_quant8)
    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = llama.apply_linear(h[:, -1], params["lm_head"], cfg.x_quant8)
    return torch.argmax(logits, -1)


def _wall(fn, reps: int, dev) -> float:
    """The least of ``reps`` host-clock seconds of ``fn()`` between device
    syncs, after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best


@torch.no_grad()
def prefill_marginal(params, cfg, dev, T: int, reps: int = 3,
                     trace: str | None = None) -> dict:
    """TTFT by part at T tokens (see the module docstring)."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    spec = _spec_or_h100(False)
    L = cfg.n_layers
    half = L // 2
    cache = llama.KVCache.create(cfg, 1, max(1024, llama._round_up(T, 256)),
                                 device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (1, T), generator=torch.
                           Generator().manual_seed(5)).to(dev)
    wbytes = params["layers"][0]["wqkv"].nbytes / (
        params["layers"][0]["wqkv"].shape[0]
        * params["layers"][0]["wqkv"].shape[1])
    log(f"== profile_decode --prefill {T}: {cfg.name}, {L} layers, layer "
        f"marginal over {half} -> {L} layers, the least of {reps} runs")
    t0 = _wall(lambda: prefill_variant(params, cfg, tokens, cache, 0,
                                       "full"), reps, dev)
    head = params["lm_head"]
    ms0, by0 = spec.bound_ms(head.nbytes + 2 * T * cfg.dim,
                             2 * head.shape[0] * head.shape[1], "bf16")
    rows = []
    _row(rows, "non-layer (0-layer prefill)", 1e6 * t0, ms0, by0)
    out = {"T": T, "layers": L, "non_layer_ms": 1e3 * t0, "modes": {}}
    for mode in MODES:
        # the full layer also at a quarter and three quarters of the depth:
        # whether the time grows linearly with the layers
        depths = (L // 4, half, 3 * L // 4, L) if mode == "full" else \
            (half, L)
        t = {n: _wall(lambda n=n: prefill_variant(params, cfg, tokens, cache,
                                                  n, mode), reps, dev)
             for n in depths}
        per = (t[L] - t[half]) / (L - half)
        w, ops = prefill_flops(cfg, T, mode)
        ms, by = spec.bound_ms(w * wbytes, ops, "bf16")
        _row(rows, f"{mode} layer (marginal)", 1e6 * per, ms, by, L)
        out["modes"][mode] = {"t_half_ms": 1e3 * t[half],
                              "t_full_ms": 1e3 * t[L],
                              "per_layer_ms": 1e3 * per,
                              "bound_ms": ms, "bound_by": by}
        if mode == "full":
            fixed = t[L] - per * L
            log(f"  full: {L} layers {1e3 * t[L]:.2f} ms = {L} x "
                f"{1e3 * per:.3f} ms + fixed {1e3 * fixed:.2f} ms; by depth "
                + ", ".join(f"{n}: {1e3 * v:.2f}" for n, v in
                            sorted({0: t0, **t}.items())) + " ms")
            out["fixed_ms"] = 1e3 * fixed
            out["full_by_depth_ms"] = {n: 1e3 * v for n, v in t.items()}
    real = _wall(lambda: llama.prefill(params, cfg, tokens, cache), reps, dev)
    # the host's share: the time until prefill() returns, its launches
    # queued (the least of reps), against the wall until the device is done
    enqueue = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        llama.prefill(params, cfg, tokens, cache)
        enqueue = min(enqueue, time.perf_counter() - t1)
        torch.cuda.synchronize(dev)
    cache.lengths.zero_()
    prof, wall = _profile(lambda: llama.prefill(params, cfg, tokens, cache),
                          spec)
    cache.lengths.zero_()
    kernels, ops = attribute(prof, 1)
    busy = sum(r["device_us"] for r in kernels)
    log(f"  llama.prefill of {T} tokens (TTFT's prefill): {1e3 * real:.2f} "
        f"ms on the host clock, {1e3 * enqueue:.2f} ms of them until its "
        f"launches were queued; under torch.profiler device busy "
        f"{busy / 1e3:.2f} ms, {sum(r['launches'] for r in kernels):.0f} "
        f"launches, so host gaps {1e3 * real - busy / 1e3:.2f} ms "
        f"(profiled wall {1e3 * wall:.2f} ms)")
    log("  by op (each call's kernels, its bound):")
    _log_ops(ops, "prefill")
    log("  by kernel:")
    _log_table(kernels, "prefill")
    if trace:
        os.makedirs(trace, exist_ok=True)
        path = os.path.join(trace, f"prefill_{T}_trace.json")
        prof.export_chrome_trace(path)
        log(f"  trace written to {path}")
    out.update(rows=rows, prefill_ms=1e3 * real, busy_ms=busy / 1e3,
               enqueue_ms=1e3 * enqueue,
               host_gap_ms=1e3 * real - busy / 1e3, kernels=kernels,
               ops=ops)
    return out


def main(argv=None) -> int:
    args = parse(argv)
    if args.cpu:
        return plan(args)
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = require_cuda()
    log(card_line())
    cfg = config(args.model)
    params = build_params(cfg, args.fmt, args.seed, dev)
    if args.prefill:
        out = prefill_marginal(params, cfg, dev, args.prefill, args.reps,
                               args.trace)
    else:
        out = decode_components(params, cfg, dev, args.batch, args.cache)
        if args.trace:
            step_profile(params, cfg, dev, args.batch, args.cache,
                         args.trace)
    print(json.dumps({"profile_decode": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
