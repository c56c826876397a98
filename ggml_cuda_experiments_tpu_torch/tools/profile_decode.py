"""A decode step's and a prefill's time by component, each beside its bound:
the port's counterpart of the JAX package's ``tools/profile_decode.py``
(with its flags and its configuration, ``x_quant8``) and, under
``--prefill T``, of its ``tools/prefill_marginal.py``.

    python -m ggml_cuda_experiments_tpu_torch.tools.profile_decode \\
        [--model tinyllama-1.1b] [--fmt q4_k] [--cache 1024] [--batch 1]
        [--trace DIR]
    python -m ggml_cuda_experiments_tpu_torch.tools.profile_decode \\
        --model llama2-7b --prefill 512 [--reps 3]
    python -m ggml_cuda_experiments_tpu_torch.tools.profile_decode \\
        --model llama2-7b {--ladder | --layer-marginal [--ablate] |
        --nonlayer [--head-fmt q6_k] | --blocks | --embed T | --pipe |
        --enc s6 | --host} [--ckpt PATH]
    python -m ggml_cuda_experiments_tpu_torch.tools.profile_decode --cpu \\
        [--batch 8] [--prefill 512] [--ladder ...]

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

**Probe modes**, one at a time (each excludes the others and
``--prefill``), the counterparts of the JAX package's probe tools:

- ``--ladder`` (``decode_ladder.py``): batch-``--batch`` decode tok/s with
  each gate toggled, on one set of weights: unfused, + fused MLP, + fused
  attention, both, and the layer kernel (``hperm`` + ``fuse_layer``,
  bench.py's ``model_step``; the port's ``permute_hidden_params`` only
  attaches the model pack, so the JAX tool's ``--hperm`` rungs are this
  one). Each rung is a ``greedy_scan_step`` captured as a graph, the
  marginal of 8 and 40 replays, the least of 3 captures (a capture's
  graph replays in one of two modes, ~0.35 µs a node apart:
  ``graph_step_us``).
- ``--layer-marginal [--ablate]`` (``layer_marginal.py``): the decode
  layer marginal t(L) - t(L / 2) over distinct-weight layers
  (``spec_bench.truncated``), each a graph step of ``decode_variant`` in a
  mode: ``full``, ``attn``, ``mlp``; with ``--ablate`` also ``attn_mat``
  (the wqkv and wo products alone), ``attn_nofd`` (+ RoPE and the cache
  write, no flash_decode) and ``mlp_mat`` (the w_gu and w_down products);
  the non-layer base from the full mode.
- ``--nonlayer [--head-fmt q6_k]`` (``nonlayer_probe.py``): a 0-layer step
  in cumulative stages (scan, + embed, + final norm, + head, + argmax),
  each forced by data dependence on the next token (``stage_step``), each
  a graph-replay marginal; each stage's delta beside the head's stream
  bound; ``--head-fmt``: the head re-quantized to that format too.
- ``--blocks`` (``mlp_block_probe.py``, ``fused_attn_probe.py``): per call,
  ``fused_mlp`` at ``--dim`` / ``--inter`` against its unfused chain (w_gu
  linear, SiLU x up, w_down linear), and ``fused_attention`` at ``--len``
  / ``--S`` (MHA 32 x 128) against wqkv, RoPE, cache append,
  flash_decode, wo. The JAX tools chain one weight; here
  ``chain_marginal`` cycles through weight copies that stream past the
  L2, as every timer of the port does.
- ``--embed T`` (``embed_probe.py``): the embed lookup of T tokens four
  ways: indexing, ``index_select``, a one-hot bf16 product, and a per-row
  loop of one-row copies captured in a graph (the JAX tool's ``dus``).
  Timed for comparison only: the model indexes.
- ``--pipe`` (``pipe_probe.py``): the tc route of ``q4k_gemm`` at ``--t``
  tokens in each phase (``GEMM_PHASES``: all, dequant, dot, stream, and
  all again as a drift bracket) and ``torch.matmul`` on the dequantized
  bf16 weight (the JAX tool's ``xla`` rung), by size-marginal pairs (K
  4096 at 8192 -> 24576 rows, K 12288 at 4096 -> 12288 rows, the pair's
  extra time scaled to the big shape), each against the bf16 bound. The
  JAX tool's ``PIPE_MODE`` "sub" / "slots" is Mosaic's scheduling and has
  no counterpart here.
- ``--enc s6`` (``probe_s6.py``): the decode components and the graph step
  of the s6 model, each beside the same dense weights in Q4_K-E; then the
  int8 matvec's size-marginal rung (K 4096, 8192 -> 32768 rows) in e, s6
  and e again (a drift bracket). The JAX tool's decode variants (cast,
  constdd, eyedot) are Mosaic's; the port has one s6 decode.
- ``--host`` (``rig_probe.py``): the host's cost of a tiny upload (synced
  and not), a launch on a resident tensor and with a host argument, a
  launch and a fetch, and chains of 1 and 16 launches and a fetch.

Weights (every mode but ``--blocks``, ``--embed``, ``--pipe`` and
``--host``, which draw their own operands) come from ``--seed`` through a
GCTC file (``cached_params``): ``--ckpt PATH``, by default ``ckpt_path``'s
file under ``build/ckpt/``, keyed by model, format, encoding, seed and the
port's logical layout; loaded where it exists, else built on the card and
saved.

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
import statistics
import sys
import time
from pathlib import Path

import torch

LINEARS = ("wqkv", "wo", "w_gu", "w_down")
# the block ablations: the prefill marginal's, and the decode marginal's
# with --ablate (attn_nofd is decode's alone)
MODES = ("full", "attn", "mlp", "attn_mat", "mlp_mat")
DECODE_MODES = ("full", "attn", "mlp")
ABLATIONS = ("attn_mat", "attn_nofd", "mlp_mat")
# the probe modes (their flags' dests), exclusive of one another and of
# --prefill
PROBES = ("ladder", "layer_marginal", "nonlayer", "blocks", "embed", "pipe",
          "enc", "host")
LADDER = (("unfused", dict(fuse_attn=False, fuse_mlp=False)),
          ("+ fused MLP", dict(fuse_attn=False, fuse_mlp=True)),
          ("+ fused attention", dict(fuse_attn=True, fuse_mlp=False)),
          ("both", dict(fuse_attn=True, fuse_mlp=True)),
          ("layer kernel (hperm + fuse_layer)",
           dict(fuse_attn=True, fuse_mlp=True, hperm=True, fuse_layer=True)))
STAGES = ("scan", "embed", "norm", "head", "argmax")
PIPE_SHAPES = ((4096, 8192, 24576), (12288, 4096, 12288))   # K, N small, big
PIPE_RUNGS = ("all", "dequant", "dot", "stream", "all", "torch.matmul")
S6_PAIR = (4096, 8192, 32768)                           # K, N small, big
PAIR_INNER = 20                 # calls a chain of a size-marginal pair
ATTN_HEADS, ATTN_D = 32, 128    # --blocks' attention (MHA, the 7B's)
# --host's rows and the device bytes of each (an int32 [8] in and out)
HOST_ROWS = (("upload [8] int32, synced", 32),
             ("upload [8] int32, not synced", 32),
             ("launch x + 1 on a resident x", 64),
             ("launch x + 1 on an uploaded host x", 96),
             ("launch + fetch", 96),
             ("chain of 1 launch + fetch", 96),
             ("chain of 16 launches + fetch", 16 * 64 + 32),
             ("each extra launch of the chain", 64))
PROMPT = 16                     # bench.py's decode prompt (ones)
CHAIN = (8, 40)                 # calls of the two chains of a marginal
CAPTURES = 3                    # captures of a probe mode's graph step
PROFILED_STEPS = 4
# bytes a weight of each format in the port's containers (ops/quant_matmul)
# (q4_k's s6 encoding under its GCTC token)
BYTES_PER_WEIGHT = {"q4_k": 0.625, "q4_0": 0.5625, "q8_0": 1.0625,
                    "q6_k": 0.875, "q4_k~s6": 0.578125}
BOUND_TAG = "bound_us="          # the annotation that carries a call's bound


def log(*a):
    print(*a, flush=True)


def parse(argv):
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
        FORMATS, STREAM_MAX_M)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tinyllama-1.1b")
    ap.add_argument("--fmt", default="q4_k", choices=sorted(FORMATS))
    ap.add_argument("--cache", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prefill", type=int, default=0, metavar="T",
                    help="the prefill marginal at T tokens instead")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", metavar="PATH", default=None,
                    help="the GCTC weight cache (default: a file under "
                    "build/ckpt/ keyed by model, format, encoding, seed); "
                    "--enc s6: the s6 model's (the e model's keyed)")
    ap.add_argument("--trace", metavar="DIR", default=None)
    ap.add_argument("--cpu", action="store_true")
    probes = ap.add_argument_group("probe modes (one at a time)")
    probes.add_argument("--ladder", action="store_true",
                        help="decode tok/s with each fused gate toggled")
    probes.add_argument("--layer-marginal", action="store_true",
                        help="the decode layer marginal by block")
    probes.add_argument("--ablate", action="store_true",
                        help="--layer-marginal: also attn_mat, attn_nofd, "
                        "mlp_mat")
    probes.add_argument("--nonlayer", action="store_true",
                        help="the 0-layer decode step in stages")
    probes.add_argument("--head-fmt", default=None, choices=sorted(FORMATS),
                        help="--nonlayer: the head in this format too")
    probes.add_argument("--blocks", action="store_true",
                        help="the fused MLP and attention against their "
                        "unfused chains")
    probes.add_argument("--dim", type=int, default=4096)
    probes.add_argument("--inter", type=int, default=12288)
    probes.add_argument("--len", type=int, default=40)
    probes.add_argument("--S", type=int, default=1024)
    probes.add_argument("--embed", type=int, default=0, metavar="T",
                        help="the embed lookup of T tokens four ways")
    probes.add_argument("--pipe", action="store_true",
                        help="the tc GEMM's phases by size-marginal pairs")
    probes.add_argument("--t", type=int, default=512,
                        help="--pipe: tokens")
    probes.add_argument("--pairs", type=int, default=5,
                        help="--pipe, --enc s6: size-marginal pairs")
    probes.add_argument("--enc", default="e", choices=("e", "s6"),
                        help="s6: the s6 model's decode beside Q4_K-E's")
    probes.add_argument("--host", action="store_true",
                        help="the host's cost of launches, uploads, "
                        "fetches")
    probes.add_argument("--n", type=int, default=30,
                        help="--host: calls a row")
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
    on = [m for m in PROBES if (args.enc == "s6" if m == "enc"
                                else getattr(args, m))]
    if len(on) + bool(args.prefill) > 1:
        ap.error("one of --prefill and the probe modes at a time, got "
                 + ", ".join(["--prefill"] * bool(args.prefill)
                             + [f"--{m.replace('_', '-')}" for m in on]))
    args.mode = on[0] if on else None
    if args.ablate and args.mode != "layer_marginal":
        ap.error("--ablate goes with --layer-marginal")
    if args.head_fmt and args.mode != "nonlayer":
        ap.error("--head-fmt goes with --nonlayer")
    if args.mode in ("blocks", "pipe", "enc") and args.fmt != "q4_k":
        ap.error(f"--{args.mode}: q4_k's kernels only (--fmt q4_k)")
    if args.batch != 1 and args.mode in ("layer_marginal", "nonlayer",
                                         "blocks"):
        ap.error(f"--{args.mode.replace('_', '-')}: batch 1")
    if args.mode == "layer_marginal" and PRESETS[args.model].n_layers < 2:
        ap.error("--layer-marginal: at least 2 layers")
    if args.embed < 0 or args.pairs < 1 or args.n < 1:
        ap.error("--embed, --pairs, --n: positive")
    if args.t <= STREAM_MAX_M:
        ap.error(f"--t: more than {STREAM_MAX_M} tokens (the tc route)")
    if not (1 <= args.len < args.S and args.S % 64 == 0
            and args.dim % 4096 == 0 and args.inter % 4096 == 0):
        ap.error("--len in [1, --S), --S a multiple of 64, --dim and "
                 "--inter multiples of 4096 (the fused gates)")
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


def _bpw(w) -> float:
    """Bytes a weight of the stored ``w``."""
    return w.nbytes / (w.shape[0] * w.shape[1])


def step_bound_ms(spec, cfg, bpw: float, head_bpw: float, batch: int,
                  length: int) -> float:
    """The least ms of one decode step at ``bpw`` bytes a layer weight and
    ``head_bpw`` a head weight: every linear's and the head's bound
    (``linear_bound``) and each layer's attention over ``length`` keys."""
    xq8, L = cfg.x_quant8, cfg.n_layers
    kind = "int8" if batch == 1 and xq8 else "bf16"
    ms = sum(L * linear_bound(spec, n, k, n * k * bpw, batch, kind)[0]
             for _, n, k in linear_shapes(cfg))
    ms += linear_bound(spec, cfg.vocab_size, cfg.dim,
                       cfg.vocab_size * cfg.dim * head_bpw, batch, kind)[0]
    return ms + L * attention_bound(spec, cfg, batch, length)[0]


def layer_bound(spec, cfg, bpw: float, mode: str, length: int
                ) -> tuple[float, str]:
    """The least time of one batch-1 decode layer in ``mode`` (``MODES``,
    ``ABLATIONS``): its linears' weights and int8 operations, and for
    ``full`` / ``attn`` the attention over ``length`` keys (its bytes and
    bf16 operations beside them)."""
    names = {"full": LINEARS, "mlp": ("w_gu", "w_down"),
             "mlp_mat": ("w_gu", "w_down")}.get(mode, ("wqkv", "wo"))
    nk = sum(n * k for name, n, k in linear_shapes(cfg) if name in names)
    t_bytes = nk * bpw / spec.hbm_bytes_per_s
    t_ops = 2 * nk / spec.peak("int8" if cfg.x_quant8 else "bf16")
    if mode in ("full", "attn"):
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        t_bytes += (4 * hkv * length * d + 4 * hq * d) / spec.hbm_bytes_per_s
        t_ops += 4 * hq * length * d / spec.peak("bf16")
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def head_bound(spec, cfg, nbytes: float, fmt: str) -> tuple[float, str]:
    """The batch-1 head's bound (the non-layer stream): ``nbytes`` of a
    ``fmt`` weight."""
    return linear_bound(spec, cfg.vocab_size, cfg.dim, nbytes, 1,
                        kind_of(1, fmt, cfg.x_quant8))


def mlp_block_bound(spec, dim: int, inter: int, bpw: float
                    ) -> tuple[float, str]:
    """The batch-1 MLP block (w_gu [2 inter, dim], w_down [dim, inter]):
    its weights and x / y once, int8 operations."""
    nk = 3 * inter * dim
    return spec.bound_ms(nk * bpw + 4 * 2 * dim, 2 * nk, "int8")


def attn_block_bound(spec, dim: int, length: int, bpw: float
                     ) -> tuple[float, str]:
    """The batch-1 MHA attention block of ``--blocks`` (ATTN_HEADS x
    ATTN_D): wqkv and wo, the ``length`` + 1 bf16 keys and values, x / o;
    int8 operations of the products (the attention's are 2 orders fewer)."""
    nk = 4 * dim * dim
    kv = 2 * 2 * ATTN_HEADS * (length + 1) * ATTN_D
    return spec.bound_ms(nk * bpw + kv + 4 * 2 * dim,
                         2 * nk + 4 * ATTN_HEADS * (length + 1) * ATTN_D,
                         "int8")


def embed_bound(spec, T: int, dim: int) -> tuple[float, str]:
    """T bf16 rows read and written once."""
    return spec.bound_ms(2 * 2 * T * dim, 0, "bf16")


def pipe_bound(spec, T: int, n: int, k: int) -> tuple[float, str]:
    """y [T, N] f32 = x [T, K] bf16 . W^T (q4_k): W and x read once, y
    written once, 2 T N K bf16 operations."""
    return spec.bound_ms(n * k * BYTES_PER_WEIGHT["q4_k"] + 2 * T * k
                         + 4 * T * n, 2 * T * n * k, "bf16")


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
    if args.mode:
        return PLANS[args.mode](args, cfg, spec, bpw)
    path = ("fused attention + fused MLP a layer" if B == 1
            else "every linear on the GEMM stream route")
    print(f"{args.model} {args.fmt} x_quant8, batch {B}, {L} layers, cache "
          f"{args.cache}: {path}")
    for name, n, k in linear_shapes(cfg):
        ms, by = linear_bound(spec, n, k, n * k * bpw, B, kind)
        print(f"  linear {name:6s} [{n:6d} x {k:6d}] x1 a layer: bound "
              f"{1e3 * ms:8.2f} us ({by}, {kind})")
    ms, by = linear_bound(spec, cfg.vocab_size, cfg.dim,
                          cfg.vocab_size * cfg.dim * bpw, B, kind)
    print(f"  head [{cfg.vocab_size} x {cfg.dim}] x1 a step: bound "
          f"{1e3 * ms:8.2f} us ({by})")
    for length in (64, args.cache):
        ms, by = attention_bound(spec, cfg, B, length)
        print(f"  flash_decode at length {length}: bound {1e3 * ms:8.2f} us"
              f" a layer ({by})")
    print(f"  step (the components' bounds, attention at 64): "
          f"{step_bound_ms(spec, cfg, bpw, bpw, B, 64):.3f} ms; chains of "
          f"{CHAIN[0]} and {CHAIN[1]} calls, a profiler table of "
          f"{PROFILED_STEPS} eager steps")
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


def _plan_row(name: str, bound: tuple[float, str], unit: str = "") -> None:
    print(f"  {name:44s} bound {1e3 * bound[0]:11.4f} us ({bound[1]}){unit}")


def plan_ladder(args, cfg, spec, bpw) -> int:
    B, L = args.batch, cfg.n_layers
    ms = step_bound_ms(spec, cfg, bpw, bpw, B, PROMPT + sum(CHAIN) // 2)
    print(f"--ladder: {args.model} {args.fmt} x_quant8, batch {B}, {L} "
          f"layers, cache {args.cache}; each rung a greedy_scan_step graph, "
          f"the marginal of {CHAIN[0]} and {CHAIN[1]} replays")
    for name, kw in LADDER:
        gates = ", ".join(f"{k}={v}" for k, v in kw.items())
        _plan_row(f"{name} ({gates})", (ms, "bytes"), " a step")
    return 0


def plan_layer_marginal(args, cfg, spec, bpw) -> int:
    L = cfg.n_layers
    modes = DECODE_MODES + (ABLATIONS if args.ablate else ())
    print(f"--layer-marginal: {args.model} {args.fmt} x_quant8, batch 1, "
          f"cache {args.cache}: t({L}) - t({L // 2}) over distinct-weight "
          f"layers, each a graph step of decode_variant ({CHAIN[0]} and "
          f"{CHAIN[1]} replays from an empty cache)")
    for mode in modes:
        _plan_row(f"{mode} layer", layer_bound(spec, cfg, bpw, mode,
                                               sum(CHAIN) // 2), " a layer")
    _plan_row("non-layer (the head)", head_bound(
        spec, cfg, cfg.vocab_size * cfg.dim * bpw, args.fmt))
    return 0


def plan_nonlayer(args, cfg, spec, bpw) -> int:
    print(f"--nonlayer: {args.model} {args.fmt} x_quant8, a 0-layer step "
          f"in cumulative stages, each forced by the next token, each a "
          f"graph marginal of {CHAIN[0]} and {CHAIN[1]} replays")
    v, d = cfg.vocab_size, cfg.dim
    for stage in STAGES:
        fmts = [args.fmt] + ([args.head_fmt] if args.head_fmt
                             and stage in ("head", "argmax") else [])
        for fmt in fmts:
            if stage in ("head", "argmax"):
                b = head_bound(spec, cfg, v * d * BYTES_PER_WEIGHT[fmt], fmt)
            else:
                b = spec.bound_ms(0 if stage == "scan" else 4 * d, 0, "bf16")
            _plan_row(f"{stage}" + (f" [{fmt} head]" if fmt != args.fmt
                                    else ""), b, " a step")
    return 0


def plan_blocks(args, cfg, spec, bpw) -> int:
    print(f"--blocks: per call, weight copies past the L2; MLP dim "
          f"{args.dim}, intermediate {args.inter}; attention MHA "
          f"{ATTN_HEADS} x {ATTN_D} at length {args.len} of {args.S}")
    mlp = mlp_block_bound(spec, args.dim, args.inter, bpw)
    attn = attn_block_bound(spec, ATTN_HEADS * ATTN_D, args.len, bpw)
    for name in ("fused_mlp", "unfused MLP (w_gu, SiLU x up, w_down)"):
        _plan_row(name, mlp, " a call")
    for name in ("fused_attention", "unfused attention (wqkv, RoPE, "
                 "append, flash_decode, wo)"):
        _plan_row(name, attn, " a call")
    return 0


def plan_embed(args, cfg, spec, bpw) -> int:
    print(f"--embed {args.embed}: [{cfg.vocab_size} x {cfg.dim}] bf16, "
          "four ways, per call")
    for name in ("index", "index_select", "one-hot bf16 product",
                 "row copies (a graph)"):
        _plan_row(name, embed_bound(spec, args.embed, cfg.dim), " a call")
    return 0


def plan_pipe(args, cfg, spec, bpw) -> int:
    print(f"--pipe: q4k_gemm's tc route at T {args.t}, size-marginal pairs "
          f"({args.pairs}, {PAIR_INNER} calls a chain), the pair's extra "
          "time scaled to the big shape")
    for k, ns, nb in PIPE_SHAPES:
        for rung in PIPE_RUNGS:
            _plan_row(f"K {k}, {ns} -> {nb} rows: {rung}",
                      pipe_bound(spec, args.t, nb, k))
    return 0


def plan_s6(args, cfg, spec, bpw) -> int:
    B, L = args.batch, cfg.n_layers
    kind = kind_of(B, "q4_k", cfg.x_quant8)
    s6 = BYTES_PER_WEIGHT["q4_k~s6"]
    print(f"--enc s6: {args.model}, batch {B}, {L} layers: the decode "
          "components and the graph step in s6 beside Q4_K-E (s6 where K "
          "% 4096 == 0, else e)")
    for name, n, k in linear_shapes(cfg) + [("head", cfg.vocab_size,
                                             cfg.dim)]:
        for enc, b in (("e", bpw), ("s6", s6 if k % 4096 == 0 else bpw)):
            _plan_row(f"linear {name} [{n} x {k}] {enc}",
                      linear_bound(spec, n, k, n * k * b, B, kind))
    length = PROMPT + sum(CHAIN) // 2
    for enc, b in (("e", bpw), ("s6", s6)):
        _plan_row(f"step (one graph) {enc}", (step_bound_ms(
            spec, cfg, b, b, B, length), "bytes"))
    k, ns, nb = S6_PAIR
    for enc in ("e", "s6", "e"):
        b = bpw if enc == "e" else s6
        _plan_row(f"int8 matvec K {k}, {ns} -> {nb} rows {enc} (the extra "
                  "rows)", spec.bound_ms((nb - ns) * k * b, 0, "int8"))
    return 0


def plan_host(args, cfg, spec, bpw) -> int:
    print(f"--host: the host's us a call (host clock, the mean of "
          f"{args.n} calls after one); each row's device bound")
    for name, nbytes in HOST_ROWS:
        _plan_row(name, spec.bound_ms(nbytes, 0, "bf16"))
    return 0


PLANS = {"ladder": plan_ladder, "layer_marginal": plan_layer_marginal,
         "nonlayer": plan_nonlayer, "blocks": plan_blocks,
         "embed": plan_embed, "pipe": plan_pipe, "enc": plan_s6,
         "host": plan_host}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CKPT_DIR = Path(__file__).resolve().parents[2] / "build" / "ckpt"


def ckpt_path(model: str, fmt: str, enc: str = "e", seed: int = 0) -> Path:
    """The tools' default GCTC file of ``model``'s weights from ``seed`` in
    ``fmt`` (q4_k in ``enc``), in the port's logical layout, under the
    checkout's git-ignored ``build/ckpt/``. It is never the JAX tools'
    ``/tmp/bench_ckpt_{model}_{fmt}_v6.gctc``, whose quantized entries hold
    the TPU layout (the port's loader refuses them)."""
    return CKPT_DIR / f"{model}_{fmt}_{enc}_seed{seed}+logical.gctc"


def quantize_model(dense, fmt: str, enc: str = "e"):
    """``llama.quantize_params(dense, fmt)`` with every q4_k linear in
    ``enc``: quantize_params takes no encoding (as the reference's takes
    none), so for s6 its quantizer is called as ``quantize(w, fmt,
    enc="s6")`` (a K that is no multiple of 4096 stays "e")."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    if enc == "e":
        return llama.quantize_params(dense, fmt)
    import functools
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    saved = llama.quantize
    llama.quantize = functools.partial(qm.quantize, enc=enc)
    try:
        return llama.quantize_params(dense, fmt)
    finally:
        llama.quantize = saved


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def cached_params(cfg, fmt: str, seed: int, dev, enc: str = "e",
                  ckpt=None):
    """The tools' weights: ``init_weights(cfg, seed)`` quantized to
    ``fmt`` in ``enc`` (``quantize_model``) on ``dev``, through the GCTC
    file ``ckpt`` (``ckpt_path``'s when None): read by
    ``utils/loader.load_params`` where it exists, else built on ``dev`` and
    written by ``save_params`` (through a temporary file, so a reader never
    finds half of one). One line says which, and its seconds."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.utils import loader
    path = Path(ckpt) if ckpt else ckpt_path(cfg.name, fmt, enc, seed)
    what = f"{cfg.name} {fmt}{'' if enc == 'e' else ' ' + enc} weights"
    t0 = time.perf_counter()
    if path.exists():
        params = loader.load_params(path, device=dev)
        _sync(dev)
        log(f"{what} loaded from {path} in "
            f"{time.perf_counter() - t0:.1f} s")
        return params
    params = quantize_model(llama.init_weights(cfg, seed=seed, device=dev),
                            fmt, enc)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    _sync(dev)
    t1 = time.perf_counter()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        loader.save_params(tmp, params)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    log(f"{what} built from seed {seed} in {t1 - t0:.1f} s, saved to "
        f"{path} in {time.perf_counter() - t1:.1f} s")
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
    head = params["lm_head"]
    heads = _cycle([head], head.nbytes)
    x = torch.randn((B, cfg.dim), generator=g, device=dev).to(torch.bfloat16)
    us_head = _marginal_us(lambda i: llama.apply_linear(
        x, heads[i % len(heads)], xq8))
    ms, by = linear_bound(spec, *head.shape, head.nbytes, B,
                          kind_of(B, head.fmt, xq8))
    _row(rows, f"head [{head.shape[0]} x {head.shape[1]}]", us_head, ms, by)
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
    step_ms = step_bound_ms(spec, cfg, _bpw(layers[0]["wqkv"]), _bpw(head),
                            B, PROMPT + sum(CHAIN) // 2)
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


def _timed_runs(call, state, saved, dev) -> dict:
    """{n: (device s, host s to issue)} of ``n`` calls of ``call`` for each
    ``n`` of CHAIN, each run from ``saved`` (copied into ``state``) between
    CUDA events, the faster of two runs."""
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


def _per_call_us(t: dict, i: int = 0) -> float:
    """The marginal us a call of ``_timed_runs``' device (0) or host (1)
    seconds."""
    return 1e6 * (t[CHAIN[1]][i] - t[CHAIN[0]][i]) / (CHAIN[1] - CHAIN[0])


def graph_step_us(step, state, dev) -> float:
    """us of one replay of ``step`` captured as a CUDA graph
    (``llama.capture_graph``): the marginal of 8 and 40 replays, each run
    from the state as it was; the least over ``CAPTURES`` captures. The
    same step's graph replays in one of (at least) two modes, set at its
    capture and ~0.35 µs a node apart on an H100 (PERF.md §5): each
    capture's time is logged."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    saved = [t.clone() for t in state]
    times, notes = [], []
    for _ in range(CAPTURES):
        graph = llama.capture_graph(step, state)
        clocks = []
        with clock_samples(clocks):
            t = _timed_runs(graph.replay, state, saved, dev)
        del graph
        for x, s in zip(state, saved):
            x.copy_(s)
        times.append(_per_call_us(t))
        mhz = statistics.median(c for c, _ in clocks) if clocks else None
        notes.append(f"{times[-1]:.1f} (host {_per_call_us(t, 1):.1f} a "
                     f"replay, SM {mhz} MHz)")
    log(f"    captures (us): {', '.join(notes)}")
    return min(times)


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
    eager = _timed_runs(step, state, saved, dev)
    for t, s in zip(state, saved):
        t.copy_(s)
    graph = llama.capture_graph(step, state)
    clocks = []
    with clock_samples(clocks):
        replays = _timed_runs(graph.replay, state, saved, dev)
    out = {"eager_us": _per_call_us(eager),
           "eager_host_us": _per_call_us(eager, 1),
           "graph_us": _per_call_us(replays),
           "graph_host_us": _per_call_us(replays, 1),
           "clock_samples": len(clocks)}
    log(f"  the host issues an eager step in {out['eager_host_us']:.1f} us, a "
        f"replay in {out['graph_host_us']:.1f} us")
    if clocks:
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

def _ablated_layer(layer, cfg, h, cache, li, positions, mode: str,
                   decode: bool, tables=None):
    """One layer in ``mode``, the JAX tools' ablations (``MODES``,
    ``ABLATIONS``): ``full`` the real layer, ``attn`` / ``mlp`` its block
    alone; ``attn_mat`` the wqkv and wo products alone, o = q + 1e-6 sum(v)
    at decode (``layer_marginal.py``) and q + 1e-6 (sum(k) + sum(v)) at
    prefill (``prefill_marginal.py``), the sums keeping the dropped work's
    inputs alive; ``attn_nofd`` (decode) with RoPE and the cache write too,
    no flash_decode; ``mlp_mat`` the w_gu and w_down products, up + 1e-6
    gate in place of silu(gate) up."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    xq8 = cfg.x_quant8
    if mode in ("full", "attn"):
        attn, _ = llama._attention_block(layer, cfg, h, cache, li, positions,
                                         decode=decode, tables=tables)
        h = h + attn
    elif mode in ("attn_mat", "attn_nofd"):
        x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
        q, k, v = llama.qkv_proj(layer, x, cfg)
        rest = v.sum() if decode else k.sum() + v.sum()
        if mode == "attn_nofd":
            B, T, _ = h.shape
            hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            q = llama.rope(q.reshape(B, T, hq, d), positions,
                           cfg.rope_theta).reshape(B, T, hq * d)
            k = llama.rope(k.reshape(B, T, hkv, d), positions,
                           cfg.rope_theta)
            llama._write_kv(cache, li, k.transpose(1, 2),
                            v.reshape(B, T, hkv, d).transpose(1, 2),
                            positions[:, 0])
        h = h + llama.apply_linear((q + 1e-6 * rest).to(h.dtype),
                                   layer["wo"], xq8)
    if mode in ("full", "mlp"):
        h = h + llama._mlp_block(layer, cfg, h)
    elif mode == "mlp_mat":
        x = llama.rms_norm(h, layer["mlp_norm"], cfg.rms_eps)
        gate, up = llama.gate_up_proj(layer, x, xq8)
        h = h + llama.apply_linear(up + 1e-6 * gate, layer["w_down"], xq8)
    return h


def _ablated_forward(params, cfg, tokens, cache, positions, mode: str,
                     decode: bool):
    """Every layer of ``params`` in ``mode`` on tokens [B, T], then the
    final norm and the head on the last position: f32 logits [B, V]."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops.prefill_fuse import rope_tables
    h = params["embed"][tokens]
    tables = None
    if (not decode and mode in ("full", "attn") and tokens.shape[1] % 128 == 0
            and cfg.head_dim == 128):
        tables = rope_tables(positions[0], cfg.head_dim, cfg.rope_theta)
    for li, layer in enumerate(params["layers"]):
        h = _ablated_layer(layer, cfg, h, cache, li, positions, mode, decode,
                           tables)
    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    return llama.apply_linear(h[:, -1], params["lm_head"],
                              cfg.x_quant8).float()


@torch.no_grad()
def prefill_variant(params, cfg, tokens, cache, n_layers: int, mode: str):
    """``prefill_marginal.py``'s prefill: the first ``n_layers`` layers in
    ``mode``, then the final norm, the head and the argmax."""
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device).expand(B, T)
    cut = dict(params, layers=params["layers"][:n_layers])
    return torch.argmax(_ablated_forward(cut, cfg, tokens, cache, positions,
                                         mode, decode=False), -1)


@torch.no_grad()
def decode_variant(params, cfg, tok, cache, mode: str):
    """``layer_marginal.py``'s decode step: tokens [B], every layer of
    ``params`` in ``mode``, the final norm and the head; returns f32 logits
    [B, V] and advances the cache a position (in place). ``full`` is
    ``llama.decode_step`` (without the layer kernel: the tool's
    configuration has no ``hperm``)."""
    positions = cache.lengths[:, None].clone()
    logits = _ablated_forward(params, cfg, tok[:, None], cache, positions,
                              mode, decode=True)
    cache.lengths += 1
    return logits


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
    wbytes = _bpw(params["layers"][0]["wqkv"])
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


# -- the probe modes ---------------------------------------------------------

@torch.no_grad()
def ladder(params, cfg, dev, batch: int, cache: int) -> dict:
    """``decode_ladder.py``: each rung (``LADDER``) a ``greedy_scan_step``
    captured as a graph on the same weights, beside the step's bound and
    the kernels one eager step launches there (batch 1)."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.tools.bench import decode_path
    spec = _spec_or_h100(False)
    w = params["layers"][0]["wqkv"]
    bound = step_bound_ms(spec, cfg, _bpw(w), _bpw(params["lm_head"]), batch,
                          PROMPT + sum(CHAIN) // 2)
    log(f"== profile_decode --ladder: {cfg.name} batch {batch}, "
        f"{cfg.n_layers} layers, cache {cache}, x_quant8 {cfg.x_quant8}")
    rows = []
    for name, kw in LADDER:
        rcfg = dataclasses.replace(cfg, **kw)
        p = llama.permute_hidden_params(params, rcfg) if rcfg.hperm \
            else params
        path = decode_path(p, rcfg, dev) if batch == 1 else None
        step, state = _greedy_step(p, rcfg, dev, batch, cache)
        us = graph_step_us(step, state, dev)
        _row(rows, name, us, bound, "bytes", tok_s=batch * 1e6 / us,
             path=path)
        del step, state, p
        torch.cuda.empty_cache()
    return {"mode": "ladder", "batch": batch, "cache": cache, "rows": rows}


def _variant_us(params, cfg, dev, n: int, mode: str, cache: int) -> float:
    """us of one graph replay of ``decode_variant`` over the first ``n``
    layers in ``mode`` at batch 1, from token 0 and an empty cache."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.tools.spec_bench import truncated
    p, c = truncated(params, cfg, n)
    kv = llama.KVCache.create(c, 1, cache, device=dev)
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)

    def step():
        tok.copy_(torch.argmax(decode_variant(p, c, tok, kv, mode), -1))

    return graph_step_us(step, [tok, kv.lengths], dev)


@torch.no_grad()
def layer_marginal(params, cfg, dev, cache: int, ablate: bool) -> dict:
    """``layer_marginal.py``: per mode (``DECODE_MODES``, and
    ``ABLATIONS`` with ``ablate``) t(L) - t(L / 2) over the model cut to
    L / 2 and L layers (distinct weights, nothing cached), each a graph
    step of ``decode_variant``; the non-layer base t(L) - L x the full
    layer."""
    spec = _spec_or_h100(False)
    L, half = cfg.n_layers, cfg.n_layers // 2
    bpw = _bpw(params["layers"][0]["wqkv"])
    head = params["lm_head"]
    log(f"== profile_decode --layer-marginal: {cfg.name}, {half} -> {L} "
        f"layers, cache {cache}, x_quant8 {cfg.x_quant8}")
    rows, out = [], {"mode": "layer_marginal", "layers": L, "cache": cache,
                     "modes": {}}
    for mode in DECODE_MODES + (ABLATIONS if ablate else ()):
        t = {n: _variant_us(params, cfg, dev, n, mode, cache)
             for n in (half, L)}
        per = (t[L] - t[half]) / (L - half)
        ms, by = layer_bound(spec, cfg, bpw, mode, sum(CHAIN) // 2)
        _row(rows, f"{mode} layer (marginal)", per, ms, by, L)
        out["modes"][mode] = {"t_half_us": t[half], "t_full_us": t[L],
                              "per_layer_us": per, "bound_ms": ms,
                              "bound_by": by}
        if mode == "full":
            base = t[L] - per * L
            _row(rows, "non-layer (t(L) - L x the full layer)", base,
                 *head_bound(spec, cfg, head.nbytes, head.fmt))
            out["non_layer_us"] = base
            if base < 0:
                log(f"  t({L}) > 2 t({half}): the two graphs replay in "
                    "different modes (graph_step_us); the marginal is "
                    "not a layer's cost")
        torch.cuda.empty_cache()
    m = out["modes"]
    log(f"  attention block {m['attn']['per_layer_us']:.1f} us + MLP block "
        f"{m['mlp']['per_layer_us']:.1f} us = "
        f"{m['attn']['per_layer_us'] + m['mlp']['per_layer_us']:.1f} us "
        f"against the full layer's {m['full']['per_layer_us']:.1f} us")
    out["rows"] = rows
    return out


def stage_step(nl, cfg, tok, lengths, stage: str, head) -> None:
    """``nonlayer_probe.py``'s 0-layer step up to ``stage`` (``STAGES``),
    in place: lengths + 1 and tok [B] int32 the next token, a function of
    the stage's output (tok + 1 + int(its f32 sum), mod the vocabulary), so
    that no stage is dead code; ``argmax`` is the real step's. ``nl``: the
    model's embed and final_norm; ``head``: the lm_head."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    v = cfg.vocab_size
    lengths.add_(1)
    if stage == "scan":
        tok.copy_((tok + 1) % v)
        return
    out = nl["embed"][tok[:, None]]
    if stage != "embed":
        out = llama.rms_norm(out, nl["final_norm"], cfg.rms_eps)
    if stage in ("head", "argmax"):
        out = llama.apply_linear(out[:, -1], head, cfg.x_quant8)
        if stage == "argmax":
            tok.copy_(torch.argmax(out, -1))
            return
    tok.copy_((tok + 1 + out.float().sum().to(torch.int32)) % v)


@torch.no_grad()
def nonlayer(params, cfg, dev, head_fmt: str | None = None) -> dict:
    """``nonlayer_probe.py``: each stage (``STAGES``, cumulative) of a
    0-layer step a graph-replay marginal, and its delta over the stage
    before, beside the head's stream bound; ``head_fmt``: the head
    dequantized and quantized to that format, its stages too."""
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
        dequantize, quantize)
    spec = _spec_or_h100(False)
    d = cfg.dim
    heads = {"": params["lm_head"]}
    if head_fmt:
        heads[head_fmt] = quantize(dequantize(params["lm_head"]), head_fmt)
    log(f"== profile_decode --nonlayer: {cfg.name}, a 0-layer step by stage"
        + (f", the head also in {head_fmt}" if head_fmt else ""))
    rows, prev = [], {}
    for stage in STAGES:
        for name, head in heads.items():
            if name and stage not in ("head", "argmax"):
                continue
            tok = torch.zeros((1,), dtype=torch.int32, device=dev)
            lengths = torch.zeros((1,), dtype=torch.int32, device=dev)
            us = graph_step_us(lambda: stage_step(params, cfg, tok, lengths,
                                                  stage, head),
                               [tok, lengths], dev)
            if stage in ("head", "argmax"):
                b = head_bound(spec, cfg, head.nbytes, head.fmt)
            else:
                b = spec.bound_ms(0 if stage == "scan" else 4 * d, 0, "bf16")
            base = prev.get(name, prev.get(""))
            _row(rows, stage + (f" [{name} head]" if name else ""), us, *b,
                 delta_us=None if base is None else us - base)
            prev[name] = us
    for name, head in heads.items():
        ms, _ = head_bound(spec, cfg, head.nbytes, head.fmt)
        log(f"  the {name or head.fmt} head streams {head.nbytes / 2**20:.1f}"
            f" MiB: bound {1e3 * ms:.1f} us")
    return {"mode": "nonlayer", "rows": rows}


def _q4k(g, n: int, k: int, dev):
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import quantize
    return quantize(torch.randn((n, k), generator=g, device=dev)
                    / float(k) ** 0.5, "q4_k")


@torch.no_grad()
def blocks(dev, dim: int, inter: int, length: int, S: int,
           seed: int = 0) -> dict:
    """``mlp_block_probe.py`` and ``fused_attn_probe.py``: each fused
    block against its unfused chain, per call (``chain_marginal``), the
    weights cycled through copies past the L2."""
    import torch.nn.functional as F
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops.flash_decode import flash_decode
    from ggml_cuda_experiments_tpu_torch.ops.fused_attention import (
        attention_fused)
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import mlp_fused
    from ggml_cuda_experiments_tpu_torch.utils.bench import rotating
    spec = _spec_or_h100(False)
    bpw = BYTES_PER_WEIGHT["q4_k"]
    g = torch.Generator(device=dev).manual_seed(seed)
    log(f"== profile_decode --blocks: MLP {dim} x {inter}, attention MHA "
        f"{ATTN_HEADS} x {ATTN_D} at length {length} of {S}")
    rows = []
    mlps = rotating(lambda i: (_q4k(g, 2 * inter, dim, dev),
                               _q4k(g, dim, inter, dev)),
                    3 * inter * dim * bpw)
    x = torch.randn((1, dim), generator=g, device=dev)
    xb = x.to(torch.bfloat16)

    def mlp_unfused(i):
        w_gu, w_down = mlps[i % len(mlps)]
        gate, up = llama.gate_up_proj({"w_gu": w_gu}, xb, True)
        return llama.apply_linear(F.silu(gate.float()).to(xb.dtype) * up,
                                  w_down, True)

    b = mlp_block_bound(spec, dim, inter, bpw)
    _row(rows, "fused_mlp", _marginal_us(
        lambda i: mlp_fused(x, *mlps[i % len(mlps)])), *b, copies=len(mlps))
    _row(rows, "unfused MLP (w_gu, SiLU x up, w_down)",
         _marginal_us(mlp_unfused), *b, copies=len(mlps))
    del mlps
    ad = ATTN_HEADS * ATTN_D
    attns = rotating(lambda i: (_q4k(g, 3 * ad, ad, dev),
                                _q4k(g, ad, ad, dev)), 4 * ad * ad * bpw)
    kc, vc = ((0.3 * torch.randn((2, 1, ATTN_HEADS, S, ATTN_D), generator=g,
                                 device=dev)).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.full((1,), length, dtype=torch.int32, device=dev)
    xa = torch.randn((1, ad), generator=g, device=dev)
    xab = xa.to(torch.bfloat16)
    pos = lens[:, None]

    def attn_fused(i):
        wqkv, wo = attns[i % len(attns)]
        return attention_fused(xa, wqkv, wo, kc, vc, lens, 1,
                               n_heads=ATTN_HEADS, n_kv_heads=ATTN_HEADS,
                               head_dim=ATTN_D)[0]

    def attn_unfused(i):
        wqkv, wo = attns[i % len(attns)]
        qkv = llama.apply_linear(xab, wqkv, True)
        q, k, v = (qkv[:, j * ad:(j + 1) * ad].reshape(1, 1, ATTN_HEADS,
                                                       ATTN_D)
                   for j in range(3))
        q = llama.rope(q, pos, 10000.0)
        k = llama.rope(k, pos, 10000.0)
        llama._write_cache_layer(kc, 1, k.transpose(1, 2), lens)
        llama._write_cache_layer(vc, 1, v.transpose(1, 2), lens)
        o = flash_decode(q[:, 0].contiguous(), kc[1], vc[1], lens + 1)
        return llama.apply_linear(o.reshape(1, ad).to(torch.bfloat16), wo,
                                  True)

    b = attn_block_bound(spec, ad, length, bpw)
    _row(rows, "fused_attention", _marginal_us(attn_fused), *b,
         copies=len(attns))
    _row(rows, "unfused attention (wqkv, RoPE, append, flash_decode, wo)",
         _marginal_us(attn_unfused), *b, copies=len(attns))
    return {"mode": "blocks", "rows": rows}


@torch.no_grad()
def embed_lookup(cfg, dev, T: int, seed: int = 0) -> dict:
    """``embed_probe.py``: T rows of a [vocab, dim] bf16 table per call
    four ways, each checked equal to indexing; token sets cycled so the
    rows stream past the L2."""
    import torch.nn.functional as F
    from ggml_cuda_experiments_tpu_torch.utils.bench import rotating
    spec = _spec_or_h100(False)
    v, d = cfg.vocab_size, cfg.dim
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((v, d), generator=g, device=dev).to(torch.bfloat16)
    toks = rotating(lambda i: torch.randint(0, v, (T,), generator=g,
                                            device=dev), 2 * T * d)
    out = torch.empty((T, d), dtype=torch.bfloat16, device=dev)

    def rows_loop(t):
        for r in range(T):
            torch.index_select(emb, 0, t[r:r + 1], out=out[r:r + 1])
        return out

    ways = {"index": lambda t: emb[t],
            "index_select": lambda t: torch.index_select(emb, 0, t),
            "one-hot bf16 product": lambda t: F.one_hot(
                t.long(), v).to(torch.bfloat16) @ emb,
            "row copies (a graph)": rows_loop}
    log(f"== profile_decode --embed {T}: [{v} x {d}] bf16")
    rows = []
    b = embed_bound(spec, T, d)
    for name, fn in ways.items():
        if not torch.equal(fn(toks[0]), emb[toks[0]]):
            raise AssertionError(f"--embed: {name} differs from indexing")
        us = _marginal_us(lambda i: fn(toks[i % len(toks)]))
        _row(rows, name, us, *b, us_per_row=us / T, copies=len(toks))
    return {"mode": "embed", "T": T, "rows": rows}


def _pair_us(call_small, call_big, pairs: int) -> tuple[float, list]:
    """The size-marginal pair (``pipe_probe.py``, ``probe_s6.py``): chains
    of ``PAIR_INNER`` calls of each shape captured once, replayed in turn
    ``pairs`` times; the median of (t_big - t_small) a call, in us, and
    the pairs'."""
    from ggml_cuda_experiments_tpu_torch.utils.bench import (
        capture, replay_seconds)
    small = capture(call_small, PAIR_INNER)
    big = capture(call_big, PAIR_INNER)
    vals = []
    for _ in range(pairs):
        ts = replay_seconds(small)
        vals.append(1e6 * (replay_seconds(big) - ts) / PAIR_INNER)
    return statistics.median(vals), vals


@torch.no_grad()
def pipe(dev, T: int, pairs: int, seed: int = 0) -> dict:
    """``pipe_probe.py``: the tc route of ``q4k_gemm`` at T tokens in each
    phase (``PIPE_RUNGS``) and ``torch.matmul`` on the dequantized bf16
    weight, at each of ``PIPE_SHAPES`` by size-marginal pairs, the pair's
    extra time scaled to the big shape, beside its bound; then whether the
    production route runs at max(dequant, dot) or at their sum."""
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
        dequantize, q4k_gemm, quantize)
    spec = _spec_or_h100(False)
    g = torch.Generator(device=dev).manual_seed(seed)
    log(f"== profile_decode --pipe: q4k_gemm's tc route at T {T}, "
        f"{pairs} size-marginal pairs of {PAIR_INNER}-call chains")
    rows, out = [], {"mode": "pipe", "T": T, "shapes": {}}
    for k, ns, nb in PIPE_SHAPES:
        w = torch.randn((nb, k), generator=g, device=dev) / float(k) ** 0.5
        x = torch.randn((T, k), generator=g, device=dev).to(torch.bfloat16)
        qls = {n: _cycle([quantize(w[:n], "q4_k")],
                         n * k * BYTES_PER_WEIGHT["q4_k"]) for n in (ns, nb)}
        dense = {n: dequantize(qls[n][0]).to(torch.bfloat16)
                 for n in (ns, nb)}
        del w
        bound = pipe_bound(spec, T, nb, k)
        got = {}
        for rung in PIPE_RUNGS:
            if rung == "torch.matmul":
                calls = [lambda i, n=n: x @ dense[n].T for n in (ns, nb)]
            else:
                calls = [lambda i, n=n: q4k_gemm(x, qls[n][i % len(qls[n])],
                                                 phase=rung)
                         for n in (ns, nb)]
            us, vals = _pair_us(*calls, pairs)
            us *= nb / (nb - ns)
            got.setdefault(rung, []).append(us)
            _row(rows, f"K {k} N {nb} T {T}: {rung}", us, *bound,
                 pairs_us=vals)
        m = {r: statistics.mean(v) for r, v in got.items()}
        top, both = max(m["dequant"], m["dot"]), m["dequant"] + m["dot"]
        share = (m["all"] - top) / (both - top) if both > top else None
        log(f"  K {k}: all {m['all']:.1f} us (the two brackets "
            f"{got['all'][0]:.1f}, {got['all'][1]:.1f}); max(dequant, dot) "
            f"{top:.1f} us, dequant + dot {both:.1f} us, stream "
            f"{m['stream']:.1f} us: all sits "
            + ("at max(dequant, dot) + " + f"{share:.2f} of the other"
               if share is not None else "-"))
        out["shapes"][f"K{k}"] = {"us": m, "all_brackets_us": got["all"],
                                  "max_dequant_dot_us": top,
                                  "sum_dequant_dot_us": both,
                                  "overlap_share": share,
                                  "bound_ms": bound[0]}
        del qls, dense
        torch.cuda.empty_cache()
    out["rows"] = rows
    return out


@torch.no_grad()
def s6_compare(e_params, s6_params, cfg, dev, batch: int, cache: int,
               pairs: int, seed: int = 0) -> dict:
    """``probe_s6.py``: the decode components (each linear, batch
    ``batch``) and the graph step of the s6 model beside the same dense
    weights in Q4_K-E; then the int8 matvec's size-marginal rung
    (``S6_PAIR``) in e, s6 and e again."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
        qmatmul, quantize)
    spec = _spec_or_h100(False)
    models = {"e": e_params, "s6": s6_params}
    g = torch.Generator(device=dev).manual_seed(seed)
    log(f"== profile_decode --enc s6: {cfg.name} batch {batch}, "
        f"{cfg.n_layers} layers, cache {cache}, x_quant8 {cfg.x_quant8}")
    rows, out = [], {"mode": "s6", "batch": batch, "linears": {}, "step": {}}
    for name in LINEARS + ("head",):
        for enc, params in models.items():
            ws = [params["lm_head"]] if name == "head" else \
                [lay[name] for lay in params["layers"]]
            w0 = ws[0]
            ws = _cycle(ws, w0.nbytes)
            n, k = w0.shape
            x = torch.randn((batch, k), generator=g,
                            device=dev).to(torch.bfloat16)
            us = _marginal_us(lambda i: llama.apply_linear(
                x, ws[i % len(ws)], cfg.x_quant8))
            b = linear_bound(spec, n, k, w0.nbytes, batch,
                             kind_of(batch, w0.fmt, cfg.x_quant8))
            _row(rows, f"linear {name} [{n} x {k}] {w0.enc}", us, *b,
                 1 if name == "head" else cfg.n_layers, enc=w0.enc)
            out["linears"].setdefault(name, {})[enc] = us
            del ws
    length = PROMPT + sum(CHAIN) // 2
    for enc, params in models.items():
        step, state = _greedy_step(params, cfg, dev, batch, cache)
        us = graph_step_us(step, state, dev)
        w, head = params["layers"][0]["wqkv"], params["lm_head"]
        ms = step_bound_ms(spec, cfg, _bpw(w), _bpw(head), batch, length)
        _row(rows, f"step (one graph) {enc}", us, ms, "bytes")
        out["step"][enc] = us
        del step, state
        torch.cuda.empty_cache()
    k, ns, nb = S6_PAIR
    w = torch.randn((nb, k), generator=g, device=dev) / float(k) ** 0.5
    x = torch.randn((1, k), generator=g, device=dev)
    out["pair"] = []
    for enc in ("e", "s6", "e"):
        qls = {n: quantize(w[:n], "q4_k", enc=enc) for n in (ns, nb)}
        qls = {n: _cycle([q], q.nbytes) for n, q in qls.items()}
        calls = [lambda i, n=n: qmatmul(x, qls[n][i % len(qls[n])],
                                        x_quant8=True) for n in (ns, nb)]
        us, vals = _pair_us(*calls, pairs)
        dbytes = qls[nb][0].nbytes - qls[ns][0].nbytes
        gbs = dbytes / us / 1e3
        _row(rows, f"int8 matvec K {k}, {ns} -> {nb} rows {enc} (the extra "
             "rows)", us, *spec.bound_ms(dbytes, 0, "int8"), enc=enc,
             gb_s=gbs, pct_hbm=100 * 1e9 * gbs / spec.hbm_bytes_per_s,
             pairs_us=vals)
        out["pair"].append({"enc": enc, "us": us, "gb_s": gbs})
    out["rows"] = rows
    return out


@torch.no_grad()
def host_costs(dev, n: int) -> dict:
    """``rig_probe.py``: the host's us a call (the mean of ``n`` calls
    after one, host clock, the queue drained before each row) of the rows
    of ``HOST_ROWS``, each beside the device bound of its bytes."""
    spec = _spec_or_h100(False)
    host8 = torch.arange(8, dtype=torch.int32)
    xdev = host8.to(dev)

    def chain(k):
        y = xdev
        for _ in range(k):
            y = y + 1
        return y.cpu()

    def upload_synced():
        host8.to(dev)
        torch.cuda.synchronize(dev)

    calls = {"upload [8] int32, synced": upload_synced,
             "upload [8] int32, not synced": lambda: host8.to(dev),
             "launch x + 1 on a resident x": lambda: xdev + 1,
             "launch x + 1 on an uploaded host x":
                 lambda: host8.to(dev) + 1,
             "launch + fetch": lambda: (xdev + 1).cpu(),
             "chain of 1 launch + fetch": lambda: chain(1),
             "chain of 16 launches + fetch": lambda: chain(16)}
    log(f"== profile_decode --host: the mean host us of {n} calls a row")
    rows, us = [], {}
    for name, nbytes in HOST_ROWS:
        if name in calls:
            fn = calls[name]
            fn()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            us[name] = 1e6 * (time.perf_counter() - t0) / n
        else:                       # each extra launch of the chain
            us[name] = (us["chain of 16 launches + fetch"]
                        - us["chain of 1 launch + fetch"]) / 15
        _row(rows, name, us[name], *spec.bound_ms(nbytes, 0, "bf16"))
    torch.cuda.synchronize(dev)
    return {"mode": "host", "n": n, "rows": rows}


def run(args, dev, params=None) -> dict:
    """The probe mode of ``args`` on ``dev``; ``params``: the model's
    weights (``cached_params``' when None) for the modes that take them."""
    cfg = config(args.model)
    if args.mode == "blocks":
        return blocks(dev, args.dim, args.inter, args.len, args.S, args.seed)
    if args.mode == "embed":
        return embed_lookup(cfg, dev, args.embed, args.seed)
    if args.mode == "pipe":
        return pipe(dev, args.t, args.pairs, args.seed)
    if args.mode == "host":
        return host_costs(dev, args.n)
    if args.mode == "enc":
        e = params if params is not None else cached_params(
            cfg, args.fmt, args.seed, dev)
        s6 = cached_params(cfg, args.fmt, args.seed, dev, enc="s6",
                           ckpt=args.ckpt)
        return s6_compare(e, s6, cfg, dev, args.batch, args.cache,
                          args.pairs, args.seed)
    if params is None:
        params = cached_params(cfg, args.fmt, args.seed, dev,
                               ckpt=args.ckpt)
    if args.mode == "ladder":
        return ladder(params, cfg, dev, args.batch, args.cache)
    if args.mode == "layer_marginal":
        return layer_marginal(params, cfg, dev, args.cache, args.ablate)
    if args.mode == "nonlayer":
        return nonlayer(params, cfg, dev, args.head_fmt)
    raise ValueError(f"no probe mode {args.mode!r}")


def main(argv=None) -> int:
    args = parse(argv)
    if args.cpu:
        return plan(args)
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = require_cuda()
    log(card_line())
    if args.mode:
        out = run(args, dev)
    else:
        cfg = config(args.model)
        params = cached_params(cfg, args.fmt, args.seed, dev, ckpt=args.ckpt)
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
