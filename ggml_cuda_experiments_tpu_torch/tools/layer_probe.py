"""Decompose the whole-layer decode kernel's time (``ops/layer_kernel.py``,
``csrc/fused_decode.cu``) on the card: the port's counterpart of the JAX
package's ``tools/layer_probe.py``.

    python -m ggml_cuda_experiments_tpu_torch.tools.layer_probe \\
        [--lengths 57,513] [--variants all,no_sync,...] [--model-layers 32]
        [--scan [--scan-fmt q8_0]]
    python -m ggml_cuda_experiments_tpu_torch.tools.layer_probe \\
        --root DIR --tag parent       # the package of the checkout at DIR
    python -m ggml_cuda_experiments_tpu_torch.tools.layer_probe --cpu

One llama2-7b layer in q4_k (dim 4096, 32 query heads of 128, ``--kv-heads``
32 or fewer, intermediate 12288, a bf16 cache of S = 1024) with random
weights from a seed, timed through ``layer_step`` for each ``phase`` variant
(``ops/layer_kernel.py::PHASES``: every variant but "all" gives wrong
outputs and is timed only), and ``mega2``: ``attention_fused`` and
``mlp_fused`` chained with their RMSNorms (the two-kernel path the layer
kernel replaces). Each time is 20 calls captured in one CUDA graph (two
weight copies in turn, so a chain streams past the 50 MB L2), the median of
5 replays (CUDA events), in us a layer, beside the byte bound: the layer's
weights and the valid K / V rows over the card's HBM rate. With
``--model-layers N`` it also times ``model_step`` over N distinct layers
for each variant. With ``--scan`` it also times ``generate_scan`` of the
whole llama2-7b (32 layers, random q4_k weights from a seed, a 16-token
prompt) in the x_quant8 configuration, fused_attention + fused_mlp a
layer (``--scan-fmt q8_0``: random q8_0 weights in the preset's
configuration, ``q80_matvec`` a linear and the head): ms a token, the
marginal of 8 and 40 replays of one captured step
(``tools/spec_bench.py::plain_per_token``); ``--variants ""`` times the
scan alone. The card's name and power
limit first, one JSON line of every time last. ``--root`` times through that checkout's package, its
timer ``utils/bench.py::time_ms`` included; a checkout without the
``phase`` argument is timed on "all" and mega2 alone. ``--cpu`` checks the
arguments, prints the plan and its bounds and times nothing. Without ``--cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

DIM, HQ, D, KD, S = 4096, 32, 128, 12288, 1024
VARIANTS = ("all", "no_sync", "no_bound", "no_attn", "stream", "only_pack",
            "only_down", "mega2")
HBM = 3.35e12                          # H100 SXM, for the --cpu plan only


def weight_bytes(hkv: int) -> int:
    """q4_k bytes of one layer's wqkv, W_o, w_gu and w_down (qs, es, em:
    0.625 bytes a weight)."""
    rows_k = ((HQ + 2 * hkv) * D * DIM + DIM * DIM + 2 * KD * DIM
              + DIM * KD)
    return rows_k * 5 // 8


def kv_bytes(hkv: int, length: int) -> int:
    """bf16 K and V rows a layer reads at ``length`` (before the token):
    the cached keys, the new one included, at most S."""
    return 2 * hkv * min(length + 1, S) * D * 2


def layer_bound_us(hkv: int, length: int, hbm: float) -> float:
    return 1e6 * (weight_bytes(hkv) + kv_bytes(hkv, length)
                  + 8 * DIM) / hbm


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lengths", default="57,513",
                    help="cache lengths before the token")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kv-heads", type=int, default=32)
    ap.add_argument("--model-layers", type=int, default=0,
                    help="also time model_step over this many layers")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--scan", action="store_true",
                    help="also time generate_scan of llama2-7b at x_quant8")
    ap.add_argument("--scan-fmt", default="q4_k", choices=("q4_k", "q8_0"),
                    help="--scan's weights: q4_k at x_quant8, or q8_0 in "
                         "the preset's configuration")
    ap.add_argument("--root", default=None,
                    help="time the package of the checkout at this path")
    ap.add_argument("--tag", default="new")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    args.lengths = [int(v) for v in args.lengths.split(",") if v]
    args.variants = [v for v in args.variants.split(",") if v]
    bad = [v for v in args.variants if v not in VARIANTS]
    if bad:
        ap.error(f"unknown variants {bad}; take from {', '.join(VARIANTS)}")
    if not args.lengths or any(not 0 <= n < S for n in args.lengths):
        ap.error(f"lengths in [0, {S})")
    if args.kv_heads < 1 or HQ % args.kv_heads or HQ // args.kv_heads > 8:
        ap.error("kv-heads: a divisor of 32 with at most 8 heads each")
    if args.calls < 1 or args.model_layers < 0:
        ap.error("calls >= 1, model-layers >= 0")
    return args


def make_layer(g, dev, hkv: int) -> dict:
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm

    def w(n, k):
        return qm.quantize(torch.randn((n, k), generator=g, device=dev)
                           * k ** -0.5)
    return {"wqkv": w((HQ + 2 * hkv) * D, DIM), "wo": w(DIM, DIM),
            "w_gu": w(2 * KD, DIM), "w_down": w(DIM, KD),
            "attn_norm": (1 + 0.1 * torch.randn(DIM, generator=g, device=dev)
                          ).to(torch.bfloat16),
            "mlp_norm": (1 + 0.1 * torch.randn(DIM, generator=g, device=dev)
                         ).to(torch.bfloat16)}


def run(args) -> list:
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import fused_attention as fat
    from ggml_cuda_experiments_tpu_torch.ops import layer_kernel as lk
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.utils.bench import time_ms
    from ggml_cuda_experiments_tpu_torch.utils.device_info import (
        card_line, card_spec)
    if not torch.cuda.is_available():
        raise RuntimeError("layer_probe: needs a CUDA device (--cpu checks "
                           "the arguments only)")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    hbm = card_spec().hbm_bytes_per_s
    has_phase = "phase" in inspect.signature(lk.layer_step).parameters
    hkv = args.kv_heads
    g = torch.Generator(device=dev).manual_seed(0)
    layers = [make_layer(g, dev, hkv) for _ in range(2)]
    packs = [lk.pack_layers([lay]) for lay in layers]
    kc = torch.randn((2, 1, hkv, S, D), generator=g, device=dev
                     ).to(torch.bfloat16)
    vc = torch.randn((2, 1, hkv, S, D), generator=g, device=dev
                     ).to(torch.bfloat16)
    h = torch.randn((1, DIM), generator=g, device=dev)
    kw = dict(n_heads=HQ, n_kv_heads=hkv, head_dim=D)
    rows = []

    def record(kind, variant, length, ms, bound_us):
        us = 1e3 * ms
        row = {"tag": args.tag, "kind": kind, "variant": variant,
               "length": length, "kv_heads": hkv, "us": us,
               "bound_us": bound_us, "ratio": bound_us / us}
        rows.append(row)
        print(f"{args.tag} {kind} {variant:9s} len {length:4d} Hkv {hkv}: "
              f"{us:8.1f} us a layer, bound {bound_us:6.1f} us "
              f"({100 * row['ratio']:.0f}%)", flush=True)

    def mega2(i, lens):
        lay = layers[i % 2]
        x = lk._rms_f32(h, lay["attn_norm"].float(), 1e-5)
        o = fat.attention_fused(x, lay["wqkv"], lay["wo"], kc, vc, lens,
                                i % 2, **kw)[0]
        h2 = h + o
        x2 = lk._rms_f32(h2, lay["mlp_norm"].float(), 1e-5)
        return h2 + qm.mlp_fused(x2, lay["w_gu"], lay["w_down"])

    for length in args.lengths:
        lens = torch.full((1,), length, dtype=torch.int32, device=dev)
        bound = layer_bound_us(hkv, length, hbm)
        for v in args.variants:
            if v == "mega2":
                ms = time_ms(lambda i: mega2(i, lens), args.calls)
            elif v != "all" and not has_phase:
                print(f"{args.tag} layer {v}: no phase argument in this "
                      "checkout", flush=True)
                continue
            else:
                pk = {"phase": v} if has_phase else {}
                ms = time_ms(lambda i: lk.layer_step(
                    h, packs[i % 2], kc, vc, lens, i % 2, **kw, **pk),
                    args.calls)
            record("layer", v, length, ms, bound)
    if args.model_layers:
        del packs
        n = args.model_layers
        mlayers = [layers[0], layers[1]] + [make_layer(g, dev, hkv)
                                             for _ in range(n - 2)]
        m_pack = lk.pack_layers(mlayers[:n])
        kcm = torch.randn((n, 1, hkv, S, D), generator=g, device=dev
                          ).to(torch.bfloat16)
        vcm = torch.randn((n, 1, hkv, S, D), generator=g, device=dev
                          ).to(torch.bfloat16)
        for length in args.lengths:
            lens = torch.full((1,), length, dtype=torch.int32, device=dev)
            bound = layer_bound_us(hkv, length, hbm)
            for v in args.variants:
                if v == "mega2" or (v != "all" and not has_phase):
                    continue
                pk = {"phase": v} if has_phase else {}
                ms = time_ms(lambda i: lk.model_step(
                    h, m_pack, kcm, vcm, lens, **kw, **pk),
                    max(1, args.calls // 4))
                record(f"model_step/{n}", v, length, ms / n, bound)
                if v == "all":
                    print(f"{args.tag} model_step {n} layers len {length}: "
                          f"{1e3 * ms:.1f} us, bound {n * bound:.1f} us",
                          flush=True)
    if args.scan:
        del layers, kc, vc
        rows.append(scan(args.tag, dev, args.scan_fmt))
    return rows


def scan(tag: str, dev, fmt: str = "q4_k") -> dict:
    """ms a token of generate_scan over the whole llama2-7b: q4_k at
    x_quant8, or q8_0 in the preset's configuration."""
    import dataclasses
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb
    cfg = PRESETS["llama2-7b"]
    if fmt == "q4_k":
        cfg = dataclasses.replace(cfg, x_quant8=True)
    variant = "x_quant8" if fmt == "q4_k" else fmt
    torch.cuda.empty_cache()
    dense = llama.init_weights(cfg, seed=0, device=dev)
    params = llama.quantize_params(dense, fmt)
    del dense
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (1, 16), generator=g,
                           device=dev, dtype=torch.int64)
    ms = 1e3 * sb.plain_per_token(params, cfg, prompt)
    print(f"{tag} generate_scan {variant} {cfg.name} {cfg.n_layers} layers: "
          f"{ms:.4f} ms a token ({1e3 / ms:.1f} tok/s)", flush=True)
    return {"tag": tag, "kind": "generate_scan", "variant": variant,
            "layers": cfg.n_layers, "ms_token": ms}


def plan(args) -> int:
    print("device: cpu (the plan and its byte bounds at 3.35 TB/s; time not "
          "measured)")
    for length in args.lengths:
        print(f"len {length:4d} Hkv {args.kv_heads}: weights "
              f"{weight_bytes(args.kv_heads) / 1e6:.1f} MB, K/V "
              f"{kv_bytes(args.kv_heads, length) / 1e6:.2f} MB, bound "
              f"{layer_bound_us(args.kv_heads, length, HBM):.1f} us a layer; "
              f"variants {', '.join(args.variants)}"
              + (f"; model_step over {args.model_layers} layers"
                 if args.model_layers else ""))
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
    print(json.dumps({"layer_probe": run(args)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
