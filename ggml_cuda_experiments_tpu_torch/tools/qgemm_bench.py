"""The dequantizing GEMM (``q4k_gemm``, ``q40_gemm``, ``q80_gemm``) on the
card at the llama2-7b linears, through the public wrappers, so that one
command times any checkout of the port:

    python -m ggml_cuda_experiments_tpu_torch.tools.qgemm_bench [--tag new]
    python -m ggml_cuda_experiments_tpu_torch.tools.qgemm_bench \\
        --root DIR --tag parent       # the package of the checkout at DIR

``chip_smoke.py`` times its GEMM cases with ``cases``, ``gemm_x`` and
``gemm_times`` from here, so the smoke and this tool read one timing path.
Cases: each format at w_gu [24576, 4096] with M = 2, 5, 8, 16, 128, 512,
and q4k_gemm there at M = 32 and 33 (the routes' crossover); q4k_gemm at
wqkv [12288, 4096], W_o [4096, 4096] and w_down [4096, 12288] with M = 8
and 512. Each case reads enough weight copies that a chain of calls
streams past the 50 MB L2 (``utils/bench.py`` ``rotating``), 20 calls
captured in one CUDA graph, the median of 5 replays (CUDA events). One
line a case: the time, the bound (the larger of the bytes, W + x + y, over
the card's HBM rate and 2 M N K over its bf16 peak) and the ratio, the
route ``gemm_route`` picks (where the checkout has one), and at M = 8 and
512 the time of ``torch.matmul`` of bf16 x against the weight already
dequantized to bf16 (a yardstick of the product alone, not the same
function). The card's name and power limit first, one JSON line of every
case last. With ``--root`` the tool runs itself again in a child process
whose ``PYTHONPATH`` is DIR: this file's timing, that checkout's wrappers.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

NAMES = {"q4_k": "q4k_gemm", "q4_0": "q40_gemm", "q8_0": "q80_gemm"}
W_GU = (24576, 4096)
LAYERS = (("wqkv", (12288, 4096)), ("W_o", (4096, 4096)),
          ("w_down", (4096, 12288)))


def cases(fmt: str | None = None) -> list:
    """(fmt, layer, (N, K), M) of every case (of one format if given), the
    cases of one weight next to each other."""
    out = [(f, "w_gu", W_GU, m) for f in NAMES
           for m in ((2, 5, 8, 16, 32, 33, 128, 512) if f == "q4_k"
                     else (2, 5, 8, 16, 128, 512))]
    out += [("q4_k", name, nk, m) for name, nk in LAYERS for m in (8, 512)]
    return [c for c in out if fmt in (None, c[0])]


def time_ms(call, calls: int = 20, replays: int = 5) -> float:
    """Device ms of one ``call(i)``: ``calls`` calls captured in one CUDA
    graph after 3 eager calls, the graph replayed between CUDA events, the
    median of ``replays`` replays."""
    from ggml_cuda_experiments_tpu_torch.utils.bench import (
        capture, replay_seconds)
    graph = capture(call, calls, warmup=3)
    return statistics.median(1e3 * replay_seconds(graph) / calls
                             for _ in range(replays))


def gemm_x(m: int, n: int, k: int, dev):
    """The case's activations: bf16 [m, k] from a seed of m and n."""
    import torch
    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    return torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)


def gemm_times(qm, fn, x, ws) -> dict:
    """``ms``: one call of ``fn(x, w)`` cycling the weight copies ``ws``;
    at M = 8 and 512 also ``matmul_ms``: torch.matmul of x against the
    copies dequantized to bf16."""
    import torch
    out = {"ms": time_ms(lambda i: fn(x, ws[i % len(ws)]))}
    if x.shape[0] in (8, 512):
        wd = [qm.dequantize(w).to(torch.bfloat16) for w in ws]
        out["matmul_ms"] = time_ms(lambda i: torch.matmul(
            x, wd[i % len(wd)].T))
    return out


def run(tag: str) -> list:
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.utils.bench import rotating
    from ggml_cuda_experiments_tpu_torch.utils.device_info import (
        card_line, card_spec)
    if not torch.cuda.is_available():
        raise RuntimeError("qgemm_bench: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    spec = card_spec()
    g = torch.Generator(device=dev).manual_seed(0)
    route_of = getattr(qm, "gemm_route", None)
    rows, ws, key = [], None, None
    for fmt, layer, (n, k), m in cases():
        if key != (fmt, layer):
            def make(i, n=n, k=k, fmt=fmt):
                return qm.quantize(torch.randn(
                    (n, k), generator=g, device=dev) * k ** -0.5, fmt)
            ws, key = None, (fmt, layer)
            torch.cuda.empty_cache()
            ws = rotating(make, make(0).nbytes)
        t = gemm_times(qm, getattr(qm, NAMES[fmt]), gemm_x(m, n, k, dev), ws)
        us = 1e3 * t["ms"]
        nbytes = ws[0].nbytes + 2 * m * k + 4 * m * n
        bound_ms, by = spec.bound_ms(nbytes, 2 * m * n * k, "bf16")
        row = {"tag": tag, "fmt": fmt, "layer": layer, "n": n, "k": k,
               "m": m, "us": us, "bound_us": 1e3 * bound_ms, "bound_by": by,
               "ratio": 1e3 * bound_ms / us,
               "route": route_of(m) if route_of else None,
               "copies": len(ws)}
        if "matmul_ms" in t:
            row["matmul_us"] = 1e3 * t["matmul_ms"]
        rows.append(row)
        print(f"{tag} {NAMES[fmt]} {layer} N={n} K={k} M={m}: {us:.1f} us, "
              f"bound {row['bound_us']:.1f} us ({by}), ratio "
              f"{row['ratio']:.3f}, route {row['route']}"
              + (f", torch.matmul on the dequantized bf16 W "
                 f"{row['matmul_us']:.1f} us" if "matmul_us" in row else ""),
              flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="time the package of the checkout at this path")
    ap.add_argument("--tag", default="new")
    args = ap.parse_args(argv)
    if args.root:
        env = dict(os.environ, PYTHONPATH=str(Path(args.root).resolve()))
        return subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--tag", args.tag], env=env).returncode
    print(json.dumps({"qgemm_bench": run(args.tag)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
