"""The q6_k head's compute patterns priced on the card: the port's
counterpart of the JAX package's ``tools/q6_probe.py``, its rungs on its
random operands at the head's K = 4096 (``ops/probes.py``,
``csrc/q6_probe.cu``):

    cur        the port's q6_k head matvec, ``q6k_q8_matvec``, on a real
               q6_k weight
    stream     the floor for the same operands (qs + qh + es streamed)
    nib_global the nibble part as int8 products against [2048, 256]
               selectors (the port's int8 GEMM between a prologue and an
               epilogue kernel)
    nib_seg    the same per 1 KB segment against [1024, 128] slices (half
               the MACs)
    bits2      the 2-bit planes' extraction and fold alone

    python -m ggml_cuda_experiments_tpu_torch.tools.q6_probe
        [--variants stream,cur,nib_global,nib_seg,bits2] [--inner 64]
        [--reps 3] [--cpu]

As the JAX tool: each variant at 8192 and 32768 rows (the operands drawn
from one ``default_rng(0)`` in the tool's order), chains of ``--inner``
calls, the least of ``--reps`` replays at each size, and the marginal over
the byte difference (qs 2,048 + qh 1,024 + es 512 B a row; ``cur``'s q6_k
weight has the same 3,584 B a row). Here each chain is a CUDA graph over
operand copies rotated past the 50 MB L2. ``--cpu`` runs each rung once at
1024 rows through the plain versions and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

K, KH, KQ4, KB6 = 4096, 2048, 1024, 256
N_SMALL, N_BIG = 8192, 32768


def draw_operands(rows: int, rng, dev) -> dict:
    """q6_probe's ``make_probe`` operands, drawn in its order."""
    qs = rng.integers(-128, 128, size=(rows, KH)).astype(np.int8)
    qh = rng.integers(-128, 128, size=(rows, KQ4)).astype(np.int8)
    es = (rng.normal(size=(rows, KB6)) * 1e-3).astype(np.float32)
    ea = rng.integers(-8, 8, size=(KH, 256)).astype(np.int8)
    eb = rng.integers(-8, 8, size=(KH, 256)).astype(np.int8)
    xc = (rng.normal(size=(4, KQ4)) * 1e-3).astype(np.float32)
    t = {k: torch.from_numpy(v).to(dev) for k, v in
         dict(qs=qs, qh=qh, ea=ea, eb=eb, xc=xc).items()}
    t["es"] = torch.from_numpy(es).to(dev).to(torch.bfloat16)
    return t


def rung(mode: str, ops: dict):
    """fn(weights) of a rung, the weights being (qs, qh, es) copies."""
    from ggml_cuda_experiments_tpu_torch.ops import probes
    if mode == "stream":
        return lambda w: probes.q6_stream(*w)
    if mode == "bits2":
        return lambda w: probes.q6_bits2(w[1], ops["xc"], w[2])
    rhs = probes.nib_rhs(mode, ops["ea"], ops["eb"])
    return lambda w: probes.q6_nib(mode, w[0], rhs, w[2])


def make(mode: str, rows: int, rng, dev):
    """(fn(i), operand bytes) of one variant at ``rows`` rows, cycling
    operand copies rotated past the L2."""
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    from ggml_cuda_experiments_tpu_torch.utils import bench as ub
    if mode == "cur":
        w = (rng.normal(size=(rows, K)) / np.sqrt(K)).astype(np.float32)
        ql = qm.quantize(torch.from_numpy(w).to(dev), "q6_k")
        x = torch.from_numpy(rng.normal(size=(1, K)).astype(np.float32)).to(
            dev)
        ws = ub.rotating(lambda i: eb.copy_of(ql), ql.nbytes)
        return (lambda i: qm.qmatmul(x, ws[i % len(ws)])), ql.nbytes
    ops = draw_operands(rows, rng, dev)
    nbytes = sum(ops[k].numel() * ops[k].element_size()
                 for k in ("qs", "qh", "es"))
    base = (ops["qs"], ops["qh"], ops["es"])
    ws = ub.rotating(lambda i: tuple(t.clone() for t in base), nbytes)
    fn = rung(mode, ops)
    return (lambda i: fn(ws[i % len(ws)])), nbytes


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="stream,cur,nib_global,nib_seg,"
                    "bits2")
    ap.add_argument("--inner", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.utils import bench as ub
    from ggml_cuda_experiments_tpu_torch.utils.device_info import (
        card_line, card_spec)
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = torch.device("cpu") if args.cpu else require_cuda()
    rng = np.random.default_rng(0)
    names = args.variants.split(",")
    if args.cpu:
        print("device: cpu (the plain versions; no time)", flush=True)
        for v in names:
            fn, nb = make(v, 1024, rng, dev)
            y = fn(0)
            print(f"{v:10s}: ran on 1024 rows ({nb // 1024} B a row) -> "
                  f"{tuple(y.shape)}, finite {bool(torch.isfinite(y).all())};"
                  f" time not measured (CPU)", flush=True)
        return 0
    print(f"card: {card_line()}", flush=True)
    peak = card_spec().hbm_bytes_per_s
    for v in names:
        fs, nb_s = make(v, N_SMALL, rng, dev)
        fb, nb_b = make(v, N_BIG, rng, dev)
        t = {}
        for key, fn in (("s", fs), ("b", fb)):
            graph = ub.capture(fn, args.inner)
            t[key] = ub.replay_seconds(graph, args.reps)
            del graph
        per = (t["b"] - t["s"]) / args.inner
        gbs = (nb_b - nb_s) / per / 1e9
        print(f"{v:10s}: {per * 1e6:8.2f} us/Diter  {gbs:7.1f} GB/s "
              f"({100 * gbs * 1e9 / peak:5.1f}% of HBM)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
