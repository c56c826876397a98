"""Roofline headroom of the int8-activation q4_k matvec over the ladder's
grid, by bench.py's interleaved-pair protocol: the port's counterpart of
the JAX package's ``tools/roofline_sweep.py``.

    python -m ggml_cuda_experiments_tpu_torch.tools.roofline_sweep
        [--pairs 7] [--min-valid 5] [--variants base,full,cta1,cta2,cta3,stream]

Variants: ``base`` the production ``q4k_q8_matvec`` (no knob: its grid is
the CTAs that are resident); ``full`` the ladder's ``full`` rung (the same
row loop on prepared operands) at that grid; ``cta<c>`` the ``full`` rung
at c CTAs per SM (the JAX tool swept Mosaic's block_n and row subtiles;
on the card the knob is the grid); ``stream`` the stream floor, the
ceiling. Each is bench.py's size marginal (8192 against 32768 rows of
bench.py's weights, chains of 64 calls captured as CUDA graphs over
weight copies rotated past the L2). The card only.
"""

from __future__ import annotations

import argparse
import sys

import torch


def variant(v: str):
    """fn(x, ql) of a variant, or None if it is unknown."""
    from ggml_cuda_experiments_tpu_torch.ops import probes
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    if v == "base":
        return qm.q4k_q8_matvec
    if v == "stream":
        return probes.floor
    if v == "full" or (v.startswith("cta") and v[3:].isdigit()):
        c = 0 if v == "full" else int(v[3:])
        return lambda x, ql: probes.ladder(
            "full", probes.act_operands("full", x), x, ql, c)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=7)
    ap.add_argument("--min-valid", type=int, default=5)
    ap.add_argument("--variants", default="base,full,cta1,cta2,cta3,stream")
    args = ap.parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = require_cuda()
    print(f"card: {card_line()}", flush=True)
    w, x0 = eb.draws(0)
    x = torch.from_numpy(x0).to(dev)
    ql = qm.quantize(torch.from_numpy(w).to(dev), "q4_k")
    del w
    out = {}
    for v in args.variants.split(","):
        fn = variant(v)
        if fn is None:
            print(f"unknown variant {v}", flush=True)
            continue
        out[v] = eb.roofline(v, fn, ql, x, n_pairs=args.pairs,
                             min_valid=args.min_valid)[0]
        print(f"VARIANT {v:8s}: {out[v]:.2f}%", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
