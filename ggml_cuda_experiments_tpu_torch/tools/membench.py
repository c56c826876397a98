"""Memory-movement microbenchmarks on the card: the port's counterpart of
the JAX package's ``tools/membench.py``, each case's achieved GB/s against
the card's HBM rate.

    python -m ggml_cuda_experiments_tpu_torch.tools.membench [--mb 128]
        [--strides] [--cpu]

The cases are the JAX tool's, as PyTorch ops (they were XLA ops there, not
kernels of the repo): copy (x + 1), transpose, the interleave permutation,
f32 -> bf16 -> f32, and the row-sum reduce (x + the sum of its rows),
counted as 2, 2, 2, 1.5 and 3 passes of x's bytes. The interleave is an
``index_select`` over the port's own copy of the JAX package's
``_perm`` (its quant kernels' lane order, ``interleave_perm``); the port
itself never uses that order (it keeps weights in logical column order).
``--strides`` adds the strided-read sweep (every s-th column, s = 1..32,
written back padded to the full width; useful bytes x / s + x).

Each case is the JAX tool's inner-count marginal: chains of 16 and 64
passes (each pass reads the last one's output), here captured as CUDA
graphs and replayed between CUDA events, the least of 5 replays.
``--cpu`` runs each case once at 1 MB and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

QK, QK_K, SEG = 32, 256, 4096


def interleave_perm(k: int) -> np.ndarray:
    """perm[j] = the logical index at lane j of the JAX package's
    interleaved order (its ``ops/quant_matmul.py`` ``_perm``): for
    K % 256 == 0 the (K/256, 8, 32) -> (32, 8, K/256) transpose, per 4096
    segment with the nibble halves split globally when K > 4096 and
    K % 4096 == 0, else the (K/32, 32) -> (32, K/32) one."""
    if k % QK:
        raise ValueError(f"K = {k}: a multiple of {QK}")
    s = k // SEG if (k % SEG == 0 and k > SEG) else 1
    if s > 1:
        chunks = np.stack([interleave_perm(SEG) + c * SEG for c in range(s)])
        return chunks.reshape(s, 2, SEG // 2).transpose(1, 0, 2).reshape(k)
    if k % QK_K == 0:
        return (np.arange(k).reshape(k // QK_K, 8, QK)
                .transpose(2, 1, 0).reshape(k))
    return np.arange(k).reshape(k // QK, QK).transpose(1, 0).reshape(k)


def cases(x: torch.Tensor) -> dict:
    """name -> (op, passes of x's bytes)."""
    perm = torch.from_numpy(interleave_perm(x.shape[1])).to(x.device)
    return {
        "copy (x+1)": (lambda v: v + 1.0, 2),
        # a copy even for a square x, whose transpose reshapes to a view
        "transpose": (lambda v: v.t().contiguous().view(v.shape), 2),
        "interleave perm": (lambda v: torch.index_select(v, 1, perm), 2),
        "f32->bf16->f32": (lambda v: v.to(torch.bfloat16).float(), 1.5),
        "reduce (sum rows)": (lambda v: v + v.sum(0, keepdim=True), 3),
    }


def strided(stride: int):
    def op(v):
        y = v[:, ::stride]
        return torch.nn.functional.pad(y + 1.0, (0, v.shape[1] - y.shape[1]))
    return op


def pass_seconds(op, x: torch.Tensor, n_small: int = 16, n_big: int = 64,
                 reps: int = 5) -> float:
    """Seconds per pass of ``op`` by the inner-count marginal."""
    from ggml_cuda_experiments_tpu_torch.utils import bench as ub
    state = [x]

    def call(i):
        state[0] = op(x if i == 0 else state[0])

    return ub.chain_marginal(call, n_small, n_big, reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=128)
    ap.add_argument("--strides", action="store_true",
                    help="the strided-read sweep")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.utils.device_info import (
        card_line, card_spec)
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = torch.device("cpu") if args.cpu else require_cuda()
    mb = 1 if args.cpu else args.mb
    rows = 4096 if not args.cpu else 256
    cols = mb * 1024 * 1024 // 4 // rows
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(rows, cols)).astype(np.float32)
                         ).to(dev)
    ops = cases(x)
    if args.strides:
        ops.update({f"stride {s:2d}": (strided(s), 1 + 1 / s)
                    for s in (1, 2, 4, 8, 16, 32)})
    if args.cpu:
        print("device: cpu (the plain ops; no time)")
        for name, (op, _) in ops.items():
            y = op(x)
            if y.shape != x.shape:
                print(f"{name}: shape {tuple(y.shape)} != {tuple(x.shape)}")
                return 1
            print(f"{name:18s}: ran on {tuple(x.shape)}; time not measured")
        return 0
    peak = card_spec().hbm_bytes_per_s / 1e9
    print(f"card: {card_line()}; peak {peak:.0f} GB/s; x {rows} x {cols} f32 "
          f"({x.numel() * 4 / 2**20:.0f} MiB)", flush=True)
    nbytes = x.numel() * 4
    for name, (op, factor) in ops.items():
        dt = pass_seconds(op, x)
        gbs = nbytes * factor / dt / 1e9
        print(f"{name:18s}: {dt * 1e3:7.3f} ms/pass  {gbs:7.1f} GB/s "
              f"({100 * gbs / peak:5.1f}% peak)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
