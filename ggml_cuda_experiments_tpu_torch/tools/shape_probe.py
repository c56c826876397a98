"""The int8-activation q4_k matvec at the 7B decode shapes on the card: the
port's counterpart of the JAX package's ``tools/shape_probe.py``.

    python -m ggml_cuda_experiments_tpu_torch.tools.shape_probe
        [--shapes wqkv,wo,wgu,wdown] [--preprep] [--ctas 0,1,2]
        [--i1 128] [--i2 2048] [--reps 5] [--cpu]

Per shape (wqkv 12288 x 4096, wo 4096 x 4096, w_gu 24576 x 4096, w_down
4096 x 12288) it times ``q4k_q8_matvec`` (each CTA quantizes x into its
own shared memory) by the inner-count marginal: chains of ``--i1`` and
``--i2`` calls with the JAX tool's fold between calls (the sum of y's two
first K-slices, or y tiled up to K, times 0.03), captured as CUDA graphs
over weight copies rotated past the 50 MB L2, the least of ``--reps``
replays. ``--preprep`` adds, at each ``--ctas`` (the ladder's CTAs per SM;
0: what is resident; the counterpart of the JAX tool's ``--bns``),
``full_pre`` (x quantized once per call into device memory by ``q8_prep``,
then the ``full`` rung) and the ``full`` rung with the prep hoisted out of
the chain altogether, the JAX tool's ``--preprep``. ``--cpu`` checks
``full_pre`` against ``q4k_q8_matvec`` (the plain versions, bit for bit)
at each shape cut to 256 rows, and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096),
          "wgu": (24576, 4096), "wdown": (4096, 12288)}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fold(y: torch.Tensor, k: int) -> torch.Tensor:
    """The JAX tool's fold of y [1, N] into the next x [1, K]."""
    n = y.shape[1]
    if n >= 2 * k:
        v = y[:, :k] + y[:, k:2 * k]
    elif n >= k:
        v = y[:, :k]
    else:
        v = y.repeat(1, -(-k // n))[:, :k]
    return (v * 0.03).float()


def weight(n: int, k: int, dev, seed: int = 0):
    """(q4_k weight, x) of one shape from the JAX tool's draws."""
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    x = rng.normal(size=(1, k)).astype(np.float32)
    return (qm.quantize(torch.from_numpy(w).to(dev), "q4_k"),
            torch.from_numpy(x).to(dev))


def rate(name: str, fn, ql, x, i1: int, i2: int, reps: int) -> float:
    """% of HBM of fn(x, w) by the inner-count marginal."""
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    from ggml_cuda_experiments_tpu_torch.utils import bench as ub
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_spec
    n, k = ql.array_shape
    ws = ub.rotating(lambda i: eb.copy_of(ql), ql.nbytes)
    state = [x]

    def call(i):
        state[0] = fold(fn(x if i == 0 else state[0], ws[i % len(ws)]), k)

    per = ub.chain_marginal(call, i1, i2, reps)
    gbs = ql.nbytes / per / 1e9
    pct = 100.0 * gbs * 1e9 / card_spec().hbm_bytes_per_s
    log(f"{name:34s} N={n:6d} K={k:6d} ({len(ws)} copies): {per * 1e6:8.2f} "
        f"us/iter {gbs:7.1f} GB/s ({pct:5.1f}%)")
    return pct


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--shapes", default="wqkv,wo,wgu,wdown")
    ap.add_argument("--ctas", default="0")
    ap.add_argument("--i1", type=int, default=128)
    ap.add_argument("--i2", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--preprep", action="store_true")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.ops import probes
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = torch.device("cpu") if args.cpu else require_cuda()
    log(f"device: {'cpu (the plain versions; no time)' if args.cpu else card_line()}")
    results = {}
    for s in args.shapes.split(","):
        n, k = SHAPES[s]
        if args.cpu:
            ql, x = weight(256, k, dev)
            same = torch.equal(probes.full_pre(x, ql), qm.q4k_q8_matvec(x, ql))
            log(f"{s}: full_pre {'equals' if same else 'DIFFERS from'} "
                f"q4k_q8_matvec at [256, {k}]; time not measured (CPU)")
            if not same:
                return 1
            continue
        ql, x = weight(n, k, dev)
        results[s] = {"q4k_q8_matvec": rate(
            f"{s} q4k_q8_matvec", qm.q4k_q8_matvec, ql, x, args.i1, args.i2,
            args.reps)}
        if not args.preprep:
            continue
        act = probes.q8_prep(x)
        for c in (int(v) for v in args.ctas.split(",")):
            tag = f"ctas {c or 'resident'}"
            results[s][f"full_pre {tag}"] = rate(
                f"{s} full_pre {tag}",
                lambda x_, w, c=c: probes.full_pre(x_, w, c), ql, x, args.i1,
                args.i2, args.reps)
            # the prep hoisted out of the chain: x (and so y) carried only
            # as a data dependency, as the JAX tool's 1e-30 perturbation
            results[s][f"full [preprep] {tag}"] = rate(
                f"{s} full [preprep] {tag}",
                lambda x_, w, c=c: probes.ladder("full", act, x_, w, c), ql,
                x, args.i1, args.i2, args.reps)
    if results:
        log(f"summary: {results}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
