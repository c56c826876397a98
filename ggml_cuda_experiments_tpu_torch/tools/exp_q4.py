"""The q4_k matvec rungs of the JAX package's ``tools/exp_q4.py`` on the
card: the same logical op y = x @ deq(W)^T, B = 1, K = 4096, through the
stage ladder (``ops/probes.py``, ``csrc/q4_probe.cu``):

    floor    the stream floor (every qs word, es + em): the DMA ceiling
    chunk    lo a + p b on the unpacked bytes, the per-block fold, the
             scales after the sum (the exact f32 matvec)
    chunk32  the same, unpacked byte by byte in int32
    ponly, loonly, nochunk, floorhi, bf16   the stripped stages

    python -m ggml_cuda_experiments_tpu_torch.tools.exp_q4
        [--variants floor,chunk,chunk32] [--check] [--nmarg] [--ctas 0]
        [--cpu] [--rows N]

The default times each variant as the JAX tool does: an inner-count
marginal (chains of 32 and 160 calls, the fold y[:, :K] * 0.03 +
y[:, K:2K] * 0.03 between calls, the activation prep inside each call)
over the full 32768-row weight, here captured as CUDA graphs over weight
copies rotated past the L2 (``utils/bench.py``). ``--nmarg`` takes the
size marginal (8192 against 32768 rows, bench.py's pair protocol) and adds
``vpu2`` (``q4k_matvec``, the production exact-f32 matvec) and ``q8_mxu``
(``q80_matvec``). ``--check`` holds chunk, chunk32 and floorhi within
1e-4 * max and bf16 within 2e-2 * max of the exact f32 reference
(``qmatmul_ref``), and exits 1 past a bound. ``--ctas`` is the ladder's
grid (CTAs per SM; 0: what is resident), the counterpart of the JAX tool's
``--bn``. ``--cpu`` runs the plain versions (default 512 rows) and times
nothing.

The JAX tool's ``pack_xor8`` repacks the bytes to int8 p = lo + 16 hi -
128; here that is ``ops/probes.py`` ``pack_xor8``, which the plain versions
read, while the kernels XOR in registers as the production kernel does.
"""

from __future__ import annotations

import argparse
import sys

import torch

K = 4096
N = 32768
N_SMALL = 8192
VARIANTS = ("floor", "chunk", "chunk32", "ponly", "loonly", "nochunk",
            "bf16", "floorhi")
CHECKS = {"chunk": 1e-4, "chunk32": 1e-4, "floorhi": 1e-4, "bf16": 2e-2}


def log(*a):
    print(*a, flush=True)


def rung(mode: str, ctas: int = 0):
    """fn(x, ql): the activation prep and the ``mode`` rung, one call."""
    from ggml_cuda_experiments_tpu_torch.ops import probes

    def fn(x, ql):
        return probes.ladder(mode, probes.act_operands(mode, x), x, ql, ctas)
    return fn


def inner_rate(fn, ql, x, i1: int = 32, i2: int = 160, reps: int = 4):
    """(seconds per call, GB/s) of ``fn(x, ql)`` by the inner-count
    marginal over rotated copies of ``ql``."""
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    from ggml_cuda_experiments_tpu_torch.utils import bench as ub
    ws = ub.rotating(lambda i: eb.copy_of(ql), ql.nbytes)
    per = ub.chain_marginal(eb.chained(fn, ws, x), i1, i2, reps)
    return per, ql.nbytes / per / 1e9


def check(ql, x, ctas: int = 0) -> bool:
    """The matvec rungs against the exact f32 reference."""
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    want = qm.qmatmul_ref(x, ql, torch.float32)
    scale = float(want.abs().max())
    ok = True
    for mode, tol in CHECKS.items():
        got = rung(mode, ctas)(x, ql)
        err = float((got - want).abs().max())
        good = err <= tol * scale
        ok &= good
        log(f"{mode}: max |diff| {err:.3e}, rel {err / scale:.2e} (bound "
            f"{tol:g} * max) {'ok' if good else 'FAIL'}")
    return ok


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--ctas", type=int, default=0)
    ap.add_argument("--variants", default="floor,chunk,chunk32")
    ap.add_argument("--nmarg", action="store_true")
    ap.add_argument("--rows", type=int, default=None,
                    help=f"weight rows (default {N}; 512 with --cpu)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    from ggml_cuda_experiments_tpu_torch.utils.device_info import (
        card_line, card_spec)
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = torch.device("cpu") if args.cpu else require_cuda()
    n = args.rows or (512 if args.cpu else N)
    w, x0 = eb.draws(0, n)
    x = torch.from_numpy(x0).to(dev)
    ql = qm.quantize(torch.from_numpy(w).to(dev), "q4_k")
    log(f"device: {'cpu (the plain versions; no time)' if args.cpu else card_line()}")
    if args.check:
        return 0 if check(ql, x, args.ctas) else 1
    names = args.variants.split(",")
    if args.cpu:
        for name in names:
            if name in VARIANTS:
                y = rung(name, args.ctas)(x, ql)
                log(f"{name}: ran on [{n}, {K}] -> {tuple(y.shape)}; time "
                    "not measured (CPU)")
        return 0
    peak = card_spec().hbm_bytes_per_s
    if args.nmarg:
        cases = {name: rung(name, args.ctas) for name in VARIANTS}
        cases["vpu2"] = qm.q4k_matvec
        q8 = qm.quantize(torch.from_numpy(w).to(dev), "q8_0")
        for name in names:
            if name not in cases and name != "q8_mxu":
                log(f"{name}: unknown variant")
                continue
            fn, big = ((qm.q80_matvec, q8) if name == "q8_mxu"
                       else (cases[name], ql))
            pct = eb.roofline(f"{name} ctas={args.ctas}", fn, big, x,
                              n_pairs=5, min_valid=3)[0]
            log(f"{name} ctas={args.ctas}: marginal {pct / 100 * peak / 1e9:.1f}"
                f" GB/s ({pct:.1f}% of HBM)")
        return 0
    for name in names:
        if name not in VARIANTS:
            log(f"{name}: unknown variant")
            continue
        per, gbs = inner_rate(rung(name, args.ctas), ql, x)
        log(f"{name} ctas={args.ctas}: {per * 1e6:.2f} us/iter {gbs:.1f} GB/s "
            f"({100 * gbs * 1e9 / peak:.1f}% of HBM)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
