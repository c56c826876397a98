"""The int8-activation q4_k matvec's stage ladder of the JAX package's
``tools/exp_q4_r2.py`` on the card: the same streamed bytes and grid as
``q4k_q8_matvec``, the work added rung by rung (``ops/probes.py``):

    dma      byte 0 of each block, the scales and mins: the stream and
             fixed cost
    zponly   + one int8 dot (p . bq)
    zlonly   + the AND and one dot (lo . aq)
    full     everything: ``q4k_q8_matvec``'s row loop on prepared operands
    noand    both dots on p, no AND
    cols256  full with every dot taken twice (the dot's marginal cost)
    split    p . bq in int8, the low nibbles against a in f32
    full_pre full with the operands quantized once per call by ``q8_prep``
    base     ``q4k_q8_matvec`` itself (each CTA quantizes x)

``onedot``, ``onedot_sub`` and ``subtile`` are accepted and run ``full``:
the JAX rungs of those names compute full's function and differ only in
how they fed the MXU. ``<rung>:<c>`` runs a rung with ``c`` CTAs per SM
(the ladder's grid knob, the counterpart of the JAX tool's bn / vmem
variants; the production kernel has none).

    python -m ggml_cuda_experiments_tpu_torch.tools.exp_q4_r2
        [--probes dma,zponly,full,base] [--inner 96] [--reps 6] [--check]
        [--cpu]

Each rung is timed as the JAX tool's ``measure``: chains of ``--inner``
calls (the prep and the fold inside each) at 8192 and 32768 rows, the
least of ``--reps`` replays of each (CUDA graphs over weight copies
rotated past the L2), their difference over the byte difference.
``--check`` runs every named rung at 2048 rows (the JAX tool's check):
those that compute the matvec are held to ``q4k_q8_matvec`` (full,
cols256, full_pre within 1e-4 * max: their operands and dots are its own)
or, for split, to the exact f32 matvec within 2e-2 * max (the JAX tests'
int8-activation bound); the stripped rungs print their difference, which
is no error. Exit 1 past a bound. ``--cpu``: the plain versions, no time.
"""

from __future__ import annotations

import argparse
import sys

import torch

K = 4096
N_SMALL = 8192
N_BIG = 32768
ALIASES = {"split": "split_f32", "onedot": "full", "onedot_sub": "full",
           "subtile": "full"}
RUNGS = ("dma", "zponly", "zlonly", "full", "noand", "cols256", "split",
         "onedot", "onedot_sub", "subtile", "full_pre", "base")
HELD = {"full": 1e-4, "cols256": 1e-4, "full_pre": 1e-4, "split_f32": 2e-2}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def prep(x: torch.Tensor) -> torch.Tensor:
    """The JAX tool's ``prep``: the int8 operands of x (aq, bq and c, xs,
    sa, sb per block) as the ladder's operand block."""
    from ggml_cuda_experiments_tpu_torch.ops import probes
    return probes.act_operands("full", x)


def parse(name: str):
    """(ladder mode or "full_pre" / "base", ctas) of a --probes entry."""
    rung, _, ctas = name.partition(":")
    if rung not in RUNGS:
        raise ValueError(f"unknown probe {name!r}: one of {', '.join(RUNGS)}"
                         " (optionally :<CTAs per SM>)")
    return ALIASES.get(rung, rung), int(ctas or 0)


def call_for(mode: str, ctas: int):
    """fn(x, ql) of a rung, the activation prep inside."""
    from ggml_cuda_experiments_tpu_torch.ops import probes
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    if mode == "base":
        return qm.q4k_q8_matvec
    if mode == "full_pre":
        return lambda x, ql: probes.full_pre(x, ql, ctas)
    make = prep if mode in probes.INT8_MODES else (
        lambda x: probes.act_operands(mode, x))
    return lambda x, ql: probes.ladder(mode, make(x), x, ql, ctas)


def measure(name: str, fn, ql_big, x, inner: int, reps: int) -> float:
    """% of HBM by the JAX tool's size marginal (least of ``reps`` replays
    at each size)."""
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    from ggml_cuda_experiments_tpu_torch.utils import bench as ub
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_spec
    timed = {}
    for n in (N_SMALL, N_BIG):
        base = eb.rows(ql_big, n)
        ws = ub.rotating(lambda i: eb.copy_of(base), base.nbytes)
        graph = ub.capture(eb.chained(fn, ws, x), inner)
        timed[n] = (ub.replay_seconds(graph, reps), base.nbytes)
        del graph, ws
    (t_s, nb_s), (t_l, nb_l) = timed[N_SMALL], timed[N_BIG]
    per = (t_l - t_s) / inner
    gbs = (nb_l - nb_s) / per / 1e9
    pct = 100.0 * gbs * 1e9 / card_spec().hbm_bytes_per_s
    log(f"{name:24s} {per * 1e6:8.2f} us/Diter  {gbs:7.1f} GB/s "
        f"({pct:5.1f}% of HBM)")
    return pct


def check(names, dev, seed: int = 1) -> bool:
    """Every named rung at 2048 rows against its reference (see above)."""
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    w, x0 = eb.draws(seed, 2048)
    x = torch.from_numpy(x0).to(dev)
    ql = qm.quantize(torch.from_numpy(w).to(dev), "q4_k")
    prod = qm.q4k_q8_matvec(x, ql)
    exact = qm.qmatmul_ref(x, ql, torch.float32)
    ok = True
    for name in names:
        mode, ctas = parse(name)
        if mode == "base":
            continue
        got = call_for(mode, ctas)(x, ql)
        ref = exact if mode == "split_f32" else prod
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if mode in HELD:
            good = err <= HELD[mode] * scale
            ok &= good
            what = (f"bound {HELD[mode]:g} * max of "
                    f"{'the exact matvec' if mode == 'split_f32' else 'q4k_q8_matvec'}"
                    f" {'ok' if good else 'FAIL'}")
        else:
            what = "a stripped stage, not the matvec: not held"
        log(f"  check {name} (mode {mode}): max |diff| {err:.3e} (scale "
            f"{scale:.2f}) {what}")
    return ok


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--inner", type=int, default=96)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--probes", default="dma,zponly,full,base")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = torch.device("cpu") if args.cpu else require_cuda()
    names = args.probes.split(",")
    for name in names:
        parse(name)
    log(f"device: {'cpu (the plain versions; no time)' if args.cpu else card_line()}")
    if args.check:
        return 0 if check(names, dev) else 1
    if args.cpu:
        w, x0 = eb.draws(0, 512)
        x = torch.from_numpy(x0)
        ql = qm.quantize(torch.from_numpy(w), "q4_k")
        for name in names:
            y = call_for(*parse(name))(x, ql)
            log(f"{name}: ran on [512, {K}] -> {tuple(y.shape)}; time not "
                "measured (CPU)")
        return 0
    log(f"K={K}, sizes {N_SMALL}->{N_BIG}, inner={args.inner}")
    w, x0 = eb.draws(0)
    x = torch.from_numpy(x0).to(dev)
    ql = qm.quantize(torch.from_numpy(w).to(dev), "q4_k")
    results = {}
    for name in names:
        mode, ctas = parse(name)
        results[name] = measure(f"{name} (ctas {ctas or 'resident'})",
                                call_for(mode, ctas), ql, x, args.inner,
                                args.reps)
    log("\nsummary: " + "  ".join(f"{k}={v:.1f}%" for k, v in results.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
