"""The JAX package's Mosaic probes (``tools/probe_mosaic_r3.py``) through
the port's kernels (``ops/mosaic_probes.py``): each runs its kernel on the
JAX probe's input and checks the result exactly against NumPy.

    python -m ggml_cuda_experiments_tpu_torch.tools.probe_mosaic_r3 [--cpu]

Prints one line a probe, ``<name>: OK`` or ``WRONG RESULT`` or ``FAIL
<error>``, and exits 1 unless all are OK. The JAX tool asked whether Mosaic
lowers each op at all; Hopper lowers all of them, so the question left is
the last probe's, in the card's terms: the marginal cost of one tiny
launch, eager (chains of 64 and 256 launches between CUDA events, the card
waiting on the host's launches) against replayed in a CUDA graph (the same
chains captured once). ``--cpu`` runs the plain versions and times
nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def probe_transpose_dot(dev):
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    x = np.arange(32 * 128, dtype=np.float32).reshape(32, 128)
    e = np.eye(32, dtype=np.float32)
    out = mp.transpose_dot(_t(x, dev), _t(e, dev)).cpu().numpy()
    return np.array_equal(out, x.T)


def probe_lane_concat(dev):
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    x = np.arange(128 * 32, dtype=np.float32).reshape(128, 32)
    xpad = np.zeros((128, 128), np.float32)
    xpad[:, :32] = x
    out = mp.lane_concat(_t(xpad, dev)).cpu().numpy()
    ref = np.concatenate([x[32 * c:32 * (c + 1)] for c in range(4)], axis=1)
    return np.array_equal(out, ref)


def probe_roll64(dev):
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    x = np.arange(32 * 128, dtype=np.float32).reshape(32, 128)
    return np.array_equal(mp.roll64(_t(x, dev)).cpu().numpy(),
                          np.roll(x, 64, axis=1))


def probe_dyn_sublane(dev):
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    x = np.arange(32 * 128, dtype=np.float32).reshape(32, 128)
    return np.array_equal(mp.dyn_sublane(_t(x, dev)).cpu().numpy(), x * 2.0)


def probe_lane_extract(dev):
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    x = np.arange(4096, dtype=np.float32).reshape(1, 4096)
    return np.array_equal(mp.lane_extract(_t(x, dev)).cpu().numpy(),
                          x.reshape(32, 128))


def probe_read_output_ref(dev):
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    x = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    out, kept = mp.read_output(_t(x, dev))
    return (np.array_equal(out.cpu().numpy(), x * 3.0 + 1.0)
            and np.array_equal(kept.cpu().numpy(), x * 3.0))


def call_overhead(dev, n_small: int = 64, n_big: int = 256, reps: int = 5):
    """(eager, graph) seconds per tiny launch: the marginal between chains
    of ``n_small`` and ``n_big`` launches of ``tiny_call`` on [8, 128],
    each chain's least of ``reps`` runs between CUDA events."""
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    from ggml_cuda_experiments_tpu_torch.utils import bench as ub
    x0 = torch.ones((8, 128), dtype=torch.float32, device=dev)

    def chain(n):
        x = x0
        for _ in range(n):
            x = mp.tiny_call(x)
        return x

    def eager(n):
        chain(n)
        best = float("inf")
        for _ in range(reps):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            s.record()
            chain(n)
            e.record()
            e.synchronize()
            best = min(best, s.elapsed_time(e) / 1e3)
        return best

    t_eager = ub.inner_marginal(eager(n_small), eager(n_big), n_small, n_big)
    state = [x0]

    def call(i):
        state[0] = mp.tiny_call(x0 if i == 0 else state[0])

    t_graph = ub.chain_marginal(call, n_small, n_big, reps)
    return t_eager, t_graph


def probe_call_overhead(dev):
    """The tiny-call probe: its result exact, then (on the card) its
    marginal launch cost eager and in a graph."""
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    x = np.linspace(-3, 3, 8 * 128, dtype=np.float32).reshape(8, 128)
    ok = np.array_equal(mp.tiny_call(_t(x, dev)).cpu().numpy(),
                        x * np.float32(1.0001))
    if dev.type == "cpu":
        print("  tiny-call marginal cost: not measured (CPU)")
        return ok
    t_eager, t_graph = call_overhead(dev)
    print(f"  tiny-call marginal cost: eager {t_eager * 1e6:.2f} us, in a "
          f"CUDA graph {t_graph * 1e6:.2f} us")
    return ok


PROBES = (("transpose_dot (0,0)", probe_transpose_dot),
          ("lane_concat 32x4", probe_lane_concat),
          ("roll 64 lanes", probe_roll64),
          ("dyn sublane slice", probe_dyn_sublane),
          ("lane extract 128h", probe_lane_extract),
          ("read output ref across steps", probe_read_output_ref),
          ("tiny-call overhead", probe_call_overhead))


def run(name, fn, dev) -> bool:
    try:
        ok = bool(fn(dev))
        print(f"{name}: {'OK' if ok else 'WRONG RESULT'}", flush=True)
        return ok
    except Exception as e:                      # the probe's own report
        msg = str(e).replace("\n", " ")[:160]
        print(f"{name}: FAIL {msg}", flush=True)
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = torch.device("cpu") if args.cpu else require_cuda()
    print(f"device: {'cpu (the plain versions)' if args.cpu else card_line()}",
          flush=True)
    results = [run(name, fn, dev) for name, fn in PROBES]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
