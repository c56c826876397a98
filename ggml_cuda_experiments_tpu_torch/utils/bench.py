"""Benchmark machinery: device time per call from CUDA events, and the
roofline arithmetic.

The port's counterpart of the JAX package's ``utils/bench.py`` (itself the
analog of the reference's cudaEvent rigs with warm-up and repeat). The JAX
version times the host clock around ``block_until_ready``; here the
device's own events bracket ``iters`` calls after ``warmup`` ones, so what
is read is the card's time (host launch overhead is in it only where the
card waits for the host). Shares of the card's peaks come from
``CardSpec`` by the kind of the operations (bf16 / f16 tensor cores, int8,
f32 on the CUDA cores), not from the bf16 rate for every kind.

Below ``bench``, the measuring protocols of the JAX package's bench.py
and probe tools: the interleaved size-marginal pair with its rejection and
median (``pair_protocol``), the inner-count marginal (``chain_marginal``),
the rotation of weight copies past the 50 MB L2 (``rotating``), and the
timer they read: a chain captured once into a CUDA graph and replayed
between CUDA events (``capture``, ``replay_seconds``, and ``time_ms``, the
median of a few replays); host clocks are not used.

A measurement needs the card: ``bench`` and the timers raise without one.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from ggml_cuda_experiments_tpu_torch.utils.device_info import CardSpec, card_spec


@dataclasses.dataclass
class BenchResult:
    name: str
    seconds_per_iter: float
    iters: int
    bytes_per_iter: float = 0.0
    flops_per_iter: float = 0.0
    kind: str = "bf16"                 # "bf16" (also f16), "int8" or "f32"
    spec: CardSpec | None = None

    @property
    def gbytes_per_s(self) -> float:
        return self.bytes_per_iter / self.seconds_per_iter / 1e9

    @property
    def tflops(self) -> float:
        return self.flops_per_iter / self.seconds_per_iter / 1e12

    def _spec(self) -> CardSpec:
        spec = self.spec or card_spec()
        if spec is None:
            raise RuntimeError("no published peaks for this card")
        return spec

    def roofline_bw_pct(self) -> float:
        return 100.0 * (self.bytes_per_iter / self.seconds_per_iter
                        ) / self._spec().hbm_bytes_per_s

    def roofline_flops_pct(self) -> float:
        return 100.0 * (self.flops_per_iter / self.seconds_per_iter
                        ) / self._spec().peak(self.kind)

    def report(self) -> str:
        parts = [f"{self.name}: {self.seconds_per_iter * 1e3:.4f} ms/iter"]
        if self.bytes_per_iter:
            parts.append(f"{self.gbytes_per_s:.1f} GB/s "
                         f"({self.roofline_bw_pct():.1f}% of HBM)")
        if self.flops_per_iter:
            parts.append(f"{self.tflops:.2f} TFLOP/s "
                         f"({self.roofline_flops_pct():.1f}% of the "
                         f"{self.kind} peak)")
        return "  ".join(parts)


def bench(fn, *args, warmup: int = 3, iters: int = 20, name: str = "bench",
          bytes_per_iter: float = 0.0, flops_per_iter: float = 0.0,
          kind: str = "bf16") -> BenchResult:
    """Device time of ``fn(*args)``: ``warmup`` calls, then ``iters`` calls
    between two CUDA events on the current stream, divided by ``iters``."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; a CPU time is no device "
                           "metric")
    if kind not in ("bf16", "int8", "f32"):
        raise ValueError(f"bench: kind bf16, int8 or f32, got {kind!r}")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return BenchResult(name=name,
                       seconds_per_iter=start.elapsed_time(end) / 1e3 / iters,
                       iters=iters, bytes_per_iter=bytes_per_iter,
                       flops_per_iter=flops_per_iter, kind=kind,
                       spec=card_spec())


# ---------------------------------------------------------------------------
# the measuring protocols of the JAX package's bench.py and probe tools:
# pure functions of measured times, and the CUDA-graph timer they read
# ---------------------------------------------------------------------------

L2_ROTATION_BYTES = 160 * 2**20      # copies of a weight past the 50 MB L2


def _need_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; a CPU time is no "
                           "device metric")


def copies_for(nbytes: int, budget: int = L2_ROTATION_BYTES) -> int:
    """How many copies of an ``nbytes`` operand, cycled through, stream
    ``budget`` bytes past the L2 (at least one)."""
    return max(1, -(-budget // max(int(nbytes), 1)))


def rotating(make, nbytes: int, budget: int = L2_ROTATION_BYTES) -> list:
    """``make(i)`` for enough ``i`` (``copies_for``) that a chain cycling
    through them reads every byte from device memory, not from the L2."""
    return [make(i) for i in range(copies_for(nbytes, budget))]


def capture(call, n: int, warmup: int = 2):
    """``call(0) .. call(n - 1)`` captured once into a CUDA graph, after
    ``warmup`` eager calls (outside capture, so kernels are built and the
    allocator holds their blocks) and one replay."""
    _need_card("capture")
    for i in range(warmup):
        call(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            call(i)
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_seconds(graph, reps: int = 1) -> float:
    """Device seconds of one replay of ``graph`` (CUDA events), the least
    of ``reps`` replays."""
    _need_card("replay_seconds")
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def time_ms(call, calls: int = 20, replays: int = 5) -> float:
    """Device ms of one ``call(i)``: ``calls`` calls captured in one CUDA
    graph after 3 eager calls, the graph replayed between CUDA events, the
    median of ``replays`` replays (the smoke's and the timing tools')."""
    graph = capture(call, calls, warmup=3)
    return statistics.median(1e3 * replay_seconds(graph) / calls
                             for _ in range(replays))


def pair_pct(t_small: float, t_big: float, inner: int, dbytes: float,
             peak_bytes_per_s: float) -> float:
    """One interleaved pair's size-marginal rate, as a % of the peak: the
    extra bytes of the big chain over its extra time per call; inf for a
    marginal time that is not positive (bench.py)."""
    per_call = (t_big - t_small) / inner
    if per_call <= 0:
        return float("inf")
    return 100.0 * dbytes / per_call / peak_bytes_per_s


def median_pct(valid: list, rejected: list) -> float:
    """The median of the valid pairs (the upper one of an even count, as
    bench.py takes it). With none valid, bench.py's clamp: the finite
    rejected rates clamped into [0, 100], or 0."""
    if not valid:
        valid = [min(max(p, 0.0), 100.0) for p in rejected
                 if p == p and abs(p) != float("inf")] or [0.0]
    pcts = sorted(valid)
    return pcts[len(pcts) // 2]


def pair_protocol(time_pair, inner: int, dbytes: float,
                  peak_bytes_per_s: float, n_pairs: int = 13,
                  min_valid: int = 7):
    """bench.py's ``roofline_pct`` protocol over ``time_pair() -> (t_small,
    t_big)`` (seconds of the two chains, timed back to back): a pair whose
    marginal rate lies outside (0, 100] % of the peak is rejected and
    another is measured; after ``n_pairs`` pairs it stops once
    ``min_valid`` are valid, and at ``3 n_pairs`` in any case. Returns
    (median %, valid, rejected)."""
    valid, rejected = [], []
    for i in range(3 * n_pairs):
        if i >= n_pairs and len(valid) >= min_valid:
            break
        pct = pair_pct(*time_pair(), inner, dbytes, peak_bytes_per_s)
        (valid if 0.0 < pct <= 100.0 else rejected).append(pct)
    return median_pct(valid, rejected), valid, rejected


def inner_marginal(t1: float, t2: float, i1: int, i2: int) -> float:
    """Seconds per call between chains of ``i1`` and ``i2`` calls
    (shape_probe, q6_probe, membench: the fixed cost cancels)."""
    if i2 <= i1:
        raise ValueError(f"inner_marginal: i2 > i1, got {i1}, {i2}")
    return (t2 - t1) / (i2 - i1)


def chain_marginal(call, i1: int, i2: int, reps: int = 3) -> float:
    """The inner-count marginal on the card: chains of ``i1`` and ``i2``
    calls of ``call(i)``, each captured once and replayed ``reps`` times
    (the least kept); seconds per call."""
    t = {}
    for n in (i1, i2):
        graph = capture(call, n)
        t[n] = replay_seconds(graph, reps)
        del graph
    return inner_marginal(t[i1], t[i2], i1, i2)
