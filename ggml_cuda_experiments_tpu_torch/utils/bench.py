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

A measurement needs the card: ``bench`` raises without one.
"""

from __future__ import annotations

import dataclasses

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
