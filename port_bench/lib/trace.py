"""The traced run's device trace, read from ``torch.profiler``: device
operations and their intervals, kernel launches, the kernels launched
inside the benchmark's own spans, and the breakdown of device time and of
idle gaps.

The profiler's events are first turned into plain ``Event`` records, so the
arithmetic can be tested on synthetic intervals.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re

from port_bench.lib import stats

SPAN_PREFIX = "port_bench."
WINDOW_SPAN = SPAN_PREFIX + "traced"
LINEAR_SPAN = SPAN_PREFIX + "linear"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start: int              # ns
    end: int
    device: bool            # ran on the card (kernel, copy, set)
    corr: int = 0           # correlation id: a launch and its device op


def from_profiler(prof) -> list[Event]:
    """Every event of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = max(e.end_ns(), start + e.duration_ns())
        out.append(Event(e.name(), start, end,
                         str(e.device_type()).endswith("CUDA"),
                         e.correlation_id()))
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class TraceView:
    """The traced window: the span ``WINDOW_SPAN`` and what ran in it."""

    def __init__(self, events: list[Event]):
        win = [e for e in events if not e.device and e.name == WINDOW_SPAN]
        if not win:
            raise ValueError(f"no {WINDOW_SPAN} span in the trace")
        self.lo = min(e.start for e in win)
        self.hi = max(e.end for e in win)
        # the profiler mirrors the host's spans on the device's timeline:
        # they are no device work
        self.device = [e for e in events if e.device
                       and not e.name.startswith(SPAN_PREFIX)
                       and e.end > self.lo and e.start < self.hi]
        self.host = [e for e in events if not e.device
                     and e.end > self.lo and e.start < self.hi]
        spans = sorted((e.start, e.end) for e in self.host
                       if e.name == LINEAR_SPAN)
        starts = [s for s, _ in spans]
        ends = [e for _, e in spans]
        launch = {e.corr: e.start for e in self.host
                  if e.corr and e.name.startswith("cu")}
        self.in_linear = set()
        for corr, t in launch.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < ends[i]:
                self.in_linear.add(corr)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return stats.union_length([(e.start, e.end) for e in self.device],
                                  self.lo, self.hi) / 1e9

    @property
    def kernels(self) -> list[Event]:
        return [e for e in self.device if is_kernel(e.name)]

    def select(self, patterns: list[str], linear_span: bool = False
               ) -> list[Event]:
        """The kernels whose name matches one of ``patterns``, and with
        ``linear_span`` those launched inside the benchmark's span around
        the program's linear products."""
        rx = re.compile("|".join(patterns)) if patterns else None
        return [e for e in self.kernels
                if (rx is not None and rx.search(e.name))
                or (linear_span and e.corr in self.in_linear)]

    def kernel_s(self, patterns: list[str], linear_span: bool = False
                 ) -> float | None:
        """Seconds of the selected kernels, or None where none ran."""
        sel = self.select(patterns, linear_span)
        if not sel:
            return None
        return stats.union_length([(e.start, e.end) for e in sel],
                                  self.lo, self.hi) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps named by the innermost host event open at their start."""
        by = collections.Counter()
        for e in self.device:
            by[e.name] += (min(e.end, self.hi) - max(e.start, self.lo)) / 1e9
        ops = [[n[:160], s] for n, s in by.most_common(top)]
        idle = stats.gaps([(e.start, e.end) for e in self.device],
                          self.lo, self.hi)
        idle.sort(key=lambda g: g[0] - g[1])
        named = []
        for s, e in idle[:top]:
            open_ = [h for h in self.host if h.start <= s < h.end
                     and h.name != WINDOW_SPAN]
            name = max(open_, key=lambda h: h.start).name if open_ else "host"
            named.append([name[:160], (e - s) / 1e9])
        return {"device_ops": ops, "idle_gaps": named}

    def unmatched(self, patterns: list[str], top: int = 20) -> list:
        """The kernels that no pattern matched, by device time."""
        rx = re.compile("|".join(patterns)) if patterns else None
        by = collections.Counter()
        for e in self.kernels:
            if rx is None or not rx.search(e.name):
                by[e.name] += (e.end - e.start) / 1e9
        return [[n[:120], s] for n, s in by.most_common(top)]
