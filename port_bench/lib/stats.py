"""The arithmetic of the end-to-end metrics and of the trace: percentiles,
a rate over a window, and the union of busy intervals and its gaps.
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by nearest rank: the least value that
    at least q% of the values do not exceed. Over whole blocks of a mix
    whose ``points`` times q/100 is a whole number it is the same point's
    latency however many blocks the window holds."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(1, math.ceil(len(xs) * q / 100.0 - 1e-9)) - 1]


def rate(units: float, t_start: float, t_end: float) -> float:
    """Units completed over the window from its start to the last
    completion."""
    if t_end <= t_start:
        raise ValueError("a window that never completed a request")
    return units / (t_end - t_start)


def union_length(intervals, lo: float | None = None,
                 hi: float | None = None) -> float:
    """The length of the union of [start, end) intervals, clipped to
    [lo, hi] where given."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi] that no interval covers, as
    (start, end)."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]

