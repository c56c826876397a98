"""What a metric reader sees of a run, and how readers are found.

Every metric, end to end or per layer, is a file ``metrics/<name>.py``
with a function ``read(ctx) -> float | None``; a per-layer metric that
selects kernels by name lists its patterns in ``PATTERNS``. A reader that
finds nothing to read returns None, and the metric is left out of the
line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

from port_bench.lib import stats, work
from port_bench.lib.trace import TraceView
from port_bench.lib.traffic import Request


@dataclasses.dataclass
class Context:
    spec: work.Spec
    mix: dict
    setup_s: float
    weights_s: float
    t0: float = 0.0
    # (request, host start, host end) of every request the window finished
    done: list = dataclasses.field(default_factory=list)
    # the traced requests and the trace (traced run only)
    traced: list[Request] = dataclasses.field(default_factory=list)
    view: TraceView | None = None

    # -- the window ----------------------------------------------------------
    def served_tokens(self, reqs: list[Request]) -> int:
        return sum(max(r.steps, 1) * r.batch for r in reqs)

    def latencies_ms(self) -> list[float]:
        return [1e3 * (e - s) for _, s, e in self.done]

    def tokens_per_s(self) -> float:
        return stats.rate(self.served_tokens([r for r, _, _ in self.done]),
                          self.t0, max(e for _, _, e in self.done))

    # -- the traced requests' work -----------------------------------------
    def decode_contexts(self) -> list[list[int]]:
        """The cached length of each sequence before each decode step the
        traced requests need (the first token comes from the prefill)."""
        return [[r.prompt_len + i] * r.batch for r in self.traced
                for i in range(r.steps - 1)]

    def bound_s(self) -> float:
        """The least time of the traced requests' work on the card."""
        return sum(work.request_bound_s(self.spec, r.prompt_len,
                                        max(r.steps, 1), r.batch)
                   for r in self.traced)

    def linear_steps(self, decode: bool) -> list[tuple[int, int]]:
        """(rows, head rows) of each linear pass of the traced requests:
        their prefills, and with ``decode`` their decode steps."""
        steps = [(r.prompt_len * r.batch, r.batch) for r in self.traced]
        if decode:
            steps += [(len(c), len(c)) for c in self.decode_contexts()]
        return steps

    def idle_pct(self) -> float | None:
        if self.view is None or self.view.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.view.busy_s / self.view.window_s)

    def roofline_pct(self, bound_s: float, patterns: list[str],
                     linear_span: bool = False) -> float | None:
        """``bound_s`` over the device time of the selected kernels."""
        if self.view is None:
            return None
        t = self.view.kernel_s(patterns, linear_span)
        return None if not t else 100.0 * bound_s / t


def load_reader(root: Path, name: str):
    """The module ``port_bench/metrics/<name>.py``."""
    path = root / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
