"""Correctness harness: max-abs-diff reporting with hard tolerance asserts.

The port's own copy of the JAX package's ``utils/harness.py`` (NumPy only;
the analog of the reference's worst-index max-abs-diff loops, with real
assertions).
"""

from __future__ import annotations

import numpy as np


def max_abs_diff(a, b) -> tuple[float, tuple]:
    """Max absolute difference and the (unraveled) index where it occurs."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    d = np.abs(a - b)
    idx = np.unravel_index(np.argmax(d), d.shape)
    return float(d[idx]), idx


def diff_report(name: str, got, want) -> str:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mad, idx = max_abs_diff(got, want)
    denom = np.maximum(np.abs(want), 1e-6)
    rel = float(np.max(np.abs(got - want) / denom))
    return (
        f"[{name}] max_abs_diff={mad:.3e} at {idx} "
        f"(got={got[idx]:.6f} want={want[idx]:.6f}) max_rel={rel:.3e}"
    )


def assert_close(got, want, *, atol: float = 2e-2, rtol: float = 2e-2,
                 name: str = "kernel vs oracle") -> None:
    """Hard-asserting comparison with a worst-index diff report on failure.

    Default tolerances reflect bf16 operand rounding (~1e-2 relative); tests
    tighten them where the math is exact.
    """
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, f"shape mismatch {got.shape} vs {want.shape}"
    assert np.all(np.isfinite(got)), f"[{name}] non-finite values in result"
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    if not np.all(ok):
        nbad = int(np.sum(~ok))
        raise AssertionError(
            diff_report(name, got, want)
            + f" — {nbad}/{got.size} elements outside atol={atol} rtol={rtol}"
        )
