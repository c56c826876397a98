"""Percentiles, rates, the idle union and the trace reader on synthetic
intervals."""

import pytest

from port_bench.lib import stats
from port_bench.lib.trace import LINEAR_SPAN, WINDOW_SPAN, Event, TraceView


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(list(range(1, 21)), 95) == 19
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5.0, 1.0], 50) == 1.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate_over_the_window():
    assert stats.rate(300, 10.0, 12.0) == 150.0
    with pytest.raises(ValueError):
        stats.rate(1, 5.0, 5.0)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 7), (10, 12)]
    assert stats.union_length(iv) == 3 + 2 + 2
    assert stats.union_length(iv, 1, 11) == 2 + 2 + 1
    assert stats.gaps(iv, 0, 12) == [(3, 5), (7, 10)]
    # a stalled window: one launch, then nothing
    assert stats.union_length([(0, 1)], 0, 100) == 1
    assert stats.gaps([(0, 1)], 0, 100) == [(1, 100)]


def _view():
    ev = [Event(WINDOW_SPAN, 0, 1000, False),
          Event(LINEAR_SPAN, 100, 200, False),
          Event("aten::mul", 300, 380, False),
          Event("cudaLaunchKernel", 110, 112, False, corr=1),
          Event("cudaLaunchKernel", 310, 312, False, corr=2),
          Event("cudaGraphLaunch", 400, 405, False, corr=3),
          Event("elementwise_kernel<dequant>", 120, 220, True, corr=1),
          Event("elementwise_kernel<mul>", 320, 340, True, corr=2),
          Event("void gemm_tc_kernel<Q4K>", 500, 700, True, corr=3),
          Event("Memcpy DtoH", 700, 750, True, corr=4),
          Event("void late_kernel", 990, 1100, True, corr=5)]
    return TraceView(ev)


def test_trace_view_busy_idle_and_selection():
    v = _view()
    assert v.window_s == 1e-6
    assert v.busy_s == pytest.approx((100 + 20 + 250 + 10) / 1e9)
    assert len(v.kernels) == 4
    assert v.kernel_s([r"gemm_tc"]) == pytest.approx(200e-9)
    # the launch inside the linear span counts, the other does not
    assert v.kernel_s([r"gemm_tc"], linear_span=True) == pytest.approx(
        300e-9)
    assert v.kernel_s([r"nothing"]) is None
    b = v.breakdown()
    assert b["device_ops"][0] == ["void gemm_tc_kernel<Q4K>", 200e-9]
    # the longest gap [750, 990) is named by the host event open at 750
    assert b["idle_gaps"][0][1] == pytest.approx(240e-9)
    names = [n for n, _ in v.unmatched([r"gemm_tc"])]
    assert "void gemm_tc_kernel<Q4K>" not in names
    assert "elementwise_kernel<dequant>" in names


def test_trace_view_needs_its_window():
    with pytest.raises(ValueError):
        TraceView([Event("k", 0, 1, True)])


def test_readings_widest_and_mean():
    import run
    from port_bench.lib import judge
    g = {"served": [0.0, 0.2, 0.1, 0.0], "control": [0.5, 0.0, 0.3, 0.4]}
    r = judge.readings(g)
    assert r["widest_logit_gap"] == 0.2 and r["judged"] == 4
    assert r["mean_logit_gap"] == pytest.approx(0.075)
    assert r["control"] == {"widest_logit_gap": 0.5,
                            "mean_logit_gap": pytest.approx(0.3)}
    assert judge.readings({**g, "control": None})["control"] is None
    # the comparison a run makes: every number within its limit
    checks, ok = run.decide({"mean_logit_gap": 0.1}, r, 0)
    assert ok and list(checks) == ["mean_logit_gap", "wrong_answers"]
    assert not run.decide({"mean_logit_gap": 0.1}, r["control"], 0)[1]
    assert not run.decide({"mean_logit_gap": 0.1}, r, 1)[1]
