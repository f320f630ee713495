"""Percentiles, quartile spreads, interval unions and the trace summary's
busy time, idle gaps and their labels."""

import statistics

import numpy as np
import pytest

from perfbench.harness import trace
from perfbench.harness.stats import gaps, interval_union, percentile, quartile_spread


def test_percentile_matches_numpy():
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0]
    for q in (5, 50, 95, 99):
        assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_quartile_spread_uses_statistics_quantiles():
    xs = [10.0, 11.0, 12.0, 13.0, 20.0, 9.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert quartile_spread(xs) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert interval_union(iv) == pytest.approx(5.0)
    assert gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert gaps(iv, -1, 1) == [(-1, 0)]


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_summary_busy_idle_and_labels():
    events = [
        _x("perfbench.page", "user_annotation", 0, 100),
        _x("aten::mm", "cpu_op", 5, 10),
        _x("aten::item", "cpu_op", 50, 30),
        _x("gemm_kernel", "kernel", 10, 30, tid=7),
        _x("gemm_kernel", "kernel", 40, 5, tid=7),
        _x("copy", "gpu_memcpy", 85, 10, tid=7),
        _x("outside", "kernel", 200, 50, tid=7),
    ]
    device = [e for e in events if e["cat"] in ("kernel", "gpu_memcpy")
              and e["name"] != "outside"]
    s = trace.summarize(device, events)
    assert s["window_s"] == pytest.approx(85e-6)  # first device op's start to the last's end
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["device_ops"][0] == ["gemm_kernel", pytest.approx(35e-6)]
    labels = dict(s["idle_gaps"])
    assert labels["page/aten::item"] == pytest.approx(40e-6)   # 45..85
    assert labels["page/aten::mm"] == pytest.approx(10e-6)    # 0..10, middle in the mm
    assert labels["page/host"] == pytest.approx(5e-6)          # 95..100


def test_summary_without_device_work_is_none():
    assert trace.summarize([_x("perfbench.page", "user_annotation", 0, 10)]) is None
    assert trace.idle_labels([_x("gemm", "kernel", 0, 10)]) == []  # no harness span
