"""Helpers of the per-layer readers: medians of harness spans, shares of
the traced window."""

import statistics

from perfbench.harness.peaks import peaks_for


def median_ms(run, span):
    """Median of a span's timed calls in ms, or None when it was not timed."""
    xs = run.spans.get(span)
    return None if not xs else statistics.median(xs) * 1e3


def idle_pct(run, family):
    t = run.trace_summary
    if run.family != family or t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(run, family):
    """Needed products of the traced window over its seconds, as a share of
    the card's dense bf16 peak."""
    t = run.trace_summary
    count = run.counters.get(f"{family}.needed_flops")
    peaks = peaks_for(run.device_name)
    if run.family != family or t is None or not count or peaks is None:
        return None
    return 100.0 * count / t["window_s"] / peaks["bf16_flops"]
