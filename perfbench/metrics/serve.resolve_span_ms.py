"""Resolving tuples to items inside the served page: the median over the
traced pages of the `engine.resolve` span's stream ms."""

from perfbench.metrics._spans import median_span_ms


def read(run):
    return median_span_ms(run, "engine.recommend", {"engine.resolve"})
