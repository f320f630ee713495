"""Resolving one page's tuples to items (`lookup_items`) alone: median
host ms with a synchronize on each side."""

from perfbench.metrics._common import median_ms


def read(run):
    return median_ms(run, "serve.resolve") if run.family == "serve" else None
