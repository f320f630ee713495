"""Share of the traced page loop in which no device operation ran:
100 - (union of kernel, copy and fill intervals) / window."""

from perfbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run, "serve")
