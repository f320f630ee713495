"""Device idle at the boundary between pages: the median lead gap of the
`engine.recommend` root span (stream ms from the previous page's end to
this page's start) over the traced pages."""

import statistics

from perfbench.metrics._spans import lead_gaps_ms


def read(run):
    gaps = lead_gaps_ms(run, "engine.recommend")
    return None if gaps is None else statistics.median(gaps)
