"""Device idle between training steps that no step covers: the mean lead
gap of the `train.step` root span over the traced steps, so the gaps at
the chunks' boundaries are spread over every step."""

import statistics

from perfbench.metrics._spans import lead_gaps_ms


def read(run):
    gaps = lead_gaps_ms(run, "train.step")
    return None if gaps is None else statistics.fmean(gaps)
