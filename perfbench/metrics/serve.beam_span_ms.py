"""The constrained beam search inside the served page: the median over the
traced pages of the `model.beam` span's stream ms."""

from perfbench.metrics._spans import median_span_ms


def read(run):
    return median_span_ms(run, "engine.recommend", {"model.beam"})
