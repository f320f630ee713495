"""The MoE feed-forward layers inside the served page: the median over the
traced pages of the summed `model.moe` spans' stream ms (each MoE layer of
the prefill and of every digit)."""

from perfbench.metrics._spans import median_span_ms


def read(run):
    return median_span_ms(run, "engine.recommend", {"model.moe"})
