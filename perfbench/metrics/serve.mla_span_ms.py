"""Latent attention inside the served page: the median over the traced
pages of the summed `model.mla` spans' stream ms (each layer's attention in
the prefill and in every digit)."""

from perfbench.metrics._spans import median_span_ms


def read(run):
    return median_span_ms(run, "engine.recommend", {"model.mla"})
