"""Tokenize and encoder inside the served page: the median over the traced
pages of the stream ms of the `engine.tokenize` and `model.encode` spans."""

from perfbench.metrics._spans import median_span_ms


def read(run):
    return median_span_ms(run, "engine.recommend", {"engine.tokenize", "model.encode"})
