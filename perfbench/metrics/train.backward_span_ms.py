"""The backward inside run_loop's step: the median over the
traced steps of the `train.backward` span's stream ms."""

from perfbench.metrics._spans import median_span_ms


def read(run):
    return median_span_ms(run, "train.step", {"train.backward"})
