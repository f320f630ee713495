"""One step's forward and backward alone (zero_grad, the train-mode
forward, backward): median host ms with a synchronize on each side."""

from perfbench.metrics._common import median_ms


def read(run):
    return median_ms(run, "train.fwd_bwd") if run.family == "train" else None
