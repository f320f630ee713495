"""One AdamW update alone (`Optimizer.step`): median host ms with a
synchronize on each side."""

from perfbench.metrics._common import median_ms


def read(run):
    return median_ms(run, "train.optimizer") if run.family == "train" else None
