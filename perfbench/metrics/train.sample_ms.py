"""One step's sample alone (draw rows, random crop, tokenize by the
table: `sample_batch`): median host ms with a synchronize on each side."""

from perfbench.metrics._common import median_ms


def read(run):
    return median_ms(run, "train.sample") if run.family == "train" else None
