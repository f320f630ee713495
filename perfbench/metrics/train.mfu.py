"""Needed products of the steps in the traced window (harness/flops.py:
three times the forward over each step's valid tokens) over its seconds,
as a share of the dense bf16 peak."""

from perfbench.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run, "train")
