"""Needed products of the pages in the traced window (harness/flops.py
beam_flops: valid tokens, each beam row's new token once) over its
seconds, as a share of the dense bf16 peak."""

from perfbench.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run, "serve")
