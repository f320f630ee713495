"""Tokenize + encoder of one page, called alone: median host ms with a
synchronize on each side (RetrievalEngine step, `tokenize_on_device` then
`encode_context`)."""

from perfbench.metrics._common import median_ms


def read(run):
    return median_ms(run, "serve.tokenize_encode") if run.family == "serve" else None
