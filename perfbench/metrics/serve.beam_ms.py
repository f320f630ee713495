"""The constrained beam search of one page alone: the median host ms of
`generate_next_sem_id` (which runs the encoder) less `serve.encode_ms`."""

from perfbench.metrics._common import median_ms


def read(run):
    whole = median_ms(run, "serve.generate")
    encode = median_ms(run, "serve.tokenize_encode")
    if run.family != "serve" or whole is None or encode is None:
        return None
    return whole - encode
