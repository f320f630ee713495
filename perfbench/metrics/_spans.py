"""Helpers of the readers of the port's own spans (hidvae_tpu_torch
utils/debug.py `span`, `count`, `records`): the requests of the traced
window's device-only loop and their stream times. Spans record only while a
profiler runs, and a run profiles only its traced window, so the store
holds the device-only loop's roots first (`run.attempted` of them), then
the host-labelled loop's, which are left out. Every helper returns None
where there is nothing to read: no device trace (the CPU, an untraced run)
or a port without spans."""

import statistics


def requests(run, root):
    """[(root record, [its descendants])] of the first `run.attempted` roots
    named `root`, or None."""
    if run.trace_summary is None or not run.attempted:
        return None
    try:
        from hidvae_tpu_torch.utils.debug import records
    except ImportError:  # a port without spans
        return None
    recs = records()
    roots = [r for r in recs if r["parent"] is None and r["name"] == root][:run.attempted]
    if not roots:
        return None
    wanted = {r["request"]: [] for r in roots}
    for r in recs:
        if r["parent"] is not None and r["request"] in wanted:
            wanted[r["request"]].append(r)
    return [(r, wanted[r["request"]]) for r in roots]


def stream_ms(records, names):
    """Stream ms of the records named in `names`, summed; None where one
    has no stream time (off a card) or none is there."""
    times = [r["stream_ms"] for r in records if r["name"] in names]
    if not times or any(t is None for t in times):
        return None
    return sum(times)


def median_span_ms(run, root, names):
    """Median over the requests of their `names` spans' stream ms."""
    reqs = requests(run, root)
    if reqs is None:
        return None
    per = [stream_ms(children, names) for _, children in reqs]
    per = [t for t in per if t is not None]
    return statistics.median(per) if per else None


def lead_gaps_ms(run, root):
    """The roots' lead gaps (device idle between requests) in ms; the first
    root of the store has none."""
    reqs = requests(run, root)
    if reqs is None:
        return None
    gaps = [r["lead_gap_ms"] for r, _ in reqs if r["lead_gap_ms"] is not None]
    return gaps or None
