"""Share of the beam rows the decoder runs that are still alive (score
above the off-catalog penalty's half): the `beam.live_rows` counter over
`beam.rows`, summed over the traced pages, in percent."""

from perfbench.metrics._spans import requests


def read(run):
    reqs = requests(run, "engine.recommend")
    if reqs is None:
        return None
    live = sum(r["counts"].get("beam.live_rows", 0) for r, _ in reqs)
    rows = sum(r["counts"].get("beam.rows", 0) for r, _ in reqs)
    return 100.0 * live / rows if rows else None
