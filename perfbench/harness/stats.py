"""Order statistics the benchmark reports and judges bounds by."""

import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of `values`, linearly interpolated
    between the closest ranks (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def quartile_spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median, by `statistics.quantiles(values, n=4)`."""
    q1, med, q3 = statistics.quantiles([float(v) for v in values], n=4)
    return (q3 - q1) / abs(med)


def interval_union(intervals):
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start, end):
    """The idle stretches [a, b) of [start, end) that no interval covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(a, b) for a, b in out if b > a]
