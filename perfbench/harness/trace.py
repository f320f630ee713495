"""A traced window: torch.profiler over a loop, read back from its Chrome
trace. Device operations are the trace's kernels, copies and fills. The
busy time, the window and the operations come from a profile of device
activity alone, since recording every host operation slows a host-bound
loop (2.5 times for a training step on the H100). A second, shorter
profile with host activity labels each idle stretch of the device by the
harness span and the innermost host operation open at its middle."""

import json
import os
import tempfile
from collections import defaultdict

import torch

from perfbench.harness.stats import gaps, interval_union

SPAN_PREFIX = "perfbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
LABEL_SECONDS = 1.0  # the host-traced loop that labels idle stretches
NAME_CHARS = 160


def span(name: str):
    """A harness span in the traced window (a profiler annotation)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _events(prof):
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def _innermost(host, points):
    """For each point, the name of the innermost host interval holding it
    (per thread by a sweep over nested intervals; across threads the one
    that started last), else None."""
    by_tid = defaultdict(list)
    for s, e, name, tid in host:
        by_tid[tid].append((s, e, name))
    order = sorted(range(len(points)), key=lambda j: points[j])
    best = [None] * len(points)
    for items in by_tid.values():
        items.sort(key=lambda x: (x[0], -x[1]))
        stack, i = [], 0
        for j in order:
            m = points[j]
            while i < len(items) and items[i][0] <= m:
                while stack and stack[-1][1] <= items[i][0]:
                    stack.pop()
                stack.append(items[i])
                i += 1
            while stack and stack[-1][1] <= m:
                stack.pop()
            if stack and (best[j] is None or stack[-1][0] > best[j][0]):
                best[j] = (stack[-1][0], stack[-1][2])
    return [None if b is None else b[1] for b in best]


def summarize(device_events, host_events=None):
    """{busy_s, window_s, device_ops, idle_gaps}, or None
    without device operations. `device_events` (Chrome trace "X" events of
    a device-only profile) give the busy time, the window (first device
    operation's start to the last one's end) and the operations by time;
    `host_events` (a host and device profile of the same loop) label the
    idle stretches by harness span and innermost host operation."""
    device = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in device_events
              if e.get("cat") in DEVICE_CATS]
    if not device:
        return None
    w0, w1 = min(s for s, _, _ in device), max(e for _, e, _ in device)
    by_name = defaultdict(float)
    for s, e, n in device:
        by_name[n[:NAME_CHARS]] += (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": interval_union([(s, e) for s, e, _ in device]) / 1e6,
            "window_s": (w1 - w0) / 1e6, "device_ops": [[n, s] for n, s in top],
            "idle_gaps": idle_labels(host_events or [])}


def idle_labels(events):
    """[[label, seconds]] of the longest idle totals inside the harness
    spans of a host and device trace, by "<span>/<innermost host op>"."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN_PREFIX):]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX)]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    if not spans or not device:
        return []
    w0, w1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid")) for e in events
            if e.get("cat") in HOST_CATS and not e["name"].startswith(SPAN_PREFIX)]
    idle = gaps([(max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1], w0, w1)
    mids = [(a + b) / 2 for a, b in idle]
    ops = _innermost(host, mids)
    span_names = _innermost([(s, e, n, 0) for s, e, n in spans], mids)
    by_gap = defaultdict(float)
    for (a, b), op, sp in zip(idle, ops, span_names):
        by_gap[f"{sp or 'between_spans'}/{op or 'host'}"[:NAME_CHARS]] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]]


def profile(device_loop, host_loop):
    """Trace `device_loop()` with device activity alone (busy time, window
    and operations, with the least host overhead), then `host_loop()` with
    host and device activity (labels of the idle stretches); each loop opens
    harness spans with `span`. The summary; without a card the loops run
    untraced and the summary is None."""
    if not torch.cuda.is_available():
        device_loop()
        host_loop()
        return None
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CUDA]) as prof:
        device_loop()
        torch.cuda.synchronize()
    device_events = _events(prof)
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        host_loop()
        torch.cuda.synchronize()
    return summarize(device_events, _events(prof))
