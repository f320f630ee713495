"""Debug metrics and profiling (counterpart of hidvae_tpu/utils/debug.py):
`compute_debug_metrics`, `profile_trace`, the spans and counters (`span`,
`count`, `records`; only while a profiler runs) and `recording` of what
is `note`d."""

import contextlib
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("hidvae_tpu_torch.debug")


def _host(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def compute_debug_metrics(batch, model_output=None, prefix: str = "") -> dict:
    """{"<prefix>_seq_length_p<q>": quantiles (0.25 .. 1) of the rows' token
    counts} and, with `model_output.loss_d`, {"<prefix>_loss_<d>"}."""
    seq_lengths = _host(batch.seq_mask).sum(axis=1).astype(np.float64)
    p = (prefix + "_") if prefix else ""
    out = {
        f"{p}seq_length_p{q}": float(np.quantile(seq_lengths, q))
        for q in [0.25, 0.5, 0.75, 0.9, 1]
    }
    if model_output is not None and getattr(model_output, "loss_d", None) is not None:
        loss_d = _host(model_output.loss_d)
        out.update({f"{p}loss_{d}": float(loss_d[d]) for d in range(len(loss_d))})
    return out


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None, enabled: Optional[bool] = None):
    """torch.profiler (CPU, and CUDA on a card) around a block, writing
    trace_<time>_<pid>.json and spans_<time>_<pid>.json to `log_dir`
    (./profile_traces). On with `enabled` or HIDVAE_PROFILE=1; yields the
    profiler, or None."""
    if enabled is None:
        enabled = os.environ.get("HIDVAE_PROFILE") == "1"
    if not enabled:
        yield None
        return
    log_dir = log_dir or os.path.join(os.getcwd(), "profile_traces")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    stem = f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    path = os.path.join(log_dir, "trace_" + stem)
    logger.info(f"Capturing a torch.profiler trace to {path}")
    clear()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
    prof.trace_path = path
    prof.spans_path = os.path.join(log_dir, "spans_" + stem)
    with open(prof.spans_path, "w") as f:
        json.dump({"dropped": dropped(), "records": records()}, f)


# Spans record only under a profiler: an annotation "hidvae.<name>", the
# host interval and on CUDA a stream event at each end. A root span opens a
# request and a lead gap (stream time since the previous root's end).

SPAN_PREFIX = "hidvae."
MAX_SPANS = 1 << 16  # then spans are counted as dropped: the first records survive
_NOOP = contextlib.nullcontext()


class _Store:
    def __init__(self):
        self.spans, self.stack, self.devices = [], [], set()
        self.dropped, self.requests, self.last_root = 0, 0, None


_STORE = _Store()


def _event(device):
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class _Span:
    __slots__ = ("name", "device", "fields", "store", "index", "parent", "request", "counts",
                 "annotation", "start", "end", "lead", "host_start_ns", "host_end_ns")

    def __init__(self, name, device, fields):
        self.name, self.device, self.fields, self.store = name, device, fields, None

    def __enter__(self):
        st = _STORE
        if len(st.spans) >= MAX_SPANS:
            st.dropped += 1
            return None
        parent = self.parent = st.stack[-1] if st.stack else None
        if parent is None:
            self.request, st.requests = st.requests, st.requests + 1
        else:
            self.request, self.device = parent.request, self.device or parent.device
        self.store, self.index, self.counts = st, len(st.spans), {}
        self.start = self.end = self.lead = self.host_end_ns = None
        self.annotation = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self.annotation.__enter__()
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.device = torch.device(self.device)
            self.start = _event(self.device)
            st.devices.add(self.device)
            last = st.last_root
            if parent is None and last is not None and last.device == self.device:
                self.lead = last.end
        self.host_start_ns = time.perf_counter_ns()
        st.spans.append(self)
        st.stack.append(self)
        return self

    def __exit__(self, *exc):
        st = self.store
        if st is None:
            return False
        self.host_end_ns = time.perf_counter_ns()
        if self.start is not None:
            self.end = _event(self.device)
            if self.parent is None:
                st.last_root = self
        if st.stack and st.stack[-1] is self:
            st.stack.pop()
        self.annotation.__exit__(*exc)
        return False

    def as_dict(self):
        timed = self.start is not None and self.end is not None
        return {"index": self.index, "name": self.name,
                "parent": None if self.parent is None else self.parent.index,
                "request": self.request, "fields": self.fields,
                "host_start_ns": self.host_start_ns, "host_end_ns": self.host_end_ns,
                "stream_ms": self.start.elapsed_time(self.end) if timed else None,
                "lead_gap_ms": None if self.lead is None else self.lead.elapsed_time(self.start),
                "counts": {k: v.item() if isinstance(v, torch.Tensor) else v
                           for k, v in self.counts.items()}}


def tracing() -> bool:
    """Whether spans and counters record: a profiler runs (one C call)."""
    return torch.autograd._profiler_enabled()


def span(name: str, device=None, **fields):
    """A span `name` around a block, keeping `fields` (e.g. digit=i);
    `device` is where its work runs (default: its parent's)."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    return _Span(name, device, fields)


def count(name: str, value):
    """Add a host number, or a device scalar (summed on the device, no
    sync), to counter `name` of the open root span, if any."""
    if _STORE.stack:
        counts = _STORE.stack[0].counts
        counts[name] = counts[name] + value if name in counts else value


def records() -> list:
    """The spans in the order they opened, as dicts (parent: an index, None
    for a root; stream_ms, lead_gap_ms: None where not taken), after one
    synchronize a device."""
    for device in _STORE.devices:
        torch.cuda.synchronize(device)
    return [sp.as_dict() for sp in _STORE.spans]


def dropped() -> int:
    """Spans not recorded since the last `clear`: the store was full."""
    return _STORE.dropped


def clear():
    """Empty the store."""
    global _STORE
    _STORE = _Store()


_NOTES = None  # the open recorder: references, no copy, no sync


@contextlib.contextmanager
def recording():
    """Yield [(name, value)] of every `note` inside (the MoE layers' chosen
    experts, the beam's rows)."""
    global _NOTES
    outer, _NOTES = _NOTES, []
    try:
        yield _NOTES
    finally:
        _NOTES = outer


def note(name: str, value):
    """Hand `value` to the open recorder, if any."""
    if _NOTES is not None:
        _NOTES.append((name, value))
