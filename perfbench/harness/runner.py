"""One run of one cell: find the cell's configuration, traffic mix, traffic
kind, per-layer readers and limits by name; set up; measure the window (or
trace it); read memory; free the program; check against the reference.

A cell names a configuration (`perfbench/configs/<config>.json`) and a
traffic mix (`perfbench/traffic/<traffic>.json`); the mix names its kind
(`perfbench/kinds/<kind>.py`), the loop that drives the port. Per-layer
metrics are `perfbench/metrics/<metric>.py`, each a `read(run)`; the
limits of the cell's comparison are `perfbench/limits/<cell>.json`."""

import contextlib
import gc
import importlib.util
import json
import time
from pathlib import Path

import torch

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent
WARM_CALLS, TIMED_CALLS = 2, 10  # a layer timed alone: its median of 10 after 2


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(bench, workload: str):
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench, workload: str, section: str):
    """Names of the `section` metrics a cell reports, with their units."""
    return [(m["name"], m["unit"]) for m in bench[section]
            if workload in m.get("workloads", [workload])]


class Run:
    """What one run knows: the cell, its configuration and traffic, the
    device, the seed, and what the run recorded (spans in seconds, counters,
    the trace summary, end-to-end values, the comparison)."""

    def __init__(self, workload, config, traffic, limits, device, seed, seconds, trace,
                 t_process_start):
        self.workload = workload
        self.cfg = config
        self.traffic = traffic
        self.limits = limits
        self.device = torch.device(device)
        self.device_name = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_process_start = t_process_start
        self.family = None          # "serve" or "train", set by the kind
        self.spans = {}             # name -> [seconds]
        self.counters = {}
        self.trace_summary = None
        self.e2e = {}               # name -> value
        self.attempted = 0
        self.failed = 0
        self.checks = []            # (name, value, limit)
        self.memory_peak_bytes = 0

    def add_span(self, name, seconds):
        self.spans.setdefault(name, []).append(float(seconds))

    def timed(self, name, fn):
        """`fn()` called alone TIMED_CALLS times after WARM_CALLS, each
        between two synchronizes, as span `name`."""
        for _ in range(WARM_CALLS):
            fn()
        for _ in range(TIMED_CALLS):
            self.sync()
            t0 = time.perf_counter()
            fn()
            self.sync()
            self.add_span(name, time.perf_counter() - t0)

    @contextlib.contextmanager
    def phase(self, name):
        """Host seconds of a part of set-up, synchronized, as span
        "setup.<name>"."""
        t0 = time.perf_counter()
        yield
        self.sync()
        self.add_span(f"setup.{name}", time.perf_counter() - t0)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_cell(workload: str, overrides=None):
    """(BENCHMARK.json, cell entry, configuration, traffic mix, limits, kind
    module); with
    `overrides` {"config": {...}, "traffic": {...}, "limits": {...}} merged
    over the files' values (the tests' small sizes)."""
    bench = benchmark()
    entry = cell_entry(bench, workload)
    cfg = load_json(PERFBENCH / "configs" / f"{entry['config']}.json")
    traffic = load_json(PERFBENCH / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(PERFBENCH / "limits" / f"{workload}.json")
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    limits = {**limits, **overrides.get("limits", {})}
    kind = load_module(PERFBENCH / "kinds" / f"{traffic['kind']}.py",
                       f"perfbench_kind_{traffic['kind']}")
    return bench, entry, cfg, traffic, limits, kind


def run_cell(workload, seed, seconds, trace, device, t_process_start, overrides=None,
             plant=None, spans=None):
    """Run one cell once; returns the Run. `plant(objects)`, where given,
    patches the kind's program objects before they run (a planted fault);
    `spans` {name: seconds} are parts of set-up the caller timed."""
    t0 = time.perf_counter()
    bench, entry, cfg, traffic, limits, kind = load_cell(workload, overrides)
    run = Run(workload, cfg, traffic, limits, device, seed, seconds, trace, t_process_start)
    for name, value in (spans or {}).items():
        run.add_span(name, value)
    run.add_span("setup.import_port", time.perf_counter() - t0)
    state = kind.setup(run, plant)
    run.sync()
    run.e2e["setup_s"] = time.perf_counter() - t_process_start
    if trace:
        kind.traced_window(run, state)
        run.memory_peak_bytes = _peak(run)
        kind.layer_timings(run, state)
    else:
        kind.window(run, state)
        run.memory_peak_bytes = _peak(run)
    judged = kind.collect(run, state)
    del state
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    kind.check(run, judged)
    return run


def _peak(run):
    if run.device.type != "cuda":
        return 0
    run.sync()
    return int(torch.cuda.max_memory_allocated(run.device))


def per_layer_values(run, bench):
    """{name: (value, unit)} of the cell's per-layer metrics that found
    something to read."""
    out = {}
    for name, unit in metrics_of(bench, run.workload, "per_layer"):
        reader = load_module(PERFBENCH / "metrics" / f"{name}.py",
                             "perfbench_metric_" + name.replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[name] = (float(value), unit)
    return out


def correct(run) -> bool:
    return bool(run.checks) and all(v <= lim for _, v, lim in run.checks)
