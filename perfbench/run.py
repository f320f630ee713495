"""Run one cell of BENCHMARK.json once on the card this process finds:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object, the last line of standard output,
and the compared numbers with their limits as the last lines of standard
error. Exits non-zero without a result when there is no CUDA device, when
the cell asks for more cards than there are, or when JAX or the JAX package
was loaded in this process."""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The bytecode of every module a run imports, torch's too (an installation
# may ship without it and forbid writing it, and then each run compiles
# some thousands of files), cached at a fixed path inside the checkout: only
# a checkout's first run compiles it.
sys.pycache_prefix = os.path.join(ROOT, "__pycache__", "perfbench_prefix")
sys.dont_write_bytecode = False
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from perfbench.harness import guard, runner  # noqa: E402


def process_age() -> float:
    """Seconds since this process started (from /proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK")) - (
            time.perf_counter() - _T0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = _T0 - process_age()
    t_main = time.perf_counter()
    bench = runner.benchmark()
    entry = runner.cell_entry(bench, args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.init()
    spans = {"setup.to_main": t_main - t_start, "setup.cuda_init": time.perf_counter() - t_main}
    run = runner.run_cell(args.workload, args.seed, args.seconds, args.trace,
                          torch.device("cuda", 0), t_start, spans=spans)
    found = guard.forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result(run, bench, entry)))
    for name, xs in run.spans.items():
        xs = sorted(xs)
        print(f"span {name} n {len(xs)} min {xs[0]:.4f} median {xs[len(xs) // 2]:.4f} "
              f"max {xs[-1]:.4f} s", file=sys.stderr)
    for name, value in run.counters.items():
        if not name.endswith("needed_flops"):
            print(f"counter {name} {value}", file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


def result(run, bench, entry):
    """The result object of a finished run, its comparison last."""
    if run.trace:
        values = runner.per_layer_values(run, bench)
    else:
        values = {name: (run.e2e[name], unit)
                  for name, unit in runner.metrics_of(bench, run.workload, "end_to_end")
                  if name in run.e2e}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": run.device_name, "count": entry["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": runner.correct(run), "attempted": run.attempted, "failed": run.failed,
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items()},
           "device": device}
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
        out["breakdown"] = {"device_ops": run.trace_summary["device_ops"],
                            "idle_gaps": run.trace_summary["idle_gaps"]}
    out["check"] = {name: {"value": value, "limit": limit}
                    for name, value, limit in run.checks}
    return out


if __name__ == "__main__":
    sys.exit(main())
