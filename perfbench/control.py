"""Readings that set a cell's limits, on the card at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        [--program] [--control] [--faults] [--seconds 3]

--program: the port's numbers from short runs (the lower readings);
--control: the reference put in the port's place at the next lower
precision (serving: TF32 for fp32; training: fp8 for bf16), judged as the
port is (the upper readings); --faults: the port with each fault a cell of
its kind can have planted underneath (harness/faults.py). One JSON line per
reading. The benchmark's own runs never run this."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench.harness import faults, runner  # noqa: E402


def control_values(workload, seed, device, overrides=None):
    """The control's [(name, value)] for one seed."""
    _, _, cfg, traffic, limits, kind = runner.load_cell(workload, overrides=overrides)
    run = runner.Run(workload, cfg, traffic, limits, device, seed, 0, False,
                     time.perf_counter())
    run.family = "serve" if traffic["kind"] == "serve_pages" else "train"
    return kind.control(run)


def family_of(workload, overrides=None):
    _, _, _, traffic, _, _ = runner.load_cell(workload, overrides=overrides)
    return "serve" if traffic["kind"] == "serve_pages" else "train"


def program_values(workload, seed, seconds, device, overrides=None, fault=None):
    """A short run's checks [(name, value, limit)], with `fault` planted."""
    plant = None if fault is None else faults.FAULTS[family_of(workload, overrides)][fault]
    run = runner.run_cell(workload, seed, seconds, False, device, time.perf_counter(),
                          overrides=overrides, plant=plant)
    return run.checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        if args.program:
            checks = program_values(args.workload, seed, args.seconds, dev)
            print(json.dumps({"seed": seed, "mode": "program",
                              "values": {n: v for n, v, _ in checks}}), flush=True)
        if args.control:
            values = control_values(args.workload, seed, dev)
            print(json.dumps({"seed": seed, "mode": "control", "values": dict(values)}),
                  flush=True)
        if args.faults:
            for name in faults.FAULTS[family_of(args.workload)]:
                checks = program_values(args.workload, seed, args.seconds, dev, fault=name)
                print(json.dumps({"seed": seed, "mode": f"fault:{name}",
                                  "values": {n: v for n, v, _ in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
