"""Readings that set the limits of a cell of the `serve_pages_mla_moe` kind,
on the card at the cell's own size:

    python3 perfbench/control_mla_moe.py --workload moonlight_p5sports.serve_b256 \
        --seeds 11,12,13 [--program] [--control] [--faults token,half,bias,edge] \
        [--beam-tie 0.03] [--seconds 3]

As `control.py` (whose functions it uses), with the serving family and the
kind's own faults (`FAULTS`: harness/faults.py's serve token and half, the
routing bias left out of the choice, wrong rows at the beam's edge).
`--beam-tie` sets the reference's BEAM_TIE for these readings. The port's
readings also print the check's diagnostic counters (the largest routing
deficit the reference followed, the furthest below its edge its beam kept
a held row). One JSON line per reading. The benchmark's own runs never run
this."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench import control  # noqa: E402
from perfbench.harness import runner  # noqa: E402
from perfbench.reference import mla_moe as ref  # noqa: E402


def program_values(workload, seed, seconds, device, overrides=None, fault=None):
    """(checks [(name, value, limit)], diagnostic counters) of a short run,
    with the kind's fault `fault` planted."""
    kind = runner.load_cell(workload, overrides=overrides)[5]
    run = runner.run_cell(workload, seed, seconds, False, device, time.perf_counter(),
                          overrides=overrides,
                          plant=None if fault is None else kind.FAULTS[fault])
    return run.checks, {k: v for k, v in run.counters.items() if k.startswith("check.")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="", help="comma-separated names of FAULTS")
    p.add_argument("--beam-tie", type=float, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.beam_tie is not None:
        ref.BEAM_TIE = args.beam_tie
    tie = {"beam_tie": ref.BEAM_TIE}
    for seed in [int(s) for s in args.seeds.split(",")]:
        modes = (["program"] if args.program else []) + [
            f"fault:{f}" for f in args.faults.split(",") if f]
        for mode in modes:
            checks, diag = program_values(args.workload, seed, args.seconds, dev,
                                          fault=mode[6:] if mode != "program" else None)
            print(json.dumps({"seed": seed, "mode": mode, **tie,
                              "values": {n: v for n, v, _ in checks}, **diag}), flush=True)
        if args.control:
            values = control.control_values(args.workload, seed, dev)
            print(json.dumps({"seed": seed, "mode": "control", **tie,
                              "values": dict(values)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
