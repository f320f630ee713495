"""Whole runs of every cell at small sizes on the CPU (the look for a card
skipped): correct with the port as it is, not correct with the control in
its place or with a fault planted underneath."""

import json
import os
import subprocess
import sys
import time

import pytest

from _tiny import CELLS, cell_of, overrides
from perfbench import control
from perfbench.harness import faults, runner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2 ** 31 + 12345  # seeds may exceed 32 signed bits


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct(cell, trace):
    run = runner.run_cell(cell_of(cell), SEED, 0.3, trace, "cpu", time.perf_counter(),
                          overrides=overrides(cell))
    assert run.checks and runner.correct(run), run.checks
    assert run.attempted > 0
    if trace:
        names = set(runner.per_layer_values(run, runner.benchmark()))
        want = {"serve.encode_ms", "serve.beam_ms", "serve.resolve_ms", "serve.index_build_s"} \
            if run.family == "serve" else {"train.sample_ms", "train.fwd_bwd_ms",
                                           "train.optimizer_ms"}
        assert want <= names  # the device readers find no device trace on the CPU
    else:
        assert run.e2e["setup_s"] > 0
        assert {"serve_users_per_s", "serve_p95_ms"} <= set(run.e2e) \
            if run.family == "serve" else "train_examples_per_s" in run.e2e


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The reference at the next lower precision in the port's place."""
    values = dict(control.control_values(cell_of(cell), 7, "cpu", overrides(cell)))
    limits = runner.load_cell(cell_of(cell))[4]
    assert any(values[k] > limits[k] for k in limits), values


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in faults.FAULTS[control.family_of(cell_of(c))]])
def test_fault_fails(cell, fault):
    run = runner.run_cell(cell_of(cell), 11, 0.3, 0, "cpu", time.perf_counter(),
                          overrides=overrides(cell),
                          plant=faults.FAULTS[control.family_of(cell_of(cell))][fault])
    assert not runner.correct(run), run.checks


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints nothing
    on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, env=env, timeout=120)
    assert "no CUDA device" in res.stderr
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card: a result line with the
    contract's keys, correct, its comparison last."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                          "--seed", "5", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "check" and out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
