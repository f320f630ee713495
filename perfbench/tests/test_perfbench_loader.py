"""Cells, configurations, traffic mixes, kinds, per-layer readers and
limits are found by name, and BENCHMARK.json keeps to the contract's
shape."""

import json
import math
import re

import pytest

from perfbench.harness import runner
from perfbench.reference.spec import decoder_spec, vae_spec

BENCH = runner.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    bench, entry, cfg, traffic, limits, kind = runner.load_cell(cell)
    for fn in ("setup", "window", "traced_window", "layer_timings", "collect", "check",
               "control"):
        assert callable(getattr(kind, fn))
    assert limits and all(v >= 0 for v in limits.values())
    for name, _ in runner.metrics_of(bench, cell, "per_layer"):
        reader = runner.load_module(runner.PERFBENCH / "metrics" / f"{name}.py", "m")
        assert callable(reader.read)
    assert cfg["name"] == entry["config"]


def test_a_missing_name_is_refused():
    with pytest.raises(KeyError):
        runner.load_cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        runner.load_module(runner.PERFBENCH / "metrics" / "no_such.py", "m")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in BENCH["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", [c for c in BENCH["configs"]])
def test_config_file_holds_the_widths(config):
    cfg = runner.load_json(runner.ROOT / config["file"])
    assert cfg["name"] == config["name"] and cfg["reduced"] == config["reduced"] == []
    total = sum(math.prod(s) for _, s, _ in vae_spec(cfg) + decoder_spec(cfg))
    assert total > 1_000_000  # published widths, not a toy
