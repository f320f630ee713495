"""The readers of the port's spans on a fake run whose store holds known
records: the device-only loop's requests only (the first `run.attempted`
roots), sums, medians and the mean gap, and nothing read without records,
without a device trace or from a port without spans."""

from types import SimpleNamespace

import pytest

from hidvae_tpu_torch.utils import debug
from perfbench.harness import runner

SERVE = ("serve.encode_span_ms", "serve.beam_span_ms", "serve.resolve_span_ms",
         "serve.page_gap_ms", "serve.beam_live_rows_pct")
TRAIN = ("train.sample_span_ms", "train.forward_span_ms", "train.backward_span_ms",
         "train.optimizer_span_ms", "train.step_gap_ms")


def reader(name):
    return runner.load_module(runner.PERFBENCH / "metrics" / f"{name}.py",
                              "perfbench_metric_" + name.replace(".", "_"))


def store(roots):
    """Records as `records()` gives them, from [(root name, lead gap, counts,
    [(child name, stream ms)])]."""
    recs = []
    for request, (name, gap, counts, children) in enumerate(roots):
        root = len(recs)
        recs.append({"index": root, "name": name, "parent": None, "request": request,
                     "fields": {}, "host_start_ns": 0, "host_end_ns": 1,
                     "stream_ms": 1000.0, "lead_gap_ms": gap, "counts": counts})
        for child, ms in children:
            recs.append({"index": len(recs), "name": child, "parent": root,
                         "request": request, "fields": {}, "host_start_ns": 0,
                         "host_end_ns": 1, "stream_ms": ms, "lead_gap_ms": None,
                         "counts": {}})
    return recs


def page(gap, tok, enc, beam, resolve, live, rows):
    return ("engine.recommend", gap, {"beam.live_rows": live, "beam.rows": rows},
            [("engine.pad", 0.1), ("engine.tokenize", tok), ("model.encode", enc),
             ("model.beam", beam), ("model.beam.digit", beam / 2),
             ("model.beam.digit", beam / 2), ("engine.resolve", resolve)])


def step(gap, sample, fwd, bwd, opt, readback=False):
    children = [("train.sample", sample), ("train.forward", fwd), ("train.backward", bwd),
                ("train.optimizer", opt)]
    return ("train.step", gap, {}, children + ([("train.readback", 5.0)] if readback else []))


def fake_run(attempted, traced=True):
    return SimpleNamespace(attempted=attempted,
                           trace_summary={"busy_s": 1.0, "window_s": 2.0} if traced else None)


def read_all(names, run, recs, monkeypatch):
    monkeypatch.setattr(debug, "records", lambda: recs)
    return {name: reader(name).read(run) for name in names}


def test_serve_readers_take_the_device_only_pages(monkeypatch):
    # three pages of the device-only loop, then one of the host-labelled loop
    recs = store([page(None, 1.0, 10.0, 100.0, 4.0, 30, 64),
                  page(0.5, 2.0, 20.0, 300.0, 6.0, 40, 64),
                  page(0.25, 3.0, 30.0, 200.0, 5.0, 50, 64),
                  page(99.0, 90.0, 900.0, 9000.0, 90.0, 0, 64)])
    got = read_all(SERVE, fake_run(3), recs, monkeypatch)
    assert got == {"serve.encode_span_ms": 22.0, "serve.beam_span_ms": 200.0,
                   "serve.resolve_span_ms": 5.0, "serve.page_gap_ms": 0.375,
                   "serve.beam_live_rows_pct": pytest.approx(100.0 * 120 / 192)}


def test_train_readers_take_the_device_only_steps(monkeypatch):
    recs = store([step(None, 1.0, 20.0, 40.0, 2.0), step(0.1, 3.0, 22.0, 44.0, 4.0),
                  step(0.2, 2.0, 21.0, 42.0, 3.0), step(2.7, 4.0, 30.0, 50.0, 5.0, True),
                  step(50.0, 9.0, 90.0, 90.0, 9.0, True)])
    got = read_all(TRAIN, fake_run(4), recs, monkeypatch)
    assert got == {"train.sample_span_ms": 2.5, "train.forward_span_ms": 21.5,
                   "train.backward_span_ms": 43.0, "train.optimizer_span_ms": 3.5,
                   "train.step_gap_ms": pytest.approx(1.0)}


@pytest.mark.parametrize("case", ["no records", "no device trace", "no stream times",
                                  "no spans in the port"])
def test_readers_read_nothing_without_records(case, monkeypatch):
    recs = store([page(None, 1.0, 10.0, 100.0, 4.0, 30, 64), step(None, 1.0, 2.0, 3.0, 4.0)])
    run = fake_run(1, traced=case != "no device trace")
    if case == "no records":
        recs = []
    elif case == "no stream times":
        for r in recs:
            r["stream_ms"] = r["lead_gap_ms"] = None
            r["counts"] = {}
    elif case == "no spans in the port":
        monkeypatch.delattr(debug, "records")
        got = {name: reader(name).read(run) for name in SERVE + TRAIN}
        assert set(got.values()) == {None}
        return
    got = read_all(SERVE + TRAIN, run, recs, monkeypatch)
    assert set(got.values()) == {None}, got
