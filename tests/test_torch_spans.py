"""The port's spans (utils/debug.py) under a profiler and without one, and
(on a card) their stream times under a device-only profile. No JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import build_engine, seeded_histories, seeded_sequences
from hidvae_tpu_torch.models.retrieval import BEAMS
from hidvae_tpu_torch.train.common import Optimizer, inverse_sqrt_schedule
from hidvae_tpu_torch.train.transformer import as_seq_data, run_loop
from hidvae_tpu_torch.utils import debug

CPU, CUDA = [ProfilerActivity.CPU], [ProfilerActivity.CUDA]
# D 16: a width rq_assign is built for on a card
TINY = dict(input_dim=32, hidden_dims=(16,), embed_dim=16, codebook_size=16, n_layers=3,
            codebook_normalize=False, tag_class_counts=(4, 6, 20), tag_embed_dim=16,
            decoder_embed_dim=16, attn_embed_dim=32, attn_heads=2, attn_layers=2,
            max_seq_len=6, n_items=96)
SERVE = ["engine.pad", "engine.upload", "engine.tokenize", "model.encode", "model.beam",
         "model.beam.digit", "engine.resolve", "engine.copy_back"]
STEP = ["train.sample", "train.forward", "train.backward", "train.optimizer"]


def _engine(device="cpu"):
    return build_engine(TINY, device, batch_buckets=(4, 8))[0]


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _histories(rows=7, seed=1):
    return seeded_histories(TINY["n_items"], rows, 9, seed)


def _recorded(fn, activities):
    """fn()'s result and records under `activities` (None: no profiler)."""
    debug.clear()
    if activities is None:
        return fn(), debug.records()
    with profile(activities=activities):
        out = fn()
    return out, debug.records()


def _requests(recs):
    """({root index: its descendants}, records by index); each nested in
    its parent's host interval."""
    by_index, roots, reqs = {r["index"]: r for r in recs}, {}, {}
    for r in recs:
        if r["parent"] is None:
            roots[r["request"]] = r["index"]
            reqs[r["index"]] = []
            continue
        p = by_index[r["parent"]]
        assert p["request"] == r["request"]
        assert p["host_start_ns"] <= r["host_start_ns"] <= r["host_end_ns"] <= p["host_end_ns"]
        reqs[roots[r["request"]]].append(r)
    return reqs, by_index


def test_recommend_records_its_span_tree(engine):
    recs = _recorded(lambda: [engine.recommend(h) for h in (_histories(), _histories(3))],
                     CPU)[1]
    reqs, by_index = _requests(recs)
    roots = [by_index[i] for i in reqs]
    assert [(r["name"], r["request"]) for r in roots] == [("engine.recommend", 0),
                                                         ("engine.recommend", 1)]
    d = engine.sem_id_dim
    for root, rows in zip(roots, (8, 4)):  # the buckets of 7 and 3 users
        kids = reqs[root["index"]]
        assert [r["name"] for r in kids] == SERVE[:5] + SERVE[5:6] * (d - 1) + SERVE[5:]
        assert [r["fields"]["digit"] for r in kids if "digit" in r["fields"]] == list(range(d))
        assert root["counts"]["beam.rows"] == BEAMS * rows * d
        # one new decoder token a row and digit; digit i reads i cached ones
        assert root["counts"]["beam.decoder_tokens"] == BEAMS * rows * d
        assert root["counts"]["beam.cached_tokens"] == BEAMS * rows * d * (d - 1) // 2
        # digit 0 runs one seeded row a user, the later digits at most every row
        assert rows <= root["counts"]["beam.live_rows"] <= rows + BEAMS * rows * (d - 1)
        assert {r["stream_ms"] for r in kids + [root]} == {None}
    assert not debug.tracing()
    assert debug.span("a") is debug.span("b", digit=0)  # the shared no-op
    assert _recorded(lambda: engine.recommend(_histories()), None)[1] == []


def test_served_answers_are_bitwise_the_same_under_a_profiler(engine):
    hist = _histories(8, seed=3)
    plain, traced = (_recorded(lambda: engine.recommend(hist, np.arange(8), top_k=5), acts)[0]
                     for acts in (None, CPU))
    for key in ("items", "sem_ids", "scores"):
        assert plain[key].dtype == traced[key].dtype
        np.testing.assert_array_equal(plain[key], traced[key])


def _train(device, iterations, log_every, activities):
    engine = _engine(device)
    data = as_seq_data(*seeded_sequences(TINY["n_items"], 12, 6, 4), device)
    opt = Optimizer(engine.model.parameters(), inverse_sqrt_schedule(1e-3, 10), 0.01)
    return _recorded(lambda: run_loop(engine.model, opt, data, engine.corpus_ids, seed=7,
                                      start_iter=0, iterations=iterations, batch_size=4,
                                      subsample=True, log_every=log_every), activities)


def test_run_loop_records_a_root_per_step():
    reqs, by_index = _requests(_train("cpu", 2, 2, CPU)[1])
    assert [(by_index[i]["name"], by_index[i]["fields"]) for i in reqs] == [
        ("train.step", {"step": 0}), ("train.step", {"step": 1})]
    first, last = reqs.values()
    assert [r["name"] for r in first] == STEP
    assert [(r["name"], by_index[r["parent"]]["name"]) for r in last] == [
        (n, "train.step") for n in STEP + ["train.readback"]]


def test_training_losses_are_bitwise_the_same_under_a_profiler():
    (plain, _), (traced, recs) = (_train("cpu", 3, 1, acts) for acts in (None, CPU))
    assert len(plain["train_loss"]) == 3 and recs
    assert plain["train_loss"] == traced["train_loss"]


def test_the_store_keeps_the_first_spans(engine, monkeypatch):
    monkeypatch.setattr(debug, "MAX_SPANS", 5)
    recs = _recorded(lambda: engine.recommend(_histories()), CPU)[1]
    assert [r["name"] for r in recs] == ["engine.recommend"] + SERVE[:4]
    assert debug.dropped() == 1 + engine.sem_id_dim + 2  # beam, digits, resolve, copy back
    debug.clear()
    assert debug.records() == [] and debug.dropped() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["serve", "train"])
def test_stream_times_under_a_device_only_profile(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stream times are taken on the card only")
    cuda = torch.device("cuda", 0)
    with profile(activities=CUDA):
        assert debug.tracing()
    if kind == "serve":
        engine = _engine(cuda)
        engine.recommend(_histories())  # warm
        recs = _recorded(lambda: [engine.recommend(_histories(seed=s)) for s in range(3)],
                         CUDA)[1]
    else:
        recs = _train(cuda, 4, 2, CUDA)[1]
    reqs, by_index = _requests(recs)
    roots = [by_index[i] for i in reqs]
    assert len(roots) >= 3 and all(r["stream_ms"] > 0 for r in recs)
    assert roots[0]["lead_gap_ms"] is None and all(r["lead_gap_ms"] >= 0 for r in roots[1:])
    for root in roots:
        kids = [r for r in reqs[root["index"]] if r["parent"] == root["index"]]
        assert kids and sum(r["stream_ms"] for r in kids) <= root["stream_ms"] + 0.1
