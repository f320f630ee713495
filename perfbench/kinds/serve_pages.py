"""Batch recommendation in pages: one client in a closed loop sends a page
of `page_users` histories to `RetrievalEngine.recommend` (top 10, the
engine's 32-beam search constrained to the catalog) and the next page when
it returns. The mix's parameters: page_users, distinct_pages (pages drawn
from the seed and cycled), history_window, lengths, zipf_alpha,
warmup_pages, trace_seconds, check_pages.

End to end: serve_users_per_s (users of the pages completed in the window
over its seconds) and serve_p95_ms (95th percentile of every page's time
from the call to the return). The check, after the window: the corpus
table against the reference's sweep, and on `check_pages` served pages
(the one with the most history among them) every served tuple's score
against the reference's teacher-forced score, the reference's own beam
against the served one, and each served item against the tuple's row
(`judge`)."""

import time

import numpy as np
import torch

from hidvae_tpu_torch.ops.prefix_search import lookup_items
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.train.device_data import tokenize_on_device
from hidvae_tpu_torch.utils.runtime import full_fp32
from perfbench.harness import build, flops, inputs, trace
from perfbench.harness import traffic as gen
from perfbench.harness.stats import percentile
from perfbench.reference import model as ref

TOP_K = 10


def setup(run, plant=None):
    run.family = "serve"
    cfg, tr, dev = run.cfg, run.traffic, run.device
    with run.phase("inputs"):
        run.inputs = inputs.make(cfg, run.seed, dev)
        feats, vae_w, dec_w = run.inputs
        pages = gen.serve_pages(tr, cfg["n_items"], run.seed, dev)
    with run.phase("models"):
        tok = build.tokenizer(cfg, vae_w, dev)
        model = build.decoder(cfg, dec_w, tok.sem_ids_dim, torch.float32, dev)
    run.sync()
    t0 = time.perf_counter()
    engine = RetrievalEngine(model, tok, feats, max_seq_len=cfg["max_seq_len"],
                             batch_buckets=(tr["page_users"],), device=dev)
    run.sync()
    run.add_span("serve.engine_build", time.perf_counter() - t0)
    state = {"engine": engine, "pages": pages, "served": {}}
    if plant is not None:
        plant(state)
    with run.phase("warmup"):
        for i in range(tr["warmup_pages"]):
            hist, users, _ = pages[i % len(pages)]
            engine.recommend(hist, users, top_k=TOP_K)
    return state


def _page(state, i):
    """Serve page i of the cycle; returns (seconds, return time)."""
    k = i % len(state["pages"])
    hist, users, _ = state["pages"][k]
    t0 = time.perf_counter()
    out = state["engine"].recommend(hist, users, top_k=TOP_K)
    t1 = time.perf_counter()
    state["served"].setdefault(k, (out["items"], out["sem_ids"], out["scores"]))
    return t1 - t0, t1


def window(run, state):
    lat, i = [], 0
    t_start = time.perf_counter()
    while True:
        dt, t1 = _page(state, i)
        lat.append(dt)
        i += 1
        if t1 - t_start >= run.seconds:
            break
    run.attempted = i
    run.e2e["serve_users_per_s"] = i * run.traffic["page_users"] / (t1 - t_start)
    run.e2e["serve_p95_ms"] = percentile(lat, 95) * 1e3


def traced_window(run, state):
    """Pages for `trace_seconds` traced with device activity alone, then
    LABEL_SECONDS of pages traced with host activity too (idle labels)."""
    done = []

    def loop(seconds, record):
        t_start, i = time.perf_counter(), 0
        while True:
            with trace.span("page"):
                _, t1 = _page(state, i)
            if record:
                done.append(i % len(state["pages"]))
            i += 1
            if t1 - t_start >= seconds:
                break

    run.trace_summary = trace.profile(
        lambda: loop(min(run.seconds, run.traffic["trace_seconds"]), True),
        lambda: loop(trace.LABEL_SECONDS, False))
    run.attempted = len(done)
    fcfg = inputs.flop_cfg(run.cfg)
    run.counters["serve.needed_flops"] = sum(
        flops.beam_flops(fcfg, state["pages"][k][2]) for k in done)


def layer_timings(run, state):
    """One page's parts as the engine's step runs them, each called alone:
    tokenize + encoder, the whole beam search (encoder included), resolve."""
    engine, dev = state["engine"], run.device
    hist, users, _ = state["pages"][0]
    items = torch.from_numpy(engine._pad_histories(hist)).to(dev)
    uids = torch.from_numpy(users).to(dev)
    zeros = torch.zeros_like(uids)
    model = engine.model

    def batch():
        b = tokenize_on_device(engine.corpus_ids, uids, items, fut=zeros)
        return b.replace(sem_ids_fut=torch.zeros((items.shape[0], engine.sem_id_dim),
                                                 dtype=torch.int32, device=dev))

    def generate():
        return model.generate_next_sem_id(
            batch(), engine.sorted_ids, temperature=engine.generation_temperature,
            prefix_caps=engine.prefix_caps, prefix_tries=engine.prefix_tries)

    with torch.inference_mode(), full_fp32():
        out = generate()
        run.timed("serve.tokenize_encode", lambda: model.encode_context(batch()))
        run.timed("serve.generate", generate)
        run.timed("serve.resolve", lambda: lookup_items(engine.sorted_ids, engine.perm,
                                                          out.sem_ids))


def collect(run, state):
    """What is judged, on the host: the engine's corpus table and the first
    answer to every served page."""
    return {"table": state["engine"].corpus_ids.cpu().numpy(), "served": state["served"],
            "pages": state["pages"]}


def pages_to_check(run, judged):
    """`check_pages` served pages drawn from the seed, the one with the
    most history among them."""
    served = sorted(judged["served"])
    pages = judged["pages"]
    longest = max(served, key=lambda k: (int(np.sum(pages[k][2])), -k))
    rest = [k for k in served if k != longest]
    rng = np.random.default_rng(run.seed)
    n = min(run.traffic["check_pages"] - 1, len(rest))
    return [longest] + sorted(rng.choice(rest, size=n, replace=False).tolist() if n else [])


def judge(run, table, answers):
    """The comparison's numbers for a corpus table [N, D] and answers
    {page: (items, tuples, scores)} (the port's, or the control's), against
    the reference in fp32: ids_off, the table's rows that differ from the
    reference's other than by a near tie (reference/model.py
    `near_tie_rows`; the stages after the table take the near-tie rows
    over) and the served items that differ from the lowest row holding the
    served tuple; score_gap, the widest gap between a served score and the
    reference's teacher-forced score of the served tuple; best_gap, the
    widest amount by which the reference's own k-th beam beats the served
    k-th tuple, its beam taking the served side of a near tie at the
    beam's edge (reference/model.py `follow_near_ties`), as the table
    does; both gaps as shares of the reference's score, or of 1 where
    that is smaller. Returns [(name, value)]."""
    cfg, dev = run.cfg, run.device
    feats, vae_w, dec_w = run.inputs
    W = ref.with_head_dim(dec_w, cfg)
    ar = ref.Arith()
    with ref.exact_fp32(), torch.no_grad():
        ref_table, ids_off = ref.adopt_near_ties(
            vae_w, cfg, feats, ref.corpus_table(vae_w, cfg, feats),
            torch.as_tensor(np.asarray(table), device=dev))
        sets = ref.PrefixSets(ref_table, cfg["codebook_size"])
        score_gap = best_gap = 0.0
        for k, (items, tuples, scores) in answers.items():
            hist, users, _ = run.pages[k]
            h = ref.pad_histories(torch.from_numpy(hist).to(dev), cfg["max_seq_len"])
            u = torch.from_numpy(users).to(dev)
            uid, ids, mask, tt, _ = ref.tokenize(ref_table, u, h, torch.zeros_like(u))
            enc, cmask = ref.encode_context(W, cfg, ar, uid, ids, mask, tt)
            tup = torch.from_numpy(np.asarray(tuples)).to(dev).long()
            sc = torch.from_numpy(np.asarray(scores)).to(dev).float()
            rescored = ref.score_tuples(W, cfg, ar, enc, cmask, tup, sets)
            scale = torch.clamp(rescored.abs(), min=1.0)
            score_gap = max(score_gap, float(((sc - rescored).abs() / scale).max()))
            _, best = ref.beam_search(W, cfg, ar, enc, cmask, sets, follow=tup)
            best = best[:, :tup.shape[1]]
            best_gap = max(best_gap, float(((best - rescored) / torch.clamp(best.abs(), min=1.0))
                                           .max()))
            resolved = ref.resolve(sets, tup)
            ids_off += int((resolved != torch.from_numpy(np.asarray(items)).to(dev)).sum())
    return [("ids_off", ids_off), ("score_gap", score_gap), ("best_gap", best_gap)]


def check(run, judged):
    run.pages = judged["pages"]
    picked = pages_to_check(run, judged)
    values = judge(run, judged["table"], {k: judged["served"][k] for k in picked})
    run.checks = [(name, value, run.limits[name]) for name, value in values]
    run.counters["checked_pages"] = picked


def control(run):
    """The reference put in the port's place, its products at TF32
    (serving states fp32, TF32 off), on the pages a run would check: its table, beams and items,
    judged as the port's are. Returns [(name, value)]."""
    cfg, dev = run.cfg, run.device
    run.inputs = inputs.make(cfg, run.seed, dev)
    run.pages = gen.serve_pages(run.traffic, cfg["n_items"], run.seed, dev)
    feats, vae_w, dec_w = run.inputs
    W = ref.with_head_dim(dec_w, cfg)
    ar = ref.Arith(lower="tf32")
    served = {k: None for k in range(len(run.pages))}
    picked = pages_to_check(run, {"served": served, "pages": run.pages})
    answers = {}
    with ref.exact_fp32(), torch.no_grad():
        table = ref.corpus_table(vae_w, cfg, feats, ar)
        sets = ref.PrefixSets(table, cfg["codebook_size"])
        for k in picked:
            hist, users, _ = run.pages[k]
            h = ref.pad_histories(torch.from_numpy(hist).to(dev), cfg["max_seq_len"])
            u = torch.from_numpy(users).to(dev)
            uid, ids, mask, tt, _ = ref.tokenize(table, u, h, torch.zeros_like(u))
            enc, cmask = ref.encode_context(W, cfg, ar, uid, ids, mask, tt)
            tup, sc = ref.beam_search(W, cfg, ar, enc, cmask, sets)
            tup, sc = tup[:, :TOP_K], sc[:, :TOP_K]
            answers[k] = (ref.resolve(sets, tup).cpu().numpy(), tup.cpu().numpy(),
                          sc.cpu().numpy())
    return judge(run, table.cpu().numpy(), answers)
