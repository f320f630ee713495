"""Batch recommendation in pages by the decoder-only MLA-MoE retriever
(hidvae_tpu_torch/models/mla_moe.py) through `RetrievalEngine.recommend`:
the loop, traffic and end-to-end metrics of `serve_pages`, the model built
from the configuration's deepseek_v3 keys and held in its `serve_dtype`.

Before the window the kind fixes from the seed the `check_pages` pages it
will check (the one with the most history among them) and serves each
once with the port's recorder open (utils/debug.py `recording`): the
routing judged is that of the served answer. The check, after the window:
the corpus table against the reference's sweep, every served tuple's score
against the plain fp32 reference's teacher-forced score of it, the
reference's own beam against the served one for `check_beam_users` users
a page (the one with the most history among them), each served item
against the tuple's row, and the port's expert choices against the
reference's router (`judge`)."""

import time
from unittest import mock

import numpy as np
import torch

from hidvae_tpu_torch.models import retrieval
from hidvae_tpu_torch.models.mla_moe import MlaMoeRetrievalModel
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.utils.debug import recording
from perfbench.harness import build, faults, seeds, trace
from perfbench.harness import flops_mla_moe as flops
from perfbench.harness import traffic as gen
from perfbench.harness import weights
from perfbench.kinds.serve_pages import _page, layer_timings, window  # noqa: F401 (the kind's)
from perfbench.reference import mla_moe as ref
from perfbench.reference import model as table_ref
from perfbench.reference.spec import vae_spec

TOP_K = 10
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
SEQS_PER_FORWARD = 256  # the reference's sequences per forward


def dims(cfg):
    """(codes a digit, digits, semantic levels, user buckets)."""
    return (cfg["codebook_size"], flops.sem_id_dim(cfg), cfg["n_layers"], cfg["user_buckets"])


def make_weights(cfg, seed: int, device):
    """The model's weights, drawn on the device tensor by tensor in fp32 and
    held in the serve dtype (the routing bias in fp32, its spread
    `e_score_correction_bias_sd`)."""
    g = seeds.generator(seed, seeds.DECODER_WEIGHTS, device)
    dtype = DTYPES[cfg["serve_dtype"]]
    out = {}
    for name, shape, kind in ref.spec(cfg, *dims(cfg)):
        if kind == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        x = torch.randn(shape, generator=g, device=device)
        if kind == "bias":
            out[name] = x * cfg["e_score_correction_bias_sd"]
        else:  # products by fan-in, token rows by width: both the last axis
            out[name] = (x * shape[-1] ** -0.5).to(dtype)
    return out


def build_model(cfg, W, device):
    """The port's model from the configuration's keys, holding `W` itself."""
    k, d, n_sem, buckets = dims(cfg)
    with torch.device("meta"):
        model = MlaMoeRetrievalModel(cfg, k, d, n_sem_layers=n_sem, user_buckets=buckets,
                                     dtype=DTYPES[cfg["serve_dtype"]])
    model.load_state_dict(W, strict=True, assign=True)
    return model.to(device).eval().requires_grad_(False)


def bias_left_out(objs):
    """The routing bias left out of the choice: the router picks the top
    plain scores."""
    for layer in objs["engine"].model.layers:
        if layer.is_moe:
            gate = layer.mlp.gate
            gate.e_score_correction_bias = torch.zeros_like(gate.e_score_correction_bias)


EDGE_ROWS = 8


def edge_rows_swapped(objs):
    """Wrong rows at the beam's edge: each digit keeps the candidates ranked
    k + 1 .. k + EDGE_ROWS in place of those ranked k - EDGE_ROWS + 1 .. k,
    their scores their own."""
    engine = objs["engine"]
    step, top = engine._rows_step, retrieval.top_k_first_index

    def swapped(scores, k):
        s, i = top(scores, k + EDGE_ROWS)
        keep = torch.cat([torch.arange(k - EDGE_ROWS), torch.arange(k, k + EDGE_ROWS)])
        return s[..., keep.to(s.device)], i[..., keep.to(s.device)]

    def faulty(user_ids, items):
        with mock.patch.object(retrieval, "top_k_first_index", swapped):
            return step(user_ids, items)

    engine._rows_step = faulty


FAULTS = {"token": faults.serve_token, "half": faults.serve_half, "bias": bias_left_out,
          "edge": edge_rows_swapped}


def pages_to_check(seed, pages, n):
    """`n` of the pages drawn from the seed, the one with the most history
    among them."""
    longest = max(range(len(pages)), key=lambda k: (int(np.sum(pages[k][2])), -k))
    rest = [k for k in range(len(pages)) if k != longest]
    rng = np.random.default_rng(seed)
    return [longest] + sorted(rng.choice(rest, size=min(n - 1, len(rest)),
                                         replace=False).tolist())


def beam_users(seed, page, lengths, n):
    """`n` users of a page drawn from the seed, the one with the most history
    among them."""
    longest = int(np.argmax(lengths))
    rest = [u for u in range(len(lengths)) if u != longest]
    rng = np.random.default_rng([seed, page])
    return [longest] + sorted(rng.choice(rest, size=min(n - 1, len(rest)),
                                         replace=False).tolist())


def setup(run, plant=None):
    run.family = "serve"
    cfg, tr, dev = run.cfg, run.traffic, run.device
    with run.phase("inputs"):
        feats = weights.make_features(cfg["n_items"], cfg["input_dim"], run.seed, dev)
        vae_w = weights.make_weights(vae_spec(cfg), run.seed, seeds.VAE_WEIGHTS, dev)
        weights.seed_codebooks_(vae_w, cfg, feats, run.seed, dev)
        W = make_weights(cfg, run.seed, dev)
        run.inputs = (feats, vae_w, W)
        pages = gen.serve_pages(tr, cfg["n_items"], run.seed, dev)
    with run.phase("models"):
        tok = build.tokenizer(cfg, vae_w, dev)
        model = build_model(cfg, W, dev)
    run.sync()
    t0 = time.perf_counter()
    engine = RetrievalEngine(model, tok, feats, max_seq_len=cfg["max_seq_len"],
                             batch_buckets=(tr["page_users"],), device=dev)
    run.sync()
    run.add_span("serve.engine_build", time.perf_counter() - t0)
    state = {"engine": engine, "pages": pages, "served": {}, "notes": {}}
    if plant is not None:
        plant(state)
    with run.phase("warmup"):
        for i in range(tr["warmup_pages"]):
            hist, users, _ = pages[i % len(pages)]
            engine.recommend(hist, users, top_k=TOP_K)
        for k in pages_to_check(run.seed, pages, tr["check_pages"]):
            hist, users, _ = pages[k]
            with recording() as notes:
                out = engine.recommend(hist, users, top_k=TOP_K)
            state["served"][k] = (out["items"], out["sem_ids"], out["scores"])
            state["notes"][k] = notes
    return state


def traced_window(run, state):
    """`serve_pages`' traced loop (its `_page`), the needed products counted
    for this block: pages for `trace_seconds` traced with device activity
    alone, then a second of pages traced with host activity too."""
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
    run.counters["serve.needed_flops"] = sum(
        flops.page_flops(run.cfg, state["pages"][k][2]) for k in done)


def collect(run, state):
    """What is judged: the engine's corpus table, the checked pages' answers
    and the routing the recorder kept of them."""
    return {"table": state["engine"].corpus_ids.cpu().numpy(), "served": state["served"],
            "notes": state["notes"], "pages": state["pages"]}


# ---- the judged routing, user by user ----

def books(cfg, notes, lengths, k_moe):
    """Each user's routing from one page's notes: {"ctx": [layers, n, e_k]
    of the context tokens, "steps": [(keys [rows] of the rows' digits before
    the step, experts [layers, rows, e_k] of its new token)]}; None for every
    user where the notes are not a page's prefill and digits."""
    n_moe, d = flops.n_moe_layers(cfg), flops.sem_id_dim(cfg)
    lens = [flops.context_tokens(cfg, n) for n in lengths]
    experts = [v for n, v in notes if n == "moe.experts"]
    prefixes = [v for n, v in notes if n == "beam.prefixes"]
    b = len(lengths)
    if (len(experts) != n_moe * (1 + d) or len(prefixes) != d
            or experts[0].shape[0] != sum(lens) or prefixes[0].shape[0] != b):
        return [None] * b
    ctx = torch.stack(experts[:n_moe]).split(lens, 1)
    out = [{"ctx": ctx[u], "steps": []} for u in range(b)]
    for i in range(d):
        gen_i = prefixes[i][:, :, :i]
        step = torch.stack(experts[n_moe * (i + 1):n_moe * (i + 2)])     # [layers, b*k, e_k]
        step = step.view(n_moe, b, -1, k_moe)
        keys = ref.prefix_keys(gen_i)
        for u in range(b):
            out[u]["steps"].append((keys[u], step[:, u]))
    return out


def held(book, tuples):
    """The prefix keys a digit [m_i] the served search kept: its beam rows'
    digits 0..i from the routing notes where there are any, the served
    tuples' prefixes besides (all there is at the last digit)."""
    d = tuples.shape[1]
    out = [ref.prefix_keys(tuples[:, :i + 1]) for i in range(d)]
    if book is not None:
        out[:-1] = [torch.cat([book["steps"][i + 1][0], keys]) for i, keys in
                    enumerate(out[:-1])]
    return out


def follow_for(book, digits, n_moe, k_moe):
    """The experts to follow, per MoE layer [S, T, e_k] (-1: none known),
    for sequences [context, BOS, digits [S, m]] of the book's user."""
    s, m = digits.shape
    if book is None:
        return None
    lc = book["ctx"].shape[1]
    out = torch.full((n_moe, s, lc + 1 + m, k_moe), -1, dtype=torch.long,
                     device=digits.device)
    out[:, :, :lc] = book["ctx"][:, None]
    for j in range(m + 1):  # the token fed at step j: BOS, then digit j - 1
        keys, experts = book["steps"][j]
        want = ref.prefix_keys(digits[:, :j])
        hit = want[:, None] == keys[None]
        row = hit.float().argmax(1)
        found = hit.any(1)
        got = experts[:, row]
        out[:, :, lc + j] = torch.where(found[None, :, None], got, -1)
    return out


DEFICIT_STEPS = (1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2)  # the diagnostic counts' thresholds


def judge(run, table, answers, routing):
    """The comparison's numbers for a corpus table [N, D] and answers {page:
    (users [U], items [U, 10], tuples [U, 10, D], scores [U, 10])} of those
    users of the page, with the routing {page: `books`} the answer took,
    against the plain fp32 reference, which takes the served experts
    wherever the routing gives them: ids_off, the table's rows that differ
    from the reference's other than by a near tie, and the served items
    that differ from the lowest row holding the served tuple; score_gap,
    the widest gap between a served score and the reference's
    teacher-forced score of the served tuple; best_gap, the widest amount
    by which the reference's own k-th beam beats the served k-th tuple for
    the page's `check_beam_users` users among them, its beam taking the
    served search's side of a near tie at its edge (BEAM_TIE: the rows the
    served beam kept a digit, `held`); both as shares of
    the reference's score, or of 1 where that is smaller; route_off, the
    tokens of the served answer (each user's context and BOS once, each
    served tuple's digits) whose served experts lie further than ROUTE_TIE
    below the reference's own choice. Returns [(name, value)]; the
    deficits' counts, the furthest below its edge that the reference's beam
    kept a held row (`check.beam_tie_max`) and the parts' seconds go to
    counters and spans."""
    cfg, dev = run.cfg, run.device
    feats, vae_w, W = run.inputs
    kk, d, n_sem, buckets = dims(cfg)
    n_moe, k_moe = flops.n_moe_layers(cfg), cfg["num_experts_per_tok"]
    score_gap = best_gap = 0.0
    route_off, routed, deficits, unresolved, ties = 0, 0, [], 0, []
    t0 = time.perf_counter()
    with ref.exact_fp32(), torch.no_grad():
        ref_table, ids_off = table_ref.adopt_near_ties(
            vae_w, cfg, feats, table_ref.corpus_table(vae_w, cfg, feats),
            torch.as_tensor(np.asarray(table), device=dev))
        sets = ref.PrefixSets(ref_table, kk)
        t1 = time.perf_counter()
        run.add_span("check.table", t1 - t0)
        for page, (users, items, tuples, scores) in answers.items():
            hist, uids, lengths = run.pages[page]
            book = routing[page]
            h = table_ref.pad_histories(torch.from_numpy(hist).to(dev), cfg["max_seq_len"])
            ctx = []
            for u in users:
                rows = ref_table[h[u][h[u] >= 0]].reshape(-1)
                ctx.append(ref.context(W, int(uids[u]), rows,
                                       torch.arange(d, device=dev).repeat(rows.shape[0] // d),
                                       kk, n_sem, buckets))
            tup = torch.as_tensor(np.asarray(tuples), device=dev).long()
            sc = torch.as_tensor(np.asarray(scores), device=dev).float()
            m = tup.shape[1]
            rescored = torch.zeros_like(sc)
            per = max(1, SEQS_PER_FORWARD // m)
            for at in range(0, len(users), per):
                js = range(at, min(at + per, len(users)))
                xs = [ref.with_digits(W, ctx[j], tup[j][:, :d - 1], kk, n_sem) for j in js]
                fol = [follow_for(book[users[j]], tup[j][:, :d - 1], n_moe, k_moe) for j in js]
                logits, routes = ref.forward(W, cfg, xs, follow=fol)
                for j, lg, rt, f in zip(js, logits, routes, fol):
                    lc = ctx[j].shape[0]
                    rescored[j] = ref.digit_log_probs(lg[:, lc:lc + d], tup[j], sets).sum(1)
                    if f is None:
                        continue
                    # the context and BOS once, each tuple's digits
                    counted = torch.zeros(lg.shape[:2], dtype=torch.bool, device=dev)
                    counted[:, lc + 1:] = True
                    counted[0, :lc + 1] = True
                    counted &= (f[0] >= 0).all(-1)
                    for _, off, deficit in rt:
                        route_off += int((off & counted).sum())
                        routed += int(counted.sum())
                        deficits.append(deficit[counted])
            scale = torch.clamp(rescored.abs(), min=1.0)
            score_gap = max(score_gap, float(((sc - rescored).abs() / scale).max()))
            t2 = time.perf_counter()
            run.add_span("check.score", t2 - t1)
            js = [j for j, u in enumerate(users) if u in run.beam_users[page]]

            def route_of(i, prev, js=js, book=book, users=users):
                b_u = book[users[js[i]]]
                return None if b_u is None else follow_for(b_u, prev, n_moe, k_moe)

            found = ref.beam_search(W, cfg, [ctx[j] for j in js], sets, kk, n_sem, d,
                                    follow=[held(book[users[j]], tup[j]) for j in js],
                                    route_of=route_of, ties=ties)
            for j, (_, best, _) in zip(js, found):
                best = best[:m]
                best_gap = max(best_gap, float(((best - rescored[j])
                                                / torch.clamp(best.abs(), min=1.0)).max()))
            resolved = sets.resolve(tup)
            ids_off += int((resolved != torch.as_tensor(np.asarray(items), device=dev)).sum())
            unresolved += int((resolved < 0).sum())
            t1 = time.perf_counter()
            run.add_span("check.beam", t1 - t2)
    deficits = torch.cat(deficits) if deficits else torch.zeros(1, device=dev)
    run.counters["check.route_deficit_max"] = float(deficits.max())
    run.counters["check.route_deficits_over"] = {
        str(x): int((deficits > x).sum()) for x in DEFICIT_STEPS}
    run.counters["check.beam_tie_max"] = max(ties, default=0.0)
    run.counters["check.routed_tokens"] = routed
    run.counters["check.served_off_catalog"] = unresolved
    return [("ids_off", ids_off), ("score_gap", score_gap), ("best_gap", best_gap),
            ("route_off", route_off)]


def _beam_users(run):
    run.beam_users = {k: beam_users(run.seed, k, run.pages[k][2],
                                    run.traffic["check_beam_users"])
                      for k in range(len(run.pages))}


def check(run, judged):
    run.pages = judged["pages"]
    _beam_users(run)
    b = run.traffic["page_users"]
    answers = {k: (list(range(b)), *judged["served"][k]) for k in judged["notes"]}
    routing = {k: books(run.cfg, notes, run.pages[k][2], run.cfg["num_experts_per_tok"])
               for k, notes in judged["notes"].items()}
    values = judge(run, judged["table"], answers, routing)
    run.checks = [(name, value, run.limits[name]) for name, value in values]
    run.counters["checked_pages"] = sorted(judged["served"])


def control(run):
    """The reference put in the port's place on the `check_beam_users` users
    of the pages a run would check, each product's operands one precision
    below the configuration's: fp8 e4m3 in the model (bf16 stated), TF32 in
    the tokenizer's table (fp32 stated); its own table, beam, routing and
    items, judged as the port's are. Returns [(name, value)]."""
    run.family = "serve"
    cfg, dev = run.cfg, run.device
    feats = weights.make_features(cfg["n_items"], cfg["input_dim"], run.seed, dev)
    vae_w = weights.make_weights(vae_spec(cfg), run.seed, seeds.VAE_WEIGHTS, dev)
    weights.seed_codebooks_(vae_w, cfg, feats, run.seed, dev)
    W = make_weights(cfg, run.seed, dev)
    run.inputs = (feats, vae_w, W)
    run.pages = gen.serve_pages(run.traffic, cfg["n_items"], run.seed, dev)
    _beam_users(run)
    kk, d, n_sem, buckets = dims(cfg)
    ar = ref.Arith(lower="fp8")
    answers, routing = {}, {}
    with ref.exact_fp32(), torch.no_grad():
        table = table_ref.corpus_table(vae_w, cfg, feats, table_ref.Arith(lower="tf32"))
        sets = ref.PrefixSets(table, kk)
        for page in pages_to_check(run.seed, run.pages, run.traffic["check_pages"]):
            hist, uids, _ = run.pages[page]
            h = table_ref.pad_histories(torch.from_numpy(hist).to(dev), cfg["max_seq_len"])
            users = run.beam_users[page]
            book = [None] * len(uids)
            ctxs = []
            for u in users:
                rows = table[h[u][h[u] >= 0]].reshape(-1)
                ctxs.append(ref.context(W, int(uids[u]), rows,
                                        torch.arange(d, device=dev).repeat(rows.shape[0] // d),
                                        kk, n_sem, buckets))
            found = ref.beam_search(W, cfg, ctxs, sets, kk, n_sem, d, ar=ar)
            _, ctx_routes = ref.forward(W, cfg, [c[None] for c in ctxs], ar)
            out = []
            for u, (g, s, steps), rt in zip(users, found, ctx_routes):
                book[u] = {"ctx": torch.stack([idx[0] for idx, _, _ in rt]),
                           "steps": [(ref.prefix_keys(prev), e) for prev, e in steps]}
                out.append((g[:TOP_K], s[:TOP_K]))
            tup = torch.stack([g for g, _ in out])
            answers[page] = (users, sets.resolve(tup).cpu().numpy(), tup.cpu().numpy(),
                             torch.stack([s for _, s in out]).cpu().numpy())
            routing[page] = book
    return judge(run, table.cpu().numpy(), answers, routing)
