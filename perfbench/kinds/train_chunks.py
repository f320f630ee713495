"""Stage-2 training in the trainer's chunks: `train/transformer.py`
`run_loop` over a seeded pool of histories (its sampling, random crop,
tokenizing by the corpus table, dropout and AdamW), driven chunk after
chunk of `chunk_steps` steps until the window ends. The mix's parameters:
pool_sequences, history_window, lengths, zipf_alpha, chunk_steps,
trace_seconds.

Set-up builds the trainer's objects once and drives them through the first
three steps, one chunk each, as the window's own call; the window goes on
from step 3. End to end: train_examples_per_s, the rows of the steps
completed in the window over its seconds. The check: the corpus table
against the reference's sweep; each of the three steps' loss, every
parameter's first gradient (from AdamW's first moment after step 1) and
its change after step 3, against the reference's three steps."""

import statistics
import time

import torch

from hidvae_tpu_torch.train.common import Optimizer, audit_rebuilt_corpus, inverse_sqrt_schedule
from hidvae_tpu_torch.train.device_data import DeviceSeqData
from hidvae_tpu_torch.train.transformer import run_loop, sample_batch, step_generator
from perfbench.harness import build, flops, inputs, trace
from perfbench.harness import traffic as gen
from perfbench.reference import model as ref

FIRST_STEPS = 3
BETA1 = 0.9
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def setup(run, plant=None):
    run.family = "train"
    cfg, tr, dev = run.cfg, run.traffic, run.device
    with run.phase("inputs"):
        run.inputs = inputs.make(cfg, run.seed, dev)
        feats, vae_w, dec_w = run.inputs
        run.pool = gen.train_pool(tr, cfg["n_items"], run.seed, dev)
    with run.phase("models"):
        tok = build.tokenizer(cfg, vae_w, dev)
    with run.phase("table"):
        table = tok.precompute_corpus_ids(feats)
        audit_rebuilt_corpus(tok, table.cpu().numpy(), None)
    with run.phase("decoder"):
        model = build.decoder(cfg, dec_w, tok.sem_ids_dim, DTYPES[cfg["compute_dtype"]], dev)
        optimizer = Optimizer(model.parameters(),
                              inverse_sqrt_schedule(cfg["learning_rate"], cfg["warmup_steps"]),
                              cfg["weight_decay"], max_grad_norm=None)
    state = {"model": model, "optimizer": optimizer, "data": DeviceSeqData(*run.pool),
             "table": table.to(torch.int32), "step": 0}
    if plant is not None:
        plant(state)
    with run.phase("first_steps"):
        _first_steps(run, state, dec_w)
    return state


def _first_steps(run, state, dec_w):
    """Steps 0-2 through run_loop, one chunk each; records each loss, the
    first gradient's norm by parameter (AdamW's first moment after step 1
    over 1 - beta1) and each parameter's change after step 3."""
    model, optimizer, dev = state["model"], state["optimizer"], run.device
    losses = _chunk(run, state, 1, log_every=1)
    params = dict(model.named_parameters())
    grads = {}
    for name, p in params.items():
        m = optimizer.adamw.state.get(p, {}).get("exp_avg")
        grads[name] = torch.zeros((), device=dev) if m is None else m.norm() / (1.0 - BETA1)
    losses += _chunk(run, state, FIRST_STEPS - 1, log_every=1)
    with torch.no_grad():
        deltas = {name: (p.detach().float() - dec_w[name]).norm() for name, p in params.items()}
    state["first"] = {"losses": losses,
                      "grads": {k: float(v) for k, v in grads.items()},
                      "deltas": {k: float(v) for k, v in deltas.items()}}
    return losses


def _chunk(run, state, steps, log_every=None):
    """`steps` steps of run_loop from the state's step; their losses."""
    hist = run_loop(state["model"], state["optimizer"], state["data"], state["table"],
                    seed=run.seed, start_iter=state["step"], iterations=steps,
                    batch_size=run.cfg["batch_size"], subsample=True,
                    log_every=log_every or steps)
    state["step"] += steps
    return hist["train_loss"]


def window(run, state):
    first = state["step"]
    t_start = t1 = time.perf_counter()
    while True:
        t0 = t1
        _chunk(run, state, run.traffic["chunk_steps"])
        t1 = time.perf_counter()
        run.add_span("train.chunk", t1 - t0)
        if t1 - t_start >= run.seconds:
            break
    steps = state["step"] - first
    run.attempted = steps
    run.e2e["train_examples_per_s"] = steps * run.cfg["batch_size"] / (t1 - t_start)


def traced_window(run, state):
    """Chunks for `trace_seconds` traced with device activity alone, then
    one chunk or more traced with host activity too (idle labels)."""
    first = state["step"]
    counted = []

    def loop(seconds):
        t_start = time.perf_counter()
        while True:
            with trace.span("chunk"):
                _chunk(run, state, run.traffic["chunk_steps"])
            if time.perf_counter() - t_start >= seconds:
                break
        counted.append(state["step"])

    run.trace_summary = trace.profile(
        lambda: loop(min(run.seconds, run.traffic["trace_seconds"])),
        lambda: loop(trace.LABEL_SECONDS))
    run.attempted = counted[0] - first
    run.counters["train.needed_flops"] = needed_flops(run, range(first, counted[0]))


def needed_flops(run, steps):
    """Needed products of these steps, from each step's cropped batch: the
    crop redrawn from the step's generator by the reference's sampler."""
    fcfg = inputs.flop_cfg(run.cfg)
    users, items, fut = run.pool
    blank = torch.zeros((run.cfg["n_items"], fcfg["sem_id_dim"]), dtype=torch.long,
                        device=run.device)
    total = 0
    for it in steps:
        g = ref.step_generator(run.seed, it, run.device)
        _, _, mask, _, _ = ref.sample_batch((users, items, fut), blank, run.cfg["batch_size"], g)
        lens = (mask.sum(1) // fcfg["sem_id_dim"]).tolist()
        total += flops.train_step_flops(fcfg, lens)
    return total


def layer_timings(run, state):
    """A step's parts as run_loop runs them, each called alone: the sample
    (draw, crop, tokenize), forward + backward, the AdamW update."""
    model, opt, it = state["model"], state["optimizer"], state["step"]
    b = run.cfg["batch_size"]

    def sample():
        return sample_batch(state["data"], state["table"], b,
                            step_generator(run.seed, it, run.device))

    batch = sample()

    def fwd_bwd():
        opt.zero_grad()
        model(batch, step_generator(run.seed, it, run.device)).loss.backward()

    run.timed("train.sample", sample)
    run.timed("train.fwd_bwd", fwd_bwd)
    run.timed("train.optimizer", opt.step)


def collect(run, state):
    return {"table": state["table"].cpu().numpy(), **state["first"]}


def judge(run, table, losses, grads, deltas):
    """The comparison's numbers for a corpus table, the first steps'
    losses, first-gradient norms and change norms by parameter (the port's,
    or the control's), against the reference's three steps on the
    reference's table (near-tie rows taken over, as in serving):
    table_rows_off, the other differing rows; loss_gap, the widest relative
    gap of a step's loss; grad_gap and update_gap, the worst leaf's gap of
    norms over the larger of its reference norm and the median leaf's."""
    cfg, dev = run.cfg, run.device
    feats, vae_w, dec_w = run.inputs
    with torch.no_grad():
        ref_table, rows_off = ref.adopt_near_ties(vae_w, cfg, feats,
                                                  ref.corpus_table(vae_w, cfg, feats),
                                                  torch.as_tensor(table, device=dev))
    ar = ref.Arith(dtype=DTYPES[cfg["compute_dtype"]])
    with ref.exact_fp32():
        ref_losses, ref_grads, ref_w = ref.train_steps(dec_w, cfg, ar, run.pool, ref_table,
                                                       run.seed, FIRST_STEPS)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_ref = {k: float(v.norm()) for k, v in ref_grads.items()}
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(grads[k] - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref)
    # Leaves whose reference gradient is nought to rounding move by round-off
    # alone under AdamW: they are left out of the change.
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: float((ref_w[k] - dec_w[k]).norm()) for k in moved}
    d_med = statistics.median(d_ref.values())
    update_gap = max(abs(deltas[k] - d_ref[k]) / max(d_ref[k], d_med) for k in moved)
    run.counters["left_out_leaves"] = sorted(set(g_ref) - set(moved))
    return [("table_rows_off", rows_off), ("loss_gap", loss_gap), ("grad_gap", grad_gap),
            ("update_gap", update_gap)]


def check(run, judged):
    values = judge(run, judged["table"], judged["losses"], judged["grads"], judged["deltas"])
    run.checks = [(name, value, run.limits[name]) for name, value in values]


def control(run):
    """The reference in the port's place, its products in fp8 e4m3 (training
    states bf16): its table and three steps, judged as the port's are."""
    cfg, dev = run.cfg, run.device
    run.inputs = inputs.make(cfg, run.seed, dev)
    run.pool = gen.train_pool(run.traffic, cfg["n_items"], run.seed, dev)
    feats, vae_w, dec_w = run.inputs
    with torch.no_grad():
        table = ref.corpus_table(vae_w, cfg, feats, ref.Arith(lower="tf32"))
    ar = ref.Arith(dtype=DTYPES[cfg["compute_dtype"]], lower="fp8")
    with ref.exact_fp32():
        losses, grads, w = ref.train_steps(dec_w, cfg, ar, run.pool, table, run.seed,
                                           FIRST_STEPS)
    return judge(run, table.cpu().numpy(), losses,
                 {k: float(v.norm()) for k, v in grads.items()},
                 {k: float((w[k] - dec_w[k]).norm()) for k in w})
