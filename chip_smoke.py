"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: python3 chip_smoke.py

Builds the kernels, holds each to its plain version, then drives each path
(serve ... scale) through its entry on seeded weights and data at the
configs' widths. Prints the kernels' JSON, then {"ok": true, "device":
{...}}; exits non-zero without a card; no JAX."""

import inspect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hidvae_tpu_torch.bridge import load_export_arrays, save_export, state_dict_to_flax
from hidvae_tpu_torch.data.processed import RecDataset, processed_path
from hidvae_tpu_torch.data.schemas import SeqBatch
from hidvae_tpu_torch.models.hrqvae import HRqVae
from hidvae_tpu_torch.models.attention import FLASH_MIN_TOKENS, takes_flash_route
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from hidvae_tpu_torch.models.rqvae import RqVae
from hidvae_tpu_torch.ops import flash_attention as fa
from hidvae_tpu_torch.ops import moe_experts as moe
from hidvae_tpu_torch.ops import rq_assign as rq
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from hidvae_tpu_torch.train import transformer as trainer
from hidvae_tpu_torch.train.common import repetition_rate, sync
from hidvae_tpu_torch.train.device_data import tokenize_on_device
from hidvae_tpu_torch.utils.ginlite import parse_gin_file
from hidvae_tpu_torch.utils.runtime import full_fp32

SEED = 0
# configs/{h_rqvae,decoder}_amazon.gin; 20-item histories; the P5 Sports split's items.
AMAZON = dict(
    input_dim=768, hidden_dims=(512, 256, 128), embed_dim=32, codebook_size=256,
    n_layers=3, codebook_normalize=True, tag_class_counts=(38, 168, 348),
    tag_embed_dim=768, decoder_embed_dim=128, attn_embed_dim=512, attn_heads=8,
    attn_layers=8, max_seq_len=20, n_items=18357,
)
# configs/{rqvae,decoder}_ml32m.gin (plain RQ-VAE route); ML-32M's movies, 200-item windows.
ML32M = dict(
    input_dim=768, hidden_dims=(512, 256, 128), embed_dim=64, codebook_size=256,
    n_layers=3, codebook_normalize=False, tag_class_counts=None, decoder_embed_dim=128,
    attn_embed_dim=384, attn_heads=6, attn_layers=8, max_seq_len=200, n_items=87585,
)
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
DECODER_AMAZON_GIN = os.path.join(CONFIGS, "decoder_amazon.gin")
DECODER_ML32M_GIN = os.path.join(CONFIGS, "decoder_ml32m.gin")
ARTIFACT_HISTORIES = 32  # histories in the written dataset, and per request
KERNEL_CASES = (  # (B, D, L, K)
    (8192, 32, 3, 256),      # one sweep chunk of the serving path
    (18357, 32, 3, 256),     # the whole Amazon corpus
    (1001, 32, 3, 256),      # odd B: a ragged last block
    (1048576, 32, 3, 256),   # 1M rows: the timed case
    (18357, 64, 3, 256),     # the ML-32M width
    (1001, 64, 3, 256),
    (18357, 128, 3, 256),    # the widest code the kernel is built for
    (1001, 128, 3, 256),
    (8192, 64, 3, 256),      # the ML-32M sweep's launches: 10 x 8,192 + 5,665 rows
    (5665, 64, 3, 256),
    (8192, 32, 4, 256),      # the mining audit's launches (L 4): 24 x 8,192 + 3,392 rows
    (3392, 32, 4, 256),
    (640, 32, 3, 256),       # tokenize_features of the serve batch: 32 x 20 rows
    (500, 16, 3, 64),        # the view tools' sweeps (D 16, K 64), and 8,192 rows of it
    (8192, 16, 3, 64),
)
TIMED_CASES = ((8192, 32, 3, 256), (1048576, 32, 3, 256), (8192, 64, 3, 256),
               (5665, 64, 3, 256), (8192, 32, 4, 256), (3392, 32, 4, 256),
               (640, 32, 3, 256), (500, 16, 3, 64), (8192, 16, 3, 64))
# Codes made identical: their nearest rows must get the first, as argmin does.
DUPLICATE_CODES = (3, 130, 255)
TIE_RTOL = 1e-5
KMEANS_ITERS = 10  # Lloyd steps of the seeded models' codebooks
QSUM_ATOL = 1e-5  # qsum on rows whose ids agree, as tests/test_torch_kernels.py holds it
# Flash kernels against the fp32 plain version, largest error over max
# |plain| (fp32 sums in another order; bf16 rounded as the library does).
FLASH_RTOL = {torch.float32: 2e-4, torch.bfloat16: 8e-3}
H100_FP32_FLOPS = 67e12     # outside the tensor cores, SXM data sheet
H100_BF16_FLOPS = 989e12    # dense tensor-core rate, SXM data sheet
H100_BYTES_PER_S = 3.35e12


def phase(name):
    """Decorator: print a phase's start and end (seconds)."""
    def wrap(fn):
        def run(*args, **kwargs):
            print(f"[phase] {name}: start")
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"[phase] {name}: end {time.perf_counter() - t0:.2f} s")
            return out
        return run
    return wrap


# ---- reference comparison

def near_tie_levels(x, codebooks):
    """Per row and level: the plain version's best two distances within TIE_RTOL * (1 + ||r||^2)."""
    res = x.float()
    ties = []
    with full_fp32():
        for level in range(codebooks.shape[0]):
            cb = codebooks[level]
            x2 = torch.sum(res * res, dim=-1, keepdim=True)
            dist = x2 + torch.sum(cb * cb, dim=-1)[None] - 2.0 * (res @ cb.T)
            two = torch.topk(dist, 2, dim=-1, largest=False).values
            ties.append((two[:, 1] - two[:, 0]) <= TIE_RTOL * (1.0 + x2[:, 0]))
            res = res - cb[torch.argmin(dist, dim=-1)]
    return torch.stack(ties, dim=-1)


def compare_ids(ids, ids_ref, ties):
    """(rows that differ, rows that differ where the first differing level is
    not a near tie)."""
    diff = ids != ids_ref
    rows = diff.any(dim=-1)
    first = torch.argmax(diff.to(torch.int32), dim=-1)
    tie_at_first = torch.gather(ties, 1, first[:, None])[:, 0]
    return int(rows.sum()), int((rows & ~tie_at_first).sum())


def median_ms(fn, runs=10, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches=20):
    """Device ms of one fn(): `launches` calls replayed from a CUDA graph (median of 5)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(launches):
            fn()
    return median_ms(graph.replay, runs=5, warmup=1) / launches


def bound_ms(ops, n_bytes, flops):
    """(ms, bound_by): the larger of `ops` over `flops` a second and bytes
    over the H100 SXM's memory rate."""
    t_ops, t_bytes = ops / flops * 1e3, n_bytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rq_bound_ms(b, d, n_levels, k):
    """rq_assign's bytes (inputs read, outputs written once) or 2*B*K*D*L
    at the fp32 rate: `bound_ms`."""
    return bound_ms(2.0 * b * k * d * n_levels,
                    4 * (b * d + n_levels * k * d + b * n_levels + b * d), H100_FP32_FLOPS)


# ---- model and corpus

def seed_codebooks_(vae, feats, generator):
    """k-means codebooks by level (K seeded residuals, KMEANS_ITERS Lloyd
    steps): the collapse guard sees a low repetition."""
    with torch.no_grad(), full_fp32():
        enc = vae.encode(feats)
        for q in vae.layers:
            k = q.embedding.shape[0]
            pick = torch.randperm(enc.shape[0], generator=generator)[:k].to(enc.device)
            codes = enc[pick]
            for _ in range(KMEANS_ITERS):
                dist = (torch.sum(codes * codes, dim=-1)[None]
                        - 2.0 * (enc @ codes.T))  # + ||enc||^2, the same for every code
                assign = torch.argmin(dist, dim=-1)
                total = torch.zeros_like(codes).index_add_(0, assign, enc)
                count = torch.bincount(assign, minlength=k)[:, None]
                codes = torch.where(count > 0, total / count.clamp(min=1), codes)
            q.embedding.copy_(codes)
            enc = enc - q(enc).embeddings


def unit_rows(n, dim, generator):
    """[n, dim] seeded unit-norm rows (text embeddings are unit-norm)."""
    x = torch.randn(n, dim, generator=generator)
    return x / x.norm(dim=-1, keepdim=True)


def write_items(path, feats, rng, hist=None, **arrays):
    """The processed .npz at `path`: `feats` (95 % train), `hist` (or one
    placeholder) and `arrays` (tags)."""
    n = len(feats)
    hist = np.zeros((1, 2), np.int32) if hist is None else hist.astype(np.int32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, item_features=feats, item_is_train=rng.rand(n) < 0.95,
             seq_users=np.arange(len(hist), dtype=np.int32), seq_items=hist,
             seq_fut=rng.randint(0, n, len(hist)).astype(np.int32),
             seq_is_train=np.ones(len(hist), bool), **arrays)


def build_vae(cfg, g):
    """(seeded stage-1 model, unit-norm CPU features): a HiD-VAE where cfg
    has tag counts, else the plain RQ-VAE."""
    feats = unit_rows(cfg["n_items"], cfg["input_dim"], g)
    widths = (cfg["input_dim"], cfg["embed_dim"], cfg["hidden_dims"], cfg["codebook_size"])
    common = dict(codebook_normalize=cfg["codebook_normalize"], n_layers=cfg["n_layers"])
    if cfg.get("tag_class_counts") is None:
        vae = RqVae(*widths, **common)
    else:
        vae = HRqVae(*widths, tag_class_counts=cfg["tag_class_counts"],
                     tag_embed_dim=cfg["tag_embed_dim"], **common)
    vae = init_params_(vae, g).eval()
    seed_codebooks_(vae, feats[: 16 * cfg["codebook_size"]], g)
    return vae, feats


def build_decoder(cfg, sem_id_dim, generator):
    """The stage-2 model at cfg's widths with seeded weights."""
    d = sem_id_dim
    return init_params_(EncoderDecoderRetrievalModel(
        cfg["decoder_embed_dim"], cfg["attn_embed_dim"], cfg["attn_heads"],
        cfg["attn_layers"], cfg["codebook_size"], d, max_pos=cfg["max_seq_len"] * d,
        n_sem_layers=cfg["n_layers"],
    ), generator)


def build_engine(cfg, device, seed=SEED, batch_buckets=(32,)):
    """(RetrievalEngine on seeded weights and corpus, features in numpy)."""
    g = torch.Generator().manual_seed(seed)
    vae, feats = build_vae(cfg, g)
    tok = HSemanticIdTokenizer(
        vae, n_layers=cfg["n_layers"], codebook_size=cfg["codebook_size"],
        tag_class_counts=cfg["tag_class_counts"], use_concatenated_ids=True, device=device,
    )
    model = build_decoder(cfg, tok.sem_ids_dim, g)
    items = feats.numpy()
    engine = RetrievalEngine(model, tok, items, max_seq_len=cfg["max_seq_len"],
                             batch_buckets=batch_buckets, device=device)
    return engine, items


def seeded_histories(n_items, batch, length, seed=SEED):
    """[batch, length] item histories; some rows ragged (-1 padded)."""
    rng = np.random.RandomState(seed + 1)
    hist = rng.randint(0, n_items, (batch, length)).astype(np.int64)
    for r in range(0, batch, 3):
        hist[r, rng.randint(1, length):] = -1
    return hist


def check_recommendations(engine, out, n_items):
    """Items in [0, n_items) or -1, resolved ones' tuples generated and in
    the table; scores descending. Returns the resolved count."""
    items = out["items"]
    if not ((items == -1) | ((items >= 0) & (items < n_items))).all():
        raise AssertionError("recommended item outside [0, n_items) and not -1")
    corpus = engine.corpus_ids.cpu().numpy()
    ok = items >= 0
    if not ok.any():
        raise AssertionError("no recommendation resolved to an item")
    if not (corpus[items[ok]] == out["sem_ids"][ok]).all():
        raise AssertionError("a recommended item's ID tuple differs from the generated one")
    table = {tuple(r) for r in corpus.tolist()}
    missing = sum(tuple(t) not in table for t in out["sem_ids"][ok].tolist())
    if missing:
        raise AssertionError(f"{missing} generated tuples are not in the corpus table")
    if not (np.diff(out["scores"], axis=1) <= 1e-6).all():
        raise AssertionError("beam scores are not descending")
    return int(ok.sum())


# ---- phases

@phase("card")
def card_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


@phase("build")
def build_phase():
    """Build every kernel source at once (one nvcc each); print each
    build's time, registers and spills."""
    modules = (("rq_assign", rq), ("flash_attention", fa))
    with ThreadPoolExecutor(len(modules)) as pool:
        futures = [(name, pool.submit(mod.build)) for name, mod in modules]
        built = [(name, f.result()) for name, f in futures]
    for name, lib in built:
        print(f"{name} built in {lib.build_s:.2f} s -> {lib.path.name}")
        for line in ptxas_report(lib.log):
            print(f"  ptxas: {line}")
    return built


def ptxas_report(log):
    """-Xptxas -v output, a line a kernel: name, width (causal), registers
    and spills."""
    lines = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"((?:flash|rq)_[a-z_]*kernel)(?:ILi(\d+)E(?:Lb([01])E)?)?", line)
            causal = {None: "", "0": ", not causal", "1": ", causal"}[m and m.group(3)]
            lines.append(f"{m.group(1)}<{m.group(2)}{causal}>:" if m else line.strip())
        elif lines and ("registers" in line or "spill" in line):
            lines[-1] += " " + line.split(":", 1)[-1].strip()
    return lines


def duplicate_codes_(x, cbs, generator):
    """DUPLICATE_CODES made identical at every level, every other row of x
    near level 0's. Returns those rows."""
    first, *rest = DUPLICATE_CODES
    for k in rest:
        cbs[:, k] = cbs[:, first]
    rows = torch.arange(0, x.shape[0], 2, device=x.device)
    noise = torch.randn(len(rows), x.shape[1], device=x.device, generator=generator)
    x[rows] = cbs[0, first] + 1e-3 * noise
    return rows


@phase("kernel")
def kernel_phase(device):
    """rq_assign against its plain version (KERNEL_CASES, duplicated codes),
    timed at TIMED_CASES. Returns the 1M-row record, `at_*` the paths'."""
    g = torch.Generator(device=device).manual_seed(SEED)
    records = {}
    cases = [(*c, False) for c in KERNEL_CASES] + [(*TIMED_CASES[0], True)]  # True: duplicates
    for b, d, n_levels, k, dup in cases:
        x = torch.randn(b, d, device=device, generator=g)
        x = x / x.norm(dim=-1, keepdim=True)
        cbs = torch.randn(n_levels, k, d, device=device, generator=g) * 0.5
        cbs[0] = cbs[0] / cbs[0].norm(dim=-1, keepdim=True)
        dup_rows = duplicate_codes_(x, cbs, g) if dup else None
        ids, qsum = rq.rq_assign(x, cbs)
        torch.cuda.synchronize()
        ids_ref, qsum_ref = rq.rq_assign_reference(x, cbs)
        n_diff, n_bad = compare_ids(ids, ids_ref, near_tie_levels(x, cbs))
        agree = ~(ids != ids_ref).any(dim=-1)
        qerr = float((qsum - qsum_ref)[agree].abs().max()) if agree.any() else 0.0
        label = f", codes {DUPLICATE_CODES} identical" if dup else ""
        print(f"  B={b} D={d} L={n_levels} K={k}{label}: ids off in {n_diff} rows (not near "
              f"ties: {n_bad}), qsum err {qerr:.3e}")
        if dup and not ((ids[dup_rows, 0] == DUPLICATE_CODES[0]).all()
                        and torch.isin(ids, ids.new_tensor(DUPLICATE_CODES[1:])).sum() == 0):
            raise AssertionError(f"rq_assign missed the first of the identical codes "
                                 f"{DUPLICATE_CODES}")
        if n_bad:
            raise AssertionError(f"rq_assign disagrees with the plain version on {n_bad} rows")
        if not torch.isfinite(qsum).all():
            raise AssertionError("rq_assign produced non-finite qsum")
        if not agree.any() or qerr > QSUM_ATOL:
            raise AssertionError(f"rq_assign qsum off the plain version by {qerr:.3e} "
                                 f"(tol {QSUM_ATOL})")
        if (b, d, n_levels, k) in TIMED_CASES and not dup:
            ms = median_ms(lambda: rq.rq_assign(x, cbs))
            g_ms = graph_ms(lambda: rq.rq_assign(x, cbs))
            plain_ms = median_ms(lambda: rq.rq_assign_reference(x, cbs))
            bound_ms, bound_by = rq_bound_ms(b, d, n_levels, k)
            plan = rq.staging(d, n_levels, k)
            records[b, d, n_levels] = dict(
                ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=qerr, shape=f"x[{b},{d}] codebooks[{n_levels},{k},{d}]", **plan)
            print(f"  {json.dumps(records[b, d, n_levels])}")
        del x, cbs, ids, qsum, ids_ref, qsum_ref
    main, big, ml_a, ml_b, mine_a, mine_b, tok, view_a, view_b = (c[:3] for c in TIMED_CASES)
    return dict(records[big], at_main_path_launch=records[main],
                at_view_launches=[records[view_a], records[view_b]],
                at_ml32m_launches=[records[ml_a], records[ml_b]],
                at_mining_launches=[records[mine_a], records[mine_b]],
                at_tokenize_launch=records[tok])


@phase("serve")
def serve_phase(device):
    cfg = AMAZON
    rq.rq_assign.launches = 0
    t0 = time.perf_counter()
    engine, items = build_engine(cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hist = seeded_histories(cfg["n_items"], 32, cfg["max_seq_len"])
    out = engine.recommend(hist, top_k=10)
    launches = rq.rq_assign.launches
    print(f"  engine built in {build_s:.2f} s; corpus {tuple(engine.corpus_ids.shape)}; "
          f"rq_assign launches {launches}")
    if launches == 0:
        raise AssertionError("the corpus sweep did not go through the CUDA kernel")
    resolved = check_recommendations(engine, out, cfg["n_items"])
    print(f"  recommend: items {out['items'].shape}, resolved {resolved}, "
          f"first row {out['items'][0].tolist()}")

    # The table against a plain sweep on the card (same encoder and tag heads).
    tok = engine.tokenizer
    n_l = cfg["n_layers"]
    sem_ref, ties, tags_ref = plain_sweep(tok.hrq_vae, torch.from_numpy(items).to(device),
                                          tok.corpus_chunk_size)
    got = engine.corpus_ids
    n_diff, n_bad = compare_ids(got[:, :n_l], sem_ref, ties)
    same = ~(got[:, :n_l] != sem_ref).any(dim=-1)
    tags_equal = bool((got[same, n_l:] == tags_ref[same]).all())
    print(f"  corpus table vs plain sweep: rows off {n_diff} (not near ties: {n_bad}); tags "
          f"equal on the rest {tags_equal}; distinct {len(torch.unique(engine.corpus_ids, dim=0))}")
    if n_bad or not tags_equal:
        raise AssertionError("corpus table differs from the plain sweep")
    tok_launches = check_tokenize_features(tok, items, hist)
    return launches, engine, items, hist, tok_launches


def check_tokenize_features(tok, items, hist):
    """tokenize_features of `hist` (one launch) against the table's gather:
    IDs but near ties, tags, -1 padding. Returns the launches."""
    valid = hist >= 0
    x = items[np.where(valid, hist, 0)]
    rq.rq_assign.launches = 0
    got = tok.tokenize_features(x, seq_mask=valid)
    launches = rq.rq_assign.launches
    dev = tok.device
    want = tok(SeqBatch(user_ids=torch.zeros(len(hist), dtype=torch.int32, device=dev),
                        ids=torch.from_numpy(hist).to(dev),
                        ids_fut=torch.zeros((len(hist), 1), dtype=torch.int64, device=dev),
                        x=None, x_fut=None, seq_mask=torch.from_numpy(valid).to(dev)))
    b, n = hist.shape
    d, n_l = tok.sem_ids_dim, tok.n_layers
    g, w = (t.sem_ids.reshape(b, n, d) for t in (got, want))
    keep = torch.from_numpy(valid).to(dev)
    with torch.inference_mode(), full_fp32():
        encoded = tok.hrq_vae.encode(torch.from_numpy(x[valid]).to(dev))
        ties = near_tie_levels(encoded, tok.hrq_vae.stacked_codebooks())
    n_diff, n_bad = compare_ids(g[keep][:, :n_l], w[keep][:, :n_l], ties)
    same = ~(g[keep][:, :n_l] != w[keep][:, :n_l]).any(dim=-1)
    tags_equal = bool((g[keep][same] == w[keep][same]).all())
    padded = bool((g[~keep] == -1).all()) and torch.equal(got.seq_mask, want.seq_mask)
    print(f"  tokenize_features of {b} x {n} ({int(valid.sum())} items, rq_assign launches "
          f"{launches}) vs the table's gather: items off {n_diff} (not near ties: {n_bad}); "
          f"tags equal on the rest {tags_equal}; padding and mask equal {padded}")
    want_launches = 1 if dev.type == "cuda" else 0
    if n_bad or not tags_equal or not padded or launches != want_launches:
        raise AssertionError(f"tokenize_features off the table's gather (launches "
                             f"{launches}, want {want_launches})")
    return launches


def plain_sweep(vae, feats, chunk):
    """(IDs, near-tie flags, predicted tags or None) of the plain rq_assign in `chunk`s."""
    ids, ties, tags = [], [], []
    with torch.inference_mode(), full_fp32():
        cbs = vae.stacked_codebooks()
        for s in range(0, feats.shape[0], chunk):
            encoded = vae.encode(feats[s:s + chunk])
            sem = rq.rq_assign_reference(encoded, cbs)[0]
            ids.append(sem)
            ties.append(near_tie_levels(encoded, cbs))
            if hasattr(vae, "predict_tags_from_ids"):
                tags.append(vae.predict_tags_from_ids(sem)["predictions"])
    return torch.cat(ids), torch.cat(ties), (torch.cat(tags) if tags else None)


def audit_table(name, model, tag_class_counts, feats, device, rep=None):
    """`feats`' table through rq_assign, held by hold_table. Returns
    (table, launches)."""
    kw = dict(n_layers=len(model.layers), codebook_size=model.codebook_size, device=device)
    tok = (SemanticIdTokenizer(model, **kw) if tag_class_counts is None else
           HSemanticIdTokenizer(model, tag_class_counts=tag_class_counts, **kw))
    rq.rq_assign.launches = 0
    got = tok.precompute_corpus_ids(feats)
    hold_table(f"{name}: audit table (rq_assign launches {rq.rq_assign.launches})", got, model,
               feats, device, tok.corpus_chunk_size, rep)
    return got, rq.rq_assign.launches


def hold_table(name, got, model, feats, device, chunk, rep=None):
    """Table `got` against a plain sweep: no row off but near ties, the
    audit's repetition `rep` where none differs."""
    ref, ties, _ = plain_sweep(model, torch.as_tensor(feats).to(device), chunk)
    n_diff, n_bad = compare_ids(got, ref, ties)
    rep_plain = repetition_rate(ref.cpu().numpy())[0]
    print(f"  {name}: rows off the plain sweep {n_diff} (not near ties: {n_bad}); repetition "
          f"{rep_plain:.4f} (audit {rep})")
    if n_bad or (rep is not None and n_diff == 0 and rep_plain != rep):
        raise AssertionError(f"{name}: the table differs from the plain sweep")


# ---- serving from artifacts

SCORE_ATOL = 1e-5  # scores of an engine rebuilt from artifacts against the in-process one


def structural_config(cfg):
    """The stage-1 model_config a JAX checkpoint records (STRUCTURAL_VAE_KEYS)."""
    tags = cfg.get("tag_class_counts")
    return dict(input_dim=cfg["input_dim"], embed_dim=cfg["embed_dim"],
                hidden_dims=list(cfg["hidden_dims"]), codebook_size=cfg["codebook_size"],
                codebook_normalize=cfg["codebook_normalize"], codebook_sim_vq=False,
                n_layers=cfg["n_layers"], n_cat_features=0,
                # null: not recorded (the plain RQ-VAE has no tag heads)
                tag_class_counts=None if tags is None else list(tags),
                tag_embed_dim=None if tags is None else cfg["tag_embed_dim"])


def paths(root):
    """dataset_folder `root`, save_dir_root root/runs, as gin literals."""
    return {"dataset_folder": f'"{root}"', "save_dir_root": f'"{os.path.join(root, "runs")}"'}


def vae_widths(cfg):
    """cfg's stage-1 encoder and codebook widths as gin bindings."""
    return {"vae_input_dim": cfg["input_dim"], "vae_hidden_dims": list(cfg["hidden_dims"]),
            "vae_embed_dim": cfg["embed_dim"], "vae_codebook_size": cfg["codebook_size"]}


def decoder_gin(source, cfg, folder, **bindings):
    """The gin `source` with cfg's widths, dataset_folder `folder` and `bindings` bound."""
    with open(source) as f:
        text = f.read()
    tags = cfg.get("tag_class_counts")
    values = {
        **vae_widths(cfg), "tag_class_counts": None if tags is None else list(tags),
        "tag_embed_dim": cfg.get("tag_embed_dim"), "decoder_embed_dim": cfg["decoder_embed_dim"],
        "attn_embed_dim": cfg["attn_embed_dim"], "attn_heads": cfg["attn_heads"],
        "attn_layers": cfg["attn_layers"], "dataset_folder": f'"{folder}"', **bindings,
    }
    lines, bound = [], set()
    for line in text.splitlines():
        key = line.split("=")[0].strip().removeprefix("train.")
        if values.get(key) is not None:
            line = f"train.{key} = {values[key]}"
            bound.add(key)
        lines.append(line)
    lines += [f"train.{k} = {v}" for k, v in bindings.items() if k not in bound]
    return "\n".join(lines) + "\n"


def write_artifacts(root, gin_source, cfg, vae, model, feats, hist, sem_table):
    """Under `root` the decoder gin, data and exports of `vae` and `model`.
    Returns (gin, stage-1, stage-2, rate)."""
    os.makedirs(root)
    gin = os.path.join(root, "decoder.gin")
    with open(gin, "w") as f:
        f.write(decoder_gin(gin_source, cfg, root))
    train = parse_gin_file(gin)["train"]
    path = processed_path(root, train["dataset"], train.get("dataset_split", "beauty"))
    os.makedirs(os.path.dirname(path))
    n_items, n_hist = len(feats), len(hist)
    np.savez(path, item_features=feats, item_is_train=np.ones(n_items, bool),
             seq_users=np.arange(n_hist, dtype=np.int32), seq_items=hist.astype(np.int32),
             seq_fut=np.random.RandomState(SEED + 5).randint(0, n_items, n_hist).astype(np.int32),
             seq_is_train=np.ones(n_hist, bool))
    rep = repetition_rate(sem_table)[0]
    s1 = save_export(os.path.join(root, "stage1"), vae, {
        "model_config": structural_config(cfg), "metrics": {"repetition_rate": rep}})
    return gin, s1, save_decoder_export(os.path.join(root, "stage2"), cfg, model), rep


def save_decoder_export(path, cfg, model):
    """`model` exported with the geometry the JAX trainer records."""
    d = model.sem_id_dim
    return save_export(path, model, {"model_config": {
        "attn_dim": cfg["attn_embed_dim"], "attn_embed_dim": cfg["attn_embed_dim"],
        "attn_heads": cfg["attn_heads"], "attn_layers": cfg["attn_layers"],
        "decoder_embed_dim": cfg["decoder_embed_dim"], "sem_id_dim": d,
        "num_embeddings": cfg["codebook_size"], "n_sem_layers": cfg["n_layers"],
        "use_interleaved_ids": False, "max_pos": cfg["max_seq_len"] * d,
    }, "metrics": {}})


def serve_from_artifacts(name, root, gin_source, cfg, vae, model, feats, hist, sem_table,
                         device):
    """write_artifacts, then from_artifacts (a launch per 8,192 rows). Returns (engine, launches)."""
    gin, s1, s2, rep = write_artifacts(root, gin_source, cfg, vae, model, feats, hist, sem_table)
    rq.rq_assign.launches = 0
    t0 = time.perf_counter()
    engine = RetrievalEngine.from_artifacts(gin, s1, s2, device=device,
                                            batch_buckets=(len(hist),))
    seconds = time.perf_counter() - t0  # the build ends in a synchronize
    launches = rq.rq_assign.launches
    bt = engine.build_times
    print(f"  {name}: from_artifacts {seconds:.3f} s ({json.dumps(bt)}); corpus "
          f"{tuple(engine.corpus_ids.shape)}; rq_assign launches {launches}; repetition {rep:.4f}")
    want = (math.ceil(cfg["n_items"] / engine.tokenizer.corpus_chunk_size)
            if device.type == "cuda" else 0)
    if launches != want:
        raise AssertionError(f"{name}: from_artifacts launched rq_assign {launches} times, "
                             f"not {want}")
    return engine, launches


def check_same_engine(name, got, want, hist):
    """Equal tables; for `hist`, equal items and ID tuples, scores within
    SCORE_ATOL."""
    if not torch.equal(got.corpus_ids.cpu(), want.corpus_ids.cpu()):
        raise AssertionError(f"{name}: the table from artifacts differs from the in-process one")
    a, b = got.recommend(hist, top_k=10), want.recommend(hist, top_k=10)
    err = float(np.abs(a["scores"] - b["scores"]).max())
    same = (a["items"] == b["items"]).all() and (a["sem_ids"] == b["sem_ids"]).all()
    print(f"  {name}: table equal to the in-process one's; {len(hist)} histories: items, "
          f"tuples equal {bool(same)}, max score diff {err:.3e} (tol {SCORE_ATOL})")
    if not same or err > SCORE_ATOL:
        raise AssertionError(f"{name}: the engine from artifacts serves differently")


@phase("artifacts")
def artifacts_phase(device, engine, items, hist, amazon=AMAZON, ml32m=ML32M):
    """from_artifacts on both routes (the engine rebuilt; a plain RQ-VAE at
    `ml32m`'s widths against a plain sweep). Returns the launches."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tok = engine.tokenizer
        sem = engine.corpus_ids[:, :amazon["n_layers"]].cpu().numpy()
        rebuilt, launches["amazon"] = serve_from_artifacts(
            "amazon", os.path.join(tmp, "amazon"), DECODER_AMAZON_GIN, amazon, tok.hrq_vae,
            engine.model, items, hist, sem, device)
        check_same_engine("amazon", rebuilt, engine, hist)
        del rebuilt

        cfg = ml32m
        g = torch.Generator().manual_seed(SEED + 3)
        vae, feats = build_vae(cfg, g)
        model = build_decoder(cfg, cfg["n_layers"], g)
        ml_hist = seeded_histories(cfg["n_items"], ARTIFACT_HISTORIES, cfg["max_seq_len"])
        sem_ref, ties, _ = plain_sweep(vae.to(device), feats.to(device), tok.corpus_chunk_size)
        rebuilt, launches["ml32m"] = serve_from_artifacts(
            "ml32m", os.path.join(tmp, "ml32m"), DECODER_ML32M_GIN, cfg, vae, model,
            feats.numpy(), ml_hist, sem_ref.cpu().numpy(), device)
        n_diff, n_bad = compare_ids(rebuilt.corpus_ids, sem_ref, ties)
        print(f"  ml32m: table vs plain sweep: rows off {n_diff} (not near ties: {n_bad}); "
              f"distinct {len(torch.unique(rebuilt.corpus_ids, dim=0))}")
        if n_bad:
            raise AssertionError("ml32m: the table from artifacts differs from the plain sweep")
        out = rebuilt.recommend(ml_hist, top_k=10)
        resolved = check_recommendations(rebuilt, out, cfg["n_items"])
        print(f"  ml32m: recommend {out['items'].shape}, resolved {resolved}, row 0 "
              f"{out['items'][0].tolist()}")
    return launches


# ---- flash attention

# One encoder layer of the long run: B 64, 8 heads of 64, 2,401 tokens padded.
FLASH_TIMED = dict(b=64, h=8, n=2432)
FLASH_HEAD_DIM = 64     # every config's; 128 is checked at FLASH_WIDE_B rows
FLASH_WIDE_B = 1
FLASH_CHECK_B = 4       # small enough for the plain backward at full length
FLASH_PLAIN_CHUNK = 16  # the plain version is timed over the batch in chunks of 16
FLASH_REPLACES = {k: f"jax/experimental/pallas/ops/tpu/flash_attention.py:{v}"  # jax 0.9.0
                  for k, v in (("flash_fwd", 331), ("flash_bwd_dkv", 796), ("flash_bwd_dq", 1146))}


def flash_inputs(b, h, n, dtype, device, generator, dh=FLASH_HEAD_DIM):
    """q, k, v, dO [b, h, n, dh] and segment ids [b, n]: 1 on a valid prefix of n/2 to n - 31, 0
    after."""
    q, k, v, do = (torch.randn(b, h, n, dh, device=device, generator=generator)
                   .to(dtype) for _ in range(4))
    lengths = torch.randint(n // 2, n - 30, (b,), device=device, generator=generator)
    seg = (torch.arange(n, device=device)[None, :] < lengths[:, None]).to(torch.int32)
    return q, k, v, do, seg


def keyless_segments(b, n, device, generator):
    """(seg_q, seg_kv): queries in segments 1-3, keys in 1-2 (segment 3 sees no key)."""
    seg_q = torch.randint(1, 4, (b, n), device=device, generator=generator, dtype=torch.int32)
    seg_q[:, 0] = 3
    seg_kv = torch.randint(1, 3, (b, n), device=device, generator=generator, dtype=torch.int32)
    return seg_q, seg_kv


def flash_bounds_ms(b, h, n, itemsize):
    """(ms, bound_by) of each flash kernel at [b, h, n, 64] on an H100 SXM:
    products (2, 4, 3 of 2*b*h*n^2*64) over peak, or bytes."""
    flops = H100_BF16_FLOPS if itemsize == 2 else H100_FP32_FLOPS
    product = 2.0 * b * h * n * n * FLASH_HEAD_DIM
    mat = b * h * n * FLASH_HEAD_DIM * itemsize
    seg = 2 * b * n * 4
    row = b * h * n * 4  # one fp32 value per query row
    work = {  # (products, bytes)
        "flash_fwd": (2, 3 * mat + seg + mat + 2 * row),
        "flash_bwd_dkv": (4, 4 * mat + seg + 3 * row + 2 * mat),
        "flash_bwd_dq": (3, 4 * mat + seg + 3 * row + mat),
    }
    return {name: bound_ms(n_products * product, n_bytes, flops)
            for name, (n_products, n_bytes) in work.items()}


def _in_chunks(fn, tensors, chunk):
    """Run fn on batch chunks of `tensors` (the plain version at a batch its
    [B, H, N, N] intermediates fit in)."""
    for s in range(0, tensors[0].shape[0], chunk):
        fn(*(t[s:s + chunk] for t in tensors))


# (B, Dh, dtype, causal, keyless rows) of the flash phase's checks.
FLASH_CHECKS = (
    *[(FLASH_CHECK_B, FLASH_HEAD_DIM, dtype, causal, False)
      for dtype in (torch.float32, torch.bfloat16) for causal in (False, True)],
    (FLASH_WIDE_B, 128, torch.bfloat16, False, False),
    (FLASH_WIDE_B, 128, torch.float32, True, False),
    *[(FLASH_WIDE_B, FLASH_HEAD_DIM, dtype, False, True)
      for dtype in (torch.bfloat16, torch.float32)],
)
# Causal with keyless rows: the tiles above the diagonal must be visited.
FLASH_CAUSAL_KEYLESS_CHECKS = tuple(
    (FLASH_WIDE_B, dh, dtype, True, True)
    for dh in (FLASH_HEAD_DIM, 128) for dtype in (torch.bfloat16, torch.float32))


def check_flash(device, g, checks):
    """O, dQ, dK, dV against the fp32 plain version per case of `checks`
    (FLASH_RTOL). Returns each kernel's largest error."""
    h, n = FLASH_TIMED["h"], FLASH_TIMED["n"]
    errs = {name: 0.0 for name in FLASH_REPLACES}
    for cb, dh, dtype, causal, keyless in checks:
        q, k, v, do, seg = flash_inputs(cb, h, n, dtype, device, g, dh)
        ids = fa.SegmentIds(*keyless_segments(cb, n, device, g)) if keyless else \
            fa.SegmentIds(seg, seg)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        sm = dh ** -0.5
        out = fa.flash_attention(qg, kg, vg, segment_ids=ids, causal=causal, sm_scale=sm)
        got = (out, *torch.autograd.grad(out, (qg, kg, vg), do))
        torch.cuda.synchronize()
        qr, kr, vr = (t.float().requires_grad_() for t in (q, k, v))
        ref = fa.flash_attention_reference(qr, kr, vr, segment_ids=ids, causal=causal,
                                           sm_scale=sm)
        want = (ref, *torch.autograd.grad(ref, (qr, kr, vr), do.float()))
        line = []
        for label, x, y, kernel in zip(("O", "dQ", "dK", "dV"), got, want,
                                       ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                        "flash_bwd_dkv")):
            err = float((x.detach().float() - y.detach()).abs().max())
            limit = FLASH_RTOL[dtype] * float(y.detach().abs().max())
            if not torch.isfinite(x).all() or err > limit:
                raise AssertionError(f"flash {label} ({dtype}, Dh {dh}, causal={causal}, "
                                     f"keyless={keyless}): {err:.3e} > {limit:.3e}")
            errs[kernel] = max(errs[kernel], err)
            line.append(f"{label} {err:.2e} (limit {limit:.2e})")
        if keyless:
            sees = ids.q[:, :, None] == ids.kv[:, None, :]
            if causal:
                sees &= torch.ones(n, n, dtype=torch.bool, device=device).tril()
            rows = f", {int((~sees.any(dim=-1)).sum())} keyless query rows"
        else:
            rows = ""
        print(f"  B={cb} H={h} N={n} Dh={dh} {str(dtype)[6:]} causal={causal}{rows}: "
              + ", ".join(line))
        del q, k, v, do, qg, kg, vg, out, got, qr, kr, vr, ref, want
    return errs


def flash_kernel_ms(q, k, v, do, seg, causal, scale):
    """Median ms of each flash kernel on these inputs (segment ids `seg`
    for queries and keys)."""
    o, m, l = fa.flash_fwd(q, k, v, seg, seg, causal, scale)
    di = torch.sum(o.float() * do.float(), dim=-1)
    args = (seg, seg)
    return {
        "flash_fwd": median_ms(lambda: fa.flash_fwd(q, k, v, *args, causal, scale)),
        "flash_bwd_dkv": median_ms(
            lambda: fa.flash_bwd_dkv(q, k, v, *args, do, m, l, di, causal, scale)),
        "flash_bwd_dq": median_ms(
            lambda: fa.flash_bwd_dq(q, k, v, *args, do, m, l, di, causal, scale)),
    }


@phase("flash")
def flash_phase(device):
    """The flash kernels' times at B 64 beside the plain version, SDPA and the bounds; then the
    checks."""
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    h, n = FLASH_TIMED["h"], FLASH_TIMED["n"]
    scale = FLASH_HEAD_DIM ** -0.5

    # Times: the trainer's case, bf16, not causal; then the same inputs causal.
    b = FLASH_TIMED["b"]
    q, k, v, do, seg = flash_inputs(b, h, n, torch.bfloat16, device, g)
    ms = flash_kernel_ms(q, k, v, do, seg, False, scale)
    causal_ms = flash_kernel_ms(q, k, v, do, seg, True, scale)
    print("  causal, same inputs: " + ", ".join(f"{name} {t:.4f} ms"
                                              for name, t in causal_ms.items()))
    o, m, l = fa.flash_fwd(q, k, v, seg, seg, False, scale)
    di = torch.sum(o.float() * do.float(), dim=-1)
    args = (seg, seg)
    c = FLASH_PLAIN_CHUNK
    plain = {
        "flash_fwd": median_ms(lambda: _in_chunks(
            lambda *t: fa.flash_fwd_reference(*t, False, scale), (q, k, v, seg, seg), c), 3, 1),
        "flash_bwd_dkv": median_ms(lambda: _in_chunks(
            lambda *t: fa.flash_bwd_dkv_reference(*t, False, scale),
            (q, k, v, seg, seg, do, m, l, di), c), 3, 1),
        "flash_bwd_dq": median_ms(lambda: _in_chunks(
            lambda *t: fa.flash_bwd_dq_reference(*t, False, scale),
            (q, k, v, seg, seg, do, m, l, di), c), 3, 1),
    }
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    ids = fa.SegmentIds(seg, seg)

    def kernel_fwd_bwd():
        out = fa.flash_attention(qg, kg, vg, segment_ids=ids, sm_scale=scale)
        torch.autograd.grad(out, (qg, kg, vg), do)

    mask = (seg[:, :, None] == seg[:, None, :])[:, None]  # [B, 1, N, N] bool

    def sdpa_fwd():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        torch.autograd.grad(out, (qg, kg, vg), do)

    fwd_bwd_ms = median_ms(kernel_fwd_bwd)
    sdpa_ms, sdpa_fwd_bwd_ms = median_ms(sdpa_fwd), median_ms(sdpa_fwd_bwd)
    # SDPA's backward alone on a retained graph: both backward kernels' library time.
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    sdpa_bwd_ms = median_ms(
        lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do, retain_graph=True))
    del sdpa_out
    bounds = flash_bounds_ms(b, h, n, 2)
    for name in FLASH_REPLACES:
        print(f"  {name}: kernel {ms[name]:.4f} ms, plain {plain[name]:.4f} ms (chunks of {c}), "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) at B={b} H={h} N={n} bf16")
    print(f"  forward + backward (autograd, with di): kernels {fwd_bwd_ms:.4f} ms; SDPA "
          f"forward {sdpa_ms:.4f}, backward {sdpa_bwd_ms:.4f} (kernels "
          f"{ms['flash_bwd_dkv'] + ms['flash_bwd_dq']:.4f}), both {sdpa_fwd_bwd_ms:.4f}")
    del o, m, l, di, qg, kg, vg
    errs = check_flash(device, g, FLASH_CHECKS + FLASH_CAUSAL_KEYLESS_CHECKS)
    records = {}
    for name in FLASH_REPLACES:
        records[name] = dict(
            max_abs_err=errs[name], ms=ms[name], plain_ms=plain[name],
            bound_ms=bounds[name][0], bound_by=bounds[name][1],
            library_ms=sdpa_ms if name == "flash_fwd" else None,
            shape=f"q,k,v[{b},{h},{n},{FLASH_HEAD_DIM}] bf16, seg[{b},{n}], not causal")
        if name != "flash_fwd":  # no one call computes dK, dV or dQ alone
            records[name]["sdpa_backward_ms"] = sdpa_bwd_ms
    return records


# ---- routed experts (ops/moe_experts.py)

MOE_TOKENS = {"decode": 8192, "prefill": 12400}  # 256 x 32 beam rows; a page's prefill
MOE_TINY = dict(hidden=64, width=24, experts=8, top_k=2)
# Each expert's slots at top 2: tiles of 1, 127, 128, 129 rows, empty
# experts, one (of 8 or 64) with every row, one token
MOE_ROUTINGS = ([5, 0, 300, 128, 129, 0, 1, 65], [0, 0, 1000, 0, 0, 0, 0, 0],
                [3, 0, 0, 0, 0, 0, 0, 1], [0] * 63 + [4096], [128] * 8,
                [127, 129, 0, 0, 0, 0, 0, 2], [256] + [0] * 7, [1, 0, 0, 0, 0, 0, 1, 0])
MOONLIGHT = os.path.join(CONFIGS, os.pardir, "perfbench", "configs", "moonlight_p5sports.json")
MOE_KERNELS = ("_gate_up_kernel", "_down_kernel", "_combine_kernel")


def moe_inputs(t, device, g, hidden=2048, width=1408, experts=64, top_k=6, rows=None):
    """Seeded bf16 `grouped_swiglu` arguments: expert 1 in no slot, 3 in
    ~30 % (a token may name an expert twice); or each expert in `rows`[e]
    of the t * top_k slots."""
    if rows is None:
        p = torch.ones(experts, device=device)
        p[1], p[3] = 0, 0.45 * experts
        flat = torch.multinomial(p, t * top_k, replacement=True, generator=g)
    else:
        flat = torch.repeat_interleave(torch.tensor(rows, device=device))[
            torch.randperm(t * top_k, device=device, generator=g)]
    rnd = lambda *shape: torch.randn(*shape, device=device, generator=g)  # noqa: E731
    return dict(x=rnd(t, hidden).bfloat16(), w=torch.rand(t, top_k, device=device, generator=g),
                order=torch.argsort(flat, stable=True),
                ends=torch.cumsum(torch.bincount(flat, minlength=experts), 0, dtype=torch.int32),
                gate_up=(rnd(experts, 2 * width, hidden) * hidden ** -0.5).bfloat16(),
                down=(rnd(experts, hidden, width) * width ** -0.5).bfloat16(),
                shared=rnd(t, hidden).bfloat16())


def moe_errors(x, w, order, ends, gate_up, down, shared,
               fns=(moe.grouped_swiglu, moe.grouped_swiglu_plain)):
    """Each of `fns`' largest error against fp32, by expert."""
    args, k = (x, w, order, ends, gate_up, down, shared), w.shape[1]
    y = torch.zeros(order.numel(), x.shape[1], device=x.device)
    with full_fp32():
        for e, rows in enumerate(order.tensor_split(ends[:-1].tolist())):
            g, u = (x[rows // k].float() @ gate_up[e].float().T).chunk(2, -1)
            y[rows] = (torch.nn.functional.silu(g) * u) @ down[e].float().T
    want = (y.view(*w.shape, -1) * w[..., None]).sum(1) + shared.float()
    return [float((f(*args).float() - want).abs().max()) for f in fns]


def moe_bounds_ms(t, hidden=2048, width=1408, experts=64, top_k=6):
    """{launch: (ms, bound_by)}: products over the bf16 peak or bytes in and
    out once over HBM's rate (H100 SXM)."""
    r, ecw = t * top_k, experts * hidden * width
    work = {"_gate_up_kernel": (4 * r * hidden * width, t * hidden + 2 * ecw + r * width),
            "_down_kernel": (2 * r * width * hidden, r * width + ecw + r * hidden),
            "_combine_kernel": (0, r * hidden + 2 * r + 2 * t * hidden),  # w fp32: 2 r
            "all": (6 * r * hidden * width, 3 * t * hidden + 3 * ecw + 2 * r)}
    return {name: bound_ms(ops, 2 * n_bytes, H100_BF16_FLOPS)
            for name, (ops, n_bytes) in work.items()}


def launch_ms(fn, names, calls=5):
    """Device ms a call of each kernel in `names` (torch.profiler; None unseen)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {n: next((ev.device_time_total / 1e3 / calls for ev in prof.key_averages()
                     if n in ev.key and ev.device_time_total), None) for n in names}


def moonlight_page(tok, items, device, g, users=256):
    """(`grouped_swiglu` launches, 3 a MoE layer in the prefill and each
    digit, `_grouped_mm` calls) in a page of a seeded Moonlight retriever."""
    from hidvae_tpu_torch.models.mla_moe import MlaMoeRetrievalModel

    with open(MOONLIGHT) as f:
        cfg = json.load(f)
    with torch.device(device):
        model = MlaMoeRetrievalModel(cfg, cfg["codebook_size"], tok.sem_ids_dim,
                                     n_sem_layers=cfg["n_layers"], user_buckets=cfg["user_buckets"])
    for p in model.eval().requires_grad_(False).parameters():
        if p.dim() > 1:  # products by fan-in, token rows by width; norms stay 1
            torch.nn.init.normal_(p, std=p.shape[-1] ** -0.5, generator=g)
    engine = RetrievalEngine(model, tok, items, max_seq_len=cfg["max_seq_len"],
                             batch_buckets=(users,), device=device)
    hist = seeded_histories(len(items), users, cfg["max_seq_len"])
    moe.grouped_swiglu.launches = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = engine.recommend(hist, top_k=10)
    check_recommendations(engine, out, len(items))
    n_moe = sum(layer.is_moe for layer in model.layers)
    return (moe.grouped_swiglu.launches, 3 * n_moe * (1 + tok.sem_ids_dim),
            sum(ev.count for ev in prof.key_averages() if ev.key == "aten::_grouped_mm"))


@phase("moe")
def moe_phase(device, tok, items):
    """grouped_swiglu against fp32 beside the plain version, timed (each
    launch, bounds, plain, the library's products alone); its launches, and
    no `_grouped_mm`, in a Moonlight page."""
    g = torch.Generator(device=device).manual_seed(SEED + 25)
    t0 = time.perf_counter()
    moe.grouped_swiglu(**moe_inputs(MOE_TOKENS["decode"], device, g))  # compiles
    torch.cuda.synchronize()
    records = {"first_call_s": time.perf_counter() - t0}
    for name, t in MOE_TOKENS.items():
        args = moe_inputs(t, device, g)
        err, plain_err = moe_errors(**args)
        if not err <= 1.25 * plain_err:
            raise AssertionError(f"grouped_swiglu at {name}: {err:.3e}, plain {plain_err:.3e}")
        xs, hs = args["x"][args["order"] // 6], torch.randn(t * 6, 1408, device=device).bfloat16()
        gt, dn = (args[a].transpose(1, 2) for a in ("gate_up", "down"))
        bounds = moe_bounds_ms(t)
        rec = dict(ms=median_ms(lambda: moe.grouped_swiglu(**args)),
                   plain_ms=median_ms(lambda: moe.grouped_swiglu_plain(**args)),
                   library_ms=median_ms(lambda: (torch._grouped_mm(xs, gt, offs=args["ends"]),
                                                 torch._grouped_mm(hs, dn, offs=args["ends"]))),
                   bound_ms=bounds["all"][0], bound_by=bounds["all"][1], max_abs_err=err,
                   plain_max_abs_err=plain_err, shape=f"x[{t},2048] bf16, 64 x 1408, top 6")
        for kname, ms in launch_ms(lambda: moe.grouped_swiglu(**args), MOE_KERNELS).items():
            rec[kname] = dict(ms=ms, bound_ms=bounds[kname][0], bound_by=bounds[kname][1])
        print(f"  {name}: {json.dumps(rec)}")
        records[name] = rec
    launches, want, grouped = moonlight_page(tok, items, device, g)
    print(f"  a Moonlight page: {launches} grouped_swiglu launches, {grouped} _grouped_mm")
    if launches != want or grouped:
        raise AssertionError(f"a Moonlight page: {launches} launches, not {want}; {grouped} "
                             "_grouped_mm")
    records["page_launches"] = launches
    torch.cuda.empty_cache()
    return records


# ---- training

TRAIN_RUNS = (  # (name, max_seq_len, batch, steps): only the history length changes
    ("short", 20, 256, 15),
    ("long", 400, 64, 10),  # 1 + 400 * 6 = 2,401 tokens: the flash route
)
TRAIN_SEQS = 2048   # training histories per run
EVAL_BATCHES = 1    # eval-loss batches at the end of a run
FIXED_STEPS = 8     # steps on one fixed batch, which must lower its loss


def seeded_sequences(n_items, n_seqs, length, seed):
    """(users, items [n_seqs, length] -1 padded at the end, fut)."""
    rng = np.random.RandomState(seed)
    items = rng.randint(0, n_items, (n_seqs, length))
    lengths = rng.randint(max(1, length // 4), length + 1, n_seqs)
    items[np.arange(length)[None, :] >= lengths[:, None]] = -1
    return np.arange(n_seqs) * 7, items, rng.randint(0, n_items, n_seqs)


def kernel_launches():
    """Every kernel wrapper's launch count, by kernel name."""
    return {"rq_assign": rq.rq_assign.launches, **{fn.__name__: fn.launches for fn in fa.KERNELS}}


def decoder_widths(cfg, seed=SEED, model=False):
    """cfg's decoder widths and `seed` as train_arrays (model: build_model)
    takes them."""
    out = dict(vae_codebook_size=cfg["codebook_size"], vae_n_layers=cfg["n_layers"],
               decoder_embed_dim=cfg["decoder_embed_dim"], attn_heads=cfg["attn_heads"],
               attn_embed_dim=cfg["attn_embed_dim"], attn_layers=cfg["attn_layers"], seed=seed)
    return out if model else dict(out, tag_class_counts=cfg["tag_class_counts"],
                                  use_concatenated_ids=True)


def train_run(cfg, vae, feats, device, max_seq_len, batch, steps, seed=SEED, log=print):
    """train_arrays at cfg's widths on seeded histories, counts reset. Returns (result, launches,
    data)."""
    users, items, fut = seeded_sequences(cfg["n_items"], TRAIN_SEQS, max_seq_len, seed + 11)
    rq.rq_assign.launches = 0
    fa.reset_launches()
    result = trainer.train_arrays(
        feats, users, items, fut, vae=vae, iterations=steps, batch_size=batch,
        **decoder_widths(cfg, seed), log_every=1, partial_eval_every=steps, eval_batches=EVAL_BATCHES,
        eval_users=users[:batch], eval_items=items[:batch], eval_fut=fut[:batch],
        device=device, log=log, mixed_precision_type=cfg.get("precision", "bf16"),
    )
    sync(device)
    return result, kernel_launches(), (users, items, fut)


def fixed_batch_descent(result, data, batch, steps, seed=SEED):
    """Eval loss of one fixed batch before and after `steps` train steps on
    it (with dropout)."""
    model, opt = result["model"], result["optimizer"]
    table = result["tokenizer"].cached_ids.to(torch.int32)
    dev = table.device
    rows = trainer.as_seq_data(*(a[:batch] for a in data), dev)
    fixed = tokenize_on_device(table, rows.user_ids, rows.items, rows.fut)
    with torch.no_grad():
        before = float(model(fixed).loss)
    for i in range(steps):
        trainer.train_step(model, opt, fixed, trainer.step_generator(seed + 1, i, dev))
    with torch.no_grad():
        after = float(model(fixed).loss)
    return before, after


def check_train_run(name, result, launches, steps, n_encoder_layers=4, flash=False):
    """Finite losses, rq_assign launched, flash launches per encoder layer on
    the flash route, none off it."""
    hist = result["history"]
    losses = hist["train_loss"] + hist["eval_loss"]
    if len(hist["train_loss"]) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} run: losses not finite or missing: {losses}")
    if launches["rq_assign"] < 1:
        raise AssertionError(f"{name} run: the corpus sweep did not launch rq_assign")
    want = {"flash_fwd": n_encoder_layers * (steps + EVAL_BATCHES),
            "flash_bwd_dkv": n_encoder_layers * steps,
            "flash_bwd_dq": n_encoder_layers * steps}
    if not flash:
        want = {k: 0 for k in want}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{name} run: flash launches {got}, expected {want}")


@phase("train")
def train_phase(device, flash_ms_per_layer):
    """The short and long trainer runs and their fixed-batch checks. Returns the long run's
    launches."""
    cfg = AMAZON
    vae, feats = build_vae(cfg, torch.Generator().manual_seed(SEED))
    n_enc = cfg["attn_layers"] // 2
    runs = {}
    for name, max_seq_len, batch, steps in TRAIN_RUNS:
        t0 = time.perf_counter()
        result, launches, data = train_run(cfg, vae, feats, device, max_seq_len, batch, steps,
                                           log=lambda line: print(f"  {line}"))
        context = 1 + max_seq_len * result["tokenizer"].sem_ids_dim  # user + history tokens
        flash = context >= FLASH_MIN_TOKENS
        check_train_run(name, result, launches, steps, n_encoder_layers=n_enc, flash=flash)
        hist = result["history"]
        step_ms = statistics.median(hist["ms_per_step"][1:])
        print(f"  {name} run: max_seq_len {max_seq_len}, batch {batch}, {steps} steps "
              f"{time.perf_counter() - t0:.2f} s; {step_ms:.2f} ms/step (first "
              f"{hist['ms_per_step'][0]:.2f}); eval loss {hist['eval_loss'][-1]:.4f}; "
              f"launches {launches}")
        if flash:
            share = n_enc * flash_ms_per_layer / step_ms
            print(f"  {name} run: flash kernels {n_enc * flash_ms_per_layer:.2f} ms of a "
                  f"{step_ms:.2f} ms step ({100 * share:.1f} %, by the flash phase's times)")
        runs[name] = (result, launches, data, batch)
    for name, (result, launches, data, batch) in runs.items():
        before, after = fixed_batch_descent(result, data, batch, FIXED_STEPS)
        print(f"  {name} run: fixed batch of {batch}, eval loss {before:.4f} -> {after:.4f} "
              f"after {FIXED_STEPS} steps")
        if not (np.isfinite(after) and after < before):
            raise AssertionError(f"{name} run: steps on a fixed batch did not lower its loss")
    return runs["long"][1], vae, feats


# ---- the stage-1 trainer from its gin entry

H_RQVAE_AMAZON_GIN = os.path.join(CONFIGS, "h_rqvae_amazon.gin")
STAGE1_N = 4              # mini-steps between evals, audits and saves: the run takes 2N
STAGE1_EVAL_BATCHES = 2   # eval batches of 128 items
STAGE1_TAG_SKEW = 0.9     # tag class i is drawn with weight (i + 1)^-0.9: a rare tail to remap
STAGE1_TIMED = (3, 10)    # warm-up and timed updates of each throughput setting
# (name, batch, gradient accumulation): the gin's own, and one batch of the same items
STAGE1_SETTINGS = (("gin", 128, 2), ("batch256", 256, 1))


def write_stage1_inputs(root, cfg, feats, seed=SEED):
    """The processed Amazon data of `feats` with seeded power-law tags of cfg's counts. Returns its
    path."""
    rng = np.random.RandomState(seed + 31)
    n = len(feats)
    idx, emb = [], []
    for c in cfg["tag_class_counts"]:
        p = 1.0 / np.arange(1, c + 1) ** STAGE1_TAG_SKEW
        level = rng.choice(c, n, p=p / p.sum()).astype(np.int32)
        table = (rng.randn(c, cfg["tag_embed_dim"]) / math.sqrt(cfg["tag_embed_dim"]))
        idx.append(level)
        emb.append(table.astype(np.float32)[level])
    path = processed_path(root, RecDataset.AMAZON, "sports")
    write_items(path, feats, rng, tags_emb=np.stack(emb, axis=1),
                tags_indices=np.stack(idx, axis=1))
    return path


def cut_gin(source, path, values, show=False):
    """Write `path`: the gin `source` with `values` (gin literals) bound; `show` prints the cuts."""
    with open(source) as f:
        text = f.read()
    lines, bound, cuts = [], set(), []
    for line in text.splitlines():
        key = line.split("=")[0].strip().removeprefix("train.")
        if key in values and "=" in line:
            was = line.split("=", 1)[1].strip()
            line = f"train.{key} = {values[key]}"
            bound.add(key)
            if was != str(values[key]):
                cuts.append(f"{key} {was} -> {values[key]}")
        lines.append(line)
    lines += [f"train.{k} = {v}" for k, v in values.items() if k not in bound]
    cuts += [f"{k} (unset) -> {v}" for k, v in values.items() if k not in bound]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if show:
        print(f"  {os.path.basename(source)} cut for this run: " + "; ".join(cuts))
    return path


def stage1_gin(root, cfg, mini_steps, n=STAGE1_N, **bindings):
    """configs/h_rqvae_amazon.gin at cfg's widths on root's data, evals, audits and saves every n."""
    accumulate = parse_gin_file(H_RQVAE_AMAZON_GIN)["train"]["gradient_accumulate_every"]
    values = {
        "iterations": mini_steps // accumulate, "save_model_every": n, "eval_every": n,
        **vae_widths(cfg), "tag_class_counts": list(cfg["tag_class_counts"]),
        "tag_embed_dim": cfg["tag_embed_dim"],
        **paths(root),
        "eval_batches": STAGE1_EVAL_BATCHES, **bindings,
    }
    return cut_gin(H_RQVAE_AMAZON_GIN, os.path.join(root, f"h_rqvae_{mini_steps}.gin"), values)


def check_run(name, result, launches, steps, evals, device, n_items, saves=None):
    """Steps, evals, saves on the cadence, finite losses, a rq_assign launch
    per 8,192 items an audit (card), no flash. Returns the last save."""
    hist = result["history"]
    got = [os.path.basename(p) for p in result["saved_paths"]]
    if (result["step"] != steps or hist["eval_iterations"] != evals
            or (got != saves if saves else "latest" not in got)):
        raise AssertionError(f"{name}: step {result['step']}, evals {hist['eval_iterations']}, "
                             f"saves {got}; expected {steps}, {evals}, {saves or 'latest'}")
    if not all(math.isfinite(v) for v in hist["total_loss"] + hist["eval_total_loss"]):
        raise AssertionError(f"{name}: losses not finite")
    want = {"rq_assign": math.ceil(n_items / 8192) * len(evals) if device.type == "cuda" else 0,
            **{fn.__name__: 0 for fn in fa.KERNELS}}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    return [p for p in result["saved_paths"] if saves or os.path.basename(p) == "latest"][-1]


def check_stage1_run(name, result, launches, steps, evals, device, n_items):
    """check_run, and `latest`'s meta holding the model_config and the
    audit's repetition rate. Returns that rate."""
    latest = check_run(name, result, launches, steps, evals, device, n_items)
    with open(os.path.join(latest, "meta.json")) as f:
        meta = json.load(f)
    rep = meta.get("metrics", {}).get("repetition_rate")
    if rep is None or meta.get("model_config", {}).get("tag_class_counts") != \
            list(result["tag_class_counts"]):
        raise AssertionError(f"{name}: latest's meta lacks the model_config or the audit: {meta}")
    return rep

def device_busy(run, device):
    """(kernels, busy ms: the union of their spans) of one traced run()."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy, end = 0.0, None
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy += max(0.0, stop - max(start, end if end is not None else start))
        end = stop if end is None else max(end, stop)
    return len(kernels), busy / 1e3


def time_updates(name, update, batch, accumulate, device, timed):
    """Items/s of `update()`, median of timed[1] after timed[0] (the card:
    one more traced). Prints, returns the record."""
    times = []
    for _ in range(sum(timed)):
        sync(device)
        t0 = time.perf_counter()
        update()
        sync(device)
        times.append(time.perf_counter() - t0)
    t = statistics.median(times[timed[0]:])
    launches, busy = device_busy(update, device) if device.type == "cuda" else (None, None)
    busy_note = ("" if busy is None else f"; traced update: {launches} kernels, device busy "
                 f"{busy:.2f} ms ({100 * busy / (t * 1e3):.1f} % of the median update)")
    print(f"  throughput {name}: batch {batch} x {accumulate}, {t * 1e3:.2f} ms/update, "
          f"median of {timed[1]} after {timed[0]} ({min(times[timed[0]:]) * 1e3:.2f}-"
          f"{max(times[timed[0]:]) * 1e3:.2f}; {t * 1e3 / accumulate:.2f} ms/mini-step): "
          f"{batch * accumulate / t:.0f} items/s{busy_note}")
    return dict(batch=batch, accumulate=accumulate, items_per_s=batch * accumulate / t,
                ms_per_update=t * 1e3, ms_per_mini_step=t * 1e3 / accumulate,
                kernels_per_update=launches, device_busy_ms=busy)


def stage1_throughput(result, gin, device, settings=STAGE1_SETTINGS, timed=STAGE1_TIMED,
                      seed=SEED):
    """Items/s of the trained model per setting, under the optimizer that
    the bindings of `gin` build."""
    from hidvae_tpu_torch.train import hidvae as s1

    model, data, n_pairs = result["model"], result["data"], result["n_pair_rows"]
    defaults = inspect.signature(s1.train).parameters
    bindings = {k: gin.get(k, defaults[k].default)
                for k in list(inspect.signature(s1.build_optimizer).parameters)[1:]}
    out = {}
    for name, batch, accumulate in settings:
        opt, _ = s1.build_optimizer(model, **{**bindings, "gradient_accumulate_every": accumulate})
        step = s1.make_train_step(model, opt, result["class_counts"], n_mined_pairs=n_pairs)
        counter = iter(range(1_000_000, 2_000_000))

        def update():
            for _ in range(accumulate):
                g, host = s1.step_rngs(seed, next(counter), device)
                step(*data.sample(g, batch, n_pairs), g, host)

        out[name] = time_updates(name, update, batch, accumulate, device, timed)
    return out


@phase("stage1")
def stage1_phase(device, feats, root, cfg=AMAZON, n=STAGE1_N, settings=STAGE1_SETTINGS,
                 timed=STAGE1_TIMED, **bindings):
    """The stage-1 entry at cfg's widths: 2N mini-steps, N + resumed N held
    to it, the table, throughput. Returns (latest, record)."""
    script = load_script("torch_train_hidvae")
    feats_np = np.asarray(feats)
    n_items = len(feats_np)
    path = write_stage1_inputs(root, cfg, feats_np)
    print(f"  wrote {os.path.getsize(path) / 2**20:.1f} MiB ({n_items} items, tags of "
          f"{list(cfg['tag_class_counts'])} classes)")
    gin_2n = stage1_gin(root, cfg, 2 * n, n, **bindings)
    gin_n = stage1_gin(root, cfg, n, n, **bindings)
    full, launches, seconds = run_trainer_entry(script, device, gin_2n)
    rep = check_stage1_run("2N run", full, launches, 2 * n, [n, 2 * n], device, n_items)
    hist = full["history"]
    print(f"  2N run ({2 * n} mini-steps) {seconds:.2f} s: loss {hist['total_loss']}, eval "
          f"{hist['eval_total_loss']}, tags {full['tag_class_counts']} (of "
          f"{list(cfg['tag_class_counts'])}), repetition {hist['repetition_rate']}, rare tags "
          f"{[len(v) for v in full['rare_tags'].values()]}; launches {launches}")
    rare = os.path.join(root, "runs", "special_tags_files", "rare_tags.npz")
    if not os.path.exists(rare) or list(full["tag_class_counts"]) == list(cfg["tag_class_counts"]):
        raise AssertionError("stage1: the rare-tag remap did not run or wrote no rare_tags.npz")

    gin = parse_gin_file(gin_2n)["train"]
    half, resumed, runs, gaps = resume_runs(
        script, device, gin_n, n, lambda *a: check_stage1_run(*a, device, n_items), full,
        updates=2 * n // gin["gradient_accumulate_every"], stats=True)

    model = full["model"]
    _, table_launches = audit_table("stage1", model, full["tag_class_counts"], feats_np, device,
                                    rep)

    throughput = stage1_throughput(full, gin, device, settings, timed)
    record = dict(launches={"2N run": launches["rq_assign"], **runs, "table": table_launches},
                  resume_gaps=gaps, throughput=throughput, repetition_rate=rep,
                  tag_class_counts=list(full["tag_class_counts"]))
    save = latest(full)
    del full, half, resumed, model
    return save, record


# ---- the trainer from its gin entry

TRAINER_N = 5             # steps between evals and saves: the run takes 2N, the resume N + N
TRAINER_SPLITS = (2048, 300, 300)  # train, eval and test histories in the written dataset
TRAINER_EVAL_BATCHES = 2  # eval batches of 256: the second holds 44 rows, padded
# Resumed against uninterrupted (atomic adds in another order): L2 gaps of
# params over the last N steps' update, moments over their norm.
RESUME_RTOL = 1e-2
# remat against none (flash route, dropout on): losses, params' L2 gap.
REMAT_LOSS_RTOL = 1e-3
REMAT_PARAM_RTOL = 1e-2
REMAT_RUN = (400, 64, 2)  # history items, batch, steps: 2,401 tokens, the flash route


def load_script(name):
    """A script of this checkout's scripts/ as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_trainer_inputs(root, cfg, feats, stage1, splits=TRAINER_SPLITS):
    """Processed data of `feats` with seeded histories. Returns (path, test histories, the stage-1
    rate)."""
    os.makedirs(root)
    n_items = len(feats)
    users, items, fut = seeded_sequences(n_items, sum(splits), cfg["max_seq_len"], SEED + 21)
    split = np.repeat(np.arange(3, dtype=np.int8), splits)
    base = os.path.join(root, "base.gin")
    with open(base, "w") as f:
        f.write(decoder_gin(DECODER_AMAZON_GIN, cfg, root))
    train = parse_gin_file(base)["train"]
    path = processed_path(root, train["dataset"], train["dataset_split"])
    os.makedirs(os.path.dirname(path))
    np.savez(path, item_features=feats, item_is_train=np.ones(n_items, bool),
             seq_users=users.astype(np.int32), seq_items=items.astype(np.int32),
             seq_fut=fut.astype(np.int32), seq_is_train=split == 0, seq_split=split)
    with open(os.path.join(stage1, "meta.json")) as f:
        return path, items[split == 2], json.load(f)["metrics"]["repetition_rate"]


def trainer_gin(root, cfg, s1, iterations, n=TRAINER_N, **bindings):
    """configs/decoder_amazon.gin at cfg's widths on root's data and `s1`, evals and saves every n."""
    path = os.path.join(root, f"decoder_{iterations}.gin")
    with open(path, "w") as f:
        f.write(decoder_gin(
            DECODER_AMAZON_GIN, cfg, root, iterations=iterations, full_eval_every=n,
            partial_eval_every=n, save_model_every=n, eval_batches=TRAINER_EVAL_BATCHES,
            log_every=1, pretrained_rqvae_path=f'"{s1}"',
            save_dir_root=f'"{os.path.join(root, "runs")}"', **bindings))
    return path


def run_trainer_entry(script, device, *argv):
    """script.main(argv) on `device`, launch counts set to 0 just before.
    Returns (result, launches, seconds)."""
    rq.rq_assign.launches = 0
    fa.reset_launches()
    t0 = time.perf_counter()
    result = script.main([*argv, "--device", str(device)])
    sync(device)
    return result, kernel_launches(), time.perf_counter() - t0


def check_trainer_run(name, result, launches, steps, evals, device, n_items):
    """Steps, saves, evals on the cadence, metrics in [0, 1], rq_assign per
    8,192 items at the start (card), no flash. Returns TEST's pair."""
    hist = result["history"]
    d = result["tokenizer"].sem_ids_dim
    want_saves = [f"checkpoint_{it}" for it in evals]
    got_saves = [os.path.basename(p) for p in result["saved_paths"]]
    if result["step"] != steps or got_saves != want_saves or hist["full_eval_iterations"] != evals:
        raise AssertionError(f"{name}: step {result['step']}, saves {got_saves}, full evals "
                             f"{hist['full_eval_iterations']}; want {steps}, {want_saves}, {evals}")
    scores = []
    for metrics in (*hist["full_eval_metrics"], hist["test_eval_metrics"]):
        pair = (metrics[f"h@10_slice_:{d}"], metrics[f"ndcg@10_slice_:{d}"])
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in pair):
            raise AssertionError(f"{name}: hit@10, ndcg@10 {pair} not finite in [0, 1]")
        scores.append(pair)
    sweeps = math.ceil(n_items / result["tokenizer"].corpus_chunk_size)
    want = {"rq_assign": sweeps if device.type == "cuda" else 0,
            **{fn.__name__: 0 for fn in fa.KERNELS}}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    return scores[-1]


def relative_gap(a, b, scale):
    """||a - b|| / ||scale|| over dicts of arrays (L2 over all leaves), and
    the largest |a - b|."""
    num = math.sqrt(sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in a))
    den = math.sqrt(sum(float(np.sum(scale[k].astype(np.float64) ** 2)) for k in scale))
    worst = max(float(np.max(np.abs(a[k].astype(np.float64) - b[k]))) for k in a)
    return num / max(den, 1e-30), worst


def check_resume(full, half, resumed, steps, updates=None, stats=False):
    """The resumed run's step, params, moments (RESUME_RTOL) and counts
    against the uninterrupted run's. Returns the gaps."""
    pf, ph, pr = (state_dict_to_flax(r["model"])[0] for r in (full, half, resumed))
    of, orr = (r["optimizer"].state_dict(r["model"]) for r in (full, resumed))
    update = {k: pf[k] - ph[k] for k in pf}
    gaps = {"params": relative_gap(pr, pf, update)}
    if stats:
        sf, sr = (state_dict_to_flax(r["model"])[1] for r in (full, resumed))
        gaps["batch_stats"] = relative_gap(sr, sf, sf)
    for name in ("mu", "nu"):
        keys = [k for k in of if f"0/{name}/" in k]  # every group's adamw
        gaps[name] = relative_gap({k: orr[k] for k in keys}, {k: of[k] for k in keys},
                                  {k: of[k] for k in keys})
    counts = {k: int(v) for k, v in orr.items() if k.endswith("count")}
    print(f"  resume: step {resumed['step']} (uninterrupted {full['step']}), counts {counts}; "
          + "; ".join(f"{k} gap {g:.3e} (max {w:.3e})" for k, (g, w) in gaps.items())
          + f" (tol {RESUME_RTOL})")
    updates = steps if updates is None else updates
    if resumed["step"] != steps or set(counts.values()) != {updates}:
        raise AssertionError(f"resume: step {resumed['step']}, counts {counts}; want "
                             f"{steps} steps, {updates} updates")
    bad = {k: g for k, (g, _) in gaps.items() if not g <= RESUME_RTOL}
    if bad:
        raise AssertionError(f"resume: the resumed state differs from the uninterrupted one: {bad}")
    return {k: g for k, (g, _) in gaps.items()}


def latest(result):
    """A stage-1 run's last `latest` save."""
    return [p for p in result["saved_paths"] if os.path.basename(p) == "latest"][-1]


def resume_runs(script, device, gin_n, n, check, full, resume_from=latest, **gap_kwargs):
    """N steps of `gin_n`, then N resumed, each held by `check`, against `full`. Returns (N run,
    resumed run, launches, gaps)."""
    half, launches_half, _ = run_trainer_entry(script, device, gin_n)
    check("N run", half, launches_half, n, [n])
    resumed, launches, _ = run_trainer_entry(script, device, gin_n, "--resume", resume_from(half))
    check("resume", resumed, launches, 2 * n, [2 * n])
    return half, resumed, {"N run": launches_half["rq_assign"], "resume": launches["rq_assign"]}, \
        check_resume(full, half, resumed, 2 * n, **gap_kwargs)


def remat_runs(cfg, vae, feats, device, seed=SEED, run=REMAT_RUN):
    """The long run with and without remat: losses, params, flash launches, peak memory."""
    max_seq_len, batch, steps = run
    users, items, fut = seeded_sequences(cfg["n_items"], TRAIN_SEQS, max_seq_len, seed + 11)
    n_enc = cfg["attn_layers"] // 2
    out = {}
    for remat in (False, True):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        rq.rq_assign.launches = 0
        fa.reset_launches()
        result = trainer.train_arrays(
            feats, users, items, fut, vae=vae, iterations=steps, batch_size=batch,
            **decoder_widths(cfg, seed), log_every=1, remat=remat, device=device,
            mixed_precision_type=cfg.get("precision", "bf16"))
        launches = kernel_launches()
        peak = None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
        context = 1 + max_seq_len * result["tokenizer"].sem_ids_dim
        head_dim = cfg["attn_embed_dim"] // cfg["attn_heads"]
        flash = device.type == "cuda" and takes_flash_route(head_dim, context)
        want = {"flash_fwd": n_enc * steps * (2 if remat else 1),
                "flash_bwd_dkv": n_enc * steps, "flash_bwd_dq": n_enc * steps}
        want = want if flash else {k: 0 for k in want}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"remat={remat}: flash launches {launches}, expected {want}")
        out[remat] = dict(loss=result["history"]["train_loss"],
                          ms=result["history"]["ms_per_step"],
                          params=state_dict_to_flax(result["model"])[0],
                          launches=launches, peak_gib=peak)
        sem_id_dim = result["model"].sem_id_dim
        del result
    init = state_dict_to_flax(trainer.build_model(  # both runs' seeded start
        sem_id_dim=sem_id_dim, max_seq_len=max_seq_len, **decoder_widths(cfg, seed, model=True)))[0]
    plain, remat = out[False], out[True]
    update = {k: plain["params"][k] - init[k] for k in init}
    gap, worst = relative_gap(remat["params"], plain["params"], update)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(remat["loss"], plain["loss"]))
    print(f"  remat / plain: losses {remat['loss']} / {plain['loss']} ({loss_err:.3e}, tol "
          f"{REMAT_LOSS_RTOL}); params gap {gap:.3e} (max {worst:.3e}, tol {REMAT_PARAM_RTOL}); "
          f"flash launches {remat['launches']} / {plain['launches']}; peak GiB over the start "
          f"{remat['peak_gib']} / {plain['peak_gib']}; ms/step {remat['ms']} / {plain['ms']}")
    if not (loss_err <= REMAT_LOSS_RTOL and gap <= REMAT_PARAM_RTOL):
        raise AssertionError(f"remat: the run differs from the plain one (losses {loss_err:.3e}, "
                             f"params {gap:.3e})")
    return {"remat": remat["launches"], "plain": plain["launches"],
            "peak_gib": {"remat": remat["peak_gib"], "plain": plain["peak_gib"]},
            "loss_rel_err": loss_err, "param_gap": gap}


@phase("trainer")
def trainer_phase(device, vae, feats, stage1, cfg=AMAZON, n=TRAINER_N, splits=TRAINER_SPLITS,
                  remat_run=REMAT_RUN, **bindings):
    """The stage-2 entry at cfg's widths: 2N steps, N + resumed N held to it,
    from_artifacts, remat. Returns the record."""
    script = load_script("torch_train_transformer")
    feats_np = np.asarray(feats)
    n_items = len(feats_np)
    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "trainer")
        data_path, test_hist, rep = write_trainer_inputs(root, cfg, feats_np, stage1, splits)
        print(f"  wrote {os.path.getsize(data_path) / 2**20:.1f} MiB ({n_items} items, {splits} "
              f"histories); stage 1 {stage1} (repetition {rep:.4f})")
        gin_2n = trainer_gin(root, cfg, stage1, 2 * n, n, **bindings)
        gin_n = trainer_gin(root, cfg, stage1, n, n, **bindings)
        batch = parse_gin_file(gin_2n)["train"]["batch_size"]
        full, launches, seconds = run_trainer_entry(script, device, gin_2n)
        test_scores = check_trainer_run("2N run", full, launches, 2 * n, [n, 2 * n], device,
                                        n_items)
        hist = full["history"]
        step_ms = statistics.median(hist["ms_per_step"][1:])
        ckpt = full["saved_paths"][-1]
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        eval_s = [s / TRAINER_EVAL_BATCHES for s in hist["full_eval_seconds"]]
        last = hist["full_eval_metrics"][-1]
        d = full["tokenizer"].sem_ids_dim
        print(f"  2N run ({2 * n} steps, batch {batch}) {seconds:.2f} s: {step_ms:.2f} ms/step "
              f"(first {hist['ms_per_step'][0]:.2f}); eval {[round(s, 3) for s in eval_s]} s/batch; "
              f"hit@10 {last[f'h@10_slice_:{d}']:.4f}, ndcg@10 {last[f'ndcg@10_slice_:{d}']:.4f} "
              f"(digit 1 hit@10 {last['h@10_slice_:1']:.4f}), TEST {test_scores[0]:.4f} / "
              f"{test_scores[1]:.4f}; checkpoints {ckpt_bytes / 2**20:.1f} MiB in "
              f"{[round(s, 3) for s in hist['save_seconds']]} s; launches {launches}")
        record["full"] = dict(launches=launches, step_ms=step_ms, eval_s_per_batch=eval_s,
                              ckpt_bytes=ckpt_bytes, save_s=hist["save_seconds"])

        half, resumed, runs, gaps = resume_runs(
            script, device, gin_n, n, lambda *a: check_trainer_run(*a, device, n_items), full,
            lambda r: r["saved_paths"][-1])
        record["resume"] = dict(launches=runs, gaps=gaps)
        del half, resumed

        hist32 = test_hist[:ARTIFACT_HISTORIES]
        engine, serve_launches, _ = served("trainer", gin_2n, stage1, ckpt, hist32, n_items,
                                           device)
        model = full["model"]
        own = trainer.build_model(sem_id_dim=model.sem_id_dim, max_seq_len=cfg["max_seq_len"],
                                  **decoder_widths(cfg, model=True))
        own.load_state_dict(model.state_dict())  # the trained weights, searched in fp32
        direct = RetrievalEngine(own, full["tokenizer"], feats_np, max_seq_len=cfg["max_seq_len"],
                                 batch_buckets=(ARTIFACT_HISTORIES,), stage1_checkpoint=stage1,
                                 device=device)
        check_same_engine("trainer", engine, direct, hist32)
        record["serve"] = dict(launches=serve_launches)
        del engine, direct, own, full, model
    record["remat"] = remat_runs(cfg, vae, feats, device, run=remat_run)
    return record

# ---- multi-GPU: process groups over the card

MULTI_N = 3               # steps of each multi-rank run (evals and saves at N); the resume N more
MULTI_SHORT = (20, 256)   # the bf16 runs: history items, global batch (decoder_amazon.gin's)
MULTI_LONG = (400, 64, 2)  # long-history DP: history items, global batch, steps (2,401 tokens)
MULTI_TIMEOUT_S = 600     # the two Gloo ranks' whole run
# W ranks against one (sums in another order), fp32: the first loss within
# MULTI_FIRST_LOSS_RTOL, then the JAX tests' multi-device rtol 5e-3; params'
# L2 gap over the update (a wrong cut leaf gives 8e-2). bf16: losses only.
MULTI_LOSS_RTOL = 5e-3
MULTI_FIRST_LOSS_RTOL = 1e-5
MULTI_FP32_PARAM_RTOL = 1e-2
# The float64 gradient witness over each array's largest entry.
MULTI_GRAD64_RTOL = 1e-9
# Beam scores on a mesh against one rank's, relative; items equal.
MULTI_SCORE_RTOL = 1e-5


def on_one_rank(device, run):
    """run() in a process group of one rank: NCCL on the card, Gloo on the
    CPU."""
    import torch.distributed as dist

    from hidvae_tpu_torch.parallel.dryrun import free_port

    cuda = device.type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}",
                            device_id=device if cuda else None)
    try:
        return run()
    finally:
        dist.destroy_process_group()


def two_ranks(entry, root, timeout, label):
    """This script's `entry` on two Gloo ranks over `root`; prints their
    seconds (functional: both share one device)."""
    from hidvae_tpu_torch.parallel.dryrun import launch_ranks

    t0 = time.perf_counter()
    launch_ranks([sys.executable, os.path.abspath(__file__), entry, root], 2, timeout)
    where = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "the CPU"
    print(f"  {label}two Gloo ranks on {where}: {time.perf_counter() - t0:.2f} s (functional: "
          f"one device)")


def multi_rank_main(workdir):
    """A multi phase Gloo rank on cuda:0: DP and TP runs, long DP, engines at 2 x 1 and 1 x 2."""
    import torch.distributed as dist

    from hidvae_tpu_torch.parallel.collectives import COLLECTIVE_BYTES
    from hidvae_tpu_torch.parallel.mesh import make_mesh
    from hidvae_tpu_torch.utils.config import parse_config_and_run

    with open(os.path.join(workdir, "inputs.json")) as f:
        inp = json.load(f)
    device = torch.device(inp["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    out = {}
    try:
        for name, shards in (("dp", 1), ("tp", 2)):
            rq.rq_assign.launches = 0
            t0 = time.perf_counter()
            res = parse_config_and_run(trainer.train, [inp["gin_n"]], device=device,
                                       n_model_shards=shards,
                                       save_dir_root=os.path.join(workdir, name))
            h = res["history"]
            out[name] = dict(
                loss=h["train_loss"], seconds=time.perf_counter() - t0,
                ms_per_step=h["ms_per_step"], bytes_per_step=h["collective_bytes_per_step"],
                sweep_rq_launches=rq.rq_assign.launches, saved=res["saved_paths"][-1],
                mesh=res["mesh"].shape,
                shapes={k: list(p.shape) for k, p in res["model"].named_parameters()
                        if k in MULTI_SHAPE_KEYS})
            del res
        vae, feats = torch.load(inp["vae"], weights_only=False)
        for name, shards in (("dp16", 1), ("tp16", 2)):
            res = multi_arrays_run(inp["cfg"], vae, feats, device, inp["n"], inp["short_run"],
                                   n_model_shards=shards)
            out[name] = dict(loss=res["history"]["train_loss"],
                             bytes_per_step=res["history"]["collective_bytes_per_step"])
            del res
        *run, steps = inp["long_run"]
        res = multi_arrays_run(inp["cfg"], vae, feats, device, steps, run)
        out["long"] = dict(loss=res["history"]["train_loss"], launches=kernel_launches(),
                           bytes_per_step=res["history"]["collective_bytes_per_step"],
                           ms_per_step=res["history"]["ms_per_step"])
        del res
        for name, mesh_kw in (("engine_dp", dict(n_data=2)), ("engine_tp", dict(n_model=2))):
            rq.rq_assign.launches = 0
            before = dict(COLLECTIVE_BYTES)
            t0 = time.perf_counter()
            eng = RetrievalEngine.from_artifacts(
                inp["gin_2n"], inp["stage1"], inp["ckpt_2n"], device=device,
                batch_buckets=(ARTIFACT_HISTORIES,), mesh=make_mesh(**mesh_kw),
                shard_params=name == "engine_tp")
            build_s = time.perf_counter() - t0
            launches = rq.rq_assign.launches
            res = eng.recommend(np.load(inp["hist"]), top_k=10)
            np.savez(os.path.join(workdir, f"rank{rank}_{name}.npz"), table=eng.corpus_ids.cpu(),
                     items=res["items"], sem_ids=res["sem_ids"], scores=res["scores"])
            out[name] = dict(rq_launches=launches, build_s=build_s,
                             latency_s=res["latency_s"], batch_buckets=eng.batch_buckets,
                             collective_bytes={k: COLLECTIVE_BYTES[k] - before[k]
                                               for k in before})
            del eng
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


# The leaves the layout cuts at the Amazon widths, and the ID table, which it keeps whole.
MULTI_SHAPE_KEYS = ("sem_id_embedder.emb.weight", "out_proj.weight",
                    "transformer.encoder.block_0.ff.dense_0.weight",
                    "transformer.encoder.block_0.ff.dense_1.weight")


def checkpoint_params(path):
    return {k.removeprefix("params/"): v for k, v in load_export_arrays(path, "params/").items()}


def check_multi_run(name, losses, params, want_losses, want_params, init,
                    first_rtol=MULTI_FIRST_LOSS_RTOL, param_rtol=MULTI_FP32_PARAM_RTOL):
    """Losses within MULTI_LOSS_RTOL of one rank's (the first `first_rtol`),
    params within `param_rtol` of the update. Returns both gaps."""
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
    update = {k: want_params[k] - init[k] for k in init}
    gap, worst = relative_gap(params, want_params, update)
    leaves = sorted(((relative_gap({k: params[k]}, {k: want_params[k]}, {k: update[k]})[0], k)
                     for k in init), reverse=True)[:3]
    print(f"  {name}: losses {[round(x, 5) for x in losses]} vs "
          f"{[round(x, 5) for x in want_losses]} (rel {[f'{e:.2e}' for e in errs]}, tol "
          f"{MULTI_LOSS_RTOL}" + (f", first {first_rtol}" if first_rtol else "")
          + f"); params gap {gap:.3e} of the update (max {worst:.3e}, tol {param_rtol}; "
          f"leaves {[(k, f'{g:.2e}') for g, k in leaves]})")
    if len(losses) != len(want_losses) or not (
            max(errs) <= MULTI_LOSS_RTOL and gap <= param_rtol
            and (first_rtol is None or errs[0] <= first_rtol)):
        raise AssertionError(f"{name}: the run differs from the one-rank run")
    return {"loss_rel_err": max(errs), "param_gap": gap}


def multi_arrays_run(cfg, vae, feats, device, steps, run, **kwargs):
    """train_arrays on seeded histories of run = (items, global batch), counts reset."""
    max_seq_len, batch = run
    users, items, fut = seeded_sequences(len(feats), TRAIN_SEQS, max_seq_len, SEED + 11)
    rq.rq_assign.launches = 0
    fa.reset_launches()
    return trainer.train_arrays(feats, users, items, fut, vae=vae, iterations=steps,
                                batch_size=batch, log_every=1, device=device,
                                **decoder_widths(cfg), **kwargs)


def compare_engines(name, ranks_npz, want, hist):
    """Every rank's table bitwise the one-rank engine's; items and tuples
    equal, scores within MULTI_SCORE_RTOL."""
    a = want.recommend(hist, top_k=10)
    table = want.corpus_ids.cpu().numpy()
    for r, got in enumerate(ranks_npz):
        if not np.array_equal(got["table"], table):
            rows = np.flatnonzero((got["table"] != table).any(1))
            raise AssertionError(f"{name} rank {r}: corpus table differs in {len(rows)} rows "
                                 f"(first {rows[:5].tolist()})")
        differ = np.flatnonzero((got["items"] != a["items"]).any(1)
                                | (got["sem_ids"] != a["sem_ids"]).any((1, 2)))
        err = float(np.abs(got["scores"] - a["scores"]).max())
        rel = float((np.abs(got["scores"] - a["scores"]) / np.abs(a["scores"])).max())
        print(f"  {name} rank {r}: table bitwise equal; {len(hist)} histories: items differ in "
              f"rows {differ.tolist()}, max score diff {err:.3e}, rel {rel:.3e} (tol "
              f"{MULTI_SCORE_RTOL}; scores {float(a['scores'].min()):.2f}..."
              f"{float(a['scores'].max()):.2f})")
        if len(differ):
            for row in differ[:4]:
                print(f"    row {row}: items {got['items'][row].tolist()} vs "
                      f"{a['items'][row].tolist()}, scores {got['scores'][row].tolist()} vs "
                      f"{a['scores'][row].tolist()}")
        if len(differ) or rel > MULTI_SCORE_RTOL:
            raise AssertionError(f"{name} rank {r}: serves differently from one rank")


@phase("multi")
def multi_phase(device, vae, feats, stage1, cfg=AMAZON, n=MULTI_N, short_run=MULTI_SHORT,
                long_run=MULTI_LONG, splits=TRAINER_SPLITS, stage1_root=None, **bindings):
    """Multi-GPU semantics on one card: one NCCL rank; two Gloo ranks (DP,
    TP in fp32 and bf16, TP resumed, long DP, engines); with `stage1_root`
    multi_stage1. Returns the record."""
    bindings = {"mixed_precision_type": '"fp32"', **bindings}
    from hidvae_tpu_torch.utils.config import parse_config_and_run

    script = load_script("torch_train_transformer")
    feats_np = np.asarray(feats)
    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "multi")
        _, test_hist, _ = write_trainer_inputs(root, cfg, feats_np, stage1, splits)
        gin_n = trainer_gin(root, cfg, stage1, n, n, **bindings)
        gin_2n = trainer_gin(root, cfg, stage1, 2 * n, n, **bindings)
        full, _, _ = run_trainer_entry(script, device, gin_2n)
        ckpt_n, ckpt_2n = full["saved_paths"]
        want_n, want_2n = checkpoint_params(ckpt_n), checkpoint_params(ckpt_2n)
        seed = inspect.signature(trainer.train).parameters["seed"].default  # the gin's
        init = state_dict_to_flax(trainer.build_model(
            sem_id_dim=full["model"].sem_id_dim, max_seq_len=cfg["max_seq_len"],
            **decoder_widths(cfg, seed, model=True)))[0]
        want_loss = full["history"]["train_loss"]

        # 1. one rank over NCCL
        cuda = device.type == "cuda"
        one = on_one_rank(device, lambda: parse_config_and_run(
            trainer.train, [gin_n], device=device, save_dir_root=os.path.join(root, "nccl")))
        got = checkpoint_params(one["saved_paths"][-1])
        bitwise = (one["history"]["train_loss"] == want_loss[:n]
                   and all(np.array_equal(got[k], want_n[k]) for k in want_n))
        print(f"  {'NCCL' if cuda else 'Gloo'}, world 1 (mesh {one['mesh'].shape}): losses "
              f"{one['history']['train_loss']}; bitwise the one-process run's {n} steps and "
              f"checkpoint_{n}: {bitwise}")
        record["nccl_1"] = {"bitwise": bitwise,
                            **check_multi_run(f"{'NCCL' if cuda else 'Gloo'} world 1",
                                              one["history"]["train_loss"], got, want_loss[:n],
                                              want_n, init)}
        del one, full

        # 2. two Gloo ranks on the card
        hist_path = os.path.join(root, "hist.npy")
        np.save(hist_path, test_hist[:ARTIFACT_HISTORIES])
        vae_path = os.path.join(root, "vae.pt")
        torch.save((vae, feats), vae_path)
        with open(os.path.join(root, "inputs.json"), "w") as f:
            json.dump(dict(gin_n=gin_n, gin_2n=gin_2n, stage1=stage1, ckpt_2n=ckpt_2n,
                           hist=hist_path, vae=vae_path, cfg=cfg, device=str(device),
                           n=n, short_run=short_run, long_run=long_run), f)
        two_ranks("--multi-rank", root, MULTI_TIMEOUT_S, "")
        ranks = []
        for r in range(2):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for name in ("dp", "tp"):
            rr = [r[name] for r in ranks]
            print(f"  {name} (mesh {rr[0]['mesh']}): losses equal {rr[0]['loss'] == rr[1]['loss']}"
                  f"; s {[r['seconds'] for r in rr]}, ms/step {[r['ms_per_step'] for r in rr]}, "
                  f"bytes/step {[r['bytes_per_step'] for r in rr]}, sweep rq_assign "
                  f"{[r['sweep_rq_launches'] for r in rr]}; shapes {rr[0]['shapes']}")
            record[name] = check_multi_run(
                f"{name} 2 ranks", rr[0]["loss"], checkpoint_params(rr[0]["saved"]),
                want_loss[:n], want_n, init)
            record[name].update(bytes_per_step=rr[0]["bytes_per_step"],
                                rq_launches=[r["sweep_rq_launches"] for r in rr])
        one16 = multi_arrays_run(cfg, vae, feats, device, n, short_run)["history"]["train_loss"]
        for name in ("dp16", "tp16"):
            got = ranks[0][name]["loss"]
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, one16))
            print(f"  {name} 2 ranks (bf16, {short_run[0]} items, batch {short_run[1]}): losses "
                  f"{[round(x, 5) for x in got]} vs {[round(x, 5) for x in one16]} (rel "
                  f"{loss_err:.3e}, tol {MULTI_LOSS_RTOL}); bytes/step/rank "
                  f"{[r[name]['bytes_per_step'] for r in ranks]}")
            if len(got) != len(one16) or not loss_err <= MULTI_LOSS_RTOL:
                raise AssertionError(f"{name}: the bf16 run differs from the one-rank run")
            record[name] = {"loss_rel_err": loss_err}
        shapes = ranks[1]["tp"]["shapes"]
        table_rows = (cfg["codebook_size"] * cfg["n_layers"]
                      + 1000 * len(cfg["tag_class_counts"]) + 1)
        want_shapes = {"out_proj.weight": [cfg["codebook_size"] // 2, cfg["attn_embed_dim"]],
                       "sem_id_embedder.emb.weight": [table_rows, cfg["decoder_embed_dim"]],
                       "transformer.encoder.block_0.ff.dense_0.weight":
                           [512, cfg["attn_embed_dim"]],
                       "transformer.encoder.block_0.ff.dense_1.weight":
                           [cfg["attn_embed_dim"], 512]}
        if any(shapes.get(k) != v for k, v in want_shapes.items()):
            raise AssertionError(f"tp: local shapes {shapes}, expected {want_shapes}")
        print(f"  tp: out_proj and FF halved, the ID table ({table_rows} rows) whole")

        resumed, _, _ = run_trainer_entry(script, device, gin_n, "--resume",
                                          ranks[0]["tp"]["saved"])
        record["tp_resume"] = check_multi_run(
            "TP checkpoint resumed on one rank", resumed["history"]["train_loss"],
            state_dict_to_flax(resumed["model"])[0], want_loss[n:], want_2n, want_n,
            first_rtol=None)
        del resumed

        *run, steps = long_run
        long_one = multi_arrays_run(cfg, vae, feats, device, steps, run)
        n_enc = cfg["attn_layers"] // 2
        want = {"flash_fwd": n_enc * steps, "flash_bwd_dkv": n_enc * steps,
                "flash_bwd_dq": n_enc * steps}
        want = want if cuda else {k: 0 for k in want}  # the plain version on the CPU
        for r, rr in enumerate(ranks):
            got = {k: rr["long"]["launches"][k] for k in want}
            print(f"  long-history DP rank {r}: flash launches {got} ({n_enc} layers x {steps} "
                  f"steps), bytes/step {rr['long']['bytes_per_step']}, ms/step "
                  f"{rr['long']['ms_per_step']}")
            if got != want:
                raise AssertionError(f"long DP rank {r}: flash launches {got}, expected {want}")
        record["long"] = dict(launches=[{k: rr["long"]["launches"][k] for k in want}
                                        for rr in ranks])
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(ranks[0]["long"]["loss"], long_one["history"]["train_loss"]))
        print(f"  long-history DP: losses {ranks[0]['long']['loss']} vs one rank's "
              f"{long_one['history']['train_loss']} (rel {loss_err:.3e}, tol {MULTI_LOSS_RTOL})")
        if not loss_err <= MULTI_LOSS_RTOL:
            raise AssertionError("long-history DP: losses differ from the one-rank run's")
        del long_one

        want = RetrievalEngine.from_artifacts(gin_2n, stage1, ckpt_2n, device=device,
                                              batch_buckets=(ARTIFACT_HISTORIES,))
        hist = np.load(hist_path)
        for name in ("engine_dp", "engine_tp"):
            rr = [r[name] for r in ranks]
            npz = [dict(np.load(os.path.join(root, f"rank{r}_{name}.npz"))) for r in range(2)]
            print(f"  {name}: rq_assign launches a rank {[r['rq_launches'] for r in rr]} "
                  f"({len(feats_np)} rows); buckets {rr[0]['batch_buckets']}; build "
                  f"{[round(r['build_s'], 3) for r in rr]} s, request "
                  f"{[round(r['latency_s'], 4) for r in rr]} s; collective bytes "
                  f"{rr[0]['collective_bytes']}")
            compare_engines(name, npz, want, hist)
            record[name] = dict(rq_launches=[r["rq_launches"] for r in rr])
        del want
        if stage1_root is not None:
            record["stage1"] = multi_stage1(device, os.path.join(tmp, "stage1"), stage1_root)
    return record

# ---- duplicate-pair mining in the stage-1 trainer

H_RQVAE_XXL_M_GIN = os.path.join(CONFIGS, "h_rqvae_synthetic_xxl_m.gin")
# h_rqvae_synthetic_xxl_m.gin's widths at 200,000 items (not 1M).
XXL_M = dict(input_dim=768, hidden_dims=(512, 256, 128), embed_dim=32, codebook_size=256,
             n_layers=4, tag_embed_dim=768, tag_tree=(32, 8, 8), n_items=200_000)
XXL_M_CORPUS = 1_000_000  # the config's own corpus (scripts/make_synthetic_xxl.py)
MINING_N = 4              # mini-steps between evals, audits and saves: the run takes 2N
MINING_EVAL_BATCHES = 1   # eval batches of 1,024 items
MINING_PLANTED = 0.1      # share of the items planted as near-copies of another item
MINING_NOISE = 1e-4       # the copies' perturbation (unit-norm features)
MINING_TIMED = (3, 10)
MINING_SETTINGS = (("mining", 1024, 1),)  # the gin's batch, no accumulation


def write_mining_inputs(path, cfg, seed=SEED):
    """cfg's catalog at `path`, MINING_PLANTED of it near-copies sharing
    their source's tags. Returns (features, copies, sources)."""
    rng = np.random.RandomState(seed + 51)
    n = cfg["n_items"]
    feats = unit_rows(n, cfg["input_dim"], torch.Generator().manual_seed(seed + 52))
    perm = rng.permutation(n)
    k = int(MINING_PLANTED * n)
    src, dst = perm[:k], perm[k:2 * k]
    noisy = feats[src] + MINING_NOISE * torch.randn(
        k, cfg["input_dim"], generator=torch.Generator().manual_seed(seed + 53))
    feats[dst] = noisy / noisy.norm(dim=-1, keepdim=True)
    leaves = int(np.prod(cfg["tag_tree"]))
    leaf = rng.randint(0, leaves, n)
    leaf[dst] = leaf[src]
    idx, emb, width = [], [], leaves
    for b in cfg["tag_tree"]:
        width //= b
        level = (leaf // width).astype(np.int32)
        table = (rng.randn(level.max() + 1, cfg["tag_embed_dim"])
                 / math.sqrt(cfg["tag_embed_dim"])).astype(np.float32)
        idx.append(level)
        emb.append(table[level])
    feats = feats.numpy()
    write_items(path, feats, rng, tags_emb=np.stack(emb, axis=1),
                tags_indices=np.stack(idx, axis=1))
    return feats, dst, src


def check_mining_run(name, result, launches, steps, evals, device, n_items, pool):
    """check_run, `latest` holding the pool of `pool` pairs, refreshed at
    every audit. Returns the saved pool."""
    latest = check_run(name, result, launches, steps, evals, device, n_items)
    hist = result["history"]
    saved = load_export_arrays(latest, "mining_pairs").get("mining_pairs")
    live = result["data"].mining_pairs.cpu().numpy()
    if saved is None or saved.shape != (pool, 2) or not np.array_equal(saved, live):
        raise AssertionError(f"{name}: latest does not hold the run's pool of {pool} pairs")
    if hist["mining_pool_refreshed"] != evals:
        raise AssertionError(f"{name}: pool refreshed at {hist['mining_pool_refreshed']}, "
                             f"not at every audit {evals}")
    return saved

@phase("mining")
def mining_phase(device, root, cfg=XXL_M, n=MINING_N, settings=MINING_SETTINGS,
                 timed=MINING_TIMED, **bindings):
    """configs/h_rqvae_synthetic_xxl_m.gin: 2N mini-steps harvesting at N
    and 2N, the pool colliding, N + resumed N (pool bitwise), items/s."""
    script = load_script("torch_train_hidvae")
    t0 = time.perf_counter()
    path = processed_path(root, RecDataset.SYNTHETIC)
    feats, dst, src = write_mining_inputs(path, cfg)
    n_items = len(feats)
    print(f"  wrote {os.path.getsize(path) / 2**20:.1f} MiB in {time.perf_counter() - t0:.2f} s "
          f"({n_items} items of the config's {XXL_M_CORPUS}; {len(dst)} near-copies; tags of a "
          f"{'x'.join(map(str, cfg['tag_tree']))} tree)")
    values = {
        "save_model_every": n, "eval_every": n, **vae_widths(cfg),
        "vae_n_layers": cfg["n_layers"], "tag_embed_dim": cfg["tag_embed_dim"],
        **paths(root), "eval_batches": MINING_EVAL_BATCHES,
        **bindings,
    }
    gin_2n = cut_gin(H_RQVAE_XXL_M_GIN, os.path.join(root, "mining_2n.gin"),
                     dict(values, iterations=2 * n), show=True)
    gin_n = cut_gin(H_RQVAE_XXL_M_GIN, os.path.join(root, "mining_n.gin"),
                    dict(values, iterations=n))
    gin = parse_gin_file(gin_2n)["train"]
    pool = gin["sem_id_mining_pool"]
    full, launches, seconds = run_trainer_entry(script, device, gin_2n)
    check_mining_run("2N run", full, launches, 2 * n, [n, 2 * n], device, n_items, pool)
    hist = full["history"]
    rates = hist["mined_pair_collision_rate"]
    print(f"  2N run ({2 * n} mini-steps, batch {gin['batch_size']}, {full['n_pair_rows']} pairs "
          f"a batch, pool {pool}) {seconds:.2f} s: loss {hist['total_loss']}, repetition "
          f"{hist['repetition_rate']}, pool refreshed {hist['mining_pool_refreshed']}, collision "
          f"rate at {hist['iterations']}: {rates}; tags {full['tag_class_counts']}; launches "
          f"{launches}")
    if not rates[-1] > 0:
        raise AssertionError("mining: no mined pair collided in the steps after the first audit")

    # The pool against the audit's table: the audit at 2N swept these weights.
    model = full["model"]
    table, table_launches = audit_table("mining", model, full["tag_class_counts"], feats, device)
    train_idx = np.nonzero(np.load(path)["item_is_train"])[0]
    pairs = train_idx[full["data"].mining_pairs.cpu().numpy()]
    tab = table.cpu().numpy()
    colliding = float((tab[pairs[:, 0]] == tab[pairs[:, 1]]).all(axis=1).mean())
    planted = float((tab[dst] == tab[src]).all(axis=1).mean())
    print(f"  pool pairs colliding {colliding:.4f}; copies on their source's tuple "
          f"{planted:.4f}; repetition {repetition_rate(tab)[0]:.4f}")
    if colliding != 1.0:
        raise AssertionError("mining: the pool's pairs do not all collide in the audit's table")

    half, resumed, runs, gaps = resume_runs(
        script, device, gin_n, n, lambda *a: check_mining_run(*a, device, n_items, pool), full,
        updates=2 * n // gin.get("gradient_accumulate_every", 1), stats=True)
    # check_mining_run held N's saved pool equal to its live one
    restored = np.array_equal(resumed["mining_pool_start"], half["data"].mining_pairs.cpu().numpy())
    same_end = torch.equal(resumed["data"].mining_pairs, full["data"].mining_pairs)
    print(f"  resume: pool restored bitwise from N's latest {restored}; pools after "
          f"{2 * n} equal {same_end}")
    if not (restored and same_end):
        raise AssertionError("mining: the pool did not survive the resume bitwise")
    throughput = stage1_throughput(full, gin, device, settings, timed)
    record = dict(launches={"2N run": launches["rq_assign"], **runs, "table": table_launches},
                  checkpoint=latest(full),
                  resume_gaps=gaps, throughput=throughput, collision_rate=rates,
                  pool_colliding=colliding, repetition_rate=hist["repetition_rate"])
    del full, half, resumed, model
    return record


# ---- the plain RQ-VAE trainer from its gin entry

RQVAE_ML32M_GIN = os.path.join(CONFIGS, "rqvae_ml32m.gin")
RQVAE_N = 4               # mini-steps between evals, audits and saves: the run takes 2N
RQVAE_EVAL_BATCHES = 2    # eval batches of 64 items
RQVAE_TIMED = (3, 10)


def check_rqvae_run(name, result, launches, steps, evals, device, n_items):
    """check_run with checkpoint_<step - 1> saves at the evals, the last
    meta holding the model_config and its audit."""
    last = check_run(name, result, launches, steps, evals, device, n_items,
                     saves=[f"checkpoint_{e - 1}" for e in evals])
    with open(os.path.join(last, "meta.json")) as f:
        meta = json.load(f)
    if (meta["metrics"].get("repetition_rate") != result["history"]["repetition_rate"][-1]
            or meta["model_config"].get("n_cat_features") is None):
        raise AssertionError(f"{name}: the checkpoint's meta lacks its audit or config: {meta}")

@phase("rqvae")
def rqvae_phase(device, root, cfg=ML32M, n=RQVAE_N, timed=RQVAE_TIMED, **bindings):
    """configs/rqvae_ml32m.gin: 2N mini-steps, N + resumed N, the table,
    items/s, the checkpoint served with a seeded decoder."""
    from hidvae_tpu_torch.train import rqvae as rv

    script = load_script("torch_train_rqvae")
    feats = unit_rows(cfg["n_items"], cfg["input_dim"],
                      torch.Generator().manual_seed(SEED + 41)).numpy()
    hist = seeded_histories(cfg["n_items"], ARTIFACT_HISTORIES, cfg["max_seq_len"])
    rq_gin = parse_gin_file(RQVAE_ML32M_GIN)["train"]
    path = processed_path(root, rq_gin["dataset"], rq_gin.get("dataset_split", "beauty"))
    write_items(path, feats, np.random.RandomState(SEED + 43), hist)
    n_items = len(feats)
    print(f"  wrote {os.path.getsize(path) / 2**20:.1f} MiB ({n_items} items, {len(hist)} "
          f"histories)")
    values = {
        "save_model_every": n, "eval_every": n, "force_dataset_process": False,
        **vae_widths(cfg), **paths(root), "eval_batches": RQVAE_EVAL_BATCHES,
        **bindings,
    }
    gin_2n = cut_gin(RQVAE_ML32M_GIN, os.path.join(root, "rqvae_2n.gin"),
                     dict(values, iterations=2 * n), show=True)
    gin_n = cut_gin(RQVAE_ML32M_GIN, os.path.join(root, "rqvae_n.gin"),
                    dict(values, iterations=n))
    gin = parse_gin_file(gin_2n)["train"]
    full, launches, seconds = run_trainer_entry(script, device, gin_2n)
    check_rqvae_run("2N run", full, launches, 2 * n, [n, 2 * n], device, n_items)
    h = full["history"]
    print(f"  2N run ({2 * n} mini-steps, batch {gin['batch_size']}) {seconds:.2f} s: loss "
          f"{h['total_loss']}, eval {h['eval_total_loss']}, repetition {h['repetition_rate']}, "
          f"entropy {h['rqvae_entropy']}; saves {[os.path.basename(p) for p in full['saved_paths']]}"
          f"; launches {launches}")
    half, resumed, runs, gaps = resume_runs(
        script, device, gin_n, n, lambda *a: check_rqvae_run(*a, device, n_items), full,
        lambda r: r["saved_paths"][-1], updates=2 * n // gin.get("gradient_accumulate_every", 1))

    # The last audit's table (rq_assign) against a plain sweep of the same weights.
    model = full["model"]
    hold_table("rqvae: the last audit's table", torch.from_numpy(full["corpus_ids"]).to(device),
               model, feats, device, 8192, h["repetition_rate"][-1])

    defaults = inspect.signature(rv.train).parameters
    opt = rv.build_optimizer(model, **{k: gin.get(k, defaults[k].default) for k in list(
        inspect.signature(rv.build_optimizer).parameters)[1:]})
    step = rv.make_train_step(model, opt)
    counter = iter(range(1_000_000, 2_000_000))
    batch = gin["batch_size"]

    def update():
        g = rv.step_generator(SEED, next(counter), device)
        step(full["data"].sample(g, batch)[0], g)

    throughput = time_updates("rqvae", update, batch, 1, device, timed)

    # The checkpoint served with a seeded decoder at the ML-32M widths.
    ckpt = full["saved_paths"][-1]
    decoder = build_decoder(cfg, cfg["n_layers"], torch.Generator().manual_seed(SEED + 45))
    s2 = save_decoder_export(os.path.join(root, "stage2"), cfg, decoder)
    dgin = os.path.join(root, "decoder.gin")
    with open(dgin, "w") as f:
        f.write(decoder_gin(DECODER_ML32M_GIN, cfg, root))
    engine, serve_launches, _ = served(f"rqvae {os.path.basename(ckpt)}", dgin, ckpt, s2, hist,
                                       n_items, device)
    same_table = np.array_equal(engine.corpus_ids.cpu().numpy(), full["corpus_ids"])
    print(f"  rqvae: the served table equal to the audit's {same_table}")
    if not same_table:
        raise AssertionError("rqvae: the served table differs from the trainer's audit")
    record = dict(launches={"2N run": launches["rq_assign"], **runs,
                            "from_artifacts": serve_launches},
                  resume_gaps=gaps, throughput=throughput, repetition_rate=h["repetition_rate"])
    del full, half, resumed, model, engine
    return record


# ---- seeded corpora and catalog scale

H_RQVAE_LARGE_GIN = os.path.join(CONFIGS, "h_rqvae_synthetic_large.gin")
SYNTH_STEPS = 4   # mini-steps at the gin's batch of 1,024, with one eval, audit and save at the end
SCALE_SIZES = (200_000, 1_000_000)


@phase("synthetic")
def synthetic_phase(device, root, steps=SYNTH_STEPS, corpus=None, **bindings):
    """torch_make_synthetic.py large through h_rqvae_synthetic_large.gin,
    its table; load_or_build's default corpus. Returns the launches."""
    from hidvae_tpu_torch.data.processed import ProcessedArrays, load_or_build

    t0 = time.perf_counter()
    path = load_script("torch_make_synthetic").main("large", root, **(corpus or {}))
    feats = ProcessedArrays.load(path).item_features
    print(f"  torch_make_synthetic.py large: {os.path.getsize(path) / 2**20:.1f} MiB in "
          f"{time.perf_counter() - t0:.2f} s ({len(feats)} items)")
    gin = cut_gin(H_RQVAE_LARGE_GIN, os.path.join(root, "large.gin"), {
        "iterations": steps, "eval_every": steps, "save_model_every": steps, "log_every": steps,
        "eval_batches": STAGE1_EVAL_BATCHES, **paths(root), **bindings}, show=True)
    result, launches, seconds = run_trainer_entry(load_script("torch_train_hidvae"), device, gin)
    rep = check_stage1_run("synthetic run", result, launches, steps, [steps], device, len(feats))
    hist = result["history"]
    print(f"  run ({steps} mini-steps, batch {parse_gin_file(gin)['train']['batch_size']}) "
          f"{seconds:.2f} s: loss {hist['total_loss']}, eval {hist['eval_total_loss']}, tags "
          f"{result['tag_class_counts']}, repetition {rep}; launches {launches}")
    if not hist["total_loss"]:
        raise AssertionError("synthetic: no loss logged")
    _, table_launches = audit_table("synthetic", result["model"], result["tag_class_counts"],
                                    feats, device, rep)
    empty = os.path.join(root, "empty")
    default = load_or_build(empty, RecDataset.SYNTHETIC)
    written = os.path.getsize(processed_path(empty, RecDataset.SYNTHETIC))
    print(f"  load_or_build on an empty root: {default.item_features.shape[0]} items, "
          f"{default.seq_items.shape[0]} sequences, {written / 2**20:.1f} MiB")
    if default.item_features.shape != (2000, 768) or not np.array_equal(
            ProcessedArrays.load(processed_path(empty, RecDataset.SYNTHETIC)).item_features,
            default.item_features):
        raise AssertionError("synthetic: load_or_build did not write the default corpus")
    return {"run": launches["rq_assign"], "table": table_launches}


@phase("scale")
def scale_phase(device, sizes=SCALE_SIZES, **kwargs):
    """torch_bench_scale.py's bench_one by size: a launch per 8,192 items,
    all resolved, the largest table a plain sweep's. Returns the records."""
    bench = load_script("torch_bench_scale")
    records = []
    for n in sizes:
        keep = {}
        rec = bench.bench_one(n, device, keep=keep, **kwargs)
        print(f"  scale {n}: {json.dumps(rec)}")
        want = math.ceil(n / 8192) if device.type == "cuda" else 0
        if rec["rq_assign_launches"]["sweep"] != want or not (
                rec["top10_resolved_frac"] == keep["cap_resolved"] == 1.0):
            raise AssertionError(f"scale {n}: launches {rec['rq_assign_launches']} (want "
                                 f"{want}), resolved {rec['top10_resolved_frac']}, "
                                 f"{keep['cap_resolved']} (trie, cap-gather)")
        if n == max(sizes):
            ref, ties, _ = plain_sweep(keep["vae"], keep["feats"], 8192)
            n_diff, n_bad = compare_ids(keep["ids"], ref, ties)
            print(f"  scale {n}: rows differing from a plain sweep {n_diff} (not near ties: "
                  f"{n_bad})")
            if n_bad:
                raise AssertionError(f"scale {n}: the table differs from a plain sweep")
        records.append(rec)
        del keep
    return records


# ---- raw files: the dataset builders, P5 Sports trained and served from them

P5_SPORTS = dict(n_items=18_357, n_users=35_598)  # the published size of the P5 Sports split
RAW_STAGE2_STEPS = 4   # stage-2 steps on the built histories, with one full eval and a save
ML_RAW = (5_000, 500_000)  # movies and ratings of each seeded MovieLens drop
ML_RAW_TIMEOUT_S = 600
ML_GENRES = ("Action", "Adventure", "Animation", "Children's", "Comedy", "Crime", "Documentary",
             "Drama", "Fantasy", "Film-Noir", "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
             "Thriller", "War", "Western")


def write_movielens_drop(root, fmt, n_movies, n_ratings, seed=SEED, genders="FM"):
    """A seeded MovieLens drop ("1m" or "32m") in root/raw/ with the raw
    files' awkward cases (quoting, Latin-1, sparse users, ties)."""
    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    ids = np.cumsum(rng.randint(1, 4, n_movies))
    movies = []
    for i, m in enumerate(ids.tolist()):
        title = (f"Movie {m}, The (Part {i % 3}) ({1950 + i % 70})" if i % 3 else
                 f'Caf\u00e9 "{m}": A Story ({1990 + i % 30})')
        k = rng.randint(1, 4)
        genre = ("(no genres listed)" if rng.rand() < 0.03 else
                 "|".join(rng.choice(ML_GENRES, k, replace=False)))
        movies.append((m, title, genre))
    n_users = max(n_ratings // 20, 8)
    pu, pm = (1.0 / (np.arange(n) + a) ** s for n, a, s in ((n_users, 3.0, 1.3),
                                                             (n_movies, 1.0, 1.2)))
    user = 1 + rng.permutation(n_users)[rng.choice(n_users, n_ratings, p=pu / pu.sum())]
    movie = ids[rng.permutation(n_movies)[rng.choice(n_movies, n_ratings, p=pm / pm.sum())]]
    movie = np.where(rng.rand(n_ratings) < 0.002, ids[-1] + 1 + rng.randint(0, 50, n_ratings),
                     movie)
    ts = 978_300_000 + 60 * rng.randint(0, max(n_ratings // 4, 1), n_ratings)
    stars = rng.randint(1, 11, n_ratings) / 2.0
    cols = zip(user.tolist(), movie.tolist(), stars.tolist(), ts.tolist())
    if fmt == "1m":
        with open(os.path.join(raw, "movies.dat"), "w", encoding="ISO-8859-1") as f:
            f.writelines(f"{m}::{t}::{g}\n" for m, t, g in movies)
        with open(os.path.join(raw, "ratings.dat"), "w") as f:
            f.writelines(f"{u}::{m}::{math.ceil(r)}::{t}\n" for u, m, r, t in cols)
        with open(os.path.join(raw, "users.dat"), "w") as f:
            f.writelines(f"{u}::{genders[rng.randint(len(genders))]}::"
                         f"{(1, 18, 25, 35, 45, 50, 56)[rng.randint(7)]}::{rng.randint(21)}::"
                         f"{rng.randint(100000):05d}\n" for u in range(1, n_users + 1))
    else:
        import csv

        with open(os.path.join(raw, "movies.csv"), "w", newline="", encoding="utf-8") as f:
            csv.writer(f).writerows([("movieId", "title", "genres"), *movies])
        with open(os.path.join(raw, "ratings.csv"), "w") as f:
            f.write("userId,movieId,rating,timestamp\n")
            f.writelines(f"{u},{m},{r},{t}\n" for u, m, r, t in cols)


def movielens_main(workdir, n_movies, n_ratings):
    """--movielens DIR MOVIES RATINGS: both formats built, pandas refused;
    writes DIR/movielens.json."""
    from hidvae_tpu_torch.data.processed import load_or_build

    if sys.modules.get("pandas") is not None:
        raise AssertionError("pandas was imported before the MovieLens builds")
    sys.modules["pandas"] = sys.modules["sentence_transformers"] = None
    out = {}
    for fmt, dataset in (("32m", RecDataset.ML_32M), ("1m", RecDataset.ML_1M)):
        root = os.path.join(workdir, fmt)
        t0 = time.perf_counter()
        write_movielens_drop(root, fmt, int(n_movies), int(n_ratings))
        t1 = time.perf_counter()
        a = load_or_build(root, dataset, force_process=True)
        t2 = time.perf_counter()
        n_items, width = a.item_features.shape
        rec = dict(features=[n_items, width], sequences=list(a.seq_items.shape),
                   train_share=float(a.seq_is_train.mean()), write_s=t1 - t0, build_s=t2 - t1,
                   users=None if a.user_features is None else list(a.user_features.shape))
        print(f"  {dataset.name} without pandas: {json.dumps(rec)}")
        ok = (0 < n_items <= int(n_movies) and 768 < width <= 768 + len(ML_GENRES) + 1
              and a.seq_items.shape[1] == 200 and np.isfinite(a.item_features).all()
              and 0 < rec["train_share"] < 1 and a.seq_items.max() < n_items
              and (a.seq_fut >= 0).all() and (a.user_features is None) == (fmt == "32m"))
        if fmt == "1m":
            ok = ok and a.user_features.shape[1] == 3 and set(a.user_features[:, 1]) == {0.0, 1.0}
        if not ok or "pandas" in [m.split(".")[0] for m, v in sys.modules.items() if v]:
            raise AssertionError(f"{dataset.name}: the build is malformed or imported pandas")
        out[fmt] = rec
    with open(os.path.join(workdir, "movielens.json"), "w") as f:
        json.dump(out, f)


def write_drop(preset, root, **size):
    """torch_make_synthetic.py's raw `preset` under `root`, its MiB and
    seconds printed."""
    t0 = time.perf_counter()
    raw = load_script("torch_make_synthetic").main(preset, root, **size)
    mib = sum(os.path.getsize(os.path.join(raw, f)) for f in os.listdir(raw)) / 2**20
    print(f"  {preset} drop {size}: {mib:.1f} MiB in {time.perf_counter() - t0:.2f} s")


def built_run(trainer_module, script, device, gin, want, vocab):
    """`script` on `gin`, load_or_build timed, shapes held to want(arrays).
    Returns (result, launches, seconds, arrays)."""
    from hidvae_tpu_torch.data.text_embedding import encode_text_feature

    built, build = {}, trainer_module.load_or_build

    def timed_build(*args):
        t = time.perf_counter()
        built["a"] = build(*args)
        built["s"] = time.perf_counter() - t
        return built["a"]

    trainer_module.load_or_build = timed_build
    try:
        result, launches, seconds = run_trainer_entry(load_script(script), device, gin)
    finally:
        trainer_module.load_or_build = build
    a = built["a"]
    want = want(a)
    with open(vocab) as f:
        vocab = [len(v) for v in json.load(f)["vocabs"]]
    shapes = [a.item_features.shape, a.tags_indices.shape, a.tags_emb.shape, a.seq_items.shape]
    print(f"  load_or_build in {script}: {built['s']:.2f} s (text encoder "
          f"{encode_text_feature.encoder}); features, tags_indices, tags_emb, histories {shapes}; "
          f"histories by split {np.bincount(a.seq_split).tolist()}; tag vocabularies {vocab}")
    if shapes != want:
        raise AssertionError(f"raw: built shapes {shapes}, expected {want}")
    return result, launches, seconds, a


def stage1_summary(name, result, launches, seconds, rep, tags=None):
    h = result["history"]
    remap = (f"; rare-tag remap {list(tags)} -> {list(result['tag_class_counts'])}, folded "
             f"{[len(v) for v in result['rare_tags'].values()]}" if tags else "")
    print(f"  {name} ({result['step']} mini-steps) {seconds:.2f} s, "
          f"{statistics.median(h['ms_per_step']):.2f} ms/mini-step: loss {h['total_loss']}"
          f"{remap}; repetition {rep}; launches {launches}")


def stage2_built(name, gin, steps, device, n_items):
    """The stage-2 entry on `gin`, `steps` steps. Returns (result, rq_assign launches)."""
    r2, launches, seconds = run_trainer_entry(load_script("torch_train_transformer"), device, gin)
    scores = check_trainer_run(name, r2, launches, steps, [steps], device, n_items)
    print(f"  {name} ({steps} steps) {seconds:.2f} s, "
          f"{statistics.median(r2['history']['ms_per_step'][1:] or [math.nan]):.2f} ms/step "
          f"after the first: loss {r2['history']['train_loss']}; TEST hit@10, ndcg@10 "
          f"{[float(x) for x in scores]}; launches {launches}")
    return r2, launches["rq_assign"]


def serve_built(name, gin, s1, s2, a, device):
    """from_artifacts on 32 test histories, every top-10 item resolved. Returns the launches."""
    hist = a.seq_items[a.seq_split == 2][:ARTIFACT_HISTORIES]
    _, launches, out = served(name, gin, s1, s2, hist, len(a.item_features), device)
    if (out["items"] < 0).any():
        raise AssertionError(f"{name}: a top-10 item of a test history did not resolve")
    return launches


def served(name, gin, s1, s2, hist, n_items, device):
    """from_artifacts (counts reset) and its top-10 of `hist`, checked.
    Returns (engine, rq_assign launches, recommendations)."""
    rq.rq_assign.launches = 0
    t0 = time.perf_counter()
    engine = RetrievalEngine.from_artifacts(gin, s1, s2, device=device,
                                            batch_buckets=(len(hist),))
    seconds, launches = time.perf_counter() - t0, rq.rq_assign.launches
    out = engine.recommend(hist, top_k=10)
    resolved = check_recommendations(engine, out, n_items)
    print(f"  {name}: from_artifacts of {os.path.basename(s2)} {seconds:.3f} s (rq_assign "
          f"launches {launches}); {resolved} of {out['items'].size} top-10 resolved")
    return engine, launches, out


KUAIRAND_GINS = {k: os.path.join(CONFIGS, f"{k}_kuairand.gin")
                 for k in ("rqvae", "h_rqvae", "decoder")}


@phase("raw")
def raw_phase(device, root, cfg=AMAZON, drop=P5_SPORTS, n=STAGE1_N, steps=RAW_STAGE2_STEPS,
              movielens=ML_RAW, stage2=None, kuairand_drop=None, kuairand=None, **bindings):
    """The Amazon gins on the amazon-raw drop (built, n mini-steps, stage 2
    `steps`, served); kuairand_part; movielens_main. Returns the launches."""
    from hidvae_tpu_torch.train import hidvae as s1

    write_drop("amazon-raw", root, **drop)
    gin = stage1_gin(root, cfg, n, n, force_dataset_process=True, **bindings)
    n_items, n_users = drop["n_items"], drop["n_users"]
    result, launches, seconds, a = built_run(
        s1, "torch_train_hidvae", device, gin,
        lambda _: [(n_items, 768), (n_items, 5), (n_items, 5, 768), (3 * n_users, 20)],
        os.path.join(root, "processed", "tag_index_sports.json"))
    rep = check_stage1_run("raw stage 1", result, launches, n, [n], device, n_items)
    stage1_summary("stage 1", result, launches, seconds, rep, cfg["tag_class_counts"])
    counts = list(result["tag_class_counts"])
    _, table = audit_table("raw", result["model"], counts, a.item_features, device, rep)
    s1_save = latest(result)
    gin2 = trainer_gin(root, dict(cfg, tag_class_counts=counts), s1_save, steps, steps,
                       **(stage2 or {}))
    r2, launches2 = stage2_built("raw stage 2", gin2, steps, device, n_items)
    out = {"stage1": launches["rq_assign"], "table": table, "stage2": launches2,
           "from_artifacts": serve_built("raw", gin2, s1_save, r2["saved_paths"][-1], a, device)}
    del result, r2
    out["kuairand"] = kuairand_part(device, os.path.join(root, "kuairand"), n, steps,
                                    kuairand_drop or {}, kuairand or {})

    ml = os.path.join(root, "movielens")
    os.makedirs(ml)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--movielens", ml,
                    *map(str, movielens)], check=True, timeout=ML_RAW_TIMEOUT_S)
    with open(os.path.join(ml, "movielens.json")) as f:
        if sorted(json.load(f)) != ["1m", "32m"]:
            raise AssertionError("raw: a MovieLens build is missing")
    return out


def kuairand_part(device, root, n, steps, size, bindings):
    """The three KuaiRand gins on the kuairand-raw drop (`bindings` for all
    or by gin): both stage-1 entries, stage 2, serving; tables against a
    plain sweep. Returns the launches."""
    from hidvae_tpu_torch.train import hidvae as s1
    from hidvae_tpu_torch.train import rqvae as rv

    write_drop("kuairand-raw", root, **size)
    common = {k: v for k, v in bindings.items() if k not in KUAIRAND_GINS}
    common.update(paths(root))

    def gin(name, **values):
        return cut_gin(KUAIRAND_GINS[name], os.path.join(root, f"{name}.gin"),
                       {**values, **common, **bindings.get(name, {})}, show=True)

    def shapes(a):  # three histories a user
        n_items, users = len(a.item_features), len(np.unique(a.seq_users))
        return [(n_items, 768), (n_items, 3), (n_items, 3, 768), (3 * users, 40)]

    vocab = os.path.join(root, "processed", "kuairand_tag_index.json")
    # The plain RQ-VAE entry builds processed/kuairand_beauty.npz (no dataset_split).
    g = gin("rqvae", iterations=n, save_model_every=n, eval_every=n, force_dataset_process=True,
            eval_batches=RQVAE_EVAL_BATCHES)
    res, launches, seconds, a = built_run(rv, "torch_train_rqvae", device, g, shapes, vocab)
    n_items = len(a.item_features)
    check_rqvae_run("kuairand rqvae", res, launches, n, [n], device, n_items)
    rep = res["history"]["repetition_rate"][-1]
    stage1_summary("kuairand rqvae", res, launches, seconds, rep)
    out = {"rqvae": launches["rq_assign"], "rqvae_table": audit_table(
        "kuairand rqvae", res["model"], None, a.item_features, device, rep)[1]}
    rq_ckpt = res["saved_paths"][-1]

    # The HiD-VAE entry ("kuairand" split: another file, built again).
    accumulate = parse_gin_file(KUAIRAND_GINS["h_rqvae"])["train"]["gradient_accumulate_every"]
    g = gin("h_rqvae", iterations=n // accumulate, save_model_every=n, eval_every=n,
            eval_batches=STAGE1_EVAL_BATCHES)
    res, launches, seconds, a2 = built_run(s1, "torch_train_hidvae", device, g, shapes, vocab)
    if not all(np.array_equal(getattr(a, k), getattr(a2, k)) for k in vars(a)
               if getattr(a, k) is not None):
        raise AssertionError("kuairand: the two builds of one drop differ")
    rep = check_stage1_run("kuairand h_rqvae", res, launches, n, [n], device, n_items)
    stage1_summary("kuairand h_rqvae", res, launches, seconds, rep,
                   parse_gin_file(g)["train"]["tag_class_counts"])
    out.update(h_rqvae=launches["rq_assign"], h_rqvae_table=audit_table(
        "kuairand h_rqvae", res["model"], list(res["tag_class_counts"]), a.item_features,
        device, rep)[1])
    del res

    # Stage 2 on the RQ-VAE checkpoint, as the gin pairs them.
    g = gin("decoder", iterations=steps, full_eval_every=steps, partial_eval_every=steps,
            save_model_every=steps, eval_batches=TRAINER_EVAL_BATCHES, log_every=1,
            pretrained_rqvae_path=f'"{rq_ckpt}"')
    r2, out["stage2"] = stage2_built("kuairand stage 2", g, steps, device, n_items)
    out["from_artifacts"] = serve_built("kuairand", g, rq_ckpt, r2["saved_paths"][-1], a, device)
    return out


# ---- inspection tools: tag completion, the view scripts, diag, attribution

TOOLS_HOLES = 0.1            # share of the known tag slots punched at each level
TOOLS_LLM_ANSWERS = 500      # the loopback LLM answers this many, then refuses (503)
TOOLS_BLANK_TITLES = 0.05
DIAG_N = 50_000
ATTRIB = dict(iters=20, warmup=3, beam_iters=10)  # 5 calls left the optimizer's share in the noise


def answer_server(truth, vocabs, answers=None):
    """A loopback chat server answering from `truth` (the row from the item
    text), refusing (503) after `answers`. Returns (server, rows answered)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    rows, lock = [], threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            row = int(json.loads(body["messages"][1]["content"])["item"].split()[-1])
            with lock:
                ok = answers is None or len(rows) < answers
                if ok:
                    rows.append(row)
            if not ok:
                self.send_error(503)
                return
            text = json.dumps({f"level_{l + 1}": vocabs[l][truth[row, l]] for l in range(3)})
            data = json.dumps({"choices": [{"message": {"content": text}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, rows


def llm_run(lt, truth, holed, feats, emb, vocabs, journal, answers=None):
    """complete_tags_llm through an LLMPool on an answer_server. Returns
    (tags, rows answered, seconds)."""
    server, rows = answer_server(truth, vocabs, answers)
    pool = lt.LLMPool([lt.LLMEndpoint(f"http://127.0.0.1:{server.server_address[1]}/v1")],
                      max_retries=2, retry_delay=0)
    t0 = time.perf_counter()
    try:
        out = lt.complete_tags_llm(pool, [f"video {i}" for i in range(len(truth))], holed,
                                   vocabs, emb, feats, progress_path=journal)
    finally:
        server.shutdown()
        server.server_close()
    return out, rows, time.perf_counter() - t0


def tag_completion(root):
    """Seeded holes in the KuaiRand corpus: deterministic completion, the
    LLM route (a dying server, a resume), fill_empty_titles."""
    import logging

    from hidvae_tpu_torch.data import llm_tags as lt
    from hidvae_tpu_torch.data.processed import ProcessedArrays

    a = ProcessedArrays.load(processed_path(os.path.join(root, "kuairand"), RecDataset.KUAIRAND,
                                            "beauty"))
    truth, emb, feats = a.tags_indices.astype(np.int32), a.tags_emb, a.item_features
    rng = np.random.RandomState(SEED + 61)
    holes = (rng.rand(*truth.shape) < TOOLS_HOLES) & (truth >= 0)
    holed = np.where(holes, -1, truth)
    t0 = time.perf_counter()
    out = lt.complete_tags_hierarchical(feats, holed, emb)
    seconds = time.perf_counter() - t0
    h = lt.build_tag_hierarchy(holed)
    if not np.array_equal(out[~holes], truth[~holes]):
        raise AssertionError("tags: completion changed a known slot")
    for l, parents in ((1, "l1_to_l2"), (2, "l2_to_l3")):
        for i in np.nonzero(holes[:, l])[0]:
            kids = h[parents].get(int(out[i, l - 1]))
            if kids and out[i, l] not in kids:
                raise AssertionError(f"tags: row {i} level {l} outside its parent's children")
        if ((out[:, l - 1] >= 0) & (out[:, l] < 0)).any():
            raise AssertionError(f"tags: a level {l} slot left empty under a parent")
    rec = dict(items=len(truth), holes=holes.sum(0).tolist(),
               rows_missing_l1=int(holes[:, 0].sum()), seconds=seconds,
               recovered=float((out[holes] == truth[holes]).mean()))
    print(f"  tags: {rec['holes']} holes by level, {rec['items']} items "
          f"({rec['rows_missing_l1']} without L1), {seconds:.3f} s; "
          f"{100 * rec['recovered']:.2f} % exact; hierarchy held")

    # The LLM route on the rows whose truth is complete.
    keep = (truth >= 0).all(1)
    truth, holed, feats, emb = truth[keep], holed[keep], feats[keep], emb[keep]
    vocabs = [[f"l{l}_{t}" for t in range(truth[:, l].max() + 1)] for l in range(3)]
    journal = os.path.join(root, "llm_progress.jsonl")
    needs = set(np.nonzero((holed < 0).any(1))[0].tolist())
    answers = min(TOOLS_LLM_ANSWERS, len(needs) // 2)
    quiet = logging.getLogger(lt.__name__)
    level = quiet.level
    quiet.setLevel(logging.ERROR)  # the dead server's refusals
    try:
        _, first, s1 = llm_run(lt, truth, holed, feats, emb, vocabs, journal, answers)
        done = lt.load_completion_progress(journal)
        out, second, s2 = llm_run(lt, truth, holed, feats, emb, vocabs, journal)
    finally:
        quiet.setLevel(level)
    print(f"  llm: {len(needs)} rows; server died after {len(first)} answers ({len(done)} "
          f"journaled, {s1:.2f} s); resumed run asked {len(second)} in {s2:.2f} s "
          f"({len(second) / s2:.1f}/s); output is the truth {np.array_equal(out, truth)}")
    if not (set(done) == set(first) and len(first) == answers
            and set(second) == needs - set(done) and len(second) == len(set(second))
            and np.array_equal(out, truth)):
        raise AssertionError("llm: journal, resume or output wrong")
    blank = np.random.RandomState(SEED + 62).rand(len(truth)) < TOOLS_BLANK_TITLES
    texts = ["" if b else f"video {i}" for i, b in enumerate(blank)]
    titles = lt.fill_empty_titles(texts, truth, vocabs)
    want = [" ".join(vocabs[l][t] for l, t in enumerate(truth[i])) if b else texts[i]
            for i, b in enumerate(blank)]
    print(f"  fill_empty_titles: {int(blank.sum())} blank titles filled {titles == want}")
    if titles != want:
        raise AssertionError("fill_empty_titles: wrong titles")
    return dict(rec, llm_rows=len(needs), llm_answered_before_death=len(first),
                llm_resumed_requests=len(second), llm_requests_per_s=len(second) / s2,
                titles_filled=int(blank.sum()))


@phase("tools")
def tools_phase(device, root, diag=None, diag_n=DIAG_N, view_args=(), attrib=ATTRIB):
    """Tag completion on the raw phase's KuaiRand corpus; torch_view.py
    (tables against a plain sweep); torch_diag_mining.py on `diag`
    (checkpoint, root) or the view run's; --attrib. Returns the record."""
    card = device.type == "cuda"
    rec = {"tags": tag_completion(root)}
    view, work = load_script("torch_view"), os.path.join(root, "view")
    args = ["--root", os.path.join(work, "ds"), "--out", os.path.join(work, "out"), *view_args]
    launches = {}
    for name in ("train-hrqvae", "train-rqvae"):
        rq.rq_assign.launches = 0
        t0 = time.perf_counter()
        out = view.main([name, *args])
        seconds, launches[name] = time.perf_counter() - t0, rq.rq_assign.launches
        audits = len(out["result"]["history"]["repetition_rate"])
        hold_table(f"{name}: {seconds:.2f} s, rq_assign launches {launches[name]} (D 16, 500 "
                   f"rows; {audits} audits + the table)", out["corpus"][:, :3],
                   out["result"]["model"], out["items"].item_features, device, 8192)
        if launches[name] != (audits + 1 if card else 0):
            raise AssertionError(f"{name}: rq_assign launched {launches[name]} times")
        if name == "train-hrqvae":
            diag = diag or (out["result"]["saved_paths"][-1], os.path.join(work, "ds"))
        del out
    t0 = time.perf_counter()
    view.main(["processed", os.path.join(root, "kuairand"), "--dataset", "KUAIRAND",
               "--split", "beauty"])
    print(f"  processed (KuaiRand): {time.perf_counter() - t0:.2f} s")

    rq.rq_assign.launches = 0
    d = load_script("torch_diag_mining").diag(*diag, n=diag_n, device=device)
    launches["diag"] = rq.rq_assign.launches
    n = len(d["ids_eval"])
    if launches["diag"] != (-(-n // 1000) if card else 0) or d["rates"][
            "pairs equal under eval-mode ids"] != 1.0:
        raise AssertionError(f"diag: {launches['diag']} launches, rates {d['rates']}")
    print(f"  diag: {n} items, rq_assign launches {launches['diag']}, rates {d['rates']}")
    rep = load_script("torch_train_profile").attrib(
        device, trace_dir=os.path.join(root, "trace"), **attrib)
    rep["trace_bytes"] = os.path.getsize(rep["trace"])
    print(f"  attrib: {json.dumps(rep)}")
    return dict(rec, launches=launches, diag=d["rates"], attrib=rep)


# ---- multi-GPU: stage-1 data parallelism

# Mini-steps of each stage-1 multi run (audited and saved at its end).
MULTI1_STEPS = {"amazon": 4, "mining": 4, "mining_fp32": 4, "ml32m": 3}
MULTI1_MINING_EVERY = 2   # the mining runs audit at 2 as well: that pool feeds steps 3 and 4
MULTI1_TIMEOUT_S = 600    # the two Gloo ranks' stage-1 runs
# Biases before a train-mode BatchNorm: zero gradients up to rounding,
# which Adam turns into steps of up to 1.3 learning rates (held so).
BN_BIAS_LR_STEPS = 2 * 1.3


def split_bn_biases(params):
    """(params without the tag projectors' dense_0 biases, those biases)."""
    def is_bias(k):
        return k.startswith("tag_projector_") and k.endswith("dense_0/bias")
    return ({k: v for k, v in params.items() if not is_bias(k)},
            {k: v for k, v in params.items() if is_bias(k)})


def check_gradient_witness(recs, ranks, want_rec, want):
    """The DP 2 witness step: float64 gradients equal on both ranks and
    within MULTI_GRAD64_RTOL of one process's, the loss, mined pairs."""
    got, exact = ranks[0]["grads64"], want["grads64"]
    if set(got) != set(exact) or any(
            not np.array_equal(ranks[1]["grads64"][k], got[k]) for k in exact):
        raise AssertionError("gradient witness: the ranks' gradients differ or lack arrays")
    top = max(float(np.abs(v).max()) for v in exact.values())
    gap64, gap32 = {}, {}
    for k, v in exact.items():
        scale = (top if k.startswith("tag_projector_") and ".dense_0." in k
                 else float(np.abs(v).max())) or 1.0
        gap64[k] = float(np.abs(got[k] - v).max()) / scale
        gap32[k] = float(np.abs(ranks[0]["grads"][k] - want["grads"][k]).max()) / scale
    worst64, worst32 = (sorted(g, key=lambda k: -g[k])[:3] for g in (gap64, gap32))
    loss_err = abs(recs[0]["loss"][0] - want_rec["loss"][0]) / abs(want_rec["loss"][0])
    print(f"  gradient witness (fp32 mining gin, step {want_rec['step'] - 1}, collisions "
          f"{want_rec['mined']}): {len(exact)} arrays, DP 2 vs 1 at each one's largest entry: "
          f"float64 {[(k, f'{gap64[k]:.2e}') for k in worst64]} (tol {MULTI_GRAD64_RTOL}), fp32 "
          f"{[(k, f'{gap32[k]:.2e}') for k in worst32]}; loss {recs[0]['loss'][0]} vs "
          f"{want_rec['loss'][0]} ({loss_err:.3e})")
    if not want_rec["mined"] or not want_rec["mined"][-1] > 0:
        raise AssertionError("gradient witness: no mined pair collided in the step")
    if gap64[worst64[0]] > MULTI_GRAD64_RTOL or loss_err > MULTI_FIRST_LOSS_RTOL:
        raise AssertionError("gradient witness: DP 2 differs from one process")
    return dict(float64_gap=gap64[worst64[0]], fp32_gap=gap32[worst32[0]], loss_rel_err=loss_err)


def check_stage1_multi(name, spec, losses, params, want_losses, want_params, init, updates,
                       first_rtol=MULTI_FIRST_LOSS_RTOL, param_rtol=MULTI_FP32_PARAM_RTOL):
    """check_multi_run, the biases before a BatchNorm held to
    BN_BIAS_LR_STEPS learning rates an update."""
    lr = parse_gin_file(spec["gin"])["train"]["learning_rate"]
    (got, got_b), (want, want_b), (init, _) = (split_bn_biases(p)
                                                for p in (params, want_params, init))
    worst = max((float(np.abs(got_b[k] - want_b[k]).max()) for k in want_b), default=0.0)
    bound = BN_BIAS_LR_STEPS * lr * updates
    print(f"  {name}: BatchNorm-preceding biases within {worst:.3e} (bound {bound:.3e})")
    if worst > bound:
        raise AssertionError(f"{name}: BatchNorm-preceding biases differ by {worst}")
    return check_multi_run(name, losses, got, want_losses, want, init, first_rtol=first_rtol,
                           param_rtol=param_rtol)


def multi1_inputs(root, amazon_root, amazon=AMAZON, xxl=XXL_M, ml32m=ML32M, bindings=None):
    """The stage-1 multi gins, cut as their phases do, over the Amazon,
    mining and ML-32M data. Returns ({name: spec}, the Amazon 2N gin)."""
    bindings = bindings or {}
    os.makedirs(root, exist_ok=True)
    a_steps = MULTI1_STEPS["amazon"]
    accumulate = parse_gin_file(H_RQVAE_AMAZON_GIN)["train"]["gradient_accumulate_every"]
    a = amazon
    amazon = {
        "save_model_every": a_steps, "eval_every": a_steps, **vae_widths(a),
        "tag_class_counts": list(a["tag_class_counts"]), "tag_embed_dim": a["tag_embed_dim"],
        "dataset_folder": f'"{amazon_root}"',
        "eval_batches": STAGE1_EVAL_BATCHES, "log_every": 1, "mixed_precision_type": '"fp32"',
        **bindings.get("amazon", {})}
    gins = {"amazon": cut_gin(H_RQVAE_AMAZON_GIN, os.path.join(root, "s1_amazon.gin"),
                              dict(amazon, iterations=a_steps // accumulate), show=True)}
    amazon_2n = cut_gin(H_RQVAE_AMAZON_GIN, os.path.join(root, "s1_amazon_2n.gin"),
                        dict(amazon, iterations=2 * a_steps // accumulate))

    t0 = time.perf_counter()
    write_mining_inputs(processed_path(os.path.join(root, "mining"), RecDataset.SYNTHETIC), xxl)
    mining = {
        "iterations": MULTI1_STEPS["mining"], "save_model_every": MULTI1_STEPS["mining"],
        "eval_every": MULTI1_MINING_EVERY, **vae_widths(xxl), "vae_n_layers": xxl["n_layers"],
        "tag_embed_dim": xxl["tag_embed_dim"],
        "dataset_folder": f'"{os.path.join(root, "mining")}"',
        "eval_batches": MINING_EVAL_BATCHES, "log_every": 1, **bindings.get("mining", {})}
    gins["mining"] = cut_gin(H_RQVAE_XXL_M_GIN, os.path.join(root, "s1_mining.gin"), mining,
                             show=True)
    gins["mining_fp32"] = cut_gin(H_RQVAE_XXL_M_GIN, os.path.join(root, "s1_mining_fp32.gin"),
                                  dict(mining, mixed_precision_type='"fp32"'))

    rq_gin = parse_gin_file(RQVAE_ML32M_GIN)["train"]
    feats = unit_rows(ml32m["n_items"], ml32m["input_dim"],
                      torch.Generator().manual_seed(SEED + 41)).numpy()
    write_items(processed_path(os.path.join(root, "ml32m"), rq_gin["dataset"],
                               rq_gin.get("dataset_split", "beauty")),
                feats, np.random.RandomState(SEED + 43))
    gins["ml32m"] = cut_gin(RQVAE_ML32M_GIN, os.path.join(root, "s1_ml32m.gin"), {
        "iterations": MULTI1_STEPS["ml32m"], "save_model_every": MULTI1_STEPS["ml32m"],
        "eval_every": MULTI1_STEPS["ml32m"], "force_dataset_process": False, **vae_widths(ml32m),
        "dataset_folder": f'"{os.path.join(root, "ml32m")}"',
        "eval_batches": RQVAE_EVAL_BATCHES, "log_every": 1, **bindings.get("ml32m", {})},
        show=True)
    print(f"  wrote the stage-1 multi catalogs in {time.perf_counter() - t0:.2f} s: mining "
          f"{xxl['n_items']} (of {XXL_M_CORPUS}), ML-32M {ml32m['n_items']}, Amazon "
          f"{a['n_items']}")
    items = {"amazon": a["n_items"], "mining": xxl["n_items"], "mining_fp32": xxl["n_items"],
             "ml32m": ml32m["n_items"]}
    feats = {"amazon": processed_path(amazon_root, RecDataset.AMAZON, "sports"),
             "ml32m": processed_path(os.path.join(root, "ml32m"), rq_gin["dataset"],
                                     rq_gin.get("dataset_split", "beauty"))}
    feats["mining"] = feats["mining_fp32"] = processed_path(os.path.join(root, "mining"),
                                                            RecDataset.SYNTHETIC)
    specs = {name: dict(trainer="rqvae" if name == "ml32m" else "hidvae", gin=gin,
                        feats=feats[name], steps=MULTI1_STEPS[name], items=items[name],
                        fp32=name != "mining", exact=name in ("amazon", "ml32m"),
                        accumulate=parse_gin_file(gin)["train"].get("gradient_accumulate_every",
                                                                    1))
             for name, gin in gins.items()}
    return specs, amazon_2n


def multi1_run(spec, device, save_root, gin=None, grads=False, **kwargs):
    """spec's trainer from its gin, counts reset. Returns (record, arrays);
    on several ranks rank 0's audit against a plain sweep."""
    import importlib

    from hidvae_tpu_torch.utils.config import parse_config_and_run

    module = importlib.import_module(f"hidvae_tpu_torch.train.{spec['trainer']}")
    rq.rq_assign.launches = 0
    t0 = time.perf_counter()
    res = parse_config_and_run(module.train, [gin or spec["gin"]], device=device,
                               save_dir_root=save_root, **kwargs)
    sync(device)
    h = res["history"]
    rec = dict(loss=h["total_loss"], eval_loss=h["eval_total_loss"],
               repetition=h["repetition_rate"], audits=len(h["repetition_rate"]),
               mined=h.get("mined_pair_collision_rate"),
               rq_launches=rq.rq_assign.launches, seconds=time.perf_counter() - t0,
               bytes_per_step=h["collective_bytes_per_step"], step=res["step"],
               saved=res["saved_paths"][-1] if res["saved_paths"] else None,
               n_params=sum(p.numel() for p in res["model"].parameters()),
               tag_class_counts=res.get("tag_class_counts"),
               rare_tags=sum(len(v) for v in (res.get("rare_tags") or {}).values()))
    pool = getattr(res["data"], "mining_pairs", None)
    model = res["model"]
    arrays = dict(table=res["corpus_ids"], pool=None if pool is None else pool.cpu().numpy(),
                  params=state_dict_to_flax(model)[0])
    if grads:
        arrays["grads"] = {k: p.grad.cpu().numpy() for k, p in model.named_parameters()
                           if p.grad is not None}
    if res["mesh"].n_data > 1 and res["corpus_ids"] is not None and spec["trainer"] == "hidvae":
        feats = torch.from_numpy(np.load(spec["feats"])["item_features"]).to(device)
        ref, ties, _ = plain_sweep(model, feats, 8192)
        rec["audit_vs_plain"] = compare_ids(torch.from_numpy(res["corpus_ids"]).to(device),
                                            ref, ties)
    return rec, arrays


def save_arrays(path, arrays):
    """multi1_run's arrays as one .npz (a dict's entries under "<key>/")."""
    flat = {}
    for key, v in arrays.items():
        if isinstance(v, dict):
            flat.update({f"{key}/{k}": a for k, a in v.items()})
        elif v is not None:
            flat[key] = v
    np.savez(path, **flat)


def load_arrays(path):
    """save_arrays' arrays back."""
    out = {}
    for key, v in np.load(path).items():
        head, _, rest = key.partition("/")
        if rest:
            out.setdefault(head, {})[rest] = v
        else:
            out[key] = v
    return out


def multi1_rank_main(workdir):
    """A stage-1 multi Gloo rank on cuda:0: each gin at DP 2, then the
    gradient witness. Writes rank<r>_s1.*."""
    import torch.distributed as dist

    with open(os.path.join(workdir, "s1_inputs.json")) as f:
        inp = json.load(f)
    device = torch.device(inp["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    out = {}
    try:
        runs = [(name, spec, {}) for name, spec in inp["specs"].items()]
        w = inp["witness"]
        runs.append(("witness", inp["specs"][w["spec"]],
                     dict(grads=True, iterations=1, pretrained_hrqvae_path=w["path"])))
        for name, spec, kwargs in runs:
            run = float64_run if name == "witness" else multi1_run
            rec, arrays = run(spec, device, os.path.join(workdir, f"gloo_{name}"), **kwargs)
            out[name] = rec
            save_arrays(os.path.join(workdir, f"rank{rank}_s1_{name}.npz"), arrays)
            del arrays
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}_s1.json"), "w") as f:
        json.dump(out, f)


def differing_rows(got, want, hold=True, name=""):
    """Rows in which two tables (or pools) differ; with `hold`, none may."""
    if got is None and want is None:
        return 0
    rows = (-1 if got is None or want is None or got.shape != want.shape
            else int((got != want).reshape(len(want), -1).any(1).sum()))
    if rows > 0:
        per_col = (got != want).reshape(len(want), -1).sum(0).tolist()
        print(f"  {name}: {rows} of {len(want)} rows differ; entries per column {per_col}")
    if hold and rows:
        raise AssertionError(f"{name}: differs in {rows} rows (-1: in shape)")
    return rows


def ulp_control_run(spec, device, save_root):
    """multi1_run with every parameter one ulp off after k-means: how far
    fp32 rounding alone carries the run."""
    from hidvae_tpu_torch.train import hidvae as hv

    kmeans = hv.kmeans_init_

    def perturbed(model, *args, **kwargs):
        kmeans(model, *args, **kwargs)
        g = torch.Generator().manual_seed(SEED + 61)
        with torch.no_grad():
            for p in model.parameters():
                up = torch.rand(p.shape, generator=g).to(p.device) < 0.5
                p.copy_(torch.nextafter(p, torch.where(up, math.inf, -math.inf)))

    hv.kmeans_init_ = perturbed
    try:
        return multi1_run(spec, device, save_root)
    finally:
        hv.kmeans_init_ = kmeans


def float64_run(spec, device, save_root, **kwargs):
    """multi1_run whose steps also take summed float64 gradients (arrays["grads64"])."""
    import copy

    from hidvae_tpu_torch.models import quantize
    from hidvae_tpu_torch.models.losses import mixup_draw
    from hidvae_tpu_torch.ops.gumbel import sample_gumbel
    from hidvae_tpu_torch.train import hidvae as hv
    from hidvae_tpu_torch.train.common import reduce_gradients_

    make, gumbel, to_float = hv.make_train_step, quantize.gumbel_softmax_sample, torch.Tensor.float
    grads64 = {}

    def gumbel_fp32_draws(logits, temperature, generator=None, noise=None):
        if noise is None:
            noise = sample_gumbel(logits.shape, generator, logits.device).to(logits.dtype)
        return gumbel(logits, temperature, generator, noise)

    def make64(model, optimizer, class_counts, gumbel_t=hv.GUMBEL_T, n_mined_pairs=0):
        step = make(model, optimizer, class_counts, gumbel_t, n_mined_pairs)

        def step64(x, tags_emb, tags_indices, generator, host, rows=None):
            m64 = copy.deepcopy(model).double()
            m64.zero_grad(set_to_none=True)
            state, host64 = generator.get_state(), copy.deepcopy(host)
            metrics = step(x, tags_emb, tags_indices, generator, host, rows)
            g64 = torch.Generator(x.device)
            g64.set_state(state)

            def mixup(level, batch):
                return mixup_draw(batch, m64.mixup_alpha, g64, host64, x.device)

            torch.set_default_dtype(torch.float64)
            torch.Tensor.float = torch.Tensor.double
            quantize.gumbel_softmax_sample = gumbel_fp32_draws
            try:
                m64(x.double(), None if tags_emb is None else tags_emb.double(), tags_indices,
                    gumbel_t, train=True, class_counts=class_counts, n_mined_pairs=n_mined_pairs,
                    generator=g64, mixup=mixup, rows=rows).loss.backward()
                if rows is not None:
                    reduce_gradients_(list(m64.parameters()), rows.group)
            finally:
                torch.set_default_dtype(torch.float32)
                torch.Tensor.float = to_float
                quantize.gumbel_softmax_sample = gumbel
            grads64.update({k: p.grad.cpu().numpy() for k, p in m64.named_parameters()
                            if p.grad is not None})
            return metrics

        return step64

    hv.make_train_step = make64
    try:
        rec, arrays = multi1_run(spec, device, save_root, **kwargs)
    finally:
        hv.make_train_step = make
    arrays["grads64"] = grads64
    return rec, arrays


def multi_stage1(device, root, amazon_root, **inputs):
    """Stage-1 DP per multi1_inputs gin: one process, one NCCL rank, two
    Gloo ranks; rounding control, float64 witness, resume. Raises at the end."""
    specs, amazon_2n = multi1_inputs(root, amazon_root, **inputs)
    cuda = device.type == "cuda"
    one, init = {}, {}
    for name, spec in specs.items():
        one[name] = multi1_run(spec, device, os.path.join(root, f"one_{name}"))
        if spec["fp32"]:  # the k-means-initialized params: the scale of the run's update
            init[name] = multi1_run(spec, device, os.path.join(root, f"init_{name}"),
                                    iterations=0)[1]["params"]
    full, full_arr = multi1_run(specs["amazon"], device, os.path.join(root, "one_amazon_2n"),
                                gin=amazon_2n)

    nccl = on_one_rank(device, lambda: {
        name: multi1_run(spec, device, os.path.join(root, f"nccl_{name}"))
        for name, spec in specs.items()})

    witness = dict(spec="mining_fp32", path=one["mining_fp32"][0]["saved"])
    with open(os.path.join(root, "s1_inputs.json"), "w") as f:
        json.dump(dict(specs=specs, device=str(device), witness=witness), f)
    two_ranks("--multi-stage1-rank", root, MULTI1_TIMEOUT_S, "stage 1, ")
    ranks, npz = [], []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}_s1.json")) as f:
            ranks.append(json.load(f))
        npz.append({name: load_arrays(os.path.join(root, f"rank{r}_s1_{name}.npz"))
                    for name in [*specs, "witness"]})

    failures = []

    def fail(msg):
        print(f"  FAILED: {msg}")
        failures.append(msg)

    def hold(check, *args, **kwargs):
        try:
            return check(*args, **kwargs)
        except AssertionError as e:
            fail(str(e))
            return {}

    record = {}
    for name, spec in specs.items():
        (want, want_arr), (nc, nc_arr) = one[name], nccl[name]
        want_launches = math.ceil(spec["items"] / 8192) if cuda else 0
        bitwise = (nc["loss"] == want["loss"]
                   and differing_rows(nc_arr["table"], want_arr["table"], False) == 0
                   and differing_rows(nc_arr["pool"], want_arr["pool"], False) == 0
                   and all(np.array_equal(nc_arr["params"][k], want_arr["params"][k])
                           for k in want_arr["params"]))
        rr = [r[name] for r in ranks]
        per_audit = [r["rq_launches"] / r["audits"] for r in rr]
        if name.startswith("mining") and want["rare_tags"]:
            fail(f"stage 1 {name}: the rare-tag remap folded {want['rare_tags']} classes: the "
                 f"catalog cuts the tag heads' widths")
        print(f"  stage 1 {name} ({spec['trainer']}, {spec['steps']} mini-steps, "
              f"{'fp32' if spec['fp32'] else 'bf16'}): one process losses "
              f"{[round(x, 5) for x in want['loss']]}; NCCL 1 bitwise {bitwise}; 2 ranks: "
              f"losses equal {rr[0]['loss'] == rr[1]['loss']}, s "
              f"{[round(r['seconds'], 2) for r in rr]} (1: {want['seconds']:.2f}); "
              f"rq_assign /rank /audit {per_audit} (1: {want['rq_launches'] / want['audits']}); "
              f"bytes /mini-step /rank {[r['bytes_per_step'] for r in rr]} (gradients "
              f"{4 * want['n_params']}); tags {want['tag_class_counts']}, {want['rare_tags']} folded")
        if not bitwise:
            fail(f"stage 1 {name}: one NCCL rank differs from one process")
        if per_audit != [want_launches] * 2 or want["rq_launches"] != want_launches * want["audits"]:
            fail(f"stage 1 {name}: rq_assign launches per audit {per_audit}, expected "
                 f"{want_launches}")
        for key in ("table", "pool"):
            hold(differing_rows, npz[1][name].get(key), npz[0][name].get(key),
                 name=f"{name} ranks' {key}")
        if "audit_vs_plain" in rr[0]:
            n_diff, n_bad = rr[0]["audit_vs_plain"]
            print(f"  stage 1 {name}: rank 0's last audit vs a plain sweep: {n_diff} rows off, "
                  f"{n_bad} not at a near tie")
            if n_bad:
                fail(f"stage 1 {name}: rank 0's audit differs from a plain sweep")
        params = [z[name]["params"] for z in npz]
        if not all(np.array_equal(params[1][k], params[0][k]) for k in params[0]):
            fail(f"stage 1 {name}: the ranks' params differ")
        rec = dict(bytes_per_step=[r["bytes_per_step"] for r in rr], rq_per_audit=per_audit,
                   nccl_bitwise=bitwise)
        if spec["fp32"]:
            rec.update(hold(check_stage1_multi, f"stage 1 {name} 2 ranks", spec, rr[0]["loss"],
                            params[0], want["loss"], want_arr["params"], init[name],
                            spec["steps"] // spec["accumulate"],
                            param_rtol=MULTI_FP32_PARAM_RTOL if spec["exact"] else math.inf))
        else:
            err = max(abs(a - b) / abs(b) for a, b in zip(rr[0]["loss"], want["loss"]))
            print(f"  stage 1 {name} 2 ranks (bf16): losses {[round(x, 5) for x in rr[0]['loss']]}"
                  f" (rel {err:.3e}, tol {MULTI_LOSS_RTOL})")
            if len(rr[0]["loss"]) != len(want["loss"]) or not err <= MULTI_LOSS_RTOL:
                fail(f"stage 1 {name}: the bf16 run differs from one process")
            rec["loss_rel_err"] = err
        rec["rows_differing"] = {key: hold(
            differing_rows, npz[0][name].get(key), want_arr[key], spec["exact"],
            f"{name} {key} against one process") for key in ("table", "pool")}
        print(f"  stage 1 {name}: rows off one process's {rec['rows_differing']}"
              + ("" if spec["exact"] else " (not held)"))
        record[name] = rec

    # fp32 rounding alone: one process from params one ulp off.
    name = witness["spec"]
    ctl, ctl_arr = ulp_control_run(specs[name], device, os.path.join(root, "ulp_control"))
    want, want_arr = one[name]
    update = {k: want_arr["params"][k] - init[name][k] for k in init[name]}
    gap = relative_gap(*(split_bn_biases(p)[0] for p in (ctl_arr["params"], want_arr["params"],
                                                         update)))[0]
    rows = {key: differing_rows(ctl_arr[key], want_arr[key], False, f"{name} rounding control "
                                f"{key} against one process") for key in ("table", "pool")}
    errs = [abs(a - b) / abs(b) for a, b in zip(ctl["loss"], want["loss"])]
    print(f"  stage 1 {name}: rounding control (1 process, params one ulp off after k-means): "
          f"losses rel {[f'{e:.2e}' for e in errs]}, params gap {gap:.3e}, rows off {rows}; "
          f"DP 2: params gap {record[name].get('param_gap', math.nan):.3e}, rows "
          f"{record[name]['rows_differing']}")
    record[name]["rounding_control"] = dict(param_gap=gap, rows_differing=rows,
                                            loss_rel_err=max(errs))

    # The gradient witness: a mining mini-step, one process and DP 2, also
    # in float64.
    w_one, w_arr = float64_run(specs[witness["spec"]], device, os.path.join(root, "witness_one"),
                               grads=True, iterations=1, pretrained_hrqvae_path=witness["path"])
    record["gradient_witness"] = hold(check_gradient_witness, [r["witness"] for r in ranks],
                                      [z["witness"] for z in npz], w_one, w_arr)

    # The DP 2 checkpoint at N resumed on one process for N more.
    n = specs["amazon"]["steps"]
    resumed, res_arr = multi1_run(specs["amazon"], device, os.path.join(root, "resumed"),
                                  pretrained_hrqvae_path=ranks[0]["amazon"]["saved"])
    record["amazon_resume"] = hold(check_stage1_multi,
        "stage 1 amazon: DP 2 checkpoint resumed on one process", specs["amazon"],
        resumed["loss"], res_arr["params"], full["loss"][n:], full_arr["params"],
        one["amazon"][1]["params"], 2 * n // specs["amazon"]["accumulate"], first_rtol=None)
    hold(differing_rows, res_arr["table"], full_arr["table"], name="amazon resume table")
    if failures:
        raise AssertionError(f"stage 1 multi: {len(failures)} checks failed: {failures}")
    return record


def main():
    smi = card_phase()
    device = torch.device("cuda", 0)
    build_phase()
    rec = kernel_phase(device)
    launches, engine, items, hist, tok_launches = serve_phase(device)
    art_launches = artifacts_phase(device, engine, items, hist)
    tok = engine.tokenizer
    del engine
    flash_recs = flash_phase(device)
    moe_rec = moe_phase(device, tok, items)
    per_layer = sum(r["ms"] for r in flash_recs.values())
    long_launches, vae, feats = train_phase(device, per_layer)
    with tempfile.TemporaryDirectory() as work:
        stage1, stage1_rec = stage1_phase(device, feats, os.path.join(work, "stage1"))
        trainer_rec = trainer_phase(device, vae, feats, stage1)
        multi_rec = multi_phase(device, vae, feats, stage1,
                                stage1_root=os.path.join(work, "stage1"))
    with tempfile.TemporaryDirectory() as mining_work:
        mining_rec = mining_phase(device, mining_work)
        with tempfile.TemporaryDirectory() as work:
            rqvae_rec = rqvae_phase(device, work)
        with tempfile.TemporaryDirectory() as work:
            synthetic_launches = synthetic_phase(device, work)
        with tempfile.TemporaryDirectory() as work:
            raw_launches = raw_phase(device, work)
            tools_rec = tools_phase(device, work, diag=(mining_rec.pop("checkpoint"), mining_work))
    scale_recs = scale_phase(device)
    kernels = [dict(
        name="rq_assign", route="cuda", source="hidvae_tpu_torch/csrc/rq_assign.cu",
        replaces="hidvae_tpu/ops/pallas/rq_kernels.py:32", launches=launches, library_ms=None,
        **rec, launches_from_artifacts=art_launches,
        launches_trainer={
            "2N run": trainer_rec["full"]["launches"]["rq_assign"],
            **trainer_rec["resume"]["launches"],
            "from_artifacts": trainer_rec["serve"]["launches"]},
        launches_stage1=stage1_rec["launches"],
        launches_rqvae=rqvae_rec["launches"], launches_mining=mining_rec["launches"],
        launches_tokenize_features=tok_launches,
        launches_multi_per_rank={
            "sweep_dp": multi_rec["dp"]["rq_launches"], "sweep_tp": multi_rec["tp"]["rq_launches"],
            "engine_dp": multi_rec["engine_dp"]["rq_launches"],
            "engine_tp": multi_rec["engine_tp"]["rq_launches"]},
        launches_multi_stage1_per_rank_per_audit={
            k: v["rq_per_audit"] for k, v in multi_rec["stage1"].items() if "rq_per_audit" in v},
        launches_synthetic=synthetic_launches, launches_kuairand=raw_launches.pop("kuairand"),
        launches_raw=raw_launches,
        launches_scale={r["n_items"]: r["rq_assign_launches"] for r in scale_recs},
        launches_tools=tools_rec["launches"],
    )]
    for name, r in flash_recs.items():
        kernels.append(dict(
            name=name, route="cuda", source="hidvae_tpu_torch/csrc/flash_attention.cu",
            replaces=FLASH_REPLACES[name], reached_from="hidvae_tpu/models/attention.py:75",
            launches=long_launches[name],
            launches_remat={k: trainer_rec["remat"][k][name] for k in ("remat", "plain")},
            launches_multi_long_dp_per_rank=[rr[name] for rr in multi_rec["long"]["launches"]],
            **r))
    kernels.append(dict(
        name="grouped_swiglu", route="triton", source="hidvae_tpu_torch/ops/moe_experts.py",
        replaces=None, launches=moe_rec.pop("page_launches"), **moe_rec.pop("decode"),
        at_prefill=moe_rec.pop("prefill"), **moe_rec))
    for name, r in (("stage1", stage1_rec), ("mining", mining_rec), ("rqvae", rqvae_rec),
                    ("multi", multi_rec), ("tools", tools_rec)):
        print(f"  {name} record: {json.dumps(r)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.stdout.reconfigure(line_buffering=True)  # every line reaches the log as it is printed
    if sys.argv[1:2] == ["--multi-rank"]:
        multi_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--multi-stage1-rank"]:
        multi1_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--movielens"]:
        movielens_main(*sys.argv[2:5])
    else:
        sys.exit(main())
