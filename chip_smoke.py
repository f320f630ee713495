"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version at the shapes the serving path gives it,
then builds a RetrievalEngine at the Amazon widths of configs/h_rqvae_amazon.gin
and configs/decoder_amazon.gin (random weights from a seed, 18,357 seeded
768-d items: the size of the P5 Sports split), serves one batch and checks
the answer. Every phase prints its start and end; the last line is
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device. Imports
nothing of JAX or of the JAX package, and reads no file but the port's
sources.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hidvae_tpu_torch.models.hrqvae import HRqVae
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from hidvae_tpu_torch.ops import rq_assign as rq
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.utils.runtime import full_fp32

SEED = 0
# configs/h_rqvae_amazon.gin + configs/decoder_amazon.gin; MAX_SEQ_LEN of
# hidvae_tpu/data/amazon.py:40; the corpus size of the P5 Sports split.
AMAZON = dict(
    input_dim=768, hidden_dims=(512, 256, 128), embed_dim=32, codebook_size=256,
    n_layers=3, codebook_normalize=True, tag_class_counts=(38, 168, 348),
    tag_embed_dim=768, decoder_embed_dim=128, attn_embed_dim=512, attn_heads=8,
    attn_layers=8, max_seq_len=20, n_items=18357,
)
KERNEL_CASES = (  # (B, D, L, K)
    (8192, 32, 3, 256),      # one sweep chunk of the serving path
    (18357, 32, 3, 256),     # the whole Amazon corpus
    (1001, 32, 3, 256),      # odd B: a ragged last block
    (1048576, 32, 3, 256),   # 1M rows: the timed case
    (18357, 64, 3, 256),     # the ML-32M width
    (1001, 64, 3, 256),
)
TIMED_CASE = (1048576, 32, 3, 256)
TIE_RTOL = 1e-5
QSUM_ATOL = 1e-5  # qsum on rows whose ids agree, as tests/test_torch_kernels.py holds it
H100_FP32_FLOPS = 67e12     # outside the tensor cores, SXM data sheet
H100_BYTES_PER_S = 3.35e12


def phase(name):
    """Decorator: print a phase's start and end (with elapsed seconds)."""
    def wrap(fn):
        def run(*args, **kwargs):
            print(f"[phase] {name}: start", flush=True)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"[phase] {name}: end {time.perf_counter() - t0:.2f} s", flush=True)
            return out
        return run
    return wrap


# ---- reference comparison -------------------------------------------------

def near_tie_levels(x, codebooks):
    """Per row and level, whether the plain version's best two distances lie
    within TIE_RTOL * (1 + ||r||^2): an exact argmin may fall either way."""
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


def rq_bound_ms(b, d, n_levels, k):
    """Least time for rq_assign on an H100 SXM: each input read once and each
    output written once over the memory rate, against the distance products
    (2*B*K*D*L fp32 operations) over the fp32 rate. Returns (ms, bound_by)."""
    bytes_moved = 4 * (b * d + n_levels * k * d + b * n_levels + b * d)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * k * d * n_levels / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- model and corpus -----------------------------------------------------

def seed_codebooks_(vae, feats, generator):
    """Set each level's codebook to K residuals of distinct seeded items (the
    seeding step of k-means init), so random weights still spread the corpus
    over the ID space."""
    with torch.no_grad():
        enc = vae.encode(feats)
        for q in vae.layers:
            pick = torch.randperm(enc.shape[0], generator=generator)[: q.embedding.shape[0]]
            q.embedding.copy_(enc[pick.to(enc.device)])
            enc = enc - q(enc).embeddings


def build_engine(cfg, device, seed=SEED, batch_buckets=(32,)):
    """RetrievalEngine with seeded random weights and a seeded corpus.
    Returns (engine, item features as numpy)."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(cfg["n_items"], cfg["input_dim"], generator=g)
    feats = feats / feats.norm(dim=-1, keepdim=True)  # text embeddings are unit-norm
    vae = init_params_(HRqVae(
        cfg["input_dim"], cfg["embed_dim"], cfg["hidden_dims"], cfg["codebook_size"],
        codebook_normalize=cfg["codebook_normalize"], n_layers=cfg["n_layers"],
        tag_class_counts=cfg["tag_class_counts"],
        tag_embed_dim=cfg["tag_embed_dim"],
    ), g).eval()
    seed_codebooks_(vae, feats[: 16 * cfg["codebook_size"]], g)
    tok = HSemanticIdTokenizer(
        vae, n_layers=cfg["n_layers"], codebook_size=cfg["codebook_size"],
        tag_class_counts=cfg["tag_class_counts"], use_concatenated_ids=True, device=device,
    )
    d = tok.sem_ids_dim
    model = init_params_(EncoderDecoderRetrievalModel(
        cfg["decoder_embed_dim"], cfg["attn_embed_dim"], cfg["attn_heads"],
        cfg["attn_layers"], cfg["codebook_size"], d, max_pos=cfg["max_seq_len"] * d,
        n_sem_layers=cfg["n_layers"],
    ), g)
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
    """Items in [0, n_items) or -1; every resolved item's ID tuple is the
    generated one; every generated tuple that resolves is in the table."""
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


# ---- phases ---------------------------------------------------------------

@phase("card")
def card_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    return smi


@phase("build")
def build_phase():
    built = rq.build()
    print(f"rq_assign built in {built.build_s:.2f} s -> {built.path.name}", flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    return built


@phase("kernel")
def kernel_phase(device):
    g = torch.Generator(device=device).manual_seed(SEED)
    record = None
    for b, d, n_levels, k in KERNEL_CASES:
        x = torch.randn(b, d, device=device, generator=g)
        x = x / x.norm(dim=-1, keepdim=True)
        cbs = torch.randn(n_levels, k, d, device=device, generator=g) * 0.5
        cbs[0] = cbs[0] / cbs[0].norm(dim=-1, keepdim=True)
        ids, qsum = rq.rq_assign(x, cbs)
        torch.cuda.synchronize()
        ids_ref, qsum_ref = rq.rq_assign_reference(x, cbs)
        n_diff, n_bad = compare_ids(ids, ids_ref, near_tie_levels(x, cbs))
        agree = ~(ids != ids_ref).any(dim=-1)
        qerr = float((qsum - qsum_ref)[agree].abs().max()) if agree.any() else 0.0
        print(f"  B={b} D={d} L={n_levels} K={k}: rows with differing ids {n_diff} "
              f"(not near ties: {n_bad}), max qsum err on agreeing rows {qerr:.3e}",
              flush=True)
        if n_bad:
            raise AssertionError(f"rq_assign disagrees with the plain version on {n_bad} rows")
        if not torch.isfinite(qsum).all():
            raise AssertionError("rq_assign produced non-finite qsum")
        if not agree.any() or qerr > QSUM_ATOL:
            raise AssertionError(f"rq_assign qsum differs from the plain version by {qerr:.3e} "
                                 f"(tolerance {QSUM_ATOL})")
        if (b, d, n_levels, k) == TIMED_CASE:
            ms = median_ms(lambda: rq.rq_assign(x, cbs))
            plain_ms = median_ms(lambda: rq.rq_assign_reference(x, cbs))
            bound_ms, bound_by = rq_bound_ms(b, d, n_levels, k)
            print(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
                  f"({bound_by}) at B={b}", flush=True)
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=qerr, shape=f"x[{b},{d}] codebooks[{n_levels},{k},{d}]")
        del x, cbs, ids, qsum, ids_ref, qsum_ref
    return record


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
          f"rq_assign launches on the main path {launches}", flush=True)
    if launches == 0:
        raise AssertionError("the corpus sweep did not go through the CUDA kernel")
    resolved = check_recommendations(engine, out, cfg["n_items"])
    print(f"  recommend: items {out['items'].shape}, resolved {resolved}, "
          f"first row {out['items'][0].tolist()}", flush=True)

    # The table swept through the kernel against one swept with the plain
    # version on the card, chunk by chunk as the sweep cuts it: same encoder,
    # same tag heads, plain rq_assign.
    tok = engine.tokenizer
    m = tok.hrq_vae
    feats = torch.from_numpy(items).to(device)
    chunk = tok.corpus_chunk_size
    n_l = cfg["n_layers"]
    n_diff = n_bad = 0
    tags_equal = True
    with torch.inference_mode(), full_fp32():
        cbs = m.stacked_codebooks()
        for s in range(0, feats.shape[0], chunk):
            encoded = m.encode(feats[s:s + chunk])
            sem_ref, _ = rq.rq_assign_reference(encoded, cbs)
            got = engine.corpus_ids[s:s + chunk]
            d, bad = compare_ids(got[:, :n_l], sem_ref, near_tie_levels(encoded, cbs))
            n_diff, n_bad = n_diff + d, n_bad + bad
            same = ~(got[:, :n_l] != sem_ref).any(dim=-1)
            tags_ref = m.predict_tags_from_ids(sem_ref)["predictions"]
            tags_equal &= bool((got[same, n_l:] == tags_ref[same]).all())
    print(f"  corpus table vs plain sweep: rows differing {n_diff} (not near ties: "
          f"{n_bad}); tags equal on the rest: {tags_equal}; distinct tuples "
          f"{len(torch.unique(engine.corpus_ids, dim=0))}", flush=True)
    if n_bad or not tags_equal:
        raise AssertionError("corpus table differs from the plain sweep")

    lat = []
    for _ in range(12):
        torch.cuda.synchronize()
        lat.append(engine.recommend(hist, top_k=10)["latency_s"] * 1e3)
    p50 = statistics.median(lat)
    print(f"  serve p50 {p50:.2f} ms over {len(lat)} warm calls of 32 histories "
          f"(min {min(lat):.2f}, max {max(lat):.2f})", flush=True)
    return launches, p50


def main():
    smi = card_phase()
    device = torch.device("cuda", 0)
    build_phase()
    rec = kernel_phase(device)
    launches, _ = serve_phase(device)
    kernels = [dict(
        name="rq_assign", route="cuda", source="hidvae_tpu_torch/csrc/rq_assign.cu",
        replaces="hidvae_tpu/ops/pallas/rq_kernels.py:32", launches=launches,
        max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None,
        shape=rec["shape"],
    )]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
