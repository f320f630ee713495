"""Catalog-scale index build and serving bench (counterpart of
scripts/bench_scale.py, its steps and widths): an untrained RQ-VAE
(F 768, D 32, K 256, L 3) on seeded features; timed: sweep, engine build,
requests on each constraint path, users/s by bucket (HIDVAE_KNEE_BUCKETS).

Usage: python scripts/torch_bench_scale.py [--device cpu] [n_items ...]
(default 200000 1000000). Prints one JSON line."""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hidvae_tpu_torch.models.init import init_params_  # noqa: E402
from hidvae_tpu_torch.models.quantize import QuantizeForwardMode  # noqa: E402
from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel  # noqa: E402
from hidvae_tpu_torch.models.rqvae import RqVae  # noqa: E402
from hidvae_tpu_torch.ops import rq_assign as rq  # noqa: E402
from hidvae_tpu_torch.serve.engine import RetrievalEngine  # noqa: E402
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer  # noqa: E402
from hidvae_tpu_torch.train.common import sync  # noqa: E402
from hidvae_tpu_torch.train.init import kmeans_init_codebooks  # noqa: E402
from hidvae_tpu_torch.utils.runtime import resolve_device  # noqa: E402

# The decoder of scripts/bench_scale.py: embedding 128, attention 512, 8
# heads, 8 layers.
DECODER = dict(embedding_dim=128, attn_dim=512, num_heads=8, n_layers=8)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_one(n_items, device, request_users=64, max_seq_len=20, big=1024,
              knee_buckets=None, decoder=DECODER, keep=None):
    """The bench at `n_items`'s record; `decoder`: its widths; `keep` (a
    dict) gets the RQ-VAE, features, table, engine and the cap-gather
    path's resolved fraction."""
    device = resolve_device(device)
    F, D, K, L = 768, 32, 256, 3
    _log(f"--- n_items={n_items} ---")
    rng = np.random.RandomState(0)
    feats = rng.randn(n_items, F).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    feats = torch.from_numpy(feats).to(device)

    g = torch.Generator().manual_seed(0)
    vae = init_params_(RqVae(F, D, (512, 256, 128), K, codebook_normalize=True, n_layers=L,
                             codebook_mode=QuantizeForwardMode.ROTATION_TRICK,
                             n_cat_features=0), g).to(device).eval()
    kmeans_init_codebooks(vae, feats[:min(n_items, 20_000)],
                          torch.Generator(device=device).manual_seed(2))
    tok = SemanticIdTokenizer(vae, n_layers=L, codebook_size=K, device=device)

    # Index build: the full-corpus sweep through the frozen quantizer, after
    # one call that builds (or loads) the kernel.
    tok.encode_ids(feats[:8])
    rq.rq_assign.launches = 0
    sync(device)
    t0 = time.perf_counter()
    ids = tok.precompute_corpus_ids(feats)
    sync(device)
    t_sweep = time.perf_counter() - t0
    launches = {"sweep": rq.rq_assign.launches}
    _log(f"corpus sweep: {t_sweep:.4f}s, rq_assign launches {launches['sweep']}")

    model = init_params_(EncoderDecoderRetrievalModel(
        **decoder, num_embeddings=K, sem_id_dim=L, max_pos=max_seq_len * L, n_sem_layers=L,
        dropout=0.3), g)
    rq.rq_assign.launches = 0
    t0 = time.perf_counter()
    engine = RetrievalEngine(model, tok, feats, max_seq_len=max_seq_len,
                             batch_buckets=(request_users,), device=device)
    t_engine = time.perf_counter() - t0  # the build ends in a synchronize
    launches["engine"] = rq.rq_assign.launches  # 0 where it reuses the sweep's table
    _log(f"engine build: {t_engine:.3f}s, of it {engine.build_times}")
    div_rep = 1.0 - len(torch.unique(ids, dim=0)) / n_items
    engine.warmup()

    def median_latency(n_reps=7):
        lat, res = [], None
        for _ in range(n_reps):
            out = engine.recommend(rng.randint(0, n_items, (request_users, max_seq_len)),
                                   top_k=10)
            lat.append(out["latency_s"])
            res = float((out["items"] >= 0).mean())
        return sorted(lat)[len(lat) // 2] * 1e3, res

    lat_ms, resolved = median_latency()
    ups = request_users / (lat_ms / 1e3)

    # The trie bitmaps off: the [B * k, cap] range gather; then the caps
    # clamped to 8, which breaks the answers and isolates the gather's cost.
    caps, tries = list(engine.prefix_caps or []), engine.prefix_tries
    engine.prefix_tries = None
    engine.warmup()
    lat_caps_ms, cap_resolved = median_latency()
    engine.prefix_caps = tuple(min(c, 8) for c in caps)
    engine.warmup()
    lat_clamped_ms, _ = median_latency()
    engine.prefix_caps, engine.prefix_tries = tuple(caps), tries

    engine.warmup()
    hist = rng.randint(0, n_items, (big, max_seq_len))
    t0, t_host0 = time.perf_counter(), time.process_time()
    engine.recommend(hist, top_k=10)
    big_wall = time.perf_counter() - t0
    big_host_cpu = time.process_time() - t_host0

    # Users/s of one `big`-user request as the bucket grows, and the products
    # a bucket call executes.
    from torch.utils.flop_counter import FlopCounterMode

    knee = []
    buckets = knee_buckets or [int(b) for b in os.environ.get(
        "HIDVAE_KNEE_BUCKETS", "128,256,512,1024").split(",")]
    big_req = rng.randint(0, n_items, (big, max_seq_len))
    for bucket in buckets:
        engine.batch_buckets = (bucket,)
        engine.warmup()
        wall = sorted(engine.recommend(big_req, top_k=10)["latency_s"] for _ in range(3))[1]
        with FlopCounterMode(display=False) as counter:
            engine._step(torch.zeros((bucket,), dtype=torch.int32, device=device),
                         torch.zeros((bucket, max_seq_len), dtype=torch.int32, device=device))
        fl = counter.get_total_flops()
        row = {"bucket": bucket, "users_per_sec": round(big / wall, 1),
               "ms_per_1024_users": round(wall * 1e3 * 1024 / big, 1),
               "tflop_per_batch": round(fl / 1e12, 4)}
        knee.append(row)
    engine.batch_buckets = (request_users,)

    if keep is not None:
        keep.update(vae=vae, feats=feats, ids=ids, cap_resolved=cap_resolved, engine=engine)
    return {
        "n_items": n_items,
        "corpus_sweep_s": round(t_sweep, 4),
        "corpus_sweep_items_per_sec": round(n_items / t_sweep, 1),
        "engine_build_s": round(t_engine, 3),
        "serve_ms_per_64u_request": round(lat_ms, 2),
        "serve_users_per_sec": round(ups, 1),
        "top10_resolved_frac": round(resolved, 4),
        "corpus_repetition": round(div_rep, 4),
        "prefix_caps": caps,
        "serve_ms_cap_gather_path": round(lat_caps_ms, 2),
        "serve_ms_clamped_cap_floor": round(lat_clamped_ms, 2),
        "mask_gather_ms": round(lat_caps_ms - lat_clamped_ms, 2),
        "trie_speedup_vs_cap_gather": round(lat_caps_ms / max(lat_ms, 1e-9), 3),
        "serve_1k_users_ms": round(big_wall * 1e3, 1),
        "serve_1k_users_per_sec": round(big / big_wall, 1),
        "serve_1k_host_cpu_ms": round(big_host_cpu * 1e3, 1),
        "bucket_knee": knee,
        "rq_assign_launches": launches,
    }


def card_name(device):
    """The card's name and power limit as nvidia-smi prints them ("cpu" on
    the CPU)."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if args[:1] == ["--device"]:
        device, args = args[1], args[2:]
    device = resolve_device(device)
    # The card's first synchronize (context creation) is timed on its own,
    # so that the sweep and the engine build measure the port.
    t0 = time.perf_counter()
    torch.zeros(8, device=device).sum().item()
    first = time.perf_counter() - t0
    results = [bench_one(int(n), device) for n in args or [200_000, 1_000_000]]
    record = {"scale_bench": results, "first_synchronize_s": round(first, 3),
              "device": card_name(device)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
