"""Serve recommendations from two-stage exports (counterpart of
scripts/serve_demo.py; Orbax checkpoints converted first by
scripts/export_flax_checkpoint.py where JAX is installed):

    python scripts/torch_serve_demo.py configs/decoder_synthetic.gin \
        --stage1 EXPORTED_STAGE1 --stage2 EXPORTED_STAGE2 \
        [--users 8] [--top-k 10] [--sweep 8,32] [--device cuda]"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("gin_path", help="decoder gin config (model/tokenizer shapes)")
    ap.add_argument("--stage1", required=True, help="exported stage-1 (tokenizer) checkpoint dir")
    ap.add_argument("--stage2", required=True, help="exported stage-2 (decoder) checkpoint dir")
    ap.add_argument("--users", type=int, default=8, help="number of test users to serve")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument(
        "--sweep", default=None,
        help="comma-separated request sizes; measures a latency/throughput "
             "row per size (e.g. --sweep 8,32,64,128)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import numpy as np

    from hidvae_tpu_torch.data.processed import SeqData
    from hidvae_tpu_torch.serve.engine import RetrievalEngine
    from hidvae_tpu_torch.utils.ginlite import parse_gin_file

    cfg = parse_gin_file(args.gin_path)["train"]
    test_seq = SeqData(cfg["dataset_folder"], cfg["dataset"],
                       split=cfg.get("dataset_split", ""), seq_split="test")

    print("Building corpus index + restoring models ...", file=sys.stderr)
    t0 = time.perf_counter()
    engine = RetrievalEngine.from_artifacts(
        args.gin_path, args.stage1, args.stage2, device=args.device,
        batch_buckets=(args.users,),
    )
    print(f"engine ready in {time.perf_counter() - t0:.1f}s "
          f"(corpus {engine.n_items} x {engine.sem_id_dim})", file=sys.stderr)

    # The first N test users' histories; the test target (items[-1]) says
    # whether the recommendation hit.
    rows = np.arange(args.users)
    hist, targets, users = test_seq.items[rows], test_seq.fut[rows], test_seq.users[rows]
    out = engine.recommend(hist, user_ids=users, top_k=args.top_k)
    print(f"first request: {out['latency_s']:.1f}s", file=sys.stderr)
    lats = []
    for _ in range(5):
        out = engine.recommend(hist, user_ids=users, top_k=args.top_k)
        lats.append(out["latency_s"])
    lat = float(np.median(lats))
    print(f"steady-state: {lat * 1e3:.0f} ms / {args.users} users "
          f"({args.users / lat:.0f} users/s; "
          f"best {min(lats) * 1e3:.0f} ms over {len(lats)} requests)",
          file=sys.stderr)

    hits = 0
    for u in range(args.users):
        rec = out["items"][u]
        hit = targets[u] in rec
        hits += hit
        print(f"user {int(users[u])}: history {hist[u][hist[u] >= 0][-5:].tolist()} "
              f"-> top-{args.top_k} {rec.tolist()} "
              f"(target {targets[u]}, {'HIT' if hit else 'miss'})")
    print(f"hit@{args.top_k}: {hits}/{args.users}")

    if args.sweep:
        sizes = [int(s) for s in args.sweep.split(",")]
        print("\nbucket sweep (steady-state, median of 5):", file=sys.stderr)
        for b in sizes:
            if b not in engine.batch_buckets:
                engine.batch_buckets = tuple(sorted({*engine.batch_buckets, b}))
            h = test_seq.items[np.arange(b) % len(test_seq)]
            engine.recommend(h, top_k=args.top_k)  # warm-up
            lats = [engine.recommend(h, top_k=args.top_k)["latency_s"] for _ in range(5)]
            lat = float(np.median(lats))
            print(f"  {b:4d} users: {lat * 1e3:7.1f} ms  "
                  f"({b / lat:7.0f} users/s)", file=sys.stderr)


if __name__ == "__main__":
    main()
