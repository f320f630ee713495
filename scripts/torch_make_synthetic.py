"""A seeded synthetic dataset, bit for bit the JAX package's
scripts/make_synthetic_{large,xl,xxl,ml32m,amazon,kuairand}.py (seed 42):
presets large, xl, xxl, ml32m, amazon-raw, kuairand-raw (raw drops).

Usage: python scripts/torch_make_synthetic.py PRESET [out_root]
(default out_root: dataset/synthetic_<preset>, dataset/amazon, dataset/kuairand)"""

import csv
import gzip
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hidvae_tpu_torch.data.kuairand import LEVEL_COLS, LOG_FILES  # noqa: E402
from hidvae_tpu_torch.data.synth_tree import ZipfTree, personal_pool  # noqa: E402
from hidvae_tpu_torch.data.synthetic import build_synthetic  # noqa: E402

_BEAUTY = dict(max_seq_len=20, min_seq_len=5, seed=42)
PRESETS = {
    "large": dict(n_items=20_000, n_users=5_000, level_branching=(16, 8, 4), **_BEAUTY),
    "xl": dict(n_items=200_000, n_users=50_000, level_branching=(32, 8, 8), **_BEAUTY),
    "xxl": dict(n_items=1_000_000, n_users=100_000, level_branching=(32, 8, 8), **_BEAUTY),
    "ml32m": dict(n_items=20_000, n_users=5_000, level_branching=(16, 8, 4), max_seq_len=200,
                  min_seq_len=20, n_cat_feats=18, pool_size=64, seed=42),
}
AMAZON_RAW = dict(split="sports", n_items=18_357, n_users=35_598, seed=42)
KUAIRAND_RAW = dict(n_videos=20_000, n_users=4_000, seed=42)


class SeededTree(ZipfTree):
    """A ZipfTree of `counts` classes (prefix + index); items' classes
    (assign) and text (L1 name x3, L2 x2, L3, two item words)."""

    def __init__(self, rng, n, counts, prefixes, words):
        super().__init__(*counts)
        self.names = [[f"{p}{i:0{w}d}" for i in range(c)]
                      for p, c, w in zip(prefixes, counts, (2, 3, 3))]
        self.labels = self.assign(rng, n)
        self.texts = []
        for v, cls in enumerate(zip(*self.labels)):
            a, b, c = (names[k] for names, k in zip(self.names, cls))
            self.texts.append(f"{a} {a} {a} {b} {b} {c} {words[0]}{v} {words[1]}{v % 977}")

    def level(self, k, v):
        return self.names[k][self.labels[k][v]]

    def by_l1(self):
        return [np.nonzero(self.labels[0] == c)[0] for c in range(self.n_l1)]


def write_csv(path, header, rows):
    """pandas' to_csv(index=False) bytes."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f, lineterminator="\n").writerows([header, *rows])


def write_amazon_raw(root, split, n_items, n_users, seed):
    """make_synthetic_amazon.py:50-139's raw P5 drop, draw for draw (odd
    brands, missing categories and prices, 300 unmapped asins, users on
    small pools). Returns the raw dir."""
    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "raw", split)
    os.makedirs(raw, exist_ok=True)
    top = "Sports & Outdoors" if split == "sports" else split.capitalize()
    brands = [f"Brand{i:03d}" for i in range(400)]
    # configs/h_rqvae_amazon.gin's tag_class_counts
    tree = SeededTree(rng, n_items, (38, 168, 348), ("Cat", "Sub", "Leaf"), ("item", "model"))

    meta_rows, item2id = [], {}
    for v in range(n_items):
        asin = f"B{v:09d}"
        item2id[asin] = v + 1
        l1 = tree.level(0, v)
        row = {"asin": asin, "title": tree.texts[v],
               "brand": brands[int(rng.randint(len(brands)))],
               "categories": [[top, l1, tree.level(1, v), tree.level(2, v)]],
               "price": round(float(rng.gamma(2.0, 15.0)), 2)}
        r = rng.rand()
        if r < 0.02:
            row["brand"] = None
        elif r < 0.03:
            row["brand"] = 0.0
        if 0.03 <= r < 0.05:
            row.pop("categories")
        if 0.05 <= r < 0.07:
            row.pop("price")
        if 0.07 <= r < 0.10:
            row["categories"] = [[top, l1]]
        meta_rows.append(row)
    for v in range(300):
        meta_rows.append({"asin": f"X{v:09d}", "title": f"unsold item {v}", "brand": "NoBrand",
                          "categories": [[top]], "price": 1.0})
    rng.shuffle(meta_rows)
    with gzip.open(os.path.join(raw, "meta.json.gz"), "wt") as f:
        for row in meta_rows:
            f.write(repr(row) + "\n")

    items_by_l1 = tree.by_l1()
    user2id, lines = {}, []
    for u in range(n_users):
        personal = personal_pool(rng, items_by_l1, n_items, min_pool=12, size=14)
        seq = [int(rng.choice(personal)) if rng.rand() < 0.85 else int(rng.randint(n_items))
               for _ in range(int(rng.randint(8, 31)))]
        user2id[f"A{u:08d}"] = u + 1
        lines.append(" ".join(map(str, [u + 1] + [i + 1 for i in seq])))
    with open(os.path.join(raw, "sequential_data.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(raw, "datamaps.json"), "w") as f:
        json.dump({"item2id": {k: str(v) for k, v in item2id.items()},
                   "user2id": {k: str(v) for k, v in user2id.items()}}, f)
    print(f"wrote {raw}: {n_items} items (+300 unmapped meta rows), {n_users} users")
    return raw


def write_kuairand_raw(root, n_videos, n_users, seed):
    """make_synthetic_kuairand.py:38-134's raw KuaiRand-1K drop, draw for
    draw (2 % empty captions, 2 % shallow, 500 unclicked videos, 6 %
    inactive users; the logs split by time_ms's rank(pct=True)). Returns
    the raw dir."""
    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    # configs/h_rqvae_kuairand.gin's tag_class_counts
    tree = SeededTree(rng, n_videos, (37, 168, 353), ("L1_", "L2_", "L3_"), ("vid", "tok"))
    captions, cats = [], []
    for v in range(n_videos):
        r = rng.rand()
        captions.append((v, "" if r < 0.02 else tree.texts[v]))
        cats.append((v, tree.level(0, v), *(("UNKNOWN", "") if 0.02 <= r < 0.04 else
                                           (tree.level(1, v), tree.level(2, v)))))
    n_all = n_videos + 500
    for v in range(n_videos, n_all):
        c3 = int(rng.randint(tree.n_l3))
        c2 = tree.l3_parent[c3]
        cats.append((v, *(names[c] for names, c in zip(tree.names, (tree.l2_parent[c2], c2, c3)))))
        captions.append((v, f"unclicked vid{v}"))
    write_csv(os.path.join(raw, "kuairand_video_captions.csv"), ("final_video_id", "caption"),
              captions)
    write_csv(os.path.join(raw, "kuairand_video_categories.csv"), ("final_video_id", *LEVEL_COLS),
              cats)
    write_csv(os.path.join(raw, "video_features_basic_1k.csv"), ("video_id", "video_duration"),
              zip(range(n_all), rng.randint(5_000, 300_000, n_all).tolist()))

    vids_by_l1, rows = tree.by_l1(), []
    for u in range(n_users):
        personal = personal_pool(rng, vids_by_l1, n_videos, min_pool=20, size=18)
        length = rng.randint(3, 12) if rng.rand() < 0.06 else rng.randint(25, 61)
        t = 1_649_000_000_000 + int(rng.randint(0, 86_400_000))
        for _ in range(length):
            t += int(rng.randint(60_000, 7_200_000))
            v = int(rng.choice(personal)) if rng.rand() < 0.85 else int(rng.randint(n_videos))
            rows.append((u, v, t, 1))
            if rng.rand() < 0.4:
                t += int(rng.randint(1_000, 60_000))
                rows.append((u, int(rng.randint(n_videos)), t, 0))
    _, inv, cnt = np.unique([r[2] for r in rows], return_inverse=True, return_counts=True)
    last = np.cumsum(cnt)
    frac = ((2 * last - cnt + 1) / 2)[inv] / len(rows)
    for name, mask in zip(LOG_FILES, (frac < 0.45, (frac >= 0.45) & (frac < 0.85), frac >= 0.85)):
        write_csv(os.path.join(raw, name), ("user_id", "video_id", "time_ms", "is_click"),
                  [r for r, m in zip(rows, mask.tolist()) if m])
    print(f"wrote {raw}: {n_videos}+500 videos, {n_users} users, {len(rows)} log rows "
          f"({sum(r[3] for r in rows)} clicks)")
    return raw


def main(preset: str, root: str = None, **overrides) -> str:
    """`preset` (with `overrides`) under `root`: processed/synthetic.npz
    or the raw drop's directory, whose path it returns."""
    if preset == "amazon-raw":
        return write_amazon_raw(root or "dataset/amazon", **{**AMAZON_RAW, **overrides})
    if preset == "kuairand-raw":
        return write_kuairand_raw(root or "dataset/kuairand", **{**KUAIRAND_RAW, **overrides})
    root = root or f"dataset/synthetic_{preset}"
    path = os.path.join(root, "processed", "synthetic.npz")
    arrays = build_synthetic(**{**PRESETS[preset], **overrides})
    arrays.save(path)
    feats, seqs = arrays.item_features, arrays.seq_items
    if preset == "ml32m":
        print(f"wrote {path}: {feats.shape[0]} items x {feats.shape[1]} feats, "
              f"{seqs.shape[0]} sequences of len {seqs.shape[1]}")
    else:
        print(f"wrote {path}: {feats.shape[0]} items, {seqs.shape[0]} sequences")
    return path


if __name__ == "__main__":
    if not 2 <= len(sys.argv) <= 3 or sys.argv[1] not in [*PRESETS, "amazon-raw", "kuairand-raw"]:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(PRESETS)},amazon-raw,kuairand-raw}} [out_root]")
    main(*sys.argv[1:])
