"""Write a seeded synthetic dataset (PyTorch port; one script for the JAX
package's scripts/make_synthetic_{large,xl,xxl,ml32m,amazon}.py, with their
arguments):

  large  20,000 items,    5,000 users, tag tree 16 x 8 x 4, histories 5-20
  xl     200,000 items,  50,000 users, tag tree 32 x 8 x 8, histories 5-20
  xxl    1,000,000 items, 100,000 users, tag tree 32 x 8 x 8, histories 5-20
  ml32m  20,000 items,    5,000 users, tag tree 16 x 8 x 4, histories 20-200,
         18 categorical feature columns, personal pools of 64 items
  amazon-raw  a raw P5 drop (<root>/raw/sports/: sequential_data.txt,
         datamaps.json, meta.json.gz) at the Sports split's size, 18,357
         items and 35,598 users, for data/amazon.py's build_amazon

all from seed 42, bit for bit the JAX scripts' files (amazon-raw: the same
draws as make_synthetic_amazon.py, whose defaults are 12,000 x 12,000).
Numpy only; `xl` and `xxl` write 2.5 and 12 GB through single-threaded zlib
and take long.

Usage: python scripts/torch_make_synthetic.py PRESET [out_root]
(default out_root: dataset/synthetic_<preset>, dataset/amazon for amazon-raw)
"""

import gzip
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
N_L1, N_L2, N_L3 = 38, 168, 348  # configs/h_rqvae_amazon.gin's tag_class_counts


def write_amazon_raw(root, split, n_items, n_users, seed):
    """The raw P5 drop of make_synthetic_amazon.py:50-139, draw for draw:
    titles of repeated category tokens, None and float brands, missing
    categories and prices, shallow trees, 300 meta rows of unmapped asins,
    shuffled; users walking small personal pools. Returns the raw dir."""
    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "raw", split)
    os.makedirs(raw, exist_ok=True)
    top = "Sports & Outdoors" if split == "sports" else split.capitalize()
    l1_names = [f"Cat{i:02d}" for i in range(N_L1)]
    l2_names = [f"Sub{i:03d}" for i in range(N_L2)]
    l3_names = [f"Leaf{i:03d}" for i in range(N_L3)]
    brands = [f"Brand{i:03d}" for i in range(400)]
    item_l1, item_l2, item_l3 = ZipfTree(N_L1, N_L2, N_L3).assign(rng, n_items)

    meta_rows, item2id = [], {}
    for v in range(n_items):
        asin = f"B{v:09d}"
        item2id[asin] = v + 1
        l1, l2, l3 = l1_names[item_l1[v]], l2_names[item_l2[v]], l3_names[item_l3[v]]
        row = {"asin": asin, "title": f"{l1} {l1} {l1} {l2} {l2} {l3} item{v} model{v % 977}",
               "brand": brands[int(rng.randint(len(brands)))],
               "categories": [[top, l1, l2, l3]], "price": round(float(rng.gamma(2.0, 15.0)), 2)}
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

    items_by_l1 = [np.nonzero(item_l1 == c)[0] for c in range(N_L1)]
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


def main(preset: str, root: str = None, **overrides) -> str:
    """Write `preset` (its arguments updated by `overrides`) under `root`:
    <root>/processed/synthetic.npz, or amazon-raw's <root>/raw/<split>/.
    Returns the file's (the raw directory's) path."""
    if preset == "amazon-raw":
        return write_amazon_raw(root or "dataset/amazon", **{**AMAZON_RAW, **overrides})
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
    if not 2 <= len(sys.argv) <= 3 or sys.argv[1] not in [*PRESETS, "amazon-raw"]:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(PRESETS)},amazon-raw}} [out_root]")
    main(*sys.argv[1:])
