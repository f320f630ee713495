"""Write a seeded synthetic corpus for the configs that read
dataset/synthetic_<preset> (PyTorch port; one script for the JAX package's
scripts/make_synthetic_{large,xl,xxl,ml32m}.py, with their arguments):

  large  20,000 items,    5,000 users, tag tree 16 x 8 x 4, histories 5-20
  xl     200,000 items,  50,000 users, tag tree 32 x 8 x 8, histories 5-20
  xxl    1,000,000 items, 100,000 users, tag tree 32 x 8 x 8, histories 5-20
  ml32m  20,000 items,    5,000 users, tag tree 16 x 8 x 4, histories 20-200,
         18 categorical feature columns, personal pools of 64 items

all from seed 42, bit for bit the JAX scripts' files. Numpy only; `xl` and
`xxl` write 2.5 and 12 GB through single-threaded zlib and take long.

Usage: python scripts/torch_make_synthetic.py PRESET [out_root]
(default out_root: dataset/synthetic_<preset>)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hidvae_tpu_torch.data.synthetic import build_synthetic  # noqa: E402

_BEAUTY = dict(max_seq_len=20, min_seq_len=5, seed=42)
PRESETS = {
    "large": dict(n_items=20_000, n_users=5_000, level_branching=(16, 8, 4), **_BEAUTY),
    "xl": dict(n_items=200_000, n_users=50_000, level_branching=(32, 8, 8), **_BEAUTY),
    "xxl": dict(n_items=1_000_000, n_users=100_000, level_branching=(32, 8, 8), **_BEAUTY),
    "ml32m": dict(n_items=20_000, n_users=5_000, level_branching=(16, 8, 4), max_seq_len=200,
                  min_seq_len=20, n_cat_feats=18, pool_size=64, seed=42),
}


def main(preset: str, root: str = None, **overrides) -> str:
    """Build `preset` (its arguments updated by `overrides`) and write
    <root>/processed/synthetic.npz. Returns the path."""
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
    if not 2 <= len(sys.argv) <= 3 or sys.argv[1] not in PRESETS:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(PRESETS)}}} [out_root]")
    main(*sys.argv[1:])
