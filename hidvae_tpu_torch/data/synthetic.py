"""Seeded synthetic corpus (counterpart of hidvae_tpu/data/synthetic.py):
one RandomState's draws in JAX's order, its arrays bit for bit."""

from typing import Sequence

import numpy as np

from hidvae_tpu_torch.data.processed import ProcessedArrays


def build_synthetic(
    n_items: int = 2000,
    n_users: int = 500,
    feature_dim: int = 768,
    tag_dim: int = 768,
    n_levels: int = 3,
    level_branching: Sequence[int] = (8, 4, 4),
    max_seq_len: int = 20,
    min_seq_len: int = 5,
    n_cat_feats: int = 0,
    pool_size: int = 12,
    seed: int = 42,
) -> ProcessedArrays:
    rng = np.random.RandomState(seed)

    # Each item's leaf path through the cluster tree; level l has
    # prod(branching[:l + 1]) clusters.
    n_l0 = level_branching[0]
    paths = np.zeros((n_items, n_levels), np.int32)
    paths[:, 0] = rng.randint(0, n_l0, n_items)
    for l in range(1, n_levels):
        width = level_branching[l]
        paths[:, l] = paths[:, l - 1] * width + rng.randint(0, width, n_items)

    centers = []
    for l in range(n_levels):
        n_cl = int(np.prod(level_branching[: l + 1]))
        centers.append(rng.randn(n_cl, feature_dim).astype(np.float32) * (1.0 / (2.0 ** l)))

    feats = np.zeros((n_items, feature_dim), np.float32)
    for l in range(n_levels):
        feats += centers[l][paths[:, l]]
    feats += 0.05 * rng.randn(n_items, feature_dim).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    if n_cat_feats > 0:
        cats = (rng.rand(n_items, n_cat_feats) < 0.2).astype(np.float32)
        feats = np.concatenate([feats, cats], axis=-1)

    tags_indices = paths.copy()
    tags_emb = np.zeros((n_items, n_levels, tag_dim), np.float32)
    for l in range(n_levels):
        tag_centers = rng.randn(centers[l].shape[0], tag_dim).astype(np.float32)
        tag_centers /= np.linalg.norm(tag_centers, axis=-1, keepdims=True)
        tags_emb[:, l] = tag_centers[tags_indices[:, l]]
    tags_emb += 0.02 * rng.randn(*tags_emb.shape).astype(np.float32)

    item_is_train = rng.rand(n_items) >= 0.05

    # One user at a time: each draws a variable number of values from the
    # stream, so the loop cannot be vectorized without changing the arrays.
    seq_users, seq_items, seq_fut, seq_split = [], [], [], []
    items_by_l0 = [np.nonzero(paths[:, 0] == c)[0] for c in range(n_l0)]

    def emit(u, hist, fut, code):
        padded = np.full(max_seq_len, -1, np.int32)
        trimmed = hist[-max_seq_len:]
        padded[: len(trimmed)] = trimmed
        seq_users.append(u)
        seq_items.append(padded)
        seq_fut.append(fut)
        seq_split.append(code)

    for u in range(n_users):
        pref = rng.randint(0, n_l0)
        pool = items_by_l0[pref]
        if len(pool) < min_seq_len + 2:
            pool = np.arange(n_items)
        personal = rng.choice(pool, size=min(len(pool), pool_size), replace=False)
        length = rng.randint(min_seq_len, max_seq_len + 1)
        seq = np.where(
            rng.rand(length + 2) < 0.85,
            rng.choice(personal, length + 2),
            rng.randint(0, n_items, length + 2),
        )
        emit(u, seq[:-2], seq[-2], 0)
        emit(u, seq[:-2], seq[-2], 1)
        emit(u, seq[:-1], seq[-1], 2)

    seq_split = np.array(seq_split, np.int8)
    return ProcessedArrays(
        item_features=feats,
        item_is_train=item_is_train,
        seq_users=np.array(seq_users, np.int32),
        seq_items=np.stack(seq_items),
        seq_fut=np.array(seq_fut, np.int32),
        seq_is_train=seq_split == 0,
        tags_emb=tags_emb,
        tags_indices=tags_indices,
        seq_split=seq_split,
    )
