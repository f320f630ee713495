"""MovieLens 1M / 32M builders (counterpart of hidvae_tpu/data/
movielens.py): its pandas recipe in numpy and csv, orders and ranks as
pandas gives them."""

import csv
import os
from typing import Optional

import numpy as np

from hidvae_tpu_torch.data.amazon import item_split_95_5
from hidvae_tpu_torch.data.processed import ProcessedArrays, RecDataset
from hidvae_tpu_torch.data.text_embedding import encode_text_feature

ML_MAX_SEQ_LEN = 200


def _keep(ids, ratings_ids, min_count: int = 5):
    """Mask of `ids` rated at least `min_count` times in `ratings_ids`."""
    uniq, counts = np.unique(ratings_ids, return_counts=True)
    return np.isin(ids, uniq[counts >= min_count])


def _read_numbers(path, n_cols, skip_header=False):
    """A whole file of numbers separated by '::' or ',' as [rows, n_cols]
    float64 (every id and timestamp below 2^53 is exact), without a row loop."""
    with open(path, "rb") as f:
        data = f.read()
    if skip_header:
        data = data.split(b"\n", 1)[1] if b"\n" in data else b""
    data = data.replace(b"::", b" ").replace(b",", b" ")
    space = np.isin(np.frombuffer(data, np.uint8), np.frombuffer(b" \t\r\n", np.uint8))
    fields = int(np.count_nonzero(~space[1:] & space[:-1])) + int(space.size and not space[0])
    out = np.fromstring(data.decode("ascii"), dtype=np.float64, sep=" ") if fields else np.zeros(0)
    if out.size != fields or fields % n_cols:
        raise ValueError(f"{path}: not {n_cols} numeric fields a row")
    return out.reshape(-1, n_cols)


def _ratings(path, csv_header):
    """(user, movie, timestamp) int64 columns of a ratings file."""
    if csv_header:
        with open(path, newline="") as f:
            names = next(csv.reader(f))
        cols = _read_numbers(path, len(names), skip_header=True)
        pick = [names.index(c) for c in ("userId", "movieId", "timestamp")]
    else:
        cols, pick = _read_numbers(path, 4), [0, 1, 3]
    return tuple(cols[:, c].astype(np.int64) for c in pick)


def _movies(path):
    """(movieId int64, titles, genres) of movies.dat or movies.csv."""
    if path.endswith(".dat"):
        with open(path, encoding="ISO-8859-1") as f:  # pandas' python engine
            rows = [line.strip().split("::") for line in f if line.strip()]
    else:
        with open(path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f)
            names = next(reader)
            rows = [[r[names.index(c)] for c in ("movieId", "title", "genres")]
                    for r in reader if r]
    return (np.array([int(r[0]) for r in rows], np.int64), [r[1] for r in rows],
            [r[2] for r in rows])


def _one_hot_ranks(values):
    """Each value's column among the sorted distinct values (get_dummies)."""
    col = {v: i for i, v in enumerate(sorted(set(values)))}
    return np.array([col[v] for v in values], np.int64)


def _user_history_windows(user, item, ts, window_size: int, stride: int,
                          train_split: float = 0.8, chunk: int = 1 << 16):
    """(users, histories [n, window_size] -1 padded, targets, is_train) of
    every user's windows (movielens.py:44-81), without a loop over users."""
    threshold = np.quantile(ts, train_split)
    order = np.argsort(ts, kind="quicksort")
    order = order[np.argsort(user[order], kind="stable")]
    user, item, ts = user[order], item[order], ts[order]
    uniq, start, counts = np.unique(user, return_index=True, return_counts=True)
    live = counts >= 2
    uniq, start, n = uniq[live], start[live], counts[live]
    w = np.minimum(window_size + 1, n)  # the window's last item is the target
    step = np.where(n > w, stride, 1)
    n_win = (n - w) // step + 1
    owner = np.repeat(np.arange(len(n)), n_win)
    k = np.arange(len(owner)) - np.repeat(np.cumsum(n_win) - n_win, n_win)
    first, width = start[owner] + k * step[owner], w[owner]
    last = first + width - 1
    cols = np.arange(window_size)
    seqs = np.empty((len(owner), window_size), np.int32)
    for s in range(0, len(owner), chunk):  # bounded memory at ML-1M's stride 1
        valid = cols[None, :] < width[s:s + chunk, None] - 1
        pos = np.where(valid, first[s:s + chunk, None] + cols[None, :], 0)
        seqs[s:s + chunk] = np.where(valid, item[pos], -1)
    return (uniq[owner].astype(np.int64).astype(np.int32), seqs, item[last].astype(np.int32),
            ts[last] <= threshold)


def _build(movies, ratings, *, window_size: int, stride: int, cache_dir: Optional[str],
           users=None) -> ProcessedArrays:
    ids, titles, genres = movies
    r_user, r_movie, r_ts = ratings
    kept = np.nonzero(_keep(ids, r_movie))[0]
    ids = ids[kept]
    titles, genres = [titles[i] for i in kept], [genres[i] for i in kept]
    mapping = {int(m): i for i, m in enumerate(ids)}  # a repeated id: its last row

    tokens = [set(g.split("|")) - {""} for g in genres]
    vocab = sorted(set().union(*tokens))
    one_hot = np.array([[g in t for g in vocab] for t in tokens], np.float32)
    one_hot = one_hot.reshape(len(tokens), len(vocab))
    names = [s.split("(")[0].strip() for s in titles]
    x = np.concatenate([encode_text_feature(names, cache_dir=cache_dir), one_hot],
                       axis=1).astype(np.float32)

    keys = np.fromiter(mapping, np.int64, len(mapping))
    rows = _keep(r_user, r_user) & _keep(r_movie, r_movie) & np.isin(r_movie, keys)
    r_user, r_movie, r_ts = r_user[rows], r_movie[rows], r_ts[rows]
    by_key = np.argsort(keys)
    values = np.fromiter(mapping.values(), np.int64, len(mapping))[by_key]
    item = values[np.searchsorted(keys[by_key], r_movie)]
    seq_users, seqs, futs, is_train = _user_history_windows(r_user, item, r_ts, window_size,
                                                            stride)
    item_is_train = item_split_95_5(len(x))

    user_features = user_feature_ids = None
    if users is not None:  # movielens.py:84-93, on the final ratings
        uid, gender, age, occupation = users
        keep = _keep(uid, r_user)
        gender = [g for g, k in zip(gender, keep) if k]
        first = sorted(set(gender))[0] if gender else None
        user_features = np.stack([
            _one_hot_ranks([a for a, k in zip(age, keep) if k]),
            np.array([g == first for g in gender], np.int64),
            _one_hot_ranks([o for o, k in zip(occupation, keep) if k]),
        ], axis=1).astype(np.float32)
        user_feature_ids = uid[keep].astype(np.int32)

    return ProcessedArrays(item_features=x, item_is_train=item_is_train, seq_users=seq_users,
                           seq_items=seqs, seq_fut=futs, seq_is_train=is_train,
                           user_features=user_features, user_feature_ids=user_feature_ids)


def build_movielens(root: str, dataset: RecDataset, *, max_seq_len: int = ML_MAX_SEQ_LEN,
                    cache_dir: Optional[str] = None) -> ProcessedArrays:
    raw = os.path.join(root, "raw")
    cache = cache_dir or os.path.join(root, "cache")
    if dataset == RecDataset.ML_1M:
        movies_path = os.path.join(raw, "movies.dat")
        if not os.path.exists(movies_path):
            raise FileNotFoundError(f"ML-1M raw data not found at {movies_path}; place "
                                    "movies.dat/users.dat/ratings.dat there (nothing is "
                                    "downloaded).")
        users, users_path = None, os.path.join(raw, "users.dat")
        if os.path.exists(users_path):  # userId::gender::age::occupation::zipCode, as strings
            with open(users_path, encoding="ISO-8859-1") as f:
                rows = [line.strip().split("::") for line in f if line.strip()]
            users = (np.array([int(r[0]) for r in rows], np.int64),
                     *([r[c] for r in rows] for c in (1, 2, 3)))
        return _build(_movies(movies_path), _ratings(os.path.join(raw, "ratings.dat"), False),
                      window_size=max_seq_len, stride=1, cache_dir=cache, users=users)
    if dataset == RecDataset.ML_32M:
        movies_path = os.path.join(raw, "movies.csv")
        if not os.path.exists(movies_path):
            raise FileNotFoundError(f"ML-32M raw data not found at {movies_path}; place "
                                    "movies.csv/ratings.csv there (nothing is downloaded).")
        return _build(_movies(movies_path), _ratings(os.path.join(raw, "ratings.csv"), True),
                      window_size=max_seq_len, stride=180, cache_dir=cache)
    raise ValueError(f"Not a MovieLens dataset: {dataset}")
