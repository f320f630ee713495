"""KuaiRand-1K builder (counterpart of hidvae_tpu/data/kuairand.py): its
pandas recipe step for step in numpy and the csv module, over
<root>/raw/'s click logs, captions and categories. Fields are typed as
pd.read_csv types them (`Column`): NA strings missing, int64 (float64 with
a blank), float64, bool or strings."""

import csv
import json
import os
import re
from typing import Optional

import numpy as np

from hidvae_tpu_torch.data.amazon import item_split_95_5
from hidvae_tpu_torch.data.processed import ProcessedArrays
from hidvae_tpu_torch.data.text_embedding import BGE_ZH_MODEL, encode_text_feature

KUAIRAND_MAX_SEQ_LEN = 40
LOG_FILES = (
    "log_standard_4_08_to_4_21_1k.csv",
    "log_standard_4_22_to_5_08_1k.csv",
    "log_random_4_22_to_5_08_1k.csv",
)
LEVEL_COLS = (
    "first_level_category_name",
    "second_level_category_name",
    "third_level_category_name",
)
# pandas._libs.parsers.STR_NA_VALUES, matched against the whole field.
NA_VALUES = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"))
_SP = r"[ \t\n\r\v\f]*"
_INT = re.compile(rf"{_SP}[+-]?[0-9]+{_SP}")
_FLOAT = re.compile(rf"{_SP}[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
                    rf"|(?i:inf|infinity)){_SP}")
_BOOL = {"true": True, "false": False}


class Column:
    """A CSV column as pandas types it: `kind` ("int", "float", "bool",
    "str") and `values` (int64, float64 with NaN, or objects with None)."""

    def __init__(self, fields):
        got = [f for f in fields if f not in NA_VALUES]
        missing = len(got) < len(fields)
        if all(_INT.fullmatch(f) for f in got):
            self.kind = "float" if missing else "int"
        elif all(_FLOAT.fullmatch(f) for f in got):
            self.kind = "float"
        elif all(f.lower() in _BOOL for f in got):
            self.kind = "bool"
        else:
            self.kind = "str"
        if self.kind == "int":
            try:
                self.values = np.array([int(f) for f in fields], np.int64)
            except OverflowError:  # beyond int64: pandas keeps Python ints
                self.values = np.array([int(f) for f in fields], object)
        elif self.kind == "float":
            self.values = np.array([np.nan if f in NA_VALUES else float(f) for f in fields])
        else:
            self.values = np.array([None if f in NA_VALUES else
                                    _BOOL[f.lower()] if self.kind == "bool" else f
                                    for f in fields], object)

    @classmethod
    def of(cls, kind, values):
        out = cls.__new__(cls)
        out.kind, out.values = kind, values
        return out

    def take(self, rows, as_float=False):
        """The column at `rows` (None: a left join's unmatched row, missing;
        `as_float`: an int column made float, as the join does)."""
        vals = [None if r is None else self.values[r] for r in rows]
        if self.kind == "float" or as_float and self.kind == "int":
            return Column.of("float", np.array([np.nan if v is None else float(v) for v in vals]))
        return Column.of(self.kind, np.array(vals, self.values.dtype))

    def missing(self):
        if self.kind == "float":
            return np.isnan(self.values)
        return np.array([v is None for v in self.values.tolist()], bool)

    def texts(self):
        """fillna("").astype(str)."""
        return ["" if m else repr(float(v)) if self.kind == "float" else str(v)
                for v, m in zip(self.values.tolist(), self.missing().tolist())]


def read_csv(path: str, usecols) -> dict:
    """{name: Column} of the `usecols` columns, picked by header name."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        lost = [c for c in usecols if c not in header]
        if lost:
            raise ValueError(f"Usecols do not match columns, columns expected but not found: "
                             f"{lost}")
        rows = [r for r in reader if r]  # blank lines are skipped
    pick = [header.index(c) for c in usecols]
    return {c: Column([r[i] if i < len(r) else "" for r in rows]) for c, i in zip(usecols, pick)}


def _concat(columns):
    """pd.concat of one column of several files."""
    kinds = {c.kind for c in columns}
    kind = kinds.pop() if len(kinds) == 1 else "float" if kinds <= {"int", "float"} else "str"
    return Column.of(kind, np.concatenate([c.values.astype(float) if kind == "float" else
                                           c.values for c in columns]))


def _isin(values, keys) -> np.ndarray:
    keys = set(keys)
    return np.fromiter((v in keys for v in values.tolist()), bool, len(values))


def build_kuairand(
    root: str,
    *,
    min_user_interactions: int = 20,
    max_users: Optional[int] = None,
    max_videos: Optional[int] = None,
    max_seq_len: int = KUAIRAND_MAX_SEQ_LEN,
    random_seed: int = 42,
    cache_dir: Optional[str] = None,
) -> ProcessedArrays:
    raw = os.path.join(root, "raw")
    first_log = os.path.join(raw, LOG_FILES[0])
    if not os.path.exists(first_log):
        raise FileNotFoundError(
            f"KuaiRand raw data not found at {first_log}; place the KuaiRand-1K "
            "CSV drop there (no network egress in this environment).")
    rng = np.random.RandomState(random_seed)
    cache = cache_dir or os.path.join(root, "cache")

    # Click logs of active users (kuairand.py:65-82).
    parts = [read_csv(os.path.join(raw, f), ("user_id", "video_id", "time_ms", "is_click"))
             for f in LOG_FILES if os.path.exists(os.path.join(raw, f))]
    logs = {c: _concat([p[c] for p in parts]) for c in parts[0]}
    clicked = np.asarray(logs["is_click"].values == 1, bool)
    user, video, time_ms = (logs[c].values[clicked] for c in ("user_id", "video_id", "time_ms"))
    counts = {}  # value_counts: by count descending, ties in first-appearance order
    for u in user.tolist():
        if u is not None and u == u:
            counts[u] = counts.get(u, 0) + 1
    active = [u for u in sorted(counts, key=counts.get, reverse=True)
              if counts[u] >= min_user_interactions]
    if max_users and len(active) > max_users:
        active = rng.choice(np.array(active), max_users, replace=False).tolist()
    keep = _isin(user, active)
    user, video, time_ms = user[keep], video[keep], time_ms[keep]
    pool = set(video.tolist())

    # Captions left-joined with categories, a row per match (:85-102).
    cap = read_csv(os.path.join(raw, "kuairand_video_captions.csv"),
                   ("final_video_id", "caption"))
    cat = read_csv(os.path.join(raw, "kuairand_video_categories.csv"),
                   ("final_video_id", *LEVEL_COLS))
    by_id = {}
    for j, v in enumerate(cat["final_video_id"].values.tolist()):
        by_id.setdefault(v, []).append(j)
    left, right = [], []
    for i, v in enumerate(cap["final_video_id"].values.tolist()):
        for j in by_id.get(v, [None]):
            left.append(i)
            right.append(j)
    unmatched = None in right
    ids = cap["final_video_id"].take(left)
    caption = cap["caption"].take(left)
    levels = [cat[c].take(right, as_float=unmatched) for c in LEVEL_COLS]
    rows = np.nonzero(_isin(ids.values, pool))[0]
    if caption.kind != "str" and not caption.missing()[rows].any():
        raise AttributeError("Can only use .str accessor with string values!")
    cap_text = caption.texts()
    texts = [col.texts() for col in levels]
    rows = [r for r in rows.tolist() if cap_text[r].strip() != ""]
    rows = [r for r in rows if sum(t[r] not in ("", "UNKNOWN") for t in texts) >= 2]

    # max_videos by level-1 name, sorted (groupby.sample; :105-111).
    if max_videos and len(rows) > max_videos:
        groups = {}
        for r in rows:
            groups.setdefault(texts[0][r], []).append(r)
        rows = []
        for name in sorted(groups):
            g = groups[name]
            k = min(len(g), max(1, int(max_videos * len(g) / sum(map(len, groups.values())))))
            rows += [g[p] for p in np.random.RandomState(random_seed).choice(len(g), k,
                                                                            replace=False)]
    vid_map, kept, id_list = {}, [], ids.values.tolist()
    for r in rows:  # drop_duplicates("video_id"): the first row of each id
        v = id_list[r]
        if v not in vid_map:
            vid_map[v] = len(kept)
            kept.append(r)

    # Histories in (uid, time) order, uid by first appearance (kuairand.py:115-141).
    keep = _isin(video, vid_map)
    user, time_ms = user[keep], time_ms[keep]
    item = np.array([vid_map[v] for v in video[keep].tolist()], np.int64)
    user_map = {}
    uid = np.array([user_map.setdefault(u, len(user_map)) for u in user.tolist()], np.int64)
    if time_ms.dtype == object:
        order = np.array(sorted(range(len(uid)), key=lambda i: (uid[i], time_ms[i])), np.int64)
    else:
        order = np.lexsort((time_ms, uid))
    uid, item = uid[order], item[order]
    users, seqs, futs, split_rows = [], [], [], []
    bounds = np.flatnonzero(np.diff(uid)) + 1
    for u, items in zip(uid[np.r_[0, bounds]].tolist() if len(uid) else [],
                        np.split(item, bounds)):
        items = items.tolist()
        if len(items) < 3:
            continue
        for hist, fut, code in ((items[:-2], items[-2], 0), (items[:-2], items[-2], 1),
                                (items[:-1], items[-1], 2)):
            padded = np.full(max_seq_len, -1, np.int32)
            trimmed = hist[-max_seq_len:]
            padded[: len(trimmed)] = trimmed
            users.append(u)
            seqs.append(padded)
            futs.append(fut)
            split_rows.append(code)

    # Caption features, 3-level tags and tag-name embeddings (kuairand.py:144-165).
    item_emb = encode_text_feature([cap_text[r] for r in kept], model_name=BGE_ZH_MODEL,
                                   cache_dir=cache)
    tag_texts = [[t[r] for r in kept] for t in texts]
    vocabs, indices_cols = [], []
    for col_texts in tag_texts:
        vocab = sorted({t for t in col_texts if t and t != "UNKNOWN"})
        lookup = {t: i for i, t in enumerate(vocab)}
        indices_cols.append(np.array([lookup.get(t, -1) for t in col_texts], np.int32))
        vocabs.append(vocab)
    flat_tags = [t if t else "UNKNOWN" for col in tag_texts for t in col]
    flat_emb = encode_text_feature(flat_tags, model_name=BGE_ZH_MODEL, cache_dir=cache)
    tags_emb = flat_emb.reshape(len(LEVEL_COLS), len(kept), -1).transpose(1, 0, 2)

    vocab_path = os.path.join(root, "processed", "kuairand_tag_index.json")
    os.makedirs(os.path.dirname(vocab_path), exist_ok=True)
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump({"vocabs": vocabs}, f, ensure_ascii=False)

    return ProcessedArrays(
        item_features=np.asarray(item_emb, np.float32),
        item_is_train=item_split_95_5(len(kept), random_seed),
        seq_users=np.array(users, np.int32),
        seq_items=np.stack(seqs),
        seq_fut=np.array(futs, np.int32),
        seq_is_train=np.array(split_rows, np.int8) == 0,
        tags_emb=np.asarray(tags_emb, np.float32),
        tags_indices=np.stack(indices_cols, axis=1),
        seq_split=np.array(split_rows, np.int8),
    )
