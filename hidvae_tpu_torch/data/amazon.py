"""Amazon P5 builder (Beauty / Sports / Toys), a copy of
hidvae_tpu/data/amazon.py, reading <root>/raw/<split>/: sequential_data.txt,
datamaps.json and meta.json.gz."""

import gzip
import json
import os
import random
import re
from ast import literal_eval
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

from hidvae_tpu_torch.data.processed import ProcessedArrays
from hidvae_tpu_torch.data.text_embedding import encode_text_feature

MAX_SEQ_LEN = 20

# A fixed English stopword list (amazon.py:44-53).
STOPWORDS = frozenset(
    """a about above after again against all am an and any are as at be because
    been before being below between both but by could did do does doing down
    during each few for from further had has have having he her here hers him
    his how i if in into is it its just me more most my no nor not now of off
    on once only or other our ours out over own same she so some such than that
    the their theirs them then there these they this those through to too under
    until up very was we were what when where which while who whom why will
    with you your yours""".split()
)


def parse_meta(path: str) -> List[dict]:
    """The gzipped metadata, one python literal a line (literal_eval)."""
    with gzip.open(path, "rt") as f:
        return [literal_eval(line.strip()) for line in f]


def read_sequences(raw_dir: str, split: str, max_seq_len: int = MAX_SEQ_LEN):
    """Leave-one-out split with 0-based item ids (amazon.py:66-95): train
    items[:-2] -> items[-2]; eval the last max_seq_len of them -> items[-2];
    test the last max_seq_len before items[-1] -> items[-1]."""
    splits = {sp: defaultdict(list) for sp in ("train", "eval", "test")}
    with open(os.path.join(raw_dir, split, "sequential_data.txt")) as f:
        for line in f:
            parts = list(map(int, line.strip().split()))
            user, items = parts[0], [i - 1 for i in parts[1:]]
            eval_items = items[-(max_seq_len + 2):-2]
            test_items = items[-(max_seq_len + 1):-1]
            for sp, seq, fut in (
                    ("train", items[:-2], items[-2]),
                    ("eval", eval_items + [-1] * (max_seq_len - len(eval_items)), items[-2]),
                    ("test", test_items + [-1] * (max_seq_len - len(test_items)), items[-1])):
                splits[sp]["userId"].append(user)
                splits[sp]["itemId"].append(seq)
                splits[sp]["itemId_fut"].append(fut)
    return splits


def item_sentences(item_data: List[dict]) -> List[str]:
    """"Title: ...; Brand: ...; Categories: ...; Price: ...; " per item; the
    categories are the first list's repr (amazon.py:98-109)."""
    out = []
    for row in item_data:
        cats = row.get("categories") or [["Unknown"]]
        out.append("Title: " + str(row.get("title", "Unknown")) + "; "
                   + "Brand: " + str(row.get("brand", "Unknown")) + "; "
                   + "Categories: " + str(cats[0]) + "; "
                   + "Price: " + str(row.get("price", "Unknown")) + "; ")
    return out


def item_split_95_5(n_items: int, seed: int = 42) -> np.ndarray:
    """torch.rand > 0.05 from a CPU generator seeded `seed`: the JAX
    package's membership on any device (amazon.py:112-122)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.rand(n_items, generator=gen, device="cpu") > 0.05).numpy()


def flatten_categories(categories) -> List[str]:
    """The nested category tree in preorder, duplicates dropped."""
    flat, stack = [], list(categories or [])
    while stack:
        cat = stack.pop(0)
        if isinstance(cat, list):
            stack = list(cat) + stack
        else:
            flat.append(cat)
    return list(dict.fromkeys(flat))


def five_tags_for_item(row: dict, item_id: int, n_tags: int = 5) -> List[str]:
    """n_tags tags (amazon.py:139-177): the categories below the top; too few
    filled from title words and brand (random.Random(42 + item_id)), then
    GenericTagN; too many keep n_tags - 1 and join the rest."""
    cats = flatten_categories(row.get("categories"))
    if cats:
        cats = cats[1:]
    if len(cats) < n_tags:
        title_words = re.findall(r"\b[A-Za-z]{3,}\b", str(row.get("title", "")))
        lower_cats = [c.lower() for c in cats]
        title_words = [w for w in title_words
                       if w.lower() not in STOPWORDS and w.lower() not in lower_cats]
        brand = str(row.get("brand", "Unknown"))
        if len(title_words) + len(cats) < n_tags and brand != "Unknown":
            if brand.lower() not in lower_cats:
                title_words.append(brand)
        rng = random.Random(42 + item_id)
        needed, selected = n_tags - len(cats), []
        while len(selected) < needed:
            if title_words:
                word = rng.choice(title_words)
                title_words.remove(word)
                if word not in selected and word.strip():
                    selected.append(word)
            else:
                selected.append(f"GenericTag{len(selected) + 1}")
        tags = cats + selected
    elif len(cats) > n_tags:
        tags = cats[: n_tags - 1] + [" ".join(cats[n_tags - 1:])]
    else:
        tags = cats
    tags = [t if t.strip() else f"GenericTag{i + 1}" for i, t in enumerate(tags)]
    while len(tags) < n_tags:
        tags.append(f"GenericTag{len(tags) + 1}")
    return tags[:n_tags]


def build_tag_vocabs(tag_matrix: List[List[str]]):
    """(tags_indices [n, L] int32, per-level sorted vocabularies)."""
    n_levels = len(tag_matrix[0])
    vocabs = [sorted({tags[level] for tags in tag_matrix}) for level in range(n_levels)]
    lookups = [{t: i for i, t in enumerate(v)} for v in vocabs]
    indices = np.array([[lookups[lv][tags[lv]] for lv in range(n_levels)]
                        for tags in tag_matrix], np.int32)
    return indices, vocabs


def _sequences_to_arrays(seqs, max_seq_len: int):
    """(users, items [n, max_seq_len] -1 padded, targets, split codes 0/1/2)."""
    users, items, fut, split_code = [], [], [], []
    for sp, code in (("train", 0), ("eval", 1), ("test", 2)):
        for u, seq, f in zip(seqs[sp]["userId"], seqs[sp]["itemId"], seqs[sp]["itemId_fut"]):
            padded = np.full(max_seq_len, -1, np.int32)
            trimmed = [i for i in seq if i >= 0][-max_seq_len:]
            padded[: len(trimmed)] = trimmed
            users.append(u)
            items.append(padded)
            fut.append(f)
            split_code.append(code)
    return (np.array(users, np.int32), np.stack(items), np.array(fut, np.int32),
            np.array(split_code, np.int8))


def build_amazon(root: str, split: str = "beauty", *, with_tags: bool = True,
                 n_tag_levels: int = 5, max_seq_len: int = MAX_SEQ_LEN,
                 cache_dir: Optional[str] = None) -> ProcessedArrays:
    """The processed arrays of an Amazon split, plain or tagged
    (amazon.py:218-286)."""
    raw_dir = os.path.join(root, "raw")
    seq_path = os.path.join(raw_dir, split, "sequential_data.txt")
    if not os.path.exists(seq_path):
        raise FileNotFoundError(
            f"Amazon raw data not found at {seq_path}: place the P5 data drop "
            "(sequential_data.txt, datamaps.json, meta.json.gz) there, or write a seeded one "
            "with scripts/torch_make_synthetic.py amazon-raw; nothing is downloaded.")
    with open(os.path.join(raw_dir, split, "datamaps.json")) as f:
        asin2id = {k: int(v) - 1 for k, v in json.load(f)["item2id"].items()}
    meta = parse_meta(os.path.join(raw_dir, split, "meta.json.gz"))
    items = sorted((m for m in meta if m.get("asin") in asin2id), key=lambda m: asin2id[m["asin"]])
    for m in items:  # the brand fix, before sentences and tags
        m.setdefault("brand", "Unknown")
        if m.get("brand") is None or isinstance(m.get("brand"), float):
            m["brand"] = "Unknown"

    cache = cache_dir or os.path.join(root, "cache")
    item_emb = encode_text_feature(item_sentences(items), cache_dir=cache)
    is_train = item_split_95_5(len(items))
    users, item_mat, fut, seq_split = _sequences_to_arrays(
        read_sequences(raw_dir, split, max_seq_len), max_seq_len)

    tags_emb = tags_indices = None
    if with_tags:
        tag_matrix = [five_tags_for_item(m, asin2id[m["asin"]], n_tag_levels) for m in items]
        tags_indices, vocabs = build_tag_vocabs(tag_matrix)
        flat = [t for tags in tag_matrix for t in tags]
        tags_emb = encode_text_feature(flat, cache_dir=cache).reshape(len(items), n_tag_levels, -1)
        vocab_path = os.path.join(root, "processed", f"tag_index_{split}.json")
        os.makedirs(os.path.dirname(vocab_path), exist_ok=True)
        with open(vocab_path, "w") as f:
            json.dump({"vocabs": vocabs}, f)

    return ProcessedArrays(
        item_features=np.asarray(item_emb, np.float32), item_is_train=is_train,
        seq_users=users, seq_items=item_mat, seq_fut=fut, seq_is_train=seq_split == 0,
        tags_emb=None if tags_emb is None else np.asarray(tags_emb, np.float32),
        tags_indices=tags_indices, seq_split=seq_split)
