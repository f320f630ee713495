"""Processed datasets (counterpart of hidvae_tpu/data/processed.py): a
(dataset, split)'s `.npz`, item and sequence views; `load_or_build` builds
from a seed or raw files, as JAX."""

import os
from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np

from hidvae_tpu_torch.data.schemas import SeqBatch, TaggedSeqBatch


class RecDataset(Enum):
    AMAZON = 1
    ML_1M = 2
    ML_32M = 3
    KUAIRAND = 4
    SYNTHETIC = 5


@dataclass
class ProcessedArrays:
    """On-disk layout of a processed dataset (one .npz)."""

    item_features: np.ndarray           # [n_items, F] float32
    item_is_train: np.ndarray           # [n_items] bool (95/5 split)
    seq_users: np.ndarray               # [n_seq] int32
    seq_items: np.ndarray               # [n_seq, max_len] int32, -1 padded
    seq_fut: np.ndarray                 # [n_seq] int32 target item
    seq_is_train: np.ndarray            # [n_seq] bool
    tags_emb: Optional[np.ndarray] = None      # [n_items, L, tag_dim] float32
    tags_indices: Optional[np.ndarray] = None  # [n_items, L] int32 (-1 missing)
    # 0 = train, 1 = eval, 2 = test; derived from seq_is_train when absent.
    seq_split: Optional[np.ndarray] = None     # [n_seq] int8
    user_features: Optional[np.ndarray] = None    # [n_users, F_u] float32
    user_feature_ids: Optional[np.ndarray] = None  # [n_users] int32 raw ids

    SPLIT_CODES = {"train": 0, "eval": 1, "test": 2}

    def __post_init__(self):
        if self.seq_split is None:
            self.seq_split = np.where(self.seq_is_train, 0, 1).astype(np.int8)

    def save(self, path: str):
        """Write the arrays to `path` (np.savez_compressed), the optional
        ones only where present, under the JAX package's keys."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = {
            "item_features": self.item_features,
            "item_is_train": self.item_is_train,
            "seq_users": self.seq_users,
            "seq_items": self.seq_items,
            "seq_fut": self.seq_fut,
            "seq_is_train": self.seq_is_train,
            "seq_split": self.seq_split,
        }
        if self.tags_emb is not None:
            data["tags_emb"] = self.tags_emb
            data["tags_indices"] = self.tags_indices
        if self.user_features is not None:
            data["user_features"] = self.user_features
            data["user_feature_ids"] = self.user_feature_ids
        np.savez_compressed(path, **data)

    @classmethod
    def load(cls, path: str) -> "ProcessedArrays":
        with np.load(path, allow_pickle=False) as z:
            def opt(key):
                return z[key] if key in z else None

            return cls(
                item_features=z["item_features"],
                item_is_train=z["item_is_train"],
                seq_users=z["seq_users"],
                seq_items=z["seq_items"],
                seq_fut=z["seq_fut"],
                seq_is_train=z["seq_is_train"],
                tags_emb=opt("tags_emb"),
                tags_indices=opt("tags_indices"),
                seq_split=opt("seq_split"),
                user_features=opt("user_features"),
                user_feature_ids=opt("user_feature_ids"),
            )


def processed_path(root: str, dataset: RecDataset, split: str = "") -> str:
    name = dataset.name.lower() + (f"_{split}" if split else "")
    return os.path.join(root, "processed", f"{name}.npz")


def load_or_build(root: str, dataset: RecDataset, split: str = "",
                  force_process: bool = False) -> ProcessedArrays:
    """(dataset, split)'s arrays under `root`, read or built (processed.py
    :117-149): SYNTHETIC seeded, AMAZON from raw/<split or "beauty">/, the
    others from raw/."""
    if dataset == RecDataset.SYNTHETIC:
        split = ""
    path = processed_path(root, dataset, split)
    if not force_process and os.path.exists(path):
        return ProcessedArrays.load(path)
    if dataset == RecDataset.SYNTHETIC:
        from hidvae_tpu_torch.data.synthetic import build_synthetic

        arrays = build_synthetic()
    elif dataset == RecDataset.AMAZON:
        from hidvae_tpu_torch.data.amazon import build_amazon

        arrays = build_amazon(root, split or "beauty")
    elif dataset in (RecDataset.ML_1M, RecDataset.ML_32M):
        from hidvae_tpu_torch.data.movielens import build_movielens

        arrays = build_movielens(root, dataset)
    elif dataset == RecDataset.KUAIRAND:
        from hidvae_tpu_torch.data.kuairand import build_kuairand

        arrays = build_kuairand(root)
    else:
        raise ValueError(f"Unknown dataset {dataset}")
    arrays.save(path)
    return arrays


class ItemData:
    """Per-item corpus view with the train / eval / all item filter."""

    def __init__(
        self,
        root: str,
        dataset: RecDataset = RecDataset.SYNTHETIC,
        *,
        train_test_split: str = "all",
        split: str = "",
        force_process: bool = False,
        arrays: Optional[ProcessedArrays] = None,
    ):
        self.dataset = dataset
        arr = arrays if arrays is not None else load_or_build(root, dataset, split, force_process)
        if train_test_split == "train":
            sel = arr.item_is_train
        elif train_test_split == "eval":
            sel = ~arr.item_is_train
        else:
            sel = np.ones(len(arr.item_features), bool)
        self.indices = np.nonzero(sel)[0].astype(np.int32)
        self.item_features = arr.item_features[self.indices]
        self.has_tags = arr.tags_emb is not None
        if self.has_tags:
            self.tags_emb = arr.tags_emb[self.indices]
            self.tags_indices = arr.tags_indices[self.indices].astype(np.int32)
        else:
            self.tags_emb = None
            self.tags_indices = None

    def __len__(self):
        return len(self.item_features)

    @property
    def feature_dim(self):
        return self.item_features.shape[1]

    def batch(self, idx: np.ndarray):
        """A (Tagged)SeqBatch of single items `idx` (numpy arrays): each item
        is a one-item sequence whose target is itself."""
        x = self.item_features[idx]
        ids = idx.astype(np.int32)[:, None]
        common = dict(user_ids=np.zeros(len(idx), np.int32), ids=ids, ids_fut=ids, x=x,
                      x_fut=x, seq_mask=np.ones((len(idx), 1), bool))
        if self.has_tags:
            return TaggedSeqBatch(**common, tags_emb=self.tags_emb[idx],
                                  tags_indices=self.tags_indices[idx])
        return SeqBatch(**common)

    def iter_batches(self, batch_size: int, rng: np.random.RandomState):
        """Endless shuffled batches: a permutation per epoch, full batches only."""
        n = len(self)
        while True:
            order = rng.permutation(n)
            for start in range(0, n - batch_size + 1, batch_size):
                yield self.batch(order[start:start + batch_size])

    def iter_eval_batches(self, batch_size: int):
        """The items in order, in batches of `batch_size` (the last ragged)."""
        n = len(self)
        for start in range(0, n, batch_size):
            yield self.batch(np.arange(start, min(start + batch_size, n)))


class SeqData:
    """User-sequence view of one split: `seq_split` in {"train", "eval",
    "test"}, or `is_train`; `subsample` marks windows the trainer crops."""

    def __init__(
        self,
        root: str,
        dataset: RecDataset = RecDataset.SYNTHETIC,
        *,
        is_train: bool = True,
        subsample: bool = False,
        split: str = "",
        force_process: bool = False,
        arrays: Optional[ProcessedArrays] = None,
        seq_split: Optional[str] = None,
    ):
        self.dataset = dataset
        self.subsample = subsample
        arr = arrays if arrays is not None else load_or_build(root, dataset, split, force_process)
        if seq_split is not None:
            sel = arr.seq_split == ProcessedArrays.SPLIT_CODES[seq_split]
        else:
            sel = (arr.seq_split == 0) if is_train else (arr.seq_split == 1)
        idx = np.nonzero(sel)[0]
        self.users = arr.seq_users[idx]
        self.items = arr.seq_items[idx]
        self.fut = arr.seq_fut[idx]
        self.item_features = arr.item_features
        self.max_seq_len = self.items.shape[1]

    def __len__(self):
        return len(self.users)

    def iter_eval_batches(self, batch_size: int):
        """The split in order, `batch_size` rows a batch (the last ragged):
        int32 (users [b], histories [b, N] -1 padded, targets [b])."""
        n = len(self)
        for start in range(0, n, batch_size):
            sl = slice(start, min(start + batch_size, n))
            yield (self.users[sl].astype(np.int32), self.items[sl].astype(np.int32),
                   self.fut[sl].astype(np.int32))
