"""Retrieval metrics hit@K and NDCG@K per ID digit and per prefix, under
the JAX package's keys (a copy of hidvae_tpu/evaluate/metrics.py), numpy."""

from collections import defaultdict

import numpy as np


def _first_match_rank(match):
    """match: [B, K] bool -> (found [B], rank [B]) of the first True per row."""
    found = match.any(axis=-1)
    rank = match.argmax(axis=-1)
    return found, rank


def _dcg_discounts(k):
    return 1.0 / np.log2(np.arange(2, k + 2))


def _ndcg_at_k(rel, k):
    """rel: [B, K_total] binary relevance -> [B] NDCG@k (ref metrics.py:48-61)."""
    rel_k = rel[:, :k]
    disc = _dcg_discounts(k)
    dcg = (rel_k * disc[None, :]).sum(axis=-1)
    # Ideal: all relevant items moved to the front.
    n_rel = np.minimum(rel.sum(axis=-1), k).astype(np.int64)
    cum_disc = np.concatenate([[0.0], np.cumsum(disc)])
    idcg = cum_disc[n_rel]
    out = np.zeros_like(dcg)
    nz = idcg > 0
    out[nz] = dcg[nz] / idcg[nz]
    return out


class TopKAccumulator:
    """Positional hit@K over generated top-K ID tuples (ref metrics.py:8-33)."""

    def __init__(self, ks=(1, 5, 10)):
        self.ks = list(ks)
        self.reset()

    def reset(self):
        self.total = 0
        self.metrics = defaultdict(float)

    def accumulate(self, actual, top_k) -> None:
        """actual: [B, D]; top_k: [B, K, D] (rank-ordered candidates)."""
        actual = np.asarray(actual)
        top_k = np.asarray(top_k)
        b, d = actual.shape
        pos_match = actual[:, None, :] == top_k  # [B, K, D]
        for i in range(d):
            found, rank = _first_match_rank(pos_match[..., : i + 1].all(axis=-1))
            for k in self.ks:
                self.metrics[f"h@{k}_slice_:{i+1}"] += int((found & (rank < k)).sum())
            found, rank = _first_match_rank(pos_match[..., i])
            for k in self.ks:
                self.metrics[f"h@{k}_pos_{i}"] += int((found & (rank < k)).sum())
        self.total += b

    def reduce(self) -> dict:
        return {k: v / self.total for k, v in self.metrics.items()}


class NDCGAccumulator:
    """NDCG@K over generated top-K ID tuples (ref metrics.py:36-95), vectorized."""

    def __init__(self, ks=(1, 5, 10)):
        self.ks = list(ks)
        self.reset()

    def reset(self):
        self.total = 0
        self.metrics = defaultdict(float)

    def accumulate(self, actual, top_k) -> None:
        actual = np.asarray(actual)
        top_k = np.asarray(top_k)
        b, d = actual.shape
        n_candidates = top_k.shape[1]
        pos_match = actual[:, None, :] == top_k
        for i in range(d):
            slice_rel = pos_match[..., : i + 1].all(axis=-1).astype(np.float64)
            pos_rel = pos_match[..., i].astype(np.float64)
            for k in self.ks:
                if k <= n_candidates:
                    self.metrics[f"ndcg@{k}_slice_:{i+1}"] += _ndcg_at_k(slice_rel, k).sum()
                    self.metrics[f"ndcg@{k}_pos_{i}"] += _ndcg_at_k(pos_rel, k).sum()
        self.total += b

    def reduce(self) -> dict:
        return {k: v / self.total for k, v in self.metrics.items()}
