"""Serving path for a trained two-stage retrieval model (counterpart of
hidvae_tpu/serve/engine.py).

The serving state lives on the device: corpus ID table, sorted prefix index,
its permutation (ID tuple -> item) and the per-level trie bitmaps. Requests
are padded to a small set of batch buckets; one step per bucket runs
tokenize (corpus-table gather) -> constrained beam search -> tuple-to-item
resolution, and the host reads the result once.

Not ported yet: `from_artifacts` (it reads Orbax checkpoints and a gin
file), the corpus audit against the stage-1 checkpoint, and multi-GPU
serving.
"""

import time
from typing import Optional, Sequence

import numpy as np
import torch

from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from hidvae_tpu_torch.ops.prefix_search import build_prefix_index_with_perm, lookup_items
from hidvae_tpu_torch.tokenizer.sweep import features_fingerprint
from hidvae_tpu_torch.train.device_data import tokenize_on_device
from hidvae_tpu_torch.utils.runtime import full_fp32, resolve_device


class RetrievalEngine:
    """Batch recommendation serving over a frozen tokenizer + decoder.

    model : the EncoderDecoderRetrievalModel with its weights loaded.
    tokenizer : an HSemanticIdTokenizer over the stage-1 model, on the same
        device as the engine.
    item_features : [n_items, F] numpy array or tensor; the corpus to index.
    max_seq_len : history length the decoder was trained with (longer
        histories keep their trailing `max_seq_len` items).
    batch_buckets : ascending request-batch sizes to pad to; requests larger
        than the top bucket are processed in top-bucket chunks.
    device : `cuda` unless given; raises without a card.
    """

    def __init__(
        self,
        model: EncoderDecoderRetrievalModel,
        tokenizer,
        item_features,
        *,
        max_seq_len: int,
        batch_buckets: Sequence[int] = (8, 32, 128),
        generation_temperature: float = 1.0,
        reuse_cached_ids: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.max_seq_len = int(max_seq_len)
        self.generation_temperature = float(generation_temperature)
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))

        # A tokenizer that already holds the table for this catalog (same
        # content fingerprint, not just the same row count) is reused; the
        # sweep is deterministic for fixed weights and features.
        cached = getattr(tokenizer, "cached_ids", None)
        if (
            reuse_cached_ids
            and cached is not None
            and getattr(tokenizer, "cached_ids_fingerprint", None) is not None
            and tokenizer.cached_ids_fingerprint == features_fingerprint(item_features)
        ):
            self.corpus_ids = cached
        else:
            self.corpus_ids = tokenizer.precompute_corpus_ids(item_features)
        self.corpus_ids = self.corpus_ids.to(self.device)
        self.n_items = int(self.corpus_ids.shape[0])
        self.sem_id_dim = int(self.corpus_ids.shape[1])
        self.sorted_ids, self.perm = build_prefix_index_with_perm(self.corpus_ids)
        self.prefix_caps = tuple(tokenizer.prefix_caps) if tokenizer.prefix_caps else None
        tries_np = tokenizer.prefix_tries(self.model.num_embeddings)
        self.prefix_tries = None
        if tries_np and any(t is not None for t in tries_np.values()):
            self.prefix_tries = {
                lvl: None if t is None else (
                    torch.from_numpy(t[0]).to(self.device),
                    torch.from_numpy(t[1]).to(self.device),
                )
                for lvl, t in tries_np.items()
            }

    # ---- request preparation (host side) ----

    def _pad_histories(self, items: np.ndarray) -> np.ndarray:
        """Clip/pad raw histories to [B, max_seq_len] int32, keeping the most
        recent valid items in order, -1 filled. Vectorized: a stable sort on
        the padding flag packs valid items first, then the trailing window of
        each packed row is gathered."""
        items = np.asarray(items, np.int32)
        if items.ndim != 2:
            raise ValueError(f"histories must be [B, N], got {items.shape}")
        b, n = items.shape
        m = self.max_seq_len
        valid = items >= 0
        order = np.argsort(~valid, axis=1, kind="stable")
        packed = np.take_along_axis(items, order, axis=1)
        counts = valid.sum(axis=1)
        keep = np.minimum(counts, m)
        src = counts[:, None] - keep[:, None] + np.arange(m)[None, :]
        in_window = np.arange(m)[None, :] < keep[:, None]
        gathered = np.take_along_axis(
            packed, np.clip(src, 0, max(n - 1, 0)), axis=1
        ) if n else np.full((b, m), -1, np.int32)
        return np.where(in_window, gathered, np.int32(-1))

    def _bucket(self, b: int) -> int:
        for bucket in self.batch_buckets:
            if b <= bucket:
                return bucket
        return self.batch_buckets[-1]

    # ---- the device step ----

    @torch.inference_mode()
    def _step(self, user_ids, items):
        """tokenize -> beam search -> resolve, on the device."""
        b = items.shape[0]
        d = self.sem_id_dim
        zeros = torch.zeros((b,), dtype=torch.int32, device=self.device)
        batch = tokenize_on_device(self.corpus_ids, user_ids, items, fut=zeros)
        batch = batch.replace(
            sem_ids_fut=torch.zeros((b, d), dtype=torch.int32, device=self.device))
        with full_fp32():
            out = self.model.generate_next_sem_id(
                batch, self.sorted_ids, temperature=self.generation_temperature,
                prefix_caps=self.prefix_caps, prefix_tries=self.prefix_tries,
            )
        item_idx = lookup_items(self.sorted_ids, self.perm, out.sem_ids)  # [B, k]
        return item_idx, out.sem_ids, out.log_probas

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Run the step once for the given (default: all) buckets."""
        for bucket in buckets or self.batch_buckets:
            self.recommend(np.zeros((bucket, self.max_seq_len), np.int32))

    # ---- public API ----

    def recommend(self, histories, user_ids=None, top_k: int = 10):
        """Recommend the next items for a batch of user histories.

        histories: [B, N] int item indices, -1 padded (N arbitrary).
        user_ids: optional [B] ints (hash-bucketed by the model).
        top_k: items to return per user (<= beam width 32).

        Returns a dict with items [B, top_k] int32 (-1 = unresolved),
        sem_ids [B, top_k, D], scores [B, top_k] (descending beam
        log-probabilities) and latency_s (wall seconds of the device steps,
        read-back included)."""
        items = self._pad_histories(histories)
        b = items.shape[0]
        if b == 0:
            return {
                "items": np.zeros((0, top_k), np.int32),
                "sem_ids": np.zeros((0, top_k, self.sem_id_dim), np.int32),
                "scores": np.zeros((0, top_k), np.float32),
                "latency_s": 0.0,
            }
        uids = (np.zeros((b,), np.int32) if user_ids is None
                else np.asarray(user_ids, np.int32))

        out_items, out_sids, out_scores = [], [], []
        t0 = time.perf_counter()
        chunk = self.batch_buckets[-1]
        for start in range(0, b, chunk):
            part = items[start:start + chunk]
            pu = uids[start:start + chunk]
            rows = part.shape[0]
            pad = self._bucket(rows) - rows
            if pad:
                part = np.concatenate([part, np.full((pad, part.shape[1]), -1, np.int32)])
                pu = np.concatenate([pu, np.zeros((pad,), np.int32)])
            idx, sids, scores = self._step(
                torch.from_numpy(pu).to(self.device), torch.from_numpy(part).to(self.device))
            out_items.append(idx[:rows, :top_k].cpu().numpy())
            out_sids.append(sids[:rows, :top_k].cpu().numpy())
            out_scores.append(scores[:rows, :top_k].cpu().numpy())
        latency = time.perf_counter() - t0
        return {
            "items": np.concatenate(out_items),
            "sem_ids": np.concatenate(out_sids),
            "scores": np.concatenate(out_scores),
            "latency_s": latency,
        }
