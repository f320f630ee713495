"""Serving of a trained two-stage model (counterpart of
hidvae_tpu/serve/engine.py): table, prefix index and tries on the device;
requests padded to buckets, one step a bucket tokenizing, searching and
resolving. `from_artifacts`: from a gin and two exports, refusing a table
that contradicts stage 1's repetition. With `mesh` (engine.py:194-231)
sweep and decode split over the data ranks."""

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from hidvae_tpu_torch.data.processed import ItemData, SeqData, load_or_build
from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalModel
from hidvae_tpu_torch.ops.prefix_search import (
    build_prefix_index_with_perm,
    lookup_items,
    tries_on_device,
)
from hidvae_tpu_torch.parallel.mesh import gather_rows, shard_rows, shard_stage2_
from hidvae_tpu_torch.tokenizer.sweep import features_fingerprint
from hidvae_tpu_torch.train.common import (
    audit_rebuilt_corpus,
    reconcile_decoder_geometry,
    restore_export,
)
from hidvae_tpu_torch.train.device_data import tokenize_on_device
from hidvae_tpu_torch.train.transformer import _build_tokenizer
from hidvae_tpu_torch.utils.debug import span
from hidvae_tpu_torch.utils.ginlite import parse_gin_file
from hidvae_tpu_torch.utils.runtime import full_fp32, resolve_device

logger = logging.getLogger("hidvae_tpu_torch.serve.engine")


class RetrievalEngine:
    """Batch serving of a stage-2 `model` (a `RetrievalModel`) over a frozen
    (H)SemanticIdTokenizer and the corpus `item_features`: the history
    length, ascending `batch_buckets`, the stage-1 export whose repetition
    audits the table, `device`, `mesh` / `shard_params` for ranks serving
    together. `build_times`: table_s, audit_s, index_s, load_s."""

    @classmethod
    def from_artifacts(cls, gin_path: str, stage1_export: str, stage2_export: str, *,
                       device=None, **engine_kwargs) -> "RetrievalEngine":
        """A ready engine from a decoder gin and two exported checkpoints,
                the corpus from its dataset_folder (engine.py:51-182); `engine_kwargs` go to the
                engine."""
        t0 = time.perf_counter()
        device = resolve_device(device)
        cfg = parse_gin_file(gin_path)["train"]
        g = cfg.get
        # The plain route ignores interleaving (PARITY.md #12).
        use_interleaved = bool(g("use_interleaved_ids", False) and g("use_h_tokenizer", True))
        # One read: the corpus and the trained history length.
        split = g("dataset_split", "beauty")
        arrays = load_or_build(cfg["dataset_folder"], cfg["dataset"], split)
        items = ItemData(cfg["dataset_folder"], cfg["dataset"], train_test_split="all",
                         split=split, arrays=arrays)
        max_seq_len = SeqData(cfg["dataset_folder"], cfg["dataset"], split=split,
                              arrays=arrays).max_seq_len

        tokenizer = _build_tokenizer(
            use_h_tokenizer=g("use_h_tokenizer", True),
            pretrained_rqvae_path=stage1_export,
            vae_input_dim=cfg["vae_input_dim"],
            vae_embed_dim=cfg["vae_embed_dim"],
            vae_hidden_dims=tuple(cfg["vae_hidden_dims"]),
            vae_codebook_size=cfg["vae_codebook_size"],
            vae_n_layers=g("vae_n_layers", 3),
            vae_n_cat_feats=g("vae_n_cat_feats", 18),
            vae_codebook_normalize=g("vae_codebook_normalize", False),
            vae_sim_vq=g("vae_sim_vq", False),
            tag_class_counts=g("tag_class_counts"),
            tag_embed_dim=g("tag_embed_dim", 768),
            use_dedup_dim=g("use_dedup_dim", False),
            use_concatenated_ids=g("use_concatenated_ids", False),
            use_interleaved_ids=use_interleaved,
            commitment_weight=g("commitment_weight", 0.25),
            device=device,
        )
        d = tokenizer.sem_ids_dim
        # The checkpoint's structural config over a stale gin's geometry.
        dec = reconcile_decoder_geometry(
            stage2_export, d, decoder_embed_dim=g("decoder_embed_dim", 128),
            attn_embed_dim=g("attn_embed_dim", 512), attn_heads=g("attn_heads", 8),
            attn_layers=g("attn_layers", 8), logger=logger)
        # Geometry from the reconciled tokenizer: the gin values may be stale.
        model = EncoderDecoderRetrievalModel(
            dec["decoder_embed_dim"], dec["attn_embed_dim"], dec["attn_heads"],
            dec["attn_layers"], tokenizer.codebook_size, d, max_pos=max_seq_len * d,
            n_sem_layers=tokenizer.n_layers, use_interleaved_ids=use_interleaved,
            dropout=g("attn_dropout", None) or g("dropout_p", 0.3),
        )
        restore_export(stage2_export, model)
        load_s = time.perf_counter() - t0
        engine_kwargs.setdefault("generation_temperature", g("generation_temperature", 1.0))
        engine_kwargs.setdefault("stage1_checkpoint", stage1_export)
        engine = cls(model, tokenizer, items.item_features, max_seq_len=max_seq_len,
                     device=device, **engine_kwargs)
        engine.build_times["load_s"] = load_s
        return engine

    def __init__(self, model: RetrievalModel, tokenizer, item_features, *, max_seq_len: int,
                 batch_buckets: Sequence[int] = (8, 32, 128), generation_temperature: float = 1.0,
                 stage1_checkpoint=None, reuse_cached_ids: bool = True, device=None, mesh=None,
                 shard_params: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.max_seq_len = int(max_seq_len)
        self.generation_temperature = float(generation_temperature)
        self.mesh = mesh
        if mesh is not None:
            # Every bucket splits evenly over the data ranks (engine.py:224).
            batch_buckets = [b + (-b) % mesh.n_data for b in batch_buckets]
            if shard_params:
                shard_stage2_(self.model, mesh)
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))

        # A tokenizer holding this catalog's table (same fingerprint) is
        # reused: the sweep is deterministic.
        t0 = time.perf_counter()
        cached = getattr(tokenizer, "cached_ids", None)
        if (
            reuse_cached_ids
            and cached is not None
            and getattr(tokenizer, "cached_ids_fingerprint", None) is not None
            and tokenizer.cached_ids_fingerprint == features_fingerprint(item_features)
        ):
            self.corpus_ids = cached
        else:
            self.corpus_ids = tokenizer.precompute_corpus_ids(item_features, mesh=mesh)
        self.corpus_ids = self.corpus_ids.to(self.device)
        self.n_items = int(self.corpus_ids.shape[0])
        self.sem_id_dim = int(self.corpus_ids.shape[1])
        table = self.corpus_ids.cpu().numpy()
        t1 = time.perf_counter()
        # Refuse a table that contradicts the stage-1 export's repetition
        # (a bad rebuild serves near-constant answers silently).
        audit_rebuilt_corpus(tokenizer, table, stage1_checkpoint, log=logger)
        t2 = time.perf_counter()
        self.sorted_ids, self.perm = build_prefix_index_with_perm(self.corpus_ids)
        self.prefix_caps = tuple(tokenizer.prefix_caps) if tokenizer.prefix_caps else None
        self.prefix_tries = tries_on_device(tokenizer.prefix_tries(self.model.num_embeddings),
                                            self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.build_times = {"table_s": t1 - t0, "audit_s": t2 - t1,
                            "index_s": time.perf_counter() - t2}

    # ---- request preparation (host side) ----

    def _pad_histories(self, items: np.ndarray) -> np.ndarray:
        """Clip / pad histories to [B, max_seq_len] int32, keeping the
                most recent valid items in order, -1 filled."""
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
        """tokenize -> beam search -> resolve, on the device; over a mesh,
        this data rank's rows of the bucket, then the rows of all."""
        if self.mesh is not None:
            rows = shard_rows(items.shape[0], self.mesh)
            return tuple(gather_rows(t, items.shape[0], self.mesh)
                         for t in self._rows_step(user_ids[rows], items[rows]))
        return self._rows_step(user_ids, items)

    def _rows_step(self, user_ids, items):
        b = items.shape[0]
        d = self.sem_id_dim
        with span("engine.tokenize"):
            zeros = torch.zeros((b,), dtype=torch.int32, device=self.device)
            batch = tokenize_on_device(self.corpus_ids, user_ids, items, fut=zeros)
            batch = batch.replace(
                sem_ids_fut=torch.zeros((b, d), dtype=torch.int32, device=self.device))
        with full_fp32():
            out = self.model.generate_next_sem_id(
                batch, self.sorted_ids, temperature=self.generation_temperature,
                prefix_caps=self.prefix_caps, prefix_tries=self.prefix_tries,
            )
        with span("engine.resolve"):
            item_idx = lookup_items(self.sorted_ids, self.perm, out.sem_ids)  # [B, k]
        return item_idx, out.sem_ids, out.log_probas

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Run the step once for the given (default: all) buckets."""
        for bucket in buckets or self.batch_buckets:
            self.recommend(np.zeros((bucket, self.max_seq_len), np.int32))

    # ---- public API ----

    def recommend(self, histories, user_ids=None, top_k: int = 10):
        """Next items for `histories` [B, N] (-1 padded) and optional
        `user_ids`: {items [B, top_k] (-1 unresolved), sem_ids, scores (descending
        beam log-probabilities), latency_s}; a root span."""
        with span("engine.recommend", device=self.device):
            return self._recommend(histories, user_ids, top_k)

    def _recommend(self, histories, user_ids, top_k):
        with span("engine.pad"):
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
            with span("engine.upload"):
                pu = torch.from_numpy(pu).to(self.device)
                part = torch.from_numpy(part).to(self.device)
            idx, sids, scores = self._step(pu, part)
            with span("engine.copy_back"):
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
