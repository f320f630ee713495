"""Hierarchical semantic-ID tokenizer around a frozen HiD-VAE (counterpart
of hidvae_tpu/tokenizer/h_semids.py).

Three ID layouts:
  * semantic-only               [s1..sL]
  * concatenated (+pred tags)   [s1..sL, t1..tT]
  * interleaved                 [s1, t1, s2, t2, ...]
plus the dedup rank column of the semantic-only layout. The corpus sweep runs
the encoder and then the fused residual quantization `rq_assign_auto`: the
CUDA kernel on the card, the plain version on the CPU. The cache-miss path
(`tokenize_features`) is not ported: tokenizing needs the precomputed table.
"""

from typing import Optional, Sequence

import numpy as np
import torch

from hidvae_tpu_torch.data.schemas import SeqBatch, TokenizedSeqBatch
from hidvae_tpu_torch.ops.prefix_search import (
    build_prefix_index,
    build_prefix_tries,
    duplicate_ranks,
    exists_prefix,
)
from hidvae_tpu_torch.ops.rq_assign import check_dim, rq_assign_auto
from hidvae_tpu_torch.tokenizer.semids import _flatten_tokenize, _token_type_ids
from hidvae_tpu_torch.tokenizer.sweep import features_fingerprint, sweep_corpus
from hidvae_tpu_torch.utils.runtime import full_fp32, resolve_device


def interleave_ids(sem_ids, tag_ids):
    """[.., n_sem] and [.., n_tag] -> [s1, t1, s2, t2, ...]."""
    n_sem, n_tag = sem_ids.shape[-1], tag_ids.shape[-1]
    cols = []
    for i in range(max(n_sem, n_tag)):
        if i < n_sem:
            cols.append(sem_ids[..., i:i + 1])
        if i < n_tag:
            cols.append(tag_ids[..., i:i + 1])
    return torch.cat(cols, dim=-1)


class HSemanticIdTokenizer:
    """Tokenizer service over a frozen HRqVae (an nn.Module on `device`)."""

    def __init__(
        self,
        model,
        *,
        n_layers: int = 3,
        codebook_size: int = 256,
        tag_class_counts: Optional[Sequence[int]] = None,
        use_dedup_dim: bool = False,
        use_concatenated_ids: bool = False,
        use_interleaved_ids: bool = False,
        corpus_chunk_size: int = 8192,
        device=None,
    ):
        if use_dedup_dim and use_concatenated_ids:
            raise ValueError("use_dedup_dim and use_concatenated_ids are mutually exclusive")
        if use_dedup_dim and use_interleaved_ids:
            raise ValueError("use_dedup_dim and use_interleaved_ids are mutually exclusive")
        if use_concatenated_ids and use_interleaved_ids:
            raise ValueError("use_concatenated_ids and use_interleaved_ids are mutually exclusive")
        self.device = resolve_device(device)
        check_dim(model.embed_dim, self.device.type)
        self.hrq_vae = model.to(self.device).eval()
        self.n_layers = n_layers
        self.codebook_size = codebook_size
        self.tag_class_counts = list(tag_class_counts) if tag_class_counts else None
        self.use_dedup_dim = use_dedup_dim
        self.use_concatenated_ids = use_concatenated_ids
        self.use_interleaved_ids = use_interleaved_ids
        self.corpus_chunk_size = corpus_chunk_size
        self.reset()

    def reset(self):
        self.cached_ids = None
        self.cached_ids_fingerprint = None
        self._prefix_index = None
        self._prefix_caps = None
        self._prefix_tries = None

    @property
    def needs_tags(self):
        return self.use_concatenated_ids or self.use_interleaved_ids

    @property
    def sem_ids_dim(self):
        """Total ID tuple width."""
        if self.use_dedup_dim:
            return self.n_layers + 1
        if self.needs_tags and self.tag_class_counts:
            return self.n_layers + len(self.tag_class_counts)
        return self.n_layers

    @torch.inference_mode()
    def encode_ids(self, x):
        """Item features [B, F] -> combined ID tuples [B, D]: encoder,
        residual quantization (`rq_assign_auto`), then tags from the IDs."""
        m = self.hrq_vae
        with full_fp32():
            encoded = m.encode(x.float())
            sem_ids, _ = rq_assign_auto(encoded, m.stacked_codebooks())
            if not self.needs_tags:
                return sem_ids
            tag_ids = m.predict_tags_from_ids(sem_ids)["predictions"]
        if self.use_concatenated_ids:
            return torch.cat([sem_ids, tag_ids], dim=-1)
        return interleave_ids(sem_ids, tag_ids)

    def precompute_corpus_ids(self, item_features) -> torch.Tensor:
        """Build the [n_items, sem_ids_dim] corpus table on the device."""
        ids = sweep_corpus(self.encode_ids, item_features,
                           self.corpus_chunk_size, self.device)
        if self.use_dedup_dim:
            ids = torch.cat([ids, duplicate_ranks(ids)[:, None]], dim=-1)
        self.reset()
        self.cached_ids = ids
        self.cached_ids_fingerprint = features_fingerprint(item_features)
        self._prefix_index = build_prefix_index(ids)
        return self.cached_ids

    def exists_prefix(self, sem_id_prefix) -> torch.Tensor:
        if self._prefix_index is None:
            raise RuntimeError("No match found in empty cache.")
        return exists_prefix(self._prefix_index,
                             torch.as_tensor(sem_id_prefix, device=self.device))

    @property
    def prefix_index(self):
        return self._prefix_index

    @property
    def prefix_caps(self):
        """caps[l-1] = the most corpus rows sharing one l-prefix."""
        if self._prefix_caps is None and self.cached_ids is not None:
            ids = self.cached_ids.cpu().numpy()
            caps = []
            for length in range(1, ids.shape[1]):
                _, counts = np.unique(ids[:, :length], axis=0, return_counts=True)
                caps.append(int(counts.max()))
            self._prefix_caps = caps
        return self._prefix_caps

    def prefix_tries(self, n_digits=None):
        """Per-level trie bitmaps (host numpy), cached per bitmap width.
        n_digits: pass the decoder's vocab; tag digits outside [0, n_digits)
        are dropped as unreachable."""
        n_digits = int(n_digits or self.codebook_size)
        if self._prefix_index is None:
            return None
        if self._prefix_tries is None:
            self._prefix_tries = {}
        if n_digits not in self._prefix_tries:
            self._prefix_tries[n_digits] = build_prefix_tries(
                self._prefix_index.cpu().numpy(), n_digits
            )
        return self._prefix_tries[n_digits]

    def __call__(self, batch: SeqBatch) -> TokenizedSeqBatch:
        """Tokenize a SeqBatch by gathering from the precomputed table."""
        if self.cached_ids is None:
            raise RuntimeError("precompute_corpus_ids must run before tokenizing")
        d = self.cached_ids.shape[1]
        b, n = batch.ids.shape
        dev = self.cached_ids.device
        sem_ids, seq_mask = _flatten_tokenize(self.cached_ids, batch.ids, batch.seq_mask)
        sem_ids_fut, _ = _flatten_tokenize(self.cached_ids, batch.ids_fut, None)
        return TokenizedSeqBatch(
            user_ids=batch.user_ids,
            sem_ids=sem_ids,
            sem_ids_fut=sem_ids_fut,
            seq_mask=seq_mask,
            token_type_ids=_token_type_ids(b, n, d, dev),
            token_type_ids_fut=_token_type_ids(b, batch.ids_fut.shape[1], d, dev),
        )
