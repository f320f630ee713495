"""Plain semantic-ID tokenizer around a frozen RQ-VAE (counterpart of
hidvae_tpu/tokenizer/semids.py), and the table machinery the hierarchical
one shares: the corpus sweep through `rq_assign_auto`, the dedup rank
column, the prefix index, caps and tries, and tokenizing by gather."""

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
from hidvae_tpu_torch.tokenizer.sweep import features_fingerprint, sweep_corpus
from hidvae_tpu_torch.utils.runtime import full_fp32, resolve_device


def _flatten_tokenize(cached_ids, ids, seq_mask):
    """Gather per-item ID tuples and flatten [B, N] item ids -> [B, N*D];
    masked positions become -1. Returns (flat ids, flat mask)."""
    n_items, d = cached_ids.shape
    valid = (ids >= 0) & (ids < n_items)
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    b, n = ids.shape
    flat = cached_ids[safe].reshape(b, n * d)
    if seq_mask is not None:
        mask = torch.repeat_interleave(seq_mask, d, dim=1)
        flat = torch.where(mask, flat, torch.full_like(flat, -1))
    else:
        mask = torch.ones_like(flat, dtype=torch.bool)
    return flat, mask


def _token_type_ids(b, n, d, device=None):
    """[B, N*D] digit index of every flattened position."""
    return torch.arange(d, dtype=torch.int32, device=device).repeat(b, n)


class SemanticIdTokenizer:
    """Tokenizer service over a frozen RqVae (an nn.Module, moved to
    `device`: `cuda` unless given; raises without a card)."""

    def __init__(
        self,
        model,
        *,
        n_layers: int = 3,
        codebook_size: int = 256,
        use_dedup_dim: bool = False,
        corpus_chunk_size: int = 8192,
        device=None,
    ):
        self.device = resolve_device(device)
        check_dim(model.embed_dim, self.device.type)
        self.rq_vae = model.to(self.device).eval()
        self.n_layers = n_layers
        self.codebook_size = codebook_size
        self.use_dedup_dim = use_dedup_dim
        self.corpus_chunk_size = corpus_chunk_size
        self.reset()

    def reset(self):
        self.cached_ids = None
        self.cached_ids_fingerprint = None
        self._prefix_index = None
        self._prefix_caps = None
        self._prefix_tries = None

    @property
    def sem_ids_dim(self):
        return self.n_layers + 1 if self.use_dedup_dim else self.n_layers

    @torch.inference_mode()
    def encode_ids(self, x):
        """Item features [B, F] -> semantic IDs [B, L]: encoder, then the
        residual quantization `rq_assign_auto`, in full fp32."""
        m = self.rq_vae
        with full_fp32():
            ids, _ = rq_assign_auto(m.encode(x.float()), m.stacked_codebooks())
        return ids

    def precompute_corpus_ids(self, item_features, mesh=None) -> torch.Tensor:
        """The [n_items, sem_ids_dim] corpus table on the device (with its
        dedup rank column) and the prefix index; `mesh` splits the sweep
        over its data ranks (semids.py:109-116), every rank gets the table."""
        ids = sweep_corpus(self.encode_ids, item_features,
                           self.corpus_chunk_size, self.device, mesh)
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
