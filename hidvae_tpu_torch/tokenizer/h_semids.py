"""Hierarchical semantic-ID tokenizer around a frozen HiD-VAE
(counterpart of hidvae_tpu/tokenizer/h_semids.py): semantic-only,
concatenated [s1..sL, t1..tT] or interleaved layouts; `tokenize_features`
encodes raw features [B, N, F] in one `rq_assign_auto` over B * N rows."""

from typing import Optional, Sequence

import torch

from hidvae_tpu_torch.data.schemas import SeqBatch, TokenizedSeqBatch
from hidvae_tpu_torch.ops.rq_assign import rq_assign_auto
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer, _token_type_ids
from hidvae_tpu_torch.utils.runtime import full_fp32


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


class HSemanticIdTokenizer(SemanticIdTokenizer):
    """Tokenizer service over a frozen HRqVae (an nn.Module on `device`)."""

    def __init__(self, model, *, n_layers: int = 3, codebook_size: int = 256,
                 tag_class_counts: Optional[Sequence[int]] = None, use_dedup_dim: bool = False,
                 use_concatenated_ids: bool = False, use_interleaved_ids: bool = False,
                 corpus_chunk_size: int = 8192, device=None):
        if use_dedup_dim and use_concatenated_ids:
            raise ValueError("use_dedup_dim and use_concatenated_ids are mutually exclusive")
        if use_dedup_dim and use_interleaved_ids:
            raise ValueError("use_dedup_dim and use_interleaved_ids are mutually exclusive")
        if use_concatenated_ids and use_interleaved_ids:
            raise ValueError("use_concatenated_ids and use_interleaved_ids are mutually exclusive")
        super().__init__(model, n_layers=n_layers, codebook_size=codebook_size,
                         use_dedup_dim=use_dedup_dim, corpus_chunk_size=corpus_chunk_size,
                         device=device)
        self.hrq_vae = self.rq_vae
        self.tag_class_counts = list(tag_class_counts) if tag_class_counts else None
        self.use_concatenated_ids = use_concatenated_ids
        self.use_interleaved_ids = use_interleaved_ids

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

    @torch.inference_mode()
    def predict_tags(self, x):
        """The model's per-level tag predictions of item features [B, F] or
        [B, N, F] (h_semids.py:195): {"predictions", "confidences", "logits"}."""
        with full_fp32():
            return self.hrq_vae.predict_tags(torch.as_tensor(x, device=self.device))

    def tokenize_features(self, x, x_fut=None, seq_mask=None, user_ids=None) -> TokenizedSeqBatch:
        """Features x [B, N, F] tokenized without a table (h_semids.py:198-227):
        [B, N * D], -1 where `seq_mask` is False; x_fut [B, F] or [B, Nf, F]
        gives sem_ids_fut [B, Nf * D]."""
        x = torch.as_tensor(x, device=self.device)
        b, n, f = x.shape
        combined = self.encode_ids(x.reshape(-1, f))
        d = combined.shape[-1]
        flat = combined.reshape(b, n * d)
        if seq_mask is not None:
            mask = torch.repeat_interleave(torch.as_tensor(seq_mask, device=self.device), d, dim=1)
            flat = torch.where(mask, flat, torch.full_like(flat, -1))
        else:
            mask = torch.ones_like(flat, dtype=torch.bool)
        sem_ids_fut = None
        if x_fut is not None:
            x_fut = torch.as_tensor(x_fut, device=self.device)
            nf = x_fut.shape[1] if x_fut.dim() == 3 else 1
            sem_ids_fut = self.encode_ids(x_fut.reshape(-1, f)).reshape(b, nf * d)
        return TokenizedSeqBatch(
            user_ids=(torch.as_tensor(user_ids, device=self.device) if user_ids is not None
                      else torch.zeros((b,), dtype=torch.int32, device=self.device)),
            sem_ids=flat,
            sem_ids_fut=sem_ids_fut,
            seq_mask=mask,
            token_type_ids=_token_type_ids(b, n, d, self.device),
            token_type_ids_fut=(_token_type_ids(b, 1, d, self.device)
                                if sem_ids_fut is not None else None),
        )

    def __call__(self, batch: SeqBatch) -> TokenizedSeqBatch:
        """Tokenize by gather from the table; without one, from the batch's
        features (h_semids.py:229-240)."""
        if self.cached_ids is None:
            return self.tokenize_features(batch.x, batch.x_fut, batch.seq_mask, batch.user_ids)
        return super().__call__(batch)
