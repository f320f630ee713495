"""Hierarchical semantic-ID tokenizer around a frozen HiD-VAE (counterpart
of hidvae_tpu/tokenizer/h_semids.py).

Three ID layouts:
  * semantic-only               [s1..sL]
  * concatenated (+pred tags)   [s1..sL, t1..tT]
  * interleaved                 [s1, t1, s2, t2, ...]
plus the dedup rank column of the semantic-only layout. The corpus sweep runs
the encoder and then the fused residual quantization `rq_assign_auto`: the
CUDA kernel on the card, the plain version on the CPU. The table, prefix
index, caps, tries and tokenizing by gather are those of the plain
tokenizer (semids.py), which this one extends. Not ported yet (ROADMAP.md
queue 1, item 4): the cache-miss path `tokenize_features` (tokenizing here
needs the precomputed table) and the tokenizer's `predict_tags`; the
model's own `HRqVae.predict_tags` is ported.
"""

from typing import Optional, Sequence

import torch

from hidvae_tpu_torch.ops.rq_assign import rq_assign_auto
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
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
