"""Batch schemas as plain dataclasses of tensors (counterpart of
hidvae_tpu/data/schemas.py). Padding: item and semantic ids use -1; masks
are bool."""

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass
class SeqBatch:
    """A batch of user histories."""

    user_ids: torch.Tensor   # [B] int
    ids: torch.Tensor        # [B, N] int, -1 padded
    ids_fut: torch.Tensor    # [B, 1] int target item
    x: Optional[torch.Tensor]      # [B, N, F] item features
    x_fut: Optional[torch.Tensor]  # [B, 1, F] target item features
    seq_mask: torch.Tensor   # [B, N] bool


@dataclass
class TaggedSeqBatch(SeqBatch):
    """A SeqBatch with each item's per-level tags (ItemData's batches)."""

    tags_emb: Optional[torch.Tensor] = None      # [B, L, tag_dim]
    tags_indices: Optional[torch.Tensor] = None  # [B, L] int, -1 missing


@dataclass
class TokenizedSeqBatch:
    """Flattened semantic-ID sequences for the retrieval model: `sem_ids` is
    the [B, N*D] history, `sem_ids_fut` the [B, D_fut] target prefix, and
    `token_type_ids` the digit index of every position."""

    user_ids: torch.Tensor                       # [B] int
    sem_ids: torch.Tensor                        # [B, N*D] int, -1 padded
    sem_ids_fut: Optional[torch.Tensor]          # [B, D_fut] int or None
    seq_mask: torch.Tensor                       # [B, N*D] bool
    token_type_ids: torch.Tensor                 # [B, N*D] int
    token_type_ids_fut: Optional[torch.Tensor]   # [B, D_fut] int or None

    def replace(self, **changes) -> "TokenizedSeqBatch":
        return replace(self, **changes)
