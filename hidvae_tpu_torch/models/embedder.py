"""Semantic-ID and user-ID embedders (counterpart of hidvae_tpu/models/
embedder.py): one table by (type, layer), the last row padding; tensor-
parallel, rows cut over the model ranks, lookups summed."""

import torch
from torch import nn

from hidvae_tpu_torch.parallel.collectives import reduce_from_model

MAX_TAG_SIZE = 1000  # per tag layer


def compute_embedding_slots(sem_ids, token_type_ids, *, num_embeddings: int,
                            n_sem_layers: int, n_tag_layers: int,
                            use_interleaved_ids: bool, padding_idx: int, valid_mask=None):
    """Table row of every token, vectorized over token_type_ids."""
    t = token_type_ids.long()
    if use_interleaved_ids:
        is_sem = (t % 2) == 0
        sem_layer = t // 2
        tag_layer = t // 2
    else:
        is_sem = t < n_sem_layers
        sem_layer = t
        tag_layer = t - n_sem_layers
    ids = sem_ids.long()
    sem_slot = sem_layer * num_embeddings + torch.clamp(ids, 0, num_embeddings - 1)
    tag_slot = (num_embeddings * n_sem_layers + tag_layer * MAX_TAG_SIZE
                + torch.clamp(ids, 0, MAX_TAG_SIZE - 1))
    slots = torch.where(is_sem, sem_slot, tag_slot)
    layer_ok = torch.where(is_sem, sem_layer < n_sem_layers, tag_layer < n_tag_layers)
    pad = torch.full_like(slots, padding_idx)
    slots = torch.where(layer_ok, slots, pad)
    if valid_mask is not None:
        slots = torch.where(valid_mask, slots, pad)
    return slots


class SemIdEmbedder(nn.Module):
    """Partitioned semantic/tag ID embedding table."""

    def __init__(self, num_embeddings: int, sem_ids_dim: int, embeddings_dim: int,
                 n_sem_layers: int = 3, use_interleaved_ids: bool = False):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.n_sem_layers = n_sem_layers
        self.n_tag_layers = sem_ids_dim - n_sem_layers
        self.use_interleaved_ids = use_interleaved_ids
        tag_part = MAX_TAG_SIZE * self.n_tag_layers if self.n_tag_layers > 0 else 0
        self.table_size = num_embeddings * n_sem_layers + tag_part + 1
        self.padding_idx = self.table_size - 1
        self.emb = nn.Embedding(self.table_size, embeddings_dim)

    def forward(self, sem_ids, token_type_ids, valid_mask=None):
        """Embeddings of [..., T] ids; padding and masked tokens embed to 0."""
        slots = compute_embedding_slots(
            sem_ids, token_type_ids, num_embeddings=self.num_embeddings,
            n_sem_layers=self.n_sem_layers, n_tag_layers=self.n_tag_layers,
            use_interleaved_ids=self.use_interleaved_ids, padding_idx=self.padding_idx,
            valid_mask=valid_mask,
        )
        tp = getattr(self.emb, "tp", None)
        if tp is None:
            embs = self.emb(slots)
        else:  # rows cut over 'model': one rank finds each row, the others add 0
            local = slots - tp.rank * self.emb.weight.shape[0]
            mine = (local >= 0) & (local < self.emb.weight.shape[0])
            embs = self.emb(torch.where(mine, local, torch.zeros_like(local)))
            embs = reduce_from_model(embs * mine[..., None], tp.group)
        return torch.where((slots == self.padding_idx)[..., None],
                           torch.zeros_like(embs), embs)


class UserIdEmbedder(nn.Module):
    """Hashing-trick user embedding: emb[x % buckets]."""

    def __init__(self, num_buckets: int, embedding_dim: int):
        super().__init__()
        self.num_buckets = num_buckets
        self.emb = nn.Embedding(num_buckets, embedding_dim)

    def forward(self, x):
        return self.emb(torch.remainder(x.long(), self.num_buckets))
