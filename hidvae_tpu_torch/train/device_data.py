"""On-device batch preparation: the serving part of
hidvae_tpu/train/device_data.py. The training-time window crops and
duplicate-pair harvesting are not ported yet."""

import torch

from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch


def tokenize_on_device(cached_ids, user_ids, items, fut):
    """Corpus-table tokenization by gather. cached_ids [N_items, D];
    items [B, N] item indices (-1 padded); fut [B]. Returns a
    TokenizedSeqBatch with [B, N*D] history and [B, D] target."""
    n_items, d = cached_ids.shape
    b, n = items.shape
    valid = (items >= 0) & (items < n_items)
    safe = torch.where(valid, items, torch.zeros_like(items)).long()
    seq_ids = cached_ids[safe].reshape(b, n * d)
    mask = torch.repeat_interleave(items >= 0, d, dim=1)
    seq_ids = torch.where(mask, seq_ids, torch.full_like(seq_ids, -1))
    fut_ids = cached_ids[torch.clamp(fut, 0, n_items - 1).long()]
    ttids = torch.arange(d, dtype=torch.int32, device=items.device)
    return TokenizedSeqBatch(
        user_ids=user_ids,
        sem_ids=seq_ids,
        sem_ids_fut=fut_ids,
        seq_mask=mask,
        token_type_ids=ttids.repeat(b, n),
        token_type_ids_fut=ttids.repeat(b, 1),
    )
