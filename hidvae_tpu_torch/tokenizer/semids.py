"""Tokenization helpers shared by the semantic-ID tokenizers (the part of
hidvae_tpu/tokenizer/semids.py that h_semids.py imports). The plain
RQ-VAE tokenizer itself is not ported yet."""

import torch


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
