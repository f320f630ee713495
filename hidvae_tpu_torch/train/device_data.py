"""Device-resident training data (counterpart of
hidvae_tpu/train/device_data.py): the stage-1 corpus, gathered with
replacement (PARITY.md deviation 6), the stage-2 histories, sampled,
cropped and tokenized by gather, from an explicit generator or given
uniforms; `harvest_duplicate_pairs` (the mining pool)."""

from typing import NamedTuple, Optional

import numpy as np
import torch

from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch


class DeviceItemData(NamedTuple):
    x: torch.Tensor                       # [n, F], fp32 or bf16 storage
    tags_emb: Optional[torch.Tensor]      # [n, L, Td] or None
    tags_indices: Optional[torch.Tensor]  # [n, L] int32 or None
    # [P, 2] int32 split-local pairs colliding at the last audit, or None
    # (device_data.py:35-43).
    mining_pairs: Optional[torch.Tensor] = None

    @property
    def n(self):
        return self.x.shape[0]

    def gather(self, idx):
        """(x, tags_emb, tags_indices) of items `idx`, in their storage dtype."""
        return (self.x[idx],
                None if self.tags_emb is None else self.tags_emb[idx],
                None if self.tags_indices is None else self.tags_indices[idx])

    def sample(self, generator: torch.Generator, batch_size: int, n_pair_rows: int = 0):
        """`batch_size` items (device_data.py:52-66): with `n_pair_rows` and a
        pool, that many pairs from it (with replacement) at the head, pair
        by pair, then the rest uniformly."""
        dev = self.x.device
        if n_pair_rows and self.mining_pairs is not None:
            pr = torch.randint(0, self.mining_pairs.shape[0], (n_pair_rows,),
                               generator=generator, device=dev)
            rest = torch.randint(0, self.n, (batch_size - 2 * n_pair_rows,),
                                 generator=generator, device=dev)
            idx = torch.cat([self.mining_pairs[pr].reshape(-1).long(), rest])
        else:
            idx = torch.randint(0, self.n, (batch_size,), generator=generator, device=dev)
        return self.gather(idx)


class DeviceSeqData(NamedTuple):
    user_ids: torch.Tensor  # [n]
    items: torch.Tensor     # [n, N] int32, -1 padded
    fut: torch.Tensor       # [n] int32

    @property
    def n(self):
        return self.user_ids.shape[0]

    def sample_rows(self, generator: torch.Generator, batch_size: int):
        """`batch_size` rows drawn uniformly with replacement
        (device_data.py:78)."""
        idx = torch.randint(0, self.n, (batch_size,), generator=generator,
                            device=self.items.device)
        return self.user_ids[idx], self.items[idx], self.fut[idx]


def crop_uniforms(generator: torch.Generator, batch: int, device):
    """The two uniforms per row that `random_crop_windows` takes."""
    u1 = torch.rand((batch,), generator=generator, device=device)
    u2 = torch.rand((batch,), generator=generator, device=device)
    return u1, u2


def random_crop_windows(u1, u2, items, fut, min_len: int = 3):
    """(history + target) windows from uniforms u1, u2 [B] (:87-125):
    length U{min_len .. len+1}, start U{0 .. len+1-win}, last the target."""
    b, n = items.shape
    lengths = torch.sum(items >= 0, dim=1).to(torch.int32)
    full_len = lengths + 1
    span = torch.clamp(full_len - min_len + 1, min=1)
    win_len = min_len + torch.floor(u1 * span).to(torch.int32)
    win_len = torch.minimum(win_len, full_len)
    start = torch.floor(u2 * (full_len - win_len + 1)).to(torch.int32)

    cols = torch.arange(n, dtype=torch.int32, device=items.device)[None, :]
    pos = start[:, None] + cols
    gathered = torch.gather(items, 1, torch.clamp(pos, 0, n - 1).long())
    full_vals = torch.where(pos == lengths[:, None], fut[:, None], gathered)
    keep = cols < (win_len - 1)[:, None]
    new_items = torch.where(keep, full_vals, torch.full_like(full_vals, -1))
    fut_pos = start + win_len - 1
    at_fut = torch.gather(items, 1, torch.clamp(fut_pos, 0, n - 1).long()[:, None])[:, 0]
    new_fut = torch.where(fut_pos == lengths, fut, at_fut)
    apply = full_len > min_len
    return (torch.where(apply[:, None], new_items, items),
            torch.where(apply, new_fut, fut))


def tokenize_on_device(cached_ids, user_ids, items, fut):
    """Tokenize by gather from cached_ids [N_items, D]: items [B, N] (-1
    padded), fut [B] -> TokenizedSeqBatch ([B, N*D] history, [B, D] target)."""
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


def harvest_duplicate_pairs(corpus_ids, split_globals, pool_size: int, np_rng):
    """[pool_size, 2] int32 training pairs colliding in `corpus_ids`,
    resampled from `np_rng`; None without one (device_data.py:150-192)."""
    _, inverse, counts = np.unique(np.asarray(corpus_ids), axis=0, return_inverse=True,
                                   return_counts=True)
    inverse = inverse.reshape(-1)  # numpy 2.0.x returns it [N, 1] with `axis`
    if int(counts.max(initial=0)) < 2:
        return None
    order = np.argsort(inverse, kind="stable")
    a, b = order[:-1], order[1:]
    same = inverse[a] == inverse[b]
    pa, pb = a[same], b[same]
    sg = np.asarray(split_globals)

    def to_local(vals):
        pos = np.searchsorted(sg, vals)
        pos_c = np.clip(pos, 0, len(sg) - 1)
        return (pos < len(sg)) & (sg[pos_c] == vals), pos_c

    ok_a, la = to_local(pa)
    ok_b, lb = to_local(pb)
    ok = ok_a & ok_b
    if not ok.any():
        return None
    pairs = np.stack([la[ok], lb[ok]], axis=1).astype(np.int32)
    take = np_rng.choice(len(pairs), size=pool_size, replace=len(pairs) < pool_size)
    return pairs[take]
