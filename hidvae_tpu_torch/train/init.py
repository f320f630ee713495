"""K-means codebook initialization level by level on the residuals
(counterpart of hidvae_tpu/train/init.py)."""

from typing import Optional, Sequence

import torch

from hidvae_tpu_torch.ops.distances import l2_distance
from hidvae_tpu_torch.ops.kmeans import kmeans
from hidvae_tpu_torch.utils.runtime import full_fp32


@torch.no_grad()
def kmeans_init_codebooks(model, x, generator: Optional[torch.Generator] = None, *,
                          max_items: int = 20_000, max_iters: int = 100,
                          draws: Optional[Sequence[tuple]] = None):
    """Each level's codebook of `model` set to k-means centroids of the
    encoded x[:max_items]'s residuals; `draws[i]` (init_idx, reseed_idx)
    replaces level i's draws. Returns `model`."""
    x = x[:max_items]
    with full_fp32():
        res = model.encode(x.float())
    for i, layer in enumerate(model.layers):
        init_idx, reseed_idx = draws[i] if draws is not None else (None, None)
        out = kmeans(res, model.codebook_size, max_iters=max_iters, generator=generator,
                     init_idx=init_idx, reseed_idx=reseed_idx)
        layer.embedding.copy_(out.centroids)
        with full_fp32():
            cb = layer.codebook()
        ids = torch.argmin(l2_distance(res, cb), dim=-1)
        res = res - cb[ids]
    return model
