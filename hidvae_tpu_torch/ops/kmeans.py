"""Lloyd's k-means for codebook init (counterpart of hidvae_tpu/ops/
kmeans.py), assignment in full fp32, draws from `generator` or given
(`init_idx`, `reseed_idx(it)`, as a test passes JAX's)."""

from typing import Callable, NamedTuple, Optional

import torch

from hidvae_tpu_torch.ops.distances import l2_distance
from hidvae_tpu_torch.utils.runtime import full_fp32


class KmeansOutput(NamedTuple):
    centroids: torch.Tensor   # [K, D]
    assignment: torch.Tensor  # [B] int32


def kmeans(x, k: int, max_iters: int = 100, stop_threshold: float = 1e-10,
           generator: Optional[torch.Generator] = None, init_idx=None,
           reseed_idx: Optional[Callable[[int], torch.Tensor]] = None) -> KmeansOutput:
    """Lloyd's algorithm on x [B, D] (B >= k). The stop test reads the
    largest centroid shift back to the host once per step."""
    b = x.shape[0]
    if init_idx is None:
        init_idx = torch.randperm(b, generator=generator, device=x.device)[:k]
    if reseed_idx is None:
        def reseed_idx(it):
            return torch.randint(0, b, (k,), generator=generator, device=x.device)

    def assign(centroids):
        return torch.argmin(l2_distance(x, centroids), dim=-1).to(torch.int32)

    centroids = x[init_idx.long()]
    for it in range(max_iters):
        assignment = assign(centroids)
        one_hot = torch.nn.functional.one_hot(assignment.long(), k).to(x.dtype)
        counts = torch.sum(one_hot, dim=0)
        with full_fp32():
            sums = one_hot.T @ x
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        reseed = x[reseed_idx(it).long()]
        new = torch.where((counts > 0)[:, None], means, reseed)
        shift = float(torch.max(torch.linalg.norm(new - centroids, dim=-1)))
        centroids = new
        if shift < stop_threshold:
            break
    return KmeansOutput(centroids=centroids, assignment=assign(centroids))
