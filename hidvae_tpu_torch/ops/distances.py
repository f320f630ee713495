"""Codebook distances and nearest-code assignment (counterpart of
hidvae_tpu/ops/distances.py). fp32 at full precision: no TF32."""

from enum import Enum

import torch

from hidvae_tpu_torch.ops.normalize import l2norm
from hidvae_tpu_torch.utils.runtime import full_fp32


class DistanceMode(Enum):
    L2 = 1
    COSINE = 2


def l2_distance(x, codebook):
    """Expanded squared-L2 distance [B, K]: ||x||^2 + ||c||^2 - 2 x c^T."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(codebook * codebook, dim=-1)[None, :]
    with full_fp32():
        xc = x.float() @ codebook.float().T
    return x2 + c2 - 2.0 * xc


def cosine_distance(x, codebook):
    """Negative cosine similarity [B, K]."""
    xn = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    cn = l2norm(codebook, dim=-1)
    with full_fp32():
        return -(xn.float() @ cn.float().T)


def compute_distance(x, codebook, mode: DistanceMode):
    if mode == DistanceMode.L2:
        return l2_distance(x, codebook)
    if mode == DistanceMode.COSINE:
        return cosine_distance(x, codebook)
    raise ValueError(f"Unsupported distance mode {mode}")


def nearest_code(x, codebook, mode: DistanceMode = DistanceMode.L2):
    """ids [B] = argmin_k dist(x, codebook_k); ties go to the first index."""
    dist = compute_distance(x, codebook, mode)
    return torch.argmin(dist, dim=-1).to(torch.int32)
