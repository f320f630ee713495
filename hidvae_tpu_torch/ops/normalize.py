"""Normalization primitives (counterpart of hidvae_tpu/ops/normalize.py)."""

import torch


def l2norm(x, dim=-1, eps=1e-12):
    """x / max(||x||_2, eps) along `dim` (torch.nn.functional.normalize)."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def rms_norm(x, weight=None, eps=1e-6):
    """RMS normalization computed in fp32 then cast back."""
    dtype = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    y = y.to(dtype)
    if weight is not None:
        y = y * weight
    return y
