"""Shared building blocks (counterpart of hidvae_tpu/models/layers.py).

Submodule names follow the flax names (`dense_0`, ...) so that bridge.py maps
a flax parameter path to a state_dict key by rule."""

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from hidvae_tpu_torch.ops.normalize import l2norm, rms_norm


class RMSNorm(nn.Module):
    """RMSNorm with learned scale."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, weight=self.weight, eps=self.eps)


class MLP(nn.Module):
    """Bias-free Linear stack with SiLU between layers and an optional L2
    normalization of the output, taken in fp32. Dropout is a training-time
    op; this eval port has none."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
                 normalize: bool = False):
        super().__init__()
        dims = [in_dim] + list(hidden_dims) + [out_dim]
        self.n_dense = len(dims) - 1
        for i in range(self.n_dense):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], dims[i + 1], bias=False))
        self.normalize = normalize

    def forward(self, x):
        for i in range(self.n_dense):
            x = getattr(self, f"dense_{i}")(x)
            if i != self.n_dense - 1:
                x = F.silu(x)
        if self.normalize:
            # fp32 regardless of compute dtype: the quantizer's argmin
            # downstream is precision-sensitive.
            x = l2norm(x.float(), dim=-1)
        return x
