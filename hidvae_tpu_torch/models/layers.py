"""Shared building blocks (counterpart of hidvae_tpu/models/layers.py),
named as flax names them; `dtype` is flax's compute dtype."""

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from hidvae_tpu_torch.ops.dropout import dropout as drop
from hidvae_tpu_torch.ops.normalize import l2norm, rms_norm
from hidvae_tpu_torch.parallel.collectives import parallel_linear


def dense(layer: nn.Linear, x, dtype=None):
    """flax nn.Dense(dtype=...): input and weight cast to `dtype` (None: as
    they are); a layer cut by `shard_stage2_` (`.tp`) runs tensor-parallel."""
    tp = getattr(layer, "tp", None)
    if tp is not None:
        return parallel_linear(x, layer.weight, tp, dtype)
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class RMSNorm(nn.Module):
    """RMSNorm with learned scale (held in `dtype`), computed in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, weight=self.weight, eps=self.eps)


class MLP(nn.Module):
    """Bias-free Linear stack with SiLU between layers, dropout after each
    hidden SiLU in train mode, and an optional L2 normalization of the
    output, taken in fp32."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
                 normalize: bool = False, dropout: float = 0.0, dtype=None):
        super().__init__()
        dims = [in_dim] + list(hidden_dims) + [out_dim]
        self.n_dense = len(dims) - 1
        for i in range(self.n_dense):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], dims[i + 1], bias=False))
        self.normalize = normalize
        self.dropout = dropout
        self.dtype = dtype

    def forward(self, x, generator=None):
        """Train mode with `generator` (dropout drawn from it). Tensor-parallel,
        the hidden activations are this rank's columns, its dropout its
        columns of the whole mask."""
        for i in range(self.n_dense):
            layer = getattr(self, f"dense_{i}")
            x = dense(layer, x, self.dtype)
            if i != self.n_dense - 1:
                tp = getattr(layer, "tp", None)
                cols = None
                if tp is not None:
                    if self.n_dense != 2:
                        raise NotImplementedError("tensor parallelism cuts two-layer MLPs only")
                    cols = (tp.rank * x.shape[-1], tp.size * x.shape[-1])
                x = drop(F.silu(x), self.dropout, generator, cols)
        if self.normalize:
            # fp32 regardless of compute dtype: the quantizer's argmin
            # downstream is precision-sensitive.
            x = l2norm(x.float(), dim=-1)
        return x
