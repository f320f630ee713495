"""Seeded random weights for the port's modules, drawn from an explicit
torch.Generator with the flax initializers' distributions: lecun-normal
Dense kernels, zero biases, unit norm scales, unit-variance-over-width
embeddings, uniform [0, 1) codebooks and BOS. Trained weights come through
bridge.py instead; this serves runs that need realistic shapes, not trained
values."""

import math

import torch
from torch import nn

from hidvae_tpu_torch.models.layers import RMSNorm
from hidvae_tpu_torch.models.quantize import Quantize


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of `module` in place; returns it."""
    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in module.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, 1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0 / math.sqrt(m.embedding_dim))
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm1d):
                m.reset_running_stats()
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, Quantize):
            m.embedding.copy_(torch.rand(m.embedding.shape, generator=generator))
    if hasattr(module, "bos_emb"):
        module.bos_emb.copy_(torch.rand(module.bos_emb.shape, generator=generator))
    return module
