"""Seeded random weights with the flax initializers' distributions,
drawn from an explicit generator, for runs that need realistic shapes."""

import math

import torch
from torch import nn

from hidvae_tpu_torch.models.layers import RMSNorm
from hidvae_tpu_torch.models.quantize import Quantize


# Flax's lecun_normal is variance_scaling(1, "fan_in", "truncated_normal"): a
# normal truncated at +-2 sigma, with sigma raised by 1/0.8796... (the std of
# the standard normal truncated at +-2) so the drawn values keep variance
# 1/fan_in.
TRUNC_NORMAL_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """Fill `t` in place as flax's lecun_normal does for a kernel whose input
    width is `fan_in`; drawn on the CPU generator, then copied to t's device."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_NORMAL_STD
    draw = nn.init.trunc_normal_(torch.empty(t.shape), 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)
    return t.copy_(draw)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of `module` in place; returns it."""
    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
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
