"""One quantization level (counterpart of hidvae_tpu/models/quantize.py):
full-fp32 assignment; in training the GUMBEL_SOFTMAX, STE or
ROTATION_TRICK estimator, at eval the hard lookup."""

from enum import Enum
from typing import NamedTuple, Optional

import torch
from torch import nn

from hidvae_tpu_torch.models.losses import quantize_loss
from hidvae_tpu_torch.ops.distances import DistanceMode, compute_distance
from hidvae_tpu_torch.ops.gumbel import gumbel_softmax_sample
from hidvae_tpu_torch.ops.normalize import l2norm
from hidvae_tpu_torch.utils.runtime import full_fp32


class QuantizeForwardMode(Enum):
    GUMBEL_SOFTMAX = 1
    STE = 2
    ROTATION_TRICK = 3


class QuantizeOutput(NamedTuple):
    embeddings: torch.Tensor  # [B, D] quantized embedding (the estimator's in train mode)
    ids: torch.Tensor         # [B] int32 hard assignment
    loss: torch.Tensor        # [B] commitment + codebook loss


def rotation_trick_transform(u, q, e):
    """e - 2 (e.w) w + 2 (e.u) q with w = normalize(u + q): rotates e from
    the unit direction u onto the unit direction q; u, q and w carry no
    gradient."""
    u, q = u.detach(), q.detach()
    w = l2norm(u + q, dim=-1, eps=1e-6).detach()
    ew = torch.sum(e * w, dim=-1, keepdim=True)
    eu = torch.sum(e * u, dim=-1, keepdim=True)
    return e - 2.0 * ew * w + 2.0 * eu * q


class Quantize(nn.Module):
    """A single codebook level."""

    def __init__(self, embed_dim: int, n_embed: int, codebook_normalize: bool = False,
                 sim_vq: bool = False, commitment_weight: float = 0.25,
                 distance_mode: DistanceMode = DistanceMode.L2,
                 forward_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX):
        super().__init__()
        self.embedding = nn.Parameter(torch.rand(n_embed, embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=False) if sim_vq else None
        self.codebook_normalize = codebook_normalize
        self.commitment_weight = commitment_weight
        self.distance_mode = distance_mode
        self.forward_mode = forward_mode

    def codebook(self):
        """Effective codebook after the SimVQ projection and normalization."""
        cb = self.embedding
        if self.out_proj is not None:
            cb = self.out_proj(cb)
        if self.codebook_normalize:
            cb = l2norm(cb, dim=-1)
        return cb

    def forward(self, x, temperature: float = 0.2, train: bool = False,
                generator: Optional[torch.Generator] = None, noise=None) -> QuantizeOutput:
        """Train mode draws the Gumbel noise from `generator` unless `noise`
        [B, K] is given."""
        with full_fp32():
            codebook = self.codebook()
            dist = compute_distance(x, codebook, self.distance_mode)
        ids = torch.argmin(dist.detach(), dim=-1).to(torch.int32)  # first index on ties
        emb = codebook[ids.long()]
        if not train:
            return QuantizeOutput(embeddings=emb, ids=ids,
                                  loss=quantize_loss(x, emb, self.commitment_weight))
        if self.forward_mode == QuantizeForwardMode.GUMBEL_SOFTMAX:
            if generator is None and noise is None:
                raise ValueError("Gumbel-softmax training needs a generator or the noise")
            weights = gumbel_softmax_sample(-dist, temperature, generator, noise)
            with full_fp32():
                emb_out = weights @ codebook
            emb = emb_out
        elif self.forward_mode == QuantizeForwardMode.STE:
            emb_out = x + (emb - x).detach()
        elif self.forward_mode == QuantizeForwardMode.ROTATION_TRICK:
            emb_out = rotation_trick_transform(
                x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-8),
                emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-8),
                x,
            )
        else:
            raise ValueError(f"Unsupported forward mode {self.forward_mode}")
        return QuantizeOutput(embeddings=emb_out, ids=ids,
                              loss=quantize_loss(x, emb, self.commitment_weight))
