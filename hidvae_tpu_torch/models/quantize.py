"""One residual-quantization level, eval mode (counterpart of
hidvae_tpu/models/quantize.py with train=False).

The training modes (Gumbel-softmax, STE, rotation trick) and k-means init are
not ported yet; at eval every mode is the same hard assignment + lookup.
`QuantizeForwardMode` names them for the gin reader (utils/ginlite.py)."""

from enum import Enum
from typing import NamedTuple

import torch
from torch import nn

from hidvae_tpu_torch.ops.distances import DistanceMode, compute_distance
from hidvae_tpu_torch.ops.normalize import l2norm


class QuantizeForwardMode(Enum):
    GUMBEL_SOFTMAX = 1
    STE = 2
    ROTATION_TRICK = 3


class QuantizeOutput(NamedTuple):
    embeddings: torch.Tensor  # [B, D] looked-up code vectors
    ids: torch.Tensor         # [B] int32 hard assignment
    loss: torch.Tensor        # [B] commitment + codebook loss


def quantize_loss(query, value, commitment_weight: float = 1.0):
    """||query - value||^2 + beta * ||query - value||^2 per sample (the eval
    value of hidvae_tpu/models/losses.py quantize_loss; its stop-gradients
    only shape the gradient)."""
    emb_loss = torch.sum(torch.square(query - value), dim=-1)
    query_loss = torch.sum(torch.square(query - value), dim=-1)
    return emb_loss + commitment_weight * query_loss


class Quantize(nn.Module):
    """A single codebook level."""

    def __init__(self, embed_dim: int, n_embed: int, codebook_normalize: bool = False,
                 sim_vq: bool = False, commitment_weight: float = 0.25,
                 distance_mode: DistanceMode = DistanceMode.L2):
        super().__init__()
        self.embedding = nn.Parameter(torch.rand(n_embed, embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=False) if sim_vq else None
        self.codebook_normalize = codebook_normalize
        self.commitment_weight = commitment_weight
        self.distance_mode = distance_mode

    def codebook(self):
        """Effective codebook after the SimVQ projection and normalization."""
        cb = self.embedding
        if self.out_proj is not None:
            cb = self.out_proj(cb)
        if self.codebook_normalize:
            cb = l2norm(cb, dim=-1)
        return cb

    def forward(self, x) -> QuantizeOutput:
        codebook = self.codebook()
        dist = compute_distance(x, codebook, self.distance_mode)
        ids = torch.argmin(dist, dim=-1).to(torch.int32)  # first index on ties
        emb = codebook[ids.long()]
        return QuantizeOutput(
            embeddings=emb, ids=ids,
            loss=quantize_loss(x, emb, self.commitment_weight),
        )
