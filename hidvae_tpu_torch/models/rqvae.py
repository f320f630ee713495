"""Residual-quantized VAE, eval mode: the part of hidvae_tpu/models/rqvae.py
that HRqVae builds on (encoder, per-level quantizers, the residual cascade).
The decoder MLP is held for its weights only: reconstruction and the
training losses are not ported yet."""

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from hidvae_tpu_torch.models.layers import MLP
from hidvae_tpu_torch.models.quantize import Quantize
from hidvae_tpu_torch.ops.distances import DistanceMode


@dataclass
class RqVaeOutput:
    embeddings: torch.Tensor     # [B, L, D] per-level quantized embeddings
    residuals: torch.Tensor      # [B, L, D] per-level residual inputs
    sem_ids: torch.Tensor        # [B, L] int32
    quantize_loss: torch.Tensor  # [B]


class RqVae(nn.Module):
    """Encoder MLP -> L x {quantize, subtract residual} -> decoder."""

    def __init__(
        self,
        input_dim: int,
        embed_dim: int,
        hidden_dims: Sequence[int],
        codebook_size: int,
        codebook_normalize: bool = False,
        codebook_sim_vq: bool = False,
        codebook_distance: DistanceMode = DistanceMode.L2,
        n_layers: int = 3,
        commitment_weight: float = 0.25,
    ):
        super().__init__()
        self.input_dim = input_dim
        self.embed_dim = embed_dim
        self.hidden_dims = list(hidden_dims)
        self.codebook_size = codebook_size
        self.n_layers = n_layers
        for i in range(n_layers):
            # Only level 0 normalizes its codebook (ref rqvae.py:70).
            self.add_module(f"quantize_{i}", Quantize(
                embed_dim, codebook_size,
                codebook_normalize=(i == 0 and codebook_normalize),
                sim_vq=codebook_sim_vq, commitment_weight=commitment_weight,
                distance_mode=codebook_distance,
            ))
        self.encoder = MLP(input_dim, self.hidden_dims, embed_dim,
                           normalize=codebook_normalize)
        self.decoder = MLP(embed_dim, self.hidden_dims[::-1], input_dim, normalize=True)

    @property
    def layers(self):
        return [getattr(self, f"quantize_{i}") for i in range(self.n_layers)]

    def encode(self, x):
        # fp32 into the quantizer (argmin agreement across paths and kernel).
        return self.encoder(x).float()

    def stacked_codebooks(self):
        """Effective per-level codebooks [L, K, D], the input of rq_assign."""
        return torch.stack([layer.codebook() for layer in self.layers])

    def get_semantic_ids(self, encoded_x) -> RqVaeOutput:
        """Residual quantization cascade over an encoded batch [B, D] (the
        signature of HRqVae.get_semantic_ids; the JAX RqVae encodes inside)."""
        res = encoded_x
        embs, residuals, sem_ids, q_loss = [], [], [], 0.0
        for layer in self.layers:
            residuals.append(res)
            out = layer(res)
            q_loss = q_loss + out.loss
            res = res - out.embeddings
            embs.append(out.embeddings)
            sem_ids.append(out.ids)
        return RqVaeOutput(
            embeddings=torch.stack(embs, dim=-2),
            residuals=torch.stack(residuals, dim=-2),
            sem_ids=torch.stack(sem_ids, dim=-1),
            quantize_loss=q_loss,
        )
