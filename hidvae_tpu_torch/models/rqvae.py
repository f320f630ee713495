"""Residual-quantized VAE (counterpart of hidvae_tpu/models/rqvae.py):
encoder, quantizers, cascade, decoder and `forward`, the plain trainer's
loss (:153-171); Gumbel from `generator`, `dtype` AMP's, with `rows` the
whole split batch's terms."""

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from hidvae_tpu_torch.models.layers import MLP
from hidvae_tpu_torch.models.losses import categorical_reconstruction_loss, reconstruction_loss
from hidvae_tpu_torch.models.quantize import Quantize, QuantizeForwardMode
from hidvae_tpu_torch.ops.distances import DistanceMode
from hidvae_tpu_torch.ops.dropout import RowShard
from hidvae_tpu_torch.ops.normalize import l2norm
from hidvae_tpu_torch.parallel.collectives import Rows, all_gather_rows, all_reduce_sum


@dataclass
class RqVaeOutput:
    embeddings: torch.Tensor     # [B, L, D] per-level quantized embeddings
    residuals: torch.Tensor      # [B, L, D] per-level residual inputs
    sem_ids: torch.Tensor        # [B, L] int32
    quantize_loss: torch.Tensor  # [B]


@dataclass
class RqVaeComputedLosses:
    loss: torch.Tensor                 # scalar
    reconstruction_loss: torch.Tensor  # scalar (batch mean)
    rqvae_loss: torch.Tensor           # scalar (batch mean)
    embs_norm: torch.Tensor            # [B, L] per-level embedding norms
    p_unique_ids: torch.Tensor         # scalar fraction of unique ID tuples, detached


def p_unique_ids_stat(sem_ids):
    """Fraction of distinct ID tuples in the batch: rows with no identical
    row at a larger index, over B."""
    eq = torch.all(sem_ids[:, None, :] == sem_ids[None, :, :], dim=-1)
    no_later_dup = ~torch.any(torch.triu(eq, diagonal=1), dim=1)
    return torch.sum(no_later_dup) / sem_ids.shape[0]


def batch_means(per_row, rows: Optional[Rows] = None) -> list:
    """Each per-row term's batch mean; with `rows` the split batch's (sums
    all-reduced over the global count; the same loss on every rank, so the
    backward is the identity)."""
    if rows is None:
        return [torch.mean(t) for t in per_row]
    sums = torch.stack([torch.sum(t) for t in per_row])
    return list(torch.unbind(all_reduce_sum(sums, rows.group) / rows.total))


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
        codebook_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX,
        n_cat_features: int = 18,
        dtype=None,
    ):
        super().__init__()
        self.input_dim = input_dim
        self.n_cat_features = n_cat_features
        self.embed_dim = embed_dim
        self.hidden_dims = list(hidden_dims)
        self.codebook_size = codebook_size
        self.codebook_normalize = codebook_normalize
        self.codebook_sim_vq = codebook_sim_vq
        self.n_layers = n_layers
        for i in range(n_layers):
            # Only level 0 normalizes its codebook (ref rqvae.py:70).
            self.add_module(f"quantize_{i}", Quantize(
                embed_dim, codebook_size,
                codebook_normalize=(i == 0 and codebook_normalize),
                sim_vq=codebook_sim_vq, commitment_weight=commitment_weight,
                distance_mode=codebook_distance, forward_mode=codebook_mode,
            ))
        self.encoder = MLP(input_dim, self.hidden_dims, embed_dim,
                           normalize=codebook_normalize, dtype=dtype)
        self.decoder = MLP(embed_dim, self.hidden_dims[::-1], input_dim, normalize=True,
                           dtype=dtype)

    @property
    def layers(self):
        return [getattr(self, f"quantize_{i}") for i in range(self.n_layers)]

    def encode(self, x):
        # fp32 into the quantizer (argmin agreement across paths and kernel).
        return self.encoder(x).float()

    def decode(self, x):
        return self.decoder(x)

    def stacked_codebooks(self):
        """Effective per-level codebooks [L, K, D], the input of rq_assign."""
        return torch.stack([layer.codebook() for layer in self.layers])

    def get_semantic_ids(self, encoded_x, gumbel_t: float = 0.001, train: bool = False,
                         generator: Optional[torch.Generator] = None) -> RqVaeOutput:
        """Residual quantization cascade over an encoded batch [B, D] (the
        signature of HRqVae.get_semantic_ids; the JAX RqVae encodes inside)."""
        res = encoded_x
        embs, residuals, sem_ids, q_loss = [], [], [], 0.0
        for layer in self.layers:
            residuals.append(res)
            out = layer(res, temperature=gumbel_t, train=train, generator=generator)
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

    def reconstruct(self, embeddings_sum):
        """Decoder output, L2-normalized over its dense dims (the trailing
        n_cat_features logits stay as they are)."""
        x_hat = self.decode(embeddings_sum)
        if self.n_cat_features > 0:
            return torch.cat([l2norm(x_hat[..., :-self.n_cat_features], dim=-1),
                              x_hat[..., -self.n_cat_features:]], dim=-1)
        return l2norm(x_hat, dim=-1)

    def forward(self, x, gumbel_t: float, train: bool = False,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Rows] = None) -> RqVaeComputedLosses:
        """The loss on x [B, input_dim] (hidvae_tpu/models/rqvae.py:153-171),
        with `rows` of the split batch."""
        x = x.float()
        if rows is not None and generator is not None:
            generator = RowShard(generator, rows.start, rows.total)
        q = self.get_semantic_ids(self.encode(x), gumbel_t, train=train, generator=generator)
        x_hat = self.reconstruct(torch.sum(q.embeddings, dim=-2))
        if self.n_cat_features > 0:
            recon = categorical_reconstruction_loss(x_hat, x, self.n_cat_features)
        else:
            recon = reconstruction_loss(x_hat, x)
        loss, recon_m, q_m = batch_means([recon + q.quantize_loss, recon, q.quantize_loss], rows)
        return RqVaeComputedLosses(
            loss=loss, reconstruction_loss=recon_m, rqvae_loss=q_m,
            embs_norm=all_gather_rows(torch.linalg.norm(q.embeddings, dim=-1), rows),
            p_unique_ids=p_unique_ids_stat(all_gather_rows(q.sem_ids.detach(), rows)),
        )
