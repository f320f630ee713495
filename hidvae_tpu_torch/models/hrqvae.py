"""HiD-VAE core model, eval mode (counterpart of hidvae_tpu/models/hrqvae.py).

Everything RqVae has plus, per tag-supervised level i, a TagPredictor that
classifies the concatenation of the level-0..i code vectors and a
TagProjector for the level's tag embedding. BatchNorm uses its running
statistics. The training losses (InfoNCE alignment, focal tag loss,
uniqueness, mining) are not ported yet.
"""

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from hidvae_tpu_torch.models.rqvae import RqVae
from hidvae_tpu_torch.ops.distances import DistanceMode
from hidvae_tpu_torch.ops.normalize import l2norm

LAYER_NORM_EPS = 1e-6   # flax.linen.LayerNorm default
BATCH_NORM_EPS = 1e-5   # flax.linen.BatchNorm default


class TagPredictor(nn.Module):
    """Per-level tag classification head: sigmoid attention gate, (L2 norm
    for deeper levels), feature layer, two residual blocks, classifier.
    `use_batch_norm` maps to LayerNorm inside, as in the JAX package."""

    def __init__(self, embed_dim: int, num_classes: int, hidden_dim: Optional[int] = None,
                 use_batch_norm: bool = True, layer_idx: int = 0):
        super().__init__()
        d = embed_dim
        hidden = hidden_dim if hidden_dim is not None else 2 * d
        mid = int(hidden * 0.9)
        self.layer_idx = layer_idx
        self.use_norm = use_batch_norm
        self.attn_0 = nn.Linear(d, d // 4)
        self.attn_1 = nn.Linear(d // 4, d // 2)
        self.attn_2 = nn.Linear(d // 2, d)
        self.feat = nn.Linear(d, hidden)
        for blk in range(2):
            self.add_module(f"res{blk}_0", nn.Linear(hidden, mid))
            self.add_module(f"res{blk}_1", nn.Linear(mid, hidden))
        self.cls_0 = nn.Linear(hidden, mid)
        self.cls_1 = nn.Linear(mid, mid // 2)
        self.cls_out = nn.Linear(mid // 2, num_classes)
        if use_batch_norm:
            self.feat_ln = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
            for blk in range(2):
                self.add_module(f"res{blk}_ln0", nn.LayerNorm(mid, eps=LAYER_NORM_EPS))
                self.add_module(f"res{blk}_ln1", nn.LayerNorm(hidden, eps=LAYER_NORM_EPS))
            self.cls_ln = nn.LayerNorm(mid, eps=LAYER_NORM_EPS)

    def _norm(self, h, name):
        return getattr(self, name)(h) if self.use_norm else h

    def forward(self, x):
        a = F.relu(self.attn_0(x))
        a = F.gelu(self.attn_1(a), approximate="tanh")  # flax gelu is the tanh form
        h = x * torch.sigmoid(self.attn_2(a))
        if self.layer_idx > 0:
            h = l2norm(h, dim=-1)
        h = F.relu(self._norm(self.feat(h), "feat_ln"))
        for blk in range(2):
            r = F.relu(self._norm(getattr(self, f"res{blk}_0")(h), f"res{blk}_ln0"))
            r = F.relu(getattr(self, f"res{blk}_1")(r))
            h = h + self._norm(r, f"res{blk}_ln1")
        c = F.relu(self._norm(self.cls_0(h), "cls_ln"))
        c = F.relu(self.cls_1(c))
        return self.cls_out(c).float()


class TagProjector(nn.Module):
    """Projects a tag embedding to the level's concatenated code width:
    Linear -> BatchNorm (running statistics) -> ReLU -> Linear (-> LayerNorm)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 use_batch_norm: bool = True, use_layer_norm: bool = False):
        super().__init__()
        self.dense_0 = nn.Linear(in_dim, hidden_dim)
        self.bn = nn.BatchNorm1d(hidden_dim, eps=BATCH_NORM_EPS) if use_batch_norm else None
        self.dense_1 = nn.Linear(hidden_dim, out_dim)
        self.ln = nn.LayerNorm(out_dim, eps=LAYER_NORM_EPS) if use_layer_norm else None

    def forward(self, x):
        h = self.dense_0(x)
        if self.bn is not None:
            h = self.bn(h)
        h = self.dense_1(F.relu(h))
        if self.ln is not None:
            h = self.ln(h)
        return h.float()


class HRqVae(RqVae):
    """HiD-VAE: RqVae plus per-level tag heads."""

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
        tag_class_counts: Optional[Sequence[int]] = None,
        tag_embed_dim: int = 768,
        use_batch_norm: bool = True,
    ):
        super().__init__(
            input_dim, embed_dim, hidden_dims, codebook_size,
            codebook_normalize=codebook_normalize, codebook_sim_vq=codebook_sim_vq,
            codebook_distance=codebook_distance, n_layers=n_layers,
            commitment_weight=commitment_weight,
        )
        self.tag_class_counts = tag_class_counts
        counts = self.resolved_tag_class_counts
        concat = self.concat_embed_dims
        for i in range(self.n_tag_levels):
            self.add_module(f"tag_predictor_{i}", TagPredictor(
                concat[i], counts[i], hidden_dim=self.hidden_dims[0] // 2 * (i + 1),
                use_batch_norm=use_batch_norm, layer_idx=i,
            ))
            self.add_module(f"tag_projector_{i}", TagProjector(
                tag_embed_dim, self.hidden_dims[0], concat[i],
                use_batch_norm=use_batch_norm, use_layer_norm=codebook_normalize,
            ))

    @property
    def resolved_tag_class_counts(self):
        if self.tag_class_counts is None:
            return [10, 100, 1000][: self.n_layers]
        counts = list(self.tag_class_counts)[: self.n_layers]
        # Trailing non-positive counts mark untagged levels.
        while counts and int(counts[-1]) <= 0:
            counts.pop()
        return counts

    @property
    def n_tag_levels(self):
        return min(self.n_layers, len(self.resolved_tag_class_counts))

    @property
    def concat_embed_dims(self):
        return [self.embed_dim * (i + 1) for i in range(self.n_layers)]

    @property
    def tag_predictors(self):
        return [getattr(self, f"tag_predictor_{i}") for i in range(self.n_tag_levels)]

    @property
    def tag_projectors(self):
        return [getattr(self, f"tag_projector_{i}") for i in range(self.n_tag_levels)]

    def predict_tags_from_ids(self, ids):
        """Tag predictions from precomputed semantic IDs [B, L]: returns
        {"predictions": [B, T] int32, "confidences": [B, T]}."""
        cbs = self.stacked_codebooks()
        embs, preds, confs = [], [], []
        for i, predictor in enumerate(self.tag_predictors):
            embs.append(cbs[i][ids[:, i].long()])
            logits = predictor(torch.cat(embs, dim=-1))
            probs = torch.softmax(logits, dim=-1)
            preds.append(torch.argmax(probs, dim=-1).to(torch.int32))  # first on ties
            confs.append(torch.amax(probs, dim=-1))
        return {
            "predictions": torch.stack(preds, dim=-1),
            "confidences": torch.stack(confs, dim=-1),
        }
