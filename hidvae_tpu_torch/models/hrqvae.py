"""HiD-VAE core model (counterpart of hidvae_tpu/models/hrqvae.py).

RqVae plus a TagPredictor and TagProjector per tag-supervised level.
`forward` is the JAX loss: reconstruction, quantizer, InfoNCE alignment,
focal tag and uniqueness (PARITY.md deviation 1) terms, and with
`n_mined_pairs` the mined-pair term (deviation 18) on the first
2 * n_mined_pairs rows. Dropout and Gumbel draw from `generator`, mixup
from `mixup(level, batch)`; `dtype` (AMP) runs MLP and tag-head products in
bf16 (deviation 10). With `rows` each data rank runs its rows through the
row-local parts and the coupled terms on the gathered batch, so gradients
summed over ranks are the global batch's."""

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from hidvae_tpu_torch.models.layers import dense
from hidvae_tpu_torch.models.losses import (
    categorical_reconstruction_loss,
    reconstruction_loss,
    tag_alignment_loss,
    tag_prediction_loss,
    uniqueness_loss,
)
from hidvae_tpu_torch.models.quantize import QuantizeForwardMode
from hidvae_tpu_torch.models.rqvae import RqVae, batch_means, p_unique_ids_stat
from hidvae_tpu_torch.ops.distances import DistanceMode
from hidvae_tpu_torch.ops.dropout import RowShard
from hidvae_tpu_torch.ops.dropout import dropout as drop
from hidvae_tpu_torch.ops.normalize import l2norm
from hidvae_tpu_torch.parallel.collectives import Rows, all_gather_rows, all_reduce_sum
from hidvae_tpu_torch.utils.runtime import full_fp32

LAYER_NORM_EPS = 1e-6   # flax.linen.LayerNorm default
BATCH_NORM_EPS = 1e-5   # flax.linen.BatchNorm default
BATCH_NORM_MOMENTUM = 0.99  # flax.linen.BatchNorm default (torch's 0.01)


class FlaxBatchNorm(nn.BatchNorm1d):
    """flax.linen.BatchNorm on [B, C] in fp32 (biased variance, running
    averages at momentum 0.99). With `rows` the statistics are the global
    batch's, all-reduced."""

    def forward(self, x, train: bool = False, rows: Optional[Rows] = None):
        x = x.float()
        if train and rows is not None:
            sums = all_reduce_sum(torch.stack([torch.sum(x, dim=0), torch.sum(x * x, dim=0)]),
                                  rows.group, "sum") / rows.total
            mean = sums[0]
            var = F.relu(sums[1] - mean * mean)
        elif train:
            mean = torch.mean(x, dim=0)
            var = F.relu(torch.mean(x * x, dim=0) - mean * mean)
        if train:
            with torch.no_grad():
                m = BATCH_NORM_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class TagPredictor(nn.Module):
    """A level's tag head: sigmoid gate, (L2 norm deeper), feature layer, two
    residual blocks, classifier; `use_batch_norm` means LayerNorm, as JAX;
    dropout min(0.55, dropout_rate + 0.075 * layer_idx), halved last."""

    def __init__(self, embed_dim: int, num_classes: int, hidden_dim: Optional[int] = None,
                 use_batch_norm: bool = True, layer_idx: int = 0, dropout_rate: float = 0.2,
                 dtype=None):
        super().__init__()
        d = embed_dim
        hidden = hidden_dim if hidden_dim is not None else 2 * d
        mid = int(hidden * 0.9)
        self.layer_idx = layer_idx
        self.use_norm = use_batch_norm
        self.drop = min(0.55, dropout_rate + layer_idx * 0.075)
        self.dtype = dtype
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
        # flax's LayerNorm reduces in fp32 and returns fp32 under AMP.
        return getattr(self, name)(h.float()) if self.use_norm else h

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """`generator` set: train-mode dropout drawn from it."""
        def lin(name, h):
            return dense(getattr(self, name), h, self.dtype)

        def dr(h, rate):
            return drop(h, rate, generator)

        a = F.relu(lin("attn_0", x))
        a = F.gelu(lin("attn_1", a), approximate="tanh")  # flax gelu is the tanh form
        h = x * torch.sigmoid(lin("attn_2", a))
        if self.layer_idx > 0:
            h = l2norm(h, dim=-1)
        h = dr(F.relu(self._norm(lin("feat", h), "feat_ln")), self.drop)
        for blk in range(2):
            r = dr(F.relu(self._norm(lin(f"res{blk}_0", h), f"res{blk}_ln0")), self.drop)
            r = dr(F.relu(lin(f"res{blk}_1", r)), self.drop)
            h = h + self._norm(r, f"res{blk}_ln1")
        c = dr(F.relu(self._norm(lin("cls_0", h), "cls_ln")), self.drop)
        c = dr(F.relu(lin("cls_1", c)), self.drop * 0.5)
        return lin("cls_out", c).float()


class TagProjector(nn.Module):
    """Projects a tag embedding to the level's concatenated code width:
    Linear -> BatchNorm -> ReLU -> Dropout -> Linear (-> LayerNorm)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 use_batch_norm: bool = True, use_layer_norm: bool = False,
                 dropout_rate: float = 0.2, dtype=None):
        super().__init__()
        self.dense_0 = nn.Linear(in_dim, hidden_dim)
        self.bn = FlaxBatchNorm(hidden_dim, eps=BATCH_NORM_EPS) if use_batch_norm else None
        self.dense_1 = nn.Linear(hidden_dim, out_dim)
        self.ln = nn.LayerNorm(out_dim, eps=LAYER_NORM_EPS) if use_layer_norm else None
        self.dropout_rate = dropout_rate
        self.dtype = dtype

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None,
                rows: Optional[Rows] = None):
        h = dense(self.dense_0, x, self.dtype)
        if self.bn is not None:
            h = self.bn(h, train, rows)
        h = drop(F.relu(h), self.dropout_rate, generator if train else None)
        h = dense(self.dense_1, h, self.dtype)
        if self.ln is not None:
            h = self.ln(h.float())
        return h.float()


@dataclass
class HRqVaeOutput:
    embeddings: torch.Tensor      # [B, L, D]
    residuals: torch.Tensor       # [B, L, D]
    sem_ids: torch.Tensor         # [B, L] int32
    quantize_loss: torch.Tensor   # [B]
    tag_align_loss: torch.Tensor  # scalar, mean over tag levels
    tag_pred_loss: torch.Tensor
    tag_pred_accuracy: torch.Tensor
    tag_align_loss_by_layer: Optional[torch.Tensor] = None     # [T]
    tag_pred_loss_by_layer: Optional[torch.Tensor] = None
    tag_pred_accuracy_by_layer: Optional[torch.Tensor] = None


@dataclass
class HRqVaeComputedLosses:
    loss: torch.Tensor
    reconstruction_loss: torch.Tensor
    rqvae_loss: torch.Tensor
    tag_align_loss: torch.Tensor
    tag_pred_loss: torch.Tensor
    tag_pred_accuracy: torch.Tensor
    embs_norm: torch.Tensor       # [B, L]
    p_unique_ids: torch.Tensor
    tag_align_loss_by_layer: Optional[torch.Tensor] = None
    tag_pred_loss_by_layer: Optional[torch.Tensor] = None
    tag_pred_accuracy_by_layer: Optional[torch.Tensor] = None
    sem_id_uniqueness_loss: Optional[torch.Tensor] = None
    mined_pair_collision_rate: Optional[torch.Tensor] = None  # detached


class HRqVae(RqVae):
    """HiD-VAE: RqVae plus per-level tag heads and the stage-1 losses."""

    def __init__(self, input_dim: int, embed_dim: int, hidden_dims: Sequence[int],
                 codebook_size: int, codebook_normalize: bool = False,
                 codebook_sim_vq: bool = False, codebook_distance: DistanceMode = DistanceMode.L2,
                 n_layers: int = 3, commitment_weight: float = 0.25,
                 tag_class_counts: Optional[Sequence[int]] = None, tag_embed_dim: int = 768,
                 use_batch_norm: bool = True,
                 codebook_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX,
                 n_cat_features: int = 18, tag_alignment_weight: float = 0.5,
                 tag_prediction_weight: float = 0.5, use_focal_loss: bool = False,
                 focal_gamma_base: float = 2.0, focal_alpha_base: float = 0.25,
                 focal_per_layer_schedule: bool = True, dropout_rate: float = 0.2,
                 alignment_temperature: float = 0.1, sem_id_uniqueness_weight: float = 0.5,
                 sem_id_uniqueness_margin: float = 0.5,
                 sem_id_mining_margin: Optional[float] = None, mined_loss_isolation: bool = False,
                 use_label_smoothing: bool = True, label_smoothing_alpha: float = 0.1,
                 use_mixup: bool = True, mixup_alpha: float = 0.2, dtype=None):
        super().__init__(
            input_dim, embed_dim, hidden_dims, codebook_size,
            codebook_normalize=codebook_normalize, codebook_sim_vq=codebook_sim_vq,
            codebook_distance=codebook_distance, n_layers=n_layers,
            commitment_weight=commitment_weight, codebook_mode=codebook_mode,
            n_cat_features=n_cat_features, dtype=dtype,
        )
        self.tag_class_counts = tag_class_counts
        self.tag_embed_dim = tag_embed_dim
        self.tag_alignment_weight = tag_alignment_weight
        self.tag_prediction_weight = tag_prediction_weight
        self.use_focal_loss = use_focal_loss
        self.focal_gamma_base = focal_gamma_base
        self.focal_alpha_base = focal_alpha_base
        self.focal_per_layer_schedule = focal_per_layer_schedule
        self.alignment_temperature = alignment_temperature
        self.sem_id_uniqueness_weight = sem_id_uniqueness_weight
        self.sem_id_uniqueness_margin = sem_id_uniqueness_margin
        self.sem_id_mining_margin = sem_id_mining_margin
        self.mined_loss_isolation = mined_loss_isolation
        self.use_label_smoothing = use_label_smoothing
        self.label_smoothing_alpha = label_smoothing_alpha
        self.use_mixup = use_mixup
        self.mixup_alpha = mixup_alpha
        counts = self.resolved_tag_class_counts
        concat = self.concat_embed_dims
        for i in range(self.n_tag_levels):
            self.add_module(f"tag_predictor_{i}", TagPredictor(
                concat[i], counts[i], hidden_dim=self.hidden_dims[0] // 2 * (i + 1),
                use_batch_norm=use_batch_norm, layer_idx=i, dropout_rate=dropout_rate,
                dtype=dtype,
            ))
            self.add_module(f"tag_projector_{i}", TagProjector(
                tag_embed_dim, self.hidden_dims[0], concat[i],
                use_batch_norm=use_batch_norm, use_layer_norm=codebook_normalize,
                dropout_rate=dropout_rate, dtype=dtype,
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

    def _focal_params_for_layer(self, i: int):
        """Per-layer focal base parameters (PARITY.md deviation 2)."""
        if self.focal_per_layer_schedule:
            return (self.focal_gamma_base * (1.0 + i * 0.5),
                    max(0.05, self.focal_alpha_base - i * 0.05), i)
        return self.focal_gamma_base, self.focal_alpha_base, 0

    def get_semantic_ids(self, encoded_x, tags_emb=None, tags_indices=None,
                         gumbel_t: float = 0.001, train: bool = False,
                         class_counts: Optional[Sequence[torch.Tensor]] = None,
                         generator: Optional[torch.Generator] = None,
                         mixup: Optional[Callable] = None,
                         rows: Optional[Rows] = None) -> HRqVaeOutput:
        """Residual quantization with per-level tag supervision, drawing as
        `forward`; with `rows` this rank's rows, the whole batch's tag losses."""
        if rows is not None and generator is not None:
            generator = RowShard(generator, rows.start, rows.total)
        batch = encoded_x.shape[0] if rows is None else rows.total
        res = encoded_x
        has_tags = tags_emb is not None and tags_indices is not None
        embs, sem_ids, residuals = [], [], []
        q_loss = 0.0
        align, pred, acc = [], [], []
        for i, layer in enumerate(self.layers):
            residuals.append(res)
            out = layer(res, temperature=gumbel_t, train=train, generator=generator)
            q_loss = q_loss + out.loss
            embs.append(out.embeddings)
            sem_ids.append(out.ids)
            concat_emb = torch.cat(embs, dim=-1)
            if has_tags and i < self.n_tag_levels:
                projected = self.tag_projectors[i](tags_emb[:, i], train=train,
                                                   generator=generator, rows=rows)
                align.append(tag_alignment_loss(
                    concat_emb, projected, layer_idx=i,
                    alignment_weight=self.tag_alignment_weight,
                    temperature=self.alignment_temperature, rows=rows))
                logits = self.tag_predictors[i](concat_emb, generator if train else None)
                gamma, alpha, loss_layer = self._focal_params_for_layer(i)
                draw = (mixup(i, batch)
                        if (train and self.use_mixup and mixup is not None) else None)
                p = tag_prediction_loss(
                    logits, tags_indices[:, i], layer_idx=loss_layer,
                    use_focal_loss=self.use_focal_loss, focal_gamma=gamma, focal_alpha=alpha,
                    class_counts=None if class_counts is None else class_counts[i],
                    use_label_smoothing=self.use_label_smoothing,
                    label_smoothing_alpha=self.label_smoothing_alpha,
                    use_mixup=self.use_mixup, mixup=draw, training=train, rows=rows)
                pred.append(p.loss)
                acc.append(p.accuracy)
            res = res - out.embeddings

        if has_tags:
            align_s, pred_s, acc_s = torch.stack(align), torch.stack(pred), torch.stack(acc)
            n = self.n_tag_levels
            tag_align, tag_pred, tag_acc = (torch.sum(align_s) / n, torch.sum(pred_s) / n,
                                            torch.sum(acc_s) / n)
        else:
            align_s = pred_s = acc_s = None
            tag_align = tag_pred = tag_acc = torch.zeros((), device=encoded_x.device)
        return HRqVaeOutput(
            embeddings=torch.stack(embs, dim=-2),
            residuals=torch.stack(residuals, dim=-2),
            sem_ids=torch.stack(sem_ids, dim=-1),
            quantize_loss=q_loss,
            tag_align_loss=tag_align, tag_pred_loss=tag_pred, tag_pred_accuracy=tag_acc,
            tag_align_loss_by_layer=align_s, tag_pred_loss_by_layer=pred_s,
            tag_pred_accuracy_by_layer=acc_s,
        )

    def forward(self, x, tags_emb=None, tags_indices=None, gumbel_t: float = 1.0,
                train: bool = False, class_counts: Optional[Sequence[torch.Tensor]] = None,
                n_mined_pairs: int = 0, generator: Optional[torch.Generator] = None,
                mixup: Optional[Callable] = None,
                rows: Optional[Rows] = None) -> HRqVaeComputedLosses:
        """The training / eval loss (hidvae_tpu/models/hrqvae.py:457-560);
        with `rows` x and tags are this rank's rows, every output but
        embs_norm ([B, L] rows) the whole batch's."""
        x = x.float()
        if tags_emb is not None:
            tags_emb = tags_emb.float()
        encoded = self.encode(x)
        # Isolation: the losses below take the uniform rows; the mined rows'
        # gradient is the pair term's (batch statistics see every row).
        cut = 2 * n_mined_pairs if (self.mined_loss_isolation and n_mined_pairs > 0) else 0
        main_rows = None if rows is None else rows.after(cut)
        local_cut = cut if rows is None else x.shape[0] - main_rows.stop + main_rows.start
        main_enc = encoded[local_cut:]
        q = self.get_semantic_ids(
            main_enc, None if tags_emb is None else tags_emb[local_cut:],
            None if tags_indices is None else tags_indices[local_cut:], gumbel_t, train=train,
            class_counts=class_counts, generator=generator, mixup=mixup, rows=main_rows)
        x_hat = self.reconstruct(torch.sum(q.embeddings, dim=-2))
        if self.n_cat_features > 0:
            recon = categorical_reconstruction_loss(x_hat, x[local_cut:], self.n_cat_features)
        else:
            recon = reconstruction_loss(x_hat, x[local_cut:])
        uniq = uniqueness_loss(q.sem_ids, main_enc, margin=self.sem_id_uniqueness_margin,
                               weight=self.sem_id_uniqueness_weight, rows=main_rows)
        collision_rate = torch.zeros((), device=x.device)
        if n_mined_pairs > 0:
            # The pairs are the batch's first rows, gathered whole on every rank.
            pair_rows = None if rows is None else rows.head(2 * n_mined_pairs)
            enc_p = all_gather_rows(
                encoded[: 2 * n_mined_pairs if rows is None else pair_rows.stop - pair_rows.start],
                pair_rows, "slice")
            # Eval-mode IDs, as the audit's table (the rotation trick's
            # differ at depth), in full fp32 so no near tie moves.
            with torch.no_grad(), full_fp32():
                ids = self.get_semantic_ids(enc_p.detach()).sem_ids
            pair_ids = ids.reshape(n_mined_pairs, 2, -1)
            eq = torch.all(pair_ids[:, 0] == pair_ids[:, 1], dim=-1)
            f = l2norm(enc_p, dim=-1)
            cos = torch.sum(f[0::2] * f[1::2], dim=-1)
            margin = (self.sem_id_mining_margin if self.sem_id_mining_margin is not None
                      else self.sem_id_uniqueness_margin)
            pen = F.relu(cos - margin) * eq
            n_coll = torch.sum(eq)
            mined = torch.sum(pen) / torch.clamp(n_coll, min=1)  # 0 when none collides
            uniq = uniq + self.sem_id_uniqueness_weight * mined
            collision_rate = (n_coll / n_mined_pairs).detach()
        recon_m, q_m = batch_means([recon, q.quantize_loss], main_rows)
        loss = (recon_m + q_m + self.tag_alignment_weight * q.tag_align_loss
                + self.tag_prediction_weight * q.tag_pred_loss
                + self.sem_id_uniqueness_weight * uniq)
        return HRqVaeComputedLosses(
            loss=loss, reconstruction_loss=recon_m, rqvae_loss=q_m,
            tag_align_loss=q.tag_align_loss, tag_pred_loss=q.tag_pred_loss,
            tag_pred_accuracy=q.tag_pred_accuracy,
            embs_norm=all_gather_rows(torch.linalg.norm(q.embeddings, dim=-1), main_rows),
            p_unique_ids=p_unique_ids_stat(all_gather_rows(q.sem_ids, main_rows)),
            tag_align_loss_by_layer=q.tag_align_loss_by_layer,
            tag_pred_loss_by_layer=q.tag_pred_loss_by_layer,
            tag_pred_accuracy_by_layer=q.tag_pred_accuracy_by_layer,
            sem_id_uniqueness_loss=uniq,
            mined_pair_collision_rate=collision_rate,
        )

    def predict_tags(self, x, gumbel_t: float = 0.001, noise=None, noise_scale: float = 0.0):
        """Per-level tag predictions of features [B, F] or [B, N, F], plus
        `noise_scale * noise` if given (test-time augmentation). Returns
        {"predictions", "confidences", "logits"}, lists per level."""
        is_seq = x.dim() == 3
        if is_seq:
            b, n, f = x.shape
            x = x.reshape(-1, f)
            if noise is not None:
                noise = noise.reshape(-1, f)
        if noise is not None and noise_scale > 0:
            x = x + noise_scale * noise
        res = self.encode(x.float())
        embs, preds, confs, logits_all = [], [], [], []
        for i, layer in enumerate(self.layers[: self.n_tag_levels]):
            out = layer(res, temperature=gumbel_t, train=False)
            embs.append(out.embeddings)
            logits = self.tag_predictors[i](torch.cat(embs, dim=-1))
            probs = torch.softmax(logits, dim=-1)
            preds.append(torch.argmax(probs, dim=-1).to(torch.int32))
            confs.append(torch.amax(probs, dim=-1))
            logits_all.append(logits)
            res = res - out.embeddings
        predictions, confidences = torch.stack(preds, dim=-1), torch.stack(confs, dim=-1)
        if is_seq:
            predictions = predictions.reshape(b, n, -1)
            confidences = confidences.reshape(b, n, -1)
        return {"predictions": predictions, "confidences": confidences, "logits": logits_all}
