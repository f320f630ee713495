"""Stage-1 losses (counterpart of hidvae_tpu/models/losses.py), masked
math of static shape (PARITY.md deviation 4), mixup drawn by the caller;
batch-coupled terms take `rows` (the split batch's term on every rank)."""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.nn import functional as F

from hidvae_tpu_torch.ops.normalize import l2norm
from hidvae_tpu_torch.parallel.collectives import Rows, all_gather_rows


def reconstruction_loss(x_hat, x):
    """Per-sample squared-error sum [B]."""
    return torch.sum(torch.square(x_hat - x), dim=-1)


def categorical_reconstruction_loss(x_hat, x, n_cat_feats: int):
    """Squared error on the dense dims plus BCE-with-logits summed over the
    trailing `n_cat_feats` dims [B]."""
    if n_cat_feats <= 0:
        return reconstruction_loss(x_hat, x)
    dense = reconstruction_loss(x_hat[..., :-n_cat_feats], x[..., :-n_cat_feats])
    logits = x_hat[..., -n_cat_feats:]
    targets = x[..., -n_cat_feats:]
    bce = torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    return dense + torch.sum(bce, dim=-1)


def quantize_loss(query, value, commitment_weight: float = 1.0):
    """||sg(query) - value||^2 + beta * ||query - sg(value)||^2 per sample [B]:
    the codebook term moves the code, the commitment term the encoder."""
    emb_loss = torch.sum(torch.square(query.detach() - value), dim=-1)
    query_loss = torch.sum(torch.square(query - value.detach()), dim=-1)
    return emb_loss + commitment_weight * query_loss


def tag_alignment_loss(codebook_emb, tag_emb, layer_idx: int, alignment_weight: float = 1.0,
                       temperature: float = 0.1, rows: Optional[Rows] = None):
    """InfoNCE between the concatenated code vectors and the projected tag
    embeddings, diagonal targets, scaled by alignment_weight / (0.5 *
    layer_idx + 1). Scalar."""
    codebook_emb = all_gather_rows(codebook_emb, rows, "slice")
    tag_emb = all_gather_rows(tag_emb, rows, "slice")
    cb = l2norm(codebook_emb, dim=-1)
    tg = l2norm(tag_emb, dim=-1)
    logits = (cb @ tg.T) / temperature
    diag = torch.sum(cb * tg, dim=-1) / temperature
    loss = -torch.mean(diag - torch.logsumexp(logits, dim=-1))
    return loss * alignment_weight * (1.0 / (layer_idx * 0.5 + 1.0))


def uniqueness_loss(sem_ids, encoded_features, margin: float = 0.5, weight: float = 1.0,
                    rows: Optional[Rows] = None):
    """`weight` x the mean of relu(cos(enc_i, enc_j) - margin) over pairs
    i < j with colliding tuples (0 without one)."""
    sem_ids = all_gather_rows(sem_ids, rows)
    encoded_features = all_gather_rows(encoded_features, rows, "slice")
    b = sem_ids.shape[0]
    if b <= 1:
        return torch.zeros((), device=encoded_features.device)
    eq = torch.all(sem_ids[:, None, :] == sem_ids[None, :, :], dim=-1)
    pair_mask = torch.triu(eq, diagonal=1).float()
    feats = l2norm(encoded_features, dim=-1)
    penalty = F.relu(feats @ feats.T - margin)
    n_pairs = torch.sum(pair_mask)
    loss = torch.sum(penalty * pair_mask) / torch.clamp(n_pairs, min=1.0)
    return weight * torch.where(n_pairs > 0, loss, torch.zeros_like(loss))


class TagPredictionLossOutput(NamedTuple):
    loss: torch.Tensor      # scalar
    accuracy: torch.Tensor  # scalar


def _smoothed_one_hot(targets, num_classes, smoothing):
    one_hot = F.one_hot(targets.long(), num_classes).float()
    return one_hot * (1.0 - smoothing) + smoothing / num_classes


def _focal_smoothing(gamma, num_classes, label_smoothing_alpha, apply: bool):
    """The label smoothing both focal variants use."""
    if not apply:
        return 0.0
    class_factor = min(0.3, 0.05 * (num_classes / 100.0))
    return min(0.25, label_smoothing_alpha + gamma * 0.015 + class_factor)


def _kl_to_uniform(logits):
    """KL(uniform || softmax(logits)), the batch mean."""
    c = logits.shape[-1]
    log_probs = torch.log(torch.softmax(logits, dim=-1) + 1e-8)
    return torch.mean(torch.sum((1.0 / c) * (math.log(1.0 / c) - log_probs), dim=-1))


def mixup_draw(batch: int, alpha: float, generator: torch.Generator,
               host: np.random.Generator, device=None):
    """One mixup draw: a permutation of the batch from `generator` (on
    `device`) and lambda ~ Beta(alpha, alpha) from the host generator (a
    float, so no device sync)."""
    perm = torch.randperm(batch, generator=generator, device=device)
    return perm, float(host.beta(alpha, alpha))


def tag_prediction_loss(
    logits,
    targets,
    layer_idx: int = 0,
    *,
    use_focal_loss: bool = False,
    focal_gamma: float = 2.0,
    focal_alpha: float = 0.25,
    class_counts: Optional[torch.Tensor] = None,
    use_label_smoothing: bool = True,
    label_smoothing_alpha: float = 0.1,
    use_mixup: bool = True,
    mixup=None,
    training: bool = False,
    rows: Optional[Rows] = None,
) -> TagPredictionLossOutput:
    """Focal (weighted by `class_counts` if given) or label-smoothed CE plus
    KL to uniform over valid targets; `mixup` (permutation [B], lambda) mixes
    the logits in training; accuracy before mixup; 0 and 0 without targets."""
    logits = all_gather_rows(logits, rows, "slice")
    targets = all_gather_rows(targets, rows)
    num_classes = logits.shape[-1]
    valid = targets >= 0
    valid_f = valid.float()
    n_valid = torch.sum(valid_f)
    safe_targets = torch.where(valid, targets, torch.zeros_like(targets)).long()

    pred = torch.argmax(logits, dim=-1)
    accuracy = torch.sum((pred == safe_targets).float() * valid_f) / torch.clamp(n_valid, min=1.0)
    kl_pre = _kl_to_uniform(logits)  # before mixup

    if use_mixup and training and mixup is not None:
        perm, lam = mixup
        rows = torch.arange(logits.shape[0], device=logits.device)
        perm = torch.where(valid[perm], perm, rows)  # invalid partners: the row itself
        mixed_logits = lam * logits + (1.0 - lam) * logits[perm]
        targets_a, targets_b = safe_targets, safe_targets[perm]
    else:
        lam = 1.0
        mixed_logits = logits
        targets_a = targets_b = safe_targets

    def masked_mean(per_sample):
        return torch.sum(per_sample * valid_f) / torch.clamp(n_valid, min=1.0)

    def focal_ce(tgt, smoothing):
        one_hot = _smoothed_one_hot(tgt, num_classes, smoothing)
        pt = torch.sum(one_hot * torch.softmax(mixed_logits, dim=-1), dim=-1)
        ce = -torch.sum(one_hot * torch.log_softmax(mixed_logits, dim=-1), dim=-1)
        return pt, ce

    if use_focal_loss:
        gamma = focal_gamma * (1.0 + 0.35 * layer_idx)
        alpha = max(0.08, focal_alpha - 0.06 * layer_idx)
        smoothing = _focal_smoothing(gamma, num_classes, label_smoothing_alpha,
                                     apply=use_label_smoothing and training)
        if class_counts is not None:
            counts = class_counts.float()
            freq = torch.clamp(counts / torch.clamp(torch.sum(counts), min=1.0), min=1e-6)
            weights = 1.0 / torch.sqrt(freq)
            weights = torch.clamp(weights / torch.mean(weights), 0.5, 3.0)
            adj_gamma = gamma * (1.0 + 0.25 * min(1.0, num_classes / 250.0))

            def weighted_focal(tgt):
                pt, ce = focal_ce(tgt, smoothing)
                fl = masked_mean(weights[tgt] * (1.0 - pt) ** adj_gamma * ce)
                if num_classes > 100:
                    reg_w = min(0.12, 0.015 * (num_classes / 100.0))
                    fl = fl + reg_w * _kl_to_uniform(mixed_logits) * (1.0 if training else 0.0)
                return fl

            loss = lam * weighted_focal(targets_a) + (1.0 - lam) * weighted_focal(targets_b)
        else:
            def plain_focal(tgt):
                pt, ce = focal_ce(tgt, smoothing)
                return masked_mean(alpha * (1.0 - pt) ** gamma * ce)

            loss = lam * plain_focal(targets_a) + (1.0 - lam) * plain_focal(targets_b)
    else:
        label_smoothing = min(0.25, 0.05 + layer_idx * 0.06)

        def smoothed_ce(tgt):
            one_hot = _smoothed_one_hot(tgt, num_classes, label_smoothing)
            return masked_mean(-torch.sum(one_hot * torch.log_softmax(mixed_logits, dim=-1),
                                          dim=-1))

        loss = lam * smoothed_ce(targets_a) + (1.0 - lam) * smoothed_ce(targets_b) + 0.05 * kl_pre

    has_valid = n_valid > 0
    zero = torch.zeros((), device=logits.device)
    return TagPredictionLossOutput(
        loss=torch.where(has_valid, loss, zero),
        accuracy=torch.where(has_valid, accuracy, zero),
    )
