"""Stage-1 tag preprocessing (a copy of hidvae_tpu/train/tags.py): levels
fitted to the depth, the exact rare-tag remap into one trailing class
(PARITY.md deviation 3)."""

from typing import Dict, List, Tuple

import numpy as np


def reconcile_tag_layers(tags_emb, tags_indices, n_layers: int):
    """Truncate or pad the tag arrays to exactly n_layers levels
    (ref train_hidvae.py:252-287)."""
    actual = tags_indices.shape[1]
    if actual == n_layers:
        return tags_emb, tags_indices
    if actual > n_layers:
        return tags_emb[:, :n_layers], tags_indices[:, :n_layers]
    pad_emb = np.zeros(
        (tags_emb.shape[0], n_layers, tags_emb.shape[2]), tags_emb.dtype
    )
    pad_emb[:, :actual] = tags_emb
    pad_idx = np.full((tags_indices.shape[0], n_layers), -1, tags_indices.dtype)
    pad_idx[:, :actual] = tags_indices
    return pad_emb, pad_idx


def compute_rare_tag_remap(
    train_tags_indices: np.ndarray,
    tag_class_counts: List[int],
    rare_tag_threshold: int,
) -> Tuple[List[int], Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Per-layer remaps from train-set tag frequencies (train_hidvae.py
    :358-455): (new_tag_class_counts, id_mappings[l]: old -> new id,
    rare_tags_dict[l]: the collapsed ids, `rare_tags.pt`'s contents)."""
    n_layers = train_tags_indices.shape[1]
    new_counts: List[int] = []
    id_mappings: Dict[int, np.ndarray] = {}
    rare_tags: Dict[int, np.ndarray] = {}

    for i in range(n_layers):
        layer = train_tags_indices[:, i]
        valid = layer[layer >= 0]
        orig = tag_class_counts[i]
        if len(valid) == 0:
            new_counts.append(orig)
            continue
        # Declared counts can undershoot the data's vocab: size by the larger.
        data_vocab = int(valid.max()) + 1
        if data_vocab > orig:
            import logging

            logging.getLogger("hidvae_tpu_torch.train.tags").warning(
                f"tag layer {i}: data has {data_vocab} classes but "
                f"tag_class_counts declares {orig}; using {data_vocab}"
            )
            orig = data_vocab
        full_counts = np.bincount(valid, minlength=orig)
        rare_mask = (full_counts > 0) & (full_counts < rare_tag_threshold)
        rare_ids = np.nonzero(rare_mask)[0]
        rare_tags[i] = rare_ids
        # Non-rare includes zero-count classes (ref :390).
        non_rare = (full_counts >= rare_tag_threshold) | (full_counts == 0)
        new_count = int(non_rare.sum()) + 1
        new_counts.append(new_count)

        special = new_count - 1
        mapping = np.arange(orig, dtype=np.int64)
        new_ids = np.cumsum(non_rare) - 1
        mapping[non_rare] = new_ids[non_rare]
        mapping[rare_ids] = special
        id_mappings[i] = mapping

    return new_counts, id_mappings, rare_tags


def apply_tag_remap(tags_indices: np.ndarray, id_mappings: Dict[int, np.ndarray]):
    """Apply the remap to a tag-index matrix in place-safe copy
    (ref train_hidvae.py:450-453)."""
    out = tags_indices.copy()
    for i, mapping in id_mappings.items():
        layer = out[:, i]
        valid = layer >= 0
        layer[valid] = mapping[layer[valid]]
        out[:, i] = layer
    return out


def post_remap_class_counts(
    train_tags_indices_remapped: np.ndarray, new_tag_class_counts: List[int]
) -> List[np.ndarray]:
    """Per-layer class-frequency arrays for focal weighting, sized to the
    remapped vocab (see module docstring deviation note)."""
    out = []
    for i, c in enumerate(new_tag_class_counts):
        layer = train_tags_indices_remapped[:, i]
        valid = layer[layer >= 0]
        out.append(np.bincount(valid, minlength=c).astype(np.float32))
    return out
