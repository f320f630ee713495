"""Weight bridge: flax parameters, flattened to numpy, -> PyTorch state_dicts.

The input is a flat `dict[str, np.ndarray]` keyed by flax path
("encoder/dense_0/kernel", ...), plus the model's `batch_stats` in the same
form. The bridge never sees a JAX object and imports nothing of JAX; reading
an Orbax checkpoint is not ported yet.

The port's modules carry the flax module names, so a path maps by rule:
  .../kernel        -> .../weight, transposed ([in, out] -> [out, in])
  .../scale         -> .../weight            (LayerNorm, BatchNorm)
  .../embedding     -> .../weight            (nn.Embed -> nn.Embedding), except
  quantize_i/embedding stays `embedding`     (the codebook parameter)
  batch_stats mean/var -> running_mean/running_var (+ num_batches_tracked)
Everything else (bias, RMSNorm weight, bos_emb) keeps its name.
"""

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def flax_param_key(path: str):
    """The torch state_dict key of a flax parameter path, and whether the
    array is transposed on the way ([in, out] Dense kernels). Tests use it
    to compare gradients leaf by leaf."""
    parts = path.split("/")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    transpose = False
    if leaf == "kernel":
        leaf, transpose = "weight", True
    elif leaf == "scale":
        leaf = "weight"
    elif leaf == "embedding" and not parent.startswith("quantize_"):
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf]), transpose


def flax_to_state_dict(
    params: Mapping[str, np.ndarray],
    batch_stats: Optional[Mapping[str, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """Map flat flax params (and batch_stats) to a torch state_dict."""
    out = {}
    for path, value in params.items():
        key, transpose = flax_param_key(path)
        arr = np.asarray(value)
        if transpose:
            if arr.ndim != 2:
                raise ValueError(f"{path}: expected a 2-D Dense kernel, got {arr.shape}")
            arr = arr.T
        out[key] = torch.tensor(arr)  # a copy: flax arrays may be read-only
    for path, value in (batch_stats or {}).items():
        parts = path.split("/")
        leaf = {"mean": "running_mean", "var": "running_var"}.get(parts[-1])
        if leaf is None:
            raise ValueError(f"unexpected batch_stats entry {path}")
        prefix = ".".join(parts[:-1])
        out[f"{prefix}.{leaf}"] = torch.tensor(np.asarray(value))
        out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out


def load_flax_weights(module: torch.nn.Module, params, batch_stats=None):
    """Load flat flax params into `module`; every key must match (strict)."""
    module.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)
    return module
