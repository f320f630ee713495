"""Weight bridge: flax parameters as numpy by flax path
("encoder/dense_0/kernel") <-> torch state_dicts, and the export holding
them: `arrays.npz` ("params/...", "batch_stats/...", "step",
"opt_state/...") and `meta.json` ({model_config, metrics}). A `kernel` is
`weight` transposed; `scale` and `embedding` are `weight` (the codebook
keeps `embedding`); mean/var are running_mean/running_var."""

from typing import Dict, Mapping, Optional

import json
import os

import numpy as np
import torch
from torch import nn

ARRAYS_FILE = "arrays.npz"
META_FILE = "meta.json"


def flax_param_key(path: str):
    """(torch key of a flax path, whether it is transposed: Dense kernels)."""
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


def flax_named_parameters(module: nn.Module):
    """(flax path, parameter, transposed) for every parameter of `module`,
    in module order."""
    out = []
    for name, m in module.named_modules():
        prefix = name.replace(".", "/") + "/" if name else ""
        for pname, p in m.named_parameters(recurse=False):
            transpose = False
            if pname == "weight" and isinstance(m, nn.Linear):
                pname, transpose = "kernel", True
            elif pname == "weight" and isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
                pname = "scale"
            elif pname == "weight" and isinstance(m, nn.Embedding):
                pname = "embedding"
            out.append((prefix + pname, p, transpose))
    return out


def state_dict_to_flax(module: nn.Module):
    """The inverse of `flax_to_state_dict`, by module type: (params,
    batch_stats) flat numpy dicts keyed by flax path."""
    params, stats = {}, {}
    for path, p, transpose in flax_named_parameters(module):
        arr = p.detach().cpu().numpy()
        params[path] = np.ascontiguousarray(arr.T if transpose else arr)
    for name, m in module.named_modules():
        prefix = name.replace(".", "/") + "/" if name else ""
        for bname, b in m.named_buffers(recurse=False):
            if bname == "num_batches_tracked":
                continue
            leaf = {"running_mean": "mean", "running_var": "var"}.get(bname)
            if leaf is None:
                raise ValueError(f"unexpected buffer {name}.{bname}")
            stats[prefix + leaf] = b.detach().cpu().numpy().copy()
    return params, stats


def save_export(path: str, module: nn.Module, meta: dict) -> str:
    """`module`'s params and batch_stats as an export at `path`, `meta` as
    meta.json. Returns `path`."""
    params, stats = state_dict_to_flax(module)
    arrays = {**{f"params/{k}": v for k, v in params.items()},
              **{f"batch_stats/{k}": v for k, v in stats.items()}}
    return write_export(path, arrays, meta)


def write_export(path: str, arrays: Mapping[str, np.ndarray], meta: Optional[dict]) -> str:
    """Write the flat `arrays` ("/"-joined keys) as `arrays.npz` and, unless
    `meta` is None, `meta.json` into directory `path`. Returns `path`."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, ARRAYS_FILE), **arrays)
    if meta is not None:
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump(meta, f, indent=2, default=str)
    return path


def load_export_arrays(path: str, prefix: str = "") -> Dict[str, np.ndarray]:
    """The arrays of an export whose key starts with `prefix`, by key."""
    with np.load(os.path.join(path, ARRAYS_FILE), allow_pickle=False) as z:
        return {key: z[key] for key in z.files if key.startswith(prefix)}


def load_export(path: str):
    """(params, batch_stats: numpy by flax path, meta or {}) of an export."""
    params, stats = {}, {}
    with np.load(os.path.join(path, ARRAYS_FILE), allow_pickle=False) as z:
        for key in z.files:
            coll, _, rest = key.partition("/")
            if coll == "params":
                params[rest] = z[key]
            elif coll == "batch_stats":
                stats[rest] = z[key]
    meta_path = os.path.join(path, META_FILE)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return params, stats, meta
