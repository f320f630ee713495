"""Training commons (counterpart of part of hidvae_tpu/train/common.py): the
inverse-sqrt schedule and the plain branch of `make_optimizer`, AdamW with an
optional global-norm clip first; the checkpoint helpers that serving reads
(meta, structural reconcile, the lenient restore of an exported checkpoint);
and the corpus audit with its diversity metrics.

The JAX optimizer is `optax.adamw(schedule, weight_decay)` (b1 0.9, b2
0.999, eps 1e-8, decay on every parameter), optionally after
`optax.clip_by_global_norm`. optax evaluates the schedule at the number of
updates already applied, so update t (0-based) uses schedule(t); `Optimizer`
sets that rate on torch.optim.AdamW before each step, whose update rule is
optax's (decoupled decay lr * wd * p, bias-corrected moments, eps added to
the root).

Not ported yet: the cosine and step schedules, the plateau scale,
gradient accumulation, the tag-head parameter groups (stage 1) and saving
checkpoints."""

import json
import logging
import math
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int) -> Callable[[int], float]:
    """Flat at base_lr through `warmup_steps`, then base_lr * sqrt(warmup /
    step) (common.py:50-62); step is taken as at least 1."""

    def schedule(step: int) -> float:
        step = max(int(step), 1)
        return base_lr if step <= warmup_steps else base_lr * math.sqrt(warmup_steps / step)

    return schedule


def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm g exceeds
    max_norm, every gradient is scaled by max_norm / g. Returns g."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class Optimizer:
    """AdamW on `params` under a schedule of the update count, with an
    optional global-norm clip before it (make_optimizer, common.py:221-267,
    plain branch)."""

    def __init__(self, params, schedule: Callable[[int], float], weight_decay: float,
                 max_grad_norm: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0  # updates applied so far, optax's schedule count
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self):
        """Apply one update from the parameters' .grad."""
        if self.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params], self.max_grad_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1


# ---------------- checkpoints ----------------


def restore_export(path: str, module: torch.nn.Module, *,
                   mismatch_tolerance: float = 0.1) -> dict:
    """Load an exported checkpoint (bridge.py) into `module`, leniently, as
    the JAX package's restore_checkpoint does (common.py:306-407): a
    parameter or statistic the export lacks, or holds at another shape,
    keeps the module's current value with one warning per leaf; export
    entries the module lacks are dropped. More than
    max(mismatch_tolerance * param leaves, 8) missing or mismatched param
    leaves mean a structurally different model: raise ValueError rather
    than serve from mostly initial weights. The rest loads strictly.
    Returns the export's meta."""
    from hidvae_tpu_torch.bridge import flax_to_state_dict, load_export, state_dict_to_flax

    log = logging.getLogger("hidvae_tpu_torch.checkpoint")
    params, stats, meta = load_export(path)
    want_params, want_stats = state_dict_to_flax(module)
    merged, mismatched = {}, []
    for coll, want, have in (("params", want_params, params),
                             ("batch_stats", want_stats, stats)):
        out = {}
        for key, current in want.items():
            name = f"{coll}/{key}"
            src = have.get(key)
            if src is None:
                log.warning(f"checkpoint missing {name}; keeping initialized value")
                if coll == "params":
                    mismatched.append(name + " (missing)")
                out[key] = current
            elif tuple(src.shape) != tuple(current.shape):
                log.warning(f"checkpoint shape mismatch at {name}: {tuple(src.shape)} vs "
                            f"{tuple(current.shape)}; keeping initialized value")
                if coll == "params":
                    mismatched.append(name)
                out[key] = current
            else:
                out[key] = src
        merged[coll] = out
    n_param_leaves = len(want_params)
    allowed = max(mismatch_tolerance * max(n_param_leaves, 1), 8)
    if mismatched and len(mismatched) > allowed:
        raise ValueError(
            f"checkpoint {path} is structurally incompatible with the requested model: "
            f"{len(mismatched)}/{n_param_leaves} param leaves are shape-mismatched or missing "
            f"(> {mismatch_tolerance:.0%} tolerance). First: {mismatched[:5]}. A lenient "
            f"restore would keep these at random init — rebuild the model with the "
            f"checkpoint's recorded model_config instead."
        )
    module.load_state_dict(flax_to_state_dict(merged["params"], merged["batch_stats"]),
                           strict=True)
    return meta


# ---------------- structural model config ----------------

# Fields of the stage-1 VAE whose values change forward semantics or parameter
# shapes. A frozen tokenizer must be rebuilt with the exact values its
# checkpoint was trained with: a wrong codebook_normalize keeps every
# parameter shape (so a lenient restore succeeds) while every quantizer
# distance is wrong, which collapses the corpus ID table.
STRUCTURAL_VAE_KEYS = (
    "input_dim",
    "embed_dim",
    "hidden_dims",
    "codebook_size",
    "codebook_normalize",
    "codebook_sim_vq",
    "n_layers",
    "n_cat_features",
    "tag_class_counts",
    "tag_embed_dim",
)


def load_checkpoint_meta(path: str) -> dict:
    """Read <path>/meta.json ({model_config, metrics}), or {} if absent."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_checkpoint_model_config(path: str):
    """Read model_config from <path>/meta.json, or None if absent."""
    return load_checkpoint_meta(path).get("model_config")


def reconcile_vae_config(pretrained_path: str, requested: dict, logger=None) -> dict:
    """Overlay the checkpoint's recorded structural config onto the requested
    one. Any key the checkpoint's meta.json records (not null) wins, and
    every difference is logged; keys it does not record keep the requested
    values. Legacy meta files stored values as strings ("768", "true"):
    they are normalized before the comparison."""
    log = logger or logging.getLogger("hidvae_tpu_torch.checkpoint")
    saved = load_checkpoint_model_config(pretrained_path)
    if not saved:
        return dict(requested)

    def norm(v):
        if isinstance(v, (tuple, list)):
            return [int(x) for x in v]
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            low = v.strip().lower()
            if low in ("true", "false"):
                return low == "true"
            try:
                return int(v)
            except ValueError:
                return v
        return v

    out = dict(requested)
    for key, want in requested.items():
        if key not in saved or saved[key] is None:
            continue
        have = norm(saved[key])
        if norm(want) != have:
            log.warning(
                f"pretrained checkpoint {pretrained_path} was trained with "
                f"{key}={have!r} but the config requests {key}={want!r}; "
                f"using the checkpoint's value (structural self-heal)"
            )
            out[key] = have
    return out


# ---------------- corpus audit ----------------


def tokenizer_sem_cols(tokenizer):
    """Column indices of the semantic digits in a tokenizer's corpus table:
    [0, 2, 4, ...] in the interleaved layout, the first n_layers otherwise.
    Tag and dedup-rank columns vary per item even when the semantic index
    has collapsed, so a collapse audit slices them off."""
    d = tokenizer.sem_ids_dim
    if getattr(tokenizer, "use_interleaved_ids", False):
        return [2 * i for i in range(tokenizer.n_layers) if 2 * i < d]
    return list(range(min(tokenizer.n_layers, d)))


def audit_rebuilt_corpus(tokenizer, corpus_ids, stage1_checkpoint, log=None):
    """Diversity audit of a rebuilt corpus table and collapse guard against
    the stage-1 checkpoint's recorded (semantic-tuple) repetition rate.

    Returns (div_full, div_sem): diversity over full ID tuples and over the
    semantic digits alone; the guard compares semantic to semantic. Raises
    RuntimeError on a contradiction; checkpoints with no recorded rate pass."""
    ids = np.asarray(corpus_ids)
    sem_cols = tokenizer_sem_cols(tokenizer)
    div = id_diversity_metrics(ids, tokenizer.codebook_size, tokenizer.n_layers,
                               sem_cols=sem_cols)
    div_sem = (
        id_diversity_metrics(ids[:, sem_cols], tokenizer.codebook_size, tokenizer.n_layers)
        if ids.shape[1] > len(sem_cols) else div
    )
    if log is not None:
        log.info(f"Corpus ID diversity: {div}")
        if div_sem is not div:
            log.info(f"Semantic-only slice diversity: {div_sem}")
    if stage1_checkpoint is not None:
        recorded = load_checkpoint_meta(stage1_checkpoint).get("metrics", {})
        err = corpus_collapse_error(recorded.get("repetition_rate"), div_sem)
        if err:
            raise RuntimeError(f"{err} (checkpoint: {stage1_checkpoint})")
    return div, div_sem


def corpus_collapse_error(recorded_rep, div: dict):
    """An error message when a rebuilt table's diversity contradicts the
    checkpoint's recorded repetition rate, else None: a recorded rate under
    0.1 against a rebuilt one over 0.5 means the frozen stage-1 model was
    rebuilt with other semantics than it was trained with. Tokenizers that
    recorded a high rate of their own pass."""
    if recorded_rep is None or recorded_rep >= 0.1:
        return None
    if div["repetition_rate"] <= 0.5:
        return None
    return (
        f"Corpus ID table collapsed: the stage-1 checkpoint recorded "
        f"repetition_rate={recorded_rep:.4f} but the rebuilt tokenizer "
        f"produces {div['repetition_rate']:.4f} "
        f"({div['unique_ids']}/{div['total_ids']} unique). The frozen "
        f"stage-1 model was rebuilt with different semantics than it was "
        f"trained with — check the vae_* config values."
    )


def repetition_rate(corpus_ids: np.ndarray):
    """(1 - unique/total over full ID tuples, unique, total)."""
    total = len(corpus_ids)
    if total == 0:
        return 0.0, 0, 0
    unique = len(np.unique(corpus_ids, axis=0))
    return 1.0 - unique / total, unique, total


def id_diversity_metrics(corpus_ids: np.ndarray, codebook_size: int, n_sem_layers: int,
                         sem_cols=None):
    """Entropy of the unique-tuple distribution, most duplicates of one
    tuple, per-level codebook usage over `sem_cols` (default the first
    n_sem_layers columns), repetition rate."""
    ids = np.asarray(corpus_ids)
    _, counts = np.unique(ids, axis=0, return_counts=True)
    probs = counts / counts.sum()
    entropy = float(-(probs * np.log(probs)).sum())
    max_dup = int(counts.max())
    if sem_cols is None:
        sem_cols = range(min(n_sem_layers, ids.shape[1]))
    usage = [float(len(np.unique(ids[:, l])) / codebook_size) for l in sem_cols]
    rep, unique, total = repetition_rate(ids)
    return {
        "rqvae_entropy": entropy,
        "max_id_duplicates": max_dup,
        "codebook_usage": usage,
        "repetition_rate": rep,
        "unique_ids": unique,
        "total_ids": total,
    }
