"""Training commons of the stage-2 trainer (counterpart of part of
hidvae_tpu/train/common.py): the inverse-sqrt schedule and the plain branch
of `make_optimizer`, AdamW with an optional global-norm clip first.

The JAX optimizer is `optax.adamw(schedule, weight_decay)` (b1 0.9, b2
0.999, eps 1e-8, decay on every parameter), optionally after
`optax.clip_by_global_norm`. optax evaluates the schedule at the number of
updates already applied, so update t (0-based) uses schedule(t); `Optimizer`
sets that rate on torch.optim.AdamW before each step, whose update rule is
optax's (decoupled decay lr * wd * p, bias-corrected moments, eps added to
the root).

Not ported yet: the cosine and step schedules, the plateau scale,
gradient accumulation and the tag-head parameter groups (stage 1)."""

import math
from typing import Callable, Iterable, Optional

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
