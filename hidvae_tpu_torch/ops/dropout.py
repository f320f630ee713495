"""Dropout drawn from an explicit generator (counterpart of flax's
nn.Dropout as the JAX package uses it).

`torch.nn.functional.dropout` draws from the global generator and takes no
`generator` argument; the trainer derives one generator per step from
(seed, step), as the JAX trainer folds the step into its key, so the keep
mask is drawn here. As in flax: keep with probability 1 - p and scale the
kept values by 1 / (1 - p)."""

from typing import Optional

import torch


def dropout(x, p: float, generator: Optional[torch.Generator]):
    """Inverted dropout of `x` with rate `p`; the identity when `generator`
    is None (eval mode) or p == 0. The generator must live on x's device."""
    if generator is None or p == 0.0:
        return x
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} is not in [0, 1)")
    keep_prob = 1.0 - p
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
