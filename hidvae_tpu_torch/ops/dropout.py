"""Dropout from an explicit generator (flax's nn.Dropout); from a
`RowShard` each site draws the global mask and keeps this rank's rows,
the one-device mask bit for bit."""

from typing import NamedTuple, Optional, Union

import torch


class RowShard(NamedTuple):
    """A step's dropout generator, and the rows [start, start + rows of the
    input) of the `total`-row global batch that this rank computes."""
    generator: torch.Generator
    start: int
    total: int


def uniform(shape, generator: Union[torch.Generator, RowShard], device, dtype=torch.float32):
    """U[0, 1) of `shape` from `generator`; from a RowShard, the global
    batch's draw (rows `total`) and this rank's shape[0] rows of it, from
    `start`."""
    if not isinstance(generator, RowShard):
        return torch.rand(shape, generator=generator, device=device, dtype=dtype)
    g, start, total = generator
    u = torch.rand((total, *shape[1:]), generator=g, device=device, dtype=dtype)
    return u[start:start + shape[0]]


def dropout(x, p: float, generator: Union[None, torch.Generator, RowShard],
            cols: Optional[tuple] = None):
    """Inverted dropout of `x` with rate `p`; the identity without a
    `generator`. `cols` = (start, total): x's last dimension is columns
    [start, start + width) of a `total`-wide one."""
    if generator is None or p == 0.0:
        return x
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} is not in [0, 1)")
    keep_prob = 1.0 - p
    shape = list(x.shape)
    if cols is not None:
        shape[-1] = cols[1]
    keep = uniform(shape, generator, x.device) < keep_prob
    if cols is not None:
        keep = keep[..., cols[0]:cols[0] + x.shape[-1]]
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
