"""Collectives of the multi-GPU paths: tensor-parallel autograd functions
(Megatron's f / g) and those coupling a batch split over the data ranks.
all_reduce, all_gather and broadcast only (Gloo and NCCL on CUDA); a None
group is the identity. `COLLECTIVE_BYTES` counts the bytes handed to each.
Partial products are all-reduced in fp32, rounded once. `all_gather_rows`
and `all_reduce_sum` backward "slice" (every rank computes the same term)
or "sum" (each for its own rows)."""

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.nn import functional as F

COLLECTIVE_BYTES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


class TensorShard(NamedTuple):
    """`dim` cut into `size` equal parts over the model `group`; this rank
    holds part `rank`."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    dim: int


def collective_bytes() -> int:
    return sum(COLLECTIVE_BYTES.values())


def _count(name: str, t: torch.Tensor, group):
    if dist.get_world_size(group) > 1:
        COLLECTIVE_BYTES[name] += t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place; returns `t`."""
    if group is not None:
        _count("all_reduce", t, group)
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The parts `t` of every rank of `group`, in rank order, concatenated
    along `dim` (every part must have the same shape)."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _count("all_gather", t, group)
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class Rows(NamedTuple):
    """A batch over the data ranks of `group`: rank r holds rows
    [bounds[r], bounds[r + 1]) of bounds[-1] (parts may differ, or be
    empty); this process is `rank`."""
    group: Optional[dist.ProcessGroup]
    rank: int
    bounds: tuple

    @classmethod
    def even(cls, group, rank: int, n_ranks: int, total: int) -> "Rows":
        """`total` rows cut into n_ranks contiguous parts, in rank order,
        whose sizes differ by at most one."""
        return cls(group, rank, tuple(r * total // n_ranks for r in range(n_ranks + 1)))

    @property
    def start(self) -> int:
        return self.bounds[self.rank]

    @property
    def stop(self) -> int:
        return self.bounds[self.rank + 1]

    @property
    def total(self) -> int:
        return self.bounds[-1]

    @property
    def sizes(self) -> list:
        return [b - a for a, b in zip(self.bounds, self.bounds[1:])]

    def head(self, k: int) -> "Rows":
        """The layout of the global rows [0, k); this rank's are its first ones."""
        return self._replace(bounds=tuple(min(b, k) for b in self.bounds))

    def after(self, k: int) -> "Rows":
        """The layout of the global rows [k, total), numbered from 0; this
        rank's are its last ones."""
        return self._replace(bounds=tuple(max(b - k, 0) for b in self.bounds))


def _gather_rows(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    sizes = rows.sizes
    width = max(sizes)
    x = x.contiguous()
    if x.shape[0] < width:  # all_gather takes parts of one shape
        x = torch.cat([x, x.new_zeros((width - x.shape[0], *x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in sizes]
    _count("all_gather", x, rows.group)
    dist.all_gather(parts, x, group=rows.group)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows: Rows, sum_backward: bool):
        ctx.rows, ctx.sum_backward = rows, sum_backward
        return _gather_rows(x, rows)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_backward:
            grad = all_reduce_(grad.contiguous().clone(), ctx.rows.group)
        return grad[ctx.rows.start:ctx.rows.stop], None, None


def all_gather_rows(x: torch.Tensor, rows: Optional[Rows], backward: Optional[str] = None):
    """The whole batch [rows.total, ...] from each rank's rows `x`;
    `backward` None, "slice" or "sum". Identity without a layout or group."""
    if rows is None or rows.group is None:
        return x
    if backward is None:
        return _gather_rows(x.detach(), rows)
    if backward not in ("slice", "sum"):
        raise ValueError(f"backward {backward!r} is not 'slice' or 'sum'")
    return _GatherRows.apply(x, rows, backward == "sum")


def broadcast_(t: torch.Tensor, group, src_rank: int = 0) -> torch.Tensor:
    """`t` of the group's rank `src_rank` on every rank, in place."""
    if group is not None:
        _count("broadcast", t, group)
        dist.broadcast(t, dist.get_global_rank(group, src_rank), group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """Sum over `group`; backward the identity (the same loss on every rank:
    Megatron's g) or summed (each rank uses it for its own rows)."""

    @staticmethod
    def forward(ctx, x, group, sum_backward: bool):
        ctx.group, ctx.sum_backward = group, sum_backward
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_backward:
            grad = all_reduce_(grad.contiguous().clone(), ctx.group)
        return grad, None, None


def all_reduce_sum(x, group, backward: str = "identity"):
    """`x` summed over `group`, with the gradient of `backward` ("identity"
    or "sum", see _AllReduce). Identity without a group."""
    if group is None:
        return x
    if backward not in ("identity", "sum"):
        raise ValueError(f"backward {backward!r} is not 'identity' or 'sum'")
    return _AllReduce.apply(x, group, backward == "sum")


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' parts concatenated along the last dimension;
    backward, this rank's part of the replicated gradient."""

    @staticmethod
    def forward(ctx, x, shard: TensorShard):
        ctx.shard, ctx.width = shard, x.shape[-1]
        return all_gather_cat(x, shard.group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.shard.rank * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


class _ColumnParallelLinear(torch.autograd.Function):
    """x W_localᵀ in `dtype`, W sharded by output features: forward is local;
    the input's gradient sums the model ranks' partials (fp32)."""

    @staticmethod
    def forward(ctx, x, w, group, dtype):
        xc, wc = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(xc, wc)
        ctx.group, ctx.x_dtype, ctx.w_dtype = group, x.dtype, w.dtype
        return F.linear(xc, wc)

    @staticmethod
    def backward(ctx, grad):
        xc, wc = ctx.saved_tensors
        dx = all_reduce_(torch.matmul(grad.float(), wc.float()), ctx.group)
        dw = torch.matmul(grad.reshape(-1, grad.shape[-1]).t(), xc.reshape(-1, xc.shape[-1]))
        return dx.to(wc.dtype).to(ctx.x_dtype), dw.to(ctx.w_dtype), None, None


class _RowParallelLinear(torch.autograd.Function):
    """x_local W_localᵀ, W sharded by input features: the model ranks'
    partials summed in fp32 and rounded to `dtype` once; backward is local."""

    @staticmethod
    def forward(ctx, x, w, group, dtype):
        xc, wc = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(xc, wc)
        ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype
        return all_reduce_(F.linear(xc.float(), wc.float()), group).to(dtype)

    @staticmethod
    def backward(ctx, grad):
        xc, wc = ctx.saved_tensors
        grad = grad.to(wc.dtype)
        dx = torch.matmul(grad, wc)
        dw = torch.matmul(grad.reshape(-1, grad.shape[-1]).t(), xc.reshape(-1, xc.shape[-1]))
        return dx.to(ctx.x_dtype), dw.to(ctx.w_dtype), None, None


def parallel_linear(x, weight, shard: TensorShard, dtype=None):
    """flax Dense on a weight sharded by `shard`: dim 0 gives this rank's
    output columns, dim 1 takes its input columns and gives the whole output."""
    dtype = x.dtype if dtype is None else dtype
    fn = _ColumnParallelLinear if shard.dim == 0 else _RowParallelLinear
    return fn.apply(x, weight, shard.group, dtype)


def reduce_from_model(x, group):
    return _AllReduce.apply(x, group, False)


def gather_from_model(x, shard: TensorShard):
    """Concatenate the model ranks' last-dimension parts (fp32 on the wire,
    lossless for bf16), in x's dtype."""
    return _GatherFromModel.apply(x.float(), shard).to(x.dtype)
