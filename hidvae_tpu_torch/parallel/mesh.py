"""A ('data', 'model') mesh over a process group (counterpart of
hidvae_tpu/parallel/mesh.py), rank r at (r // n_model, r % n_model), (1, 1)
without a group; row layouts over the data ranks; the stage-2 layout
(`stage2_param_shardings`: ID table and `out_proj` by vocab, FF `dense_0`
by output, other FF kernels by input)."""

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from hidvae_tpu_torch.bridge import flax_named_parameters
from hidvae_tpu_torch.parallel.collectives import Rows, TensorShard, all_gather_cat


@dataclass(frozen=True)
class Mesh:
    n_data: int
    n_model: int
    rank: int                                  # in the mesh's process group
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        """Rank 0 writes logs, checkpoints and plots."""
        return self.rank == 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, group=None) -> Mesh:
    """A ('data', 'model') mesh over `group` (default: the world group,
    or one device). Every rank of the group must sit on the mesh."""
    if dist.is_available() and dist.is_initialized():
        ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
        rank = dist.get_rank(group)
    else:
        ranks, rank = [0], 0
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data < 1:
        raise ValueError(f"n_model={n_model} needs at least {n_model} devices, "
                         f"have {len(ranks)}")
    if n_data * n_model > len(ranks):
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
                         f"have {len(ranks)}")
    if n_data * n_model != len(ranks):
        raise ValueError(f"mesh {n_data}x{n_model} leaves ranks of the {len(ranks)}-rank "
                         f"process group off the mesh")
    if not dist.is_initialized():
        return Mesh(1, 1, 0)
    data_group = model_group = None
    # Every rank creates every group, in the same order (new_group's rule).
    for m in range(n_model):
        g = dist.new_group([ranks[d * n_model + m] for d in range(n_data)])
        if m == rank % n_model:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([ranks[d * n_model + m] for m in range(n_model)])
        if d == rank // n_model:
            model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


def init_from_env() -> torch.device:
    """Join torchrun's process group over NCCL on cuda:LOCAL_RANK and make
    that device current (raising when it does not exist). Returns the device."""
    local = int(os.environ["LOCAL_RANK"])
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= n_cards:
        raise RuntimeError(f"LOCAL_RANK {local} has no CUDA device ({n_cards} visible): "
                           f"start at most one rank per card")
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), device_id=device)
    return device


@contextlib.contextmanager
def torchrun_group(device=None):
    """Under torchrun, join its group for the block (Gloo for "cpu", else
    NCCL) and yield the device; outside torchrun yield `device`."""
    if "RANK" not in os.environ or "LOCAL_RANK" not in os.environ:
        yield device
        return
    if device == "cpu":
        dist.init_process_group("gloo")
    else:
        device = init_from_env()
    try:
        yield device
    finally:
        dist.destroy_process_group()


def pad_to_multiple(t: torch.Tensor, multiple: int):
    """`t` with its leading axis zero-padded to a multiple of `multiple`, and
    the original size."""
    n = t.shape[0]
    pad = (-n) % multiple
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    return t, n


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This data rank's rows of n: an equal contiguous part when n_data
    divides n, else all (JAX replicates such a batch)."""
    if n % mesh.n_data:
        return slice(0, n)
    part = n // mesh.n_data
    return slice(mesh.data_rank * part, (mesh.data_rank + 1) * part)


def gather_rows(t: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The whole n-row batch from each data rank's `shard_rows` part."""
    return t if n % mesh.n_data else all_gather_cat(t, mesh.data_group)


def batch_rows(n: int, mesh: Mesh) -> Optional[Rows]:
    """The layout of an n-row batch whose `shard_rows` part this rank
    computes, or None when every data rank computes all of it."""
    if mesh.n_data == 1 or n % mesh.n_data:
        return None
    return Rows.even(mesh.data_group, mesh.data_rank, mesh.n_data, n)


# ---- the stage-2 tensor-parallel layout ----

def _model_axis(path: str) -> Optional[int]:
    """stage2_param_shardings' spec of one flax leaf, as the index of its
    'model' axis (None: replicated), before the fallback of `ok()`."""
    names = path.split("/")
    axis = None
    if "sem_id_embedder" in names and names[-1] == "embedding":
        axis = 0                                      # P("model", None)
    elif "out_proj" in names and names[-1] == "kernel":
        axis = 1                                      # P(None, "model")
    elif "ff" in names and names[-1] == "kernel":
        axis = 1 if "dense_0" in names else 0
    return axis


def stage2_param_layout(mesh: Mesh, model: torch.nn.Module) -> Dict[str, Optional[int]]:
    """{flax path: torch dim cut over 'model', or None} of every stage-2
    parameter, as stage2_param_shardings lays them out."""
    out = {}
    for path, p, transpose in flax_named_parameters(model):
        shape = tuple(p.shape[::-1]) if transpose else tuple(p.shape)
        axis = _model_axis(path)
        if axis is not None and shape[axis] % mesh.n_model != 0:
            axis = None
        out[path] = None if axis is None else (1 - axis if transpose else axis)
    return out


def _part(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model_rank * n, n).clone()


def shard_stage2_(model: torch.nn.Module, mesh: Mesh, optimizer=None) -> Dict[str, Optional[int]]:
    """Cut `model`'s sharded parameters (and AdamW moments) to this rank's
    parts in place, each owner marked `.tp`. Returns the layout."""
    layout = stage2_param_layout(mesh, model)
    if mesh.n_model == 1:
        return layout
    owners = {}
    for name, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            owners[id(p)] = module
    for path, p, _ in flax_named_parameters(model):
        dim = layout[path]
        if dim is None:
            continue
        with torch.no_grad():
            p.data = _part(p.data, dim, mesh)
        if optimizer is not None:
            state = optimizer.adamw.state.get(p, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key] = _part(state[key], dim, mesh)
        owners[id(p)].tp = TensorShard(mesh.model_group, mesh.model_rank, mesh.n_model, dim)
    return layout


def sharded_params(model: torch.nn.Module):
    """The parameters that `shard_stage2_` cut."""
    return [p for m in model.modules() if getattr(m, "tp", None) is not None
            for p in m.parameters(recurse=False)]


def gather_stage2_flat(flat: Dict[str, np.ndarray], layout: Dict[str, Optional[int]],
                       mesh: Mesh, device) -> Dict[str, np.ndarray]:
    """Whole arrays from this rank's parts: each entry of `flat` whose
    flax path the layout cuts is gathered over 'model' (a collective)."""
    if mesh.n_model == 1:
        return flat
    out = {}
    for key, arr in flat.items():
        path = next((p for p in layout if key == p or key.endswith("/" + p)), None)
        dim = None if path is None else layout[path]
        if dim is None or np.ndim(arr) == 0:
            out[key] = arr
            continue
        flax_dim = 1 - dim if path.endswith("kernel") else dim
        part = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        out[key] = all_gather_cat(part, mesh.model_group, dim=flax_dim).cpu().numpy()
    return out
