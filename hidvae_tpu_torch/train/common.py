"""Training commons (counterpart of hidvae_tpu/train/common.py): schedules,
the plateau controller, the optimizer, the chunked loop of all three
trainers, checkpoints, the corpus audit, gradient reduction. `Optimizer`
is optax's adamw (0.9, 0.999, 1e-8) per group after the clip, then the plateau scale, inside
MultiSteps, its state named as flax names optax's (JAX runs resume here
and back)."""

import contextlib
import enum
import json
import logging
import math
import os
import time
from collections import deque
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from hidvae_tpu_torch.bridge import flax_named_parameters
from hidvae_tpu_torch.parallel.collectives import all_reduce_, broadcast_, collective_bytes
from hidvae_tpu_torch.utils.debug import span

STEP_SALT = 0x5EED  # the JAX trainers' fold_in constant for per-step keys
LOSS_WINDOW = 1000  # per-step losses in the window mean (transformer.py:576, hidvae.py:667)
GUMBEL_T = 0.2      # fixed by the reference stage-1 trainers (hidvae.py:555)


def reduce_gradients_(params, group, divide_by: int = 1):
    """`params`' gradients summed over `group` (divided by `divide_by`) in
    place, one all-reduce; parameters without one left out."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    if divide_by != 1:
        flat.div_(divide_by)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def run_stamp(mesh, device) -> str:
    """A run directory's time stamp: rank 0's clock, on every rank."""
    from datetime import datetime

    stamp = torch.tensor([int(datetime.now().strftime("%Y%m%d%H%M%S"))], device=device)
    if mesh.n_data * mesh.n_model > 1:
        broadcast_(stamp, torch.distributed.group.WORLD)
    s = str(int(stamp))
    return f"{s[:8]}_{s[8:]}"


def global_batch(batch_size: int, split_batches: bool, mesh, log) -> int:
    """The global batch, logged where it differs: under Accelerate's
    split_batches=False `batch_size` is per data shard (hidvae.py:548-552)."""
    if split_batches or mesh.n_data == 1:
        return batch_size
    log.info(f"split_batches=False: global batch = {batch_size * mesh.n_data} "
             f"({mesh.n_data} data shards)")
    return batch_size * mesh.n_data


def local_rows(batch, rows: slice):
    """A sampled batch's tensors (None stays None) cut to `rows`."""
    return tuple(None if t is None else t[rows] for t in batch)


def kmeans_init_(model, item_features, n_items, seed, device, mesh):
    """k-means codebooks from the first min(20,000, N) items (hidvae.py:523-532,
    rqvae.py:157-162), run on rank 0 and broadcast to every data rank."""
    from hidvae_tpu_torch.train.init import kmeans_init_codebooks

    if mesh.is_main:
        init_x = torch.from_numpy(item_features[:min(20_000, n_items)]).to(device)
        kmeans_init_codebooks(model, init_x, torch.Generator(device).manual_seed(seed))
    for layer in model.layers:
        broadcast_(layer.embedding.data, mesh.data_group)


def save_on_main(mesh, save_dir, name, save):
    """`save()` on rank 0; every rank gets the checkpoint's path."""
    return save() if mesh.is_main else os.path.abspath(os.path.join(save_dir, name))


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int) -> Callable[[int], float]:
    """Flat at base_lr through `warmup_steps`, then base_lr * sqrt(warmup /
    step) (common.py:50-62); step is taken as at least 1."""

    def schedule(step: int) -> float:
        step = max(int(step), 1)
        return base_lr if step <= warmup_steps else base_lr * math.sqrt(warmup_steps / step)

    return schedule


def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float,
                         parts: Iterable[torch.Tensor] = (), group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place; `parts` (cut over the model
    ranks of `group`) sum their squares over it. Returns the global norm."""
    grads = [g for g in grads if g is not None]
    parts = [g for g in parts if g is not None]
    sq = sum(torch.sum(g.float() * g.float()) for g in grads)
    if parts:
        sq = sq + all_reduce_(sum(torch.sum(g.float() * g.float()) for g in parts), group)
    norm = torch.sqrt(sq)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads + parts:
        g.mul_(scale.to(g.dtype))
    return norm


def make_lr_schedule(learning_rate: float, use_lr_scheduler: bool = False,
                     lr_scheduler_type: str = "cosine", lr_scheduler_T_max: int = 400_000,
                     lr_scheduler_eta_min: float = 1e-7, lr_scheduler_step_size: int = 100_000,
                     lr_scheduler_gamma: float = 0.5):
    """The stage-1 schedule of the update count (common.py:66-105):
    cosine or step; a constant float for reduce_on_plateau and unknown types."""
    if not use_lr_scheduler or lr_scheduler_type not in ("cosine", "step"):
        return learning_rate
    if lr_scheduler_type == "cosine":
        def schedule(step: int) -> float:
            t = min(int(step), lr_scheduler_T_max)
            cos = 0.5 * (1.0 + math.cos(math.pi * t / lr_scheduler_T_max))
            return lr_scheduler_eta_min + (learning_rate - lr_scheduler_eta_min) * cos
        return schedule

    def schedule(step: int) -> float:
        return learning_rate * lr_scheduler_gamma ** (int(step) // lr_scheduler_step_size)
    return schedule


class ReduceLROnPlateau:
    """ReduceLROnPlateau (mode min) as a host LR-scale controller
    (common.py:167-219); its counters ride in the checkpoint's meta."""

    def __init__(self, factor: float = 0.5, patience: int = 10, threshold: float = 1e-4,
                 cooldown: int = 0, min_scale: float = 0.0, init_scale: float = 1.0):
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.cooldown = int(cooldown)
        self.min_scale = float(min_scale)
        self.scale = float(init_scale)
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0

    def step(self, value: float) -> float:
        value = float(value)
        if self.best is None or value < self.best * (1.0 - self.threshold):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.scale

    def state_dict(self) -> dict:
        return {"scale": self.scale, "best": self.best, "num_bad": self.num_bad,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, state: dict):
        self.scale = float(state["scale"])
        self.best = None if state["best"] is None else float(state["best"])
        self.num_bad = int(state["num_bad"])
        self.cooldown_counter = int(state["cooldown_counter"])


class Optimizer:
    """AdamW under a schedule of the update count (common.py:222-271):
    `groups` [(label, params, lr scale, weight decay)] under multi_transform;
    `max_grad_norm` clips first; `plateau` scales every update;
    `accumulate_every` k: MultiSteps' running mean, an update per k.
    `count`: the updates applied."""

    def __init__(self, params, schedule, weight_decay: float,
                 max_grad_norm: Optional[float] = None, *, groups=None,
                 accumulate_every: int = 1, plateau: bool = False):
        if groups is None:
            self.labels = None
            groups = [(None, params, 1.0, weight_decay)]
        else:
            self.labels = [g[0] for g in groups]
        self.groups = [(label, [p for p in ps if p.requires_grad], scale, wd)
                       for label, ps, scale, wd in groups]
        self.params = [p for _, ps, _, _ in self.groups for p in ps]
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.accumulate_every = int(accumulate_every)
        self.plateau = plateau
        self.plateau_scale = 1.0
        self.count = 0      # updates applied so far, optax's schedule count
        self.mini_step = 0  # mini-steps accumulated since the last update
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accumulate_every > 1 else None)
        # (ids of the parameters cut over the model ranks, their group): the
        # clip's global norm sums their squares over the group.
        self.model_parts = None
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "weight_decay": wd, "lr_scale": scale}
             for _, ps, scale, wd in self.groups if ps],
            lr=self._lr(0), betas=(0.9, 0.999), eps=1e-8)

    def _lr(self, count: int) -> float:
        base = self.schedule(count) if callable(self.schedule) else self.schedule
        return base * self.plateau_scale

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """One mini-step from the parameters' .grad; returns whether the
        parameters were updated."""
        if self.acc is not None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
            if self.mini_step == 0:  # 0 + (g - 0) / 1 is g exactly
                torch._foreach_copy_(self.acc, grads)
            else:  # the grads are not read again: (g - acc) / (n + 1) in place
                torch._foreach_sub_(grads, self.acc)
                torch._foreach_div_(grads, float(self.mini_step + 1))
                torch._foreach_add_(self.acc, grads)
            if self.mini_step < self.accumulate_every - 1:
                self.mini_step += 1
                return False
            for p, a in zip(self.params, self.acc):
                p.grad = a  # the accumulator is overwritten at the next mini-step 0
            self.mini_step = 0
        if self.max_grad_norm is not None:
            cut, group = self.model_parts or ((), None)
            clip_by_global_norm_([p.grad for p in self.params if id(p) not in cut],
                                 self.max_grad_norm,
                                 [p.grad for p in self.params if id(p) in cut], group)
        lr = self._lr(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.adamw.step()
        self.count += 1
        return True

    def _named(self, module):
        """(flax path, param, transposed) of the optimizer's params, in module order."""
        ours = {id(p) for p in self.params}
        return [(path, p, t) for path, p, t in flax_named_parameters(module) if id(p) in ours]

    def _adam_prefixes(self):
        """(state-name prefix of each group's adamw chain, its params)."""
        inner = "1/" if self.max_grad_norm is not None else ""  # chain(clip, tx)
        if self.plateau:
            inner = "0/" + inner                                # chain(tx, plateau)
        if self.accumulate_every > 1:
            inner = "inner_opt_state/" + inner                  # MultiSteps
        if self.labels is None:
            return [(inner, self.groups[0][1])]
        return [(f"{inner}inner_states/{label}/inner_state/", ps)
                for label, ps, _, _ in self.groups]

    def count_key(self) -> str:
        """The name of the first adamw's count, present in every state."""
        return self._adam_prefixes()[0][0] + "0/count"

    def state_dict(self, module: torch.nn.Module) -> dict:
        """Flat numpy arrays under flax's names of the optax state
        ("0/mu/<flax path>", "0/count", the multi_transform, clip, plateau
        and MultiSteps prefixes); zero moments for a parameter not updated."""
        count = np.asarray(self.count, np.int32)
        named = self._named(module)
        out = {}
        for prefix, ps in self._adam_prefixes():
            out[f"{prefix}0/count"] = count.copy()
            mine = {id(p) for p in ps}
            for path, p, transpose in named:
                if id(p) not in mine:
                    continue
                state = self.adamw.state.get(p, {})
                for key, name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                    t = state.get(key)
                    arr = (np.zeros(tuple(p.shape), np.float32) if t is None
                           else t.detach().cpu().numpy())
                    out[f"{prefix}0/{name}/{path}"] = np.ascontiguousarray(
                        arr.T if transpose else arr)
            if callable(self.schedule):
                out[f"{prefix}2/count"] = count.copy()
        if self.plateau:
            pre = "inner_opt_state/" if self.accumulate_every > 1 else ""
            out[f"{pre}1/scale"] = np.asarray(self.plateau_scale, np.float32)
        if self.acc is not None:
            out["mini_step"] = np.asarray(self.mini_step, np.int32)
            out["gradient_step"] = count.copy()
            acc = {id(p): a for p, a in zip(self.params, self.acc)}
            for path, p, transpose in named:
                arr = (acc[id(p)].detach().cpu().numpy() if self.mini_step
                       else np.zeros(tuple(p.shape), np.float32))  # optax zeroes it on update
                out[f"acc_grads/{path}"] = np.ascontiguousarray(arr.T if transpose else arr)
        return out

    def load_state_dict(self, module: torch.nn.Module, state: dict) -> list:
        """Load a `state_dict` (counts, accumulator, plateau scale, each
        parameter's moments on its device); a parameter whose moments are
        missing or misshapen stays fresh. Returns their flax paths."""
        def tensor(arr, p, transpose):
            arr = arr.T if transpose else arr
            return torch.from_numpy(np.ascontiguousarray(arr)).to(p.device, p.dtype)

        named = self._named(module)
        missing = []
        for prefix, ps in self._adam_prefixes():
            adam_count = int(state[f"{prefix}0/count"])
            mine = {id(p) for p in ps}
            for path, p, transpose in named:
                if id(p) not in mine:
                    continue
                moments = [state.get(f"{prefix}0/{name}/{path}") for name in ("mu", "nu")]
                if any(m is None or tuple(m.T.shape if transpose else m.shape) != tuple(p.shape)
                       for m in moments):
                    missing.append(path)
                    self.adamw.state.pop(p, None)
                    continue
                # torch's AdamW keeps its bias-correction step as a CPU float.
                self.adamw.state[p] = {"step": torch.tensor(float(adam_count)),
                                       "exp_avg": tensor(moments[0], p, transpose),
                                       "exp_avg_sq": tensor(moments[1], p, transpose)}
            self.count = int(state.get(f"{prefix}2/count", adam_count))
        if self.plateau:
            pre = "inner_opt_state/" if self.accumulate_every > 1 else ""
            self.plateau_scale = float(state.get(f"{pre}1/scale", 1.0))
        if self.acc is not None:
            self.mini_step = int(state.get("mini_step", 0))
            self.count = int(state.get("gradient_step", self.count))
            acc = []
            for path, p, transpose in named:
                arr = state.get(f"acc_grads/{path}")
                acc.append(torch.zeros_like(p) if arr is None else tensor(arr, p, transpose))
            self.acc = acc
        return missing


def make_optimizer(module: torch.nn.Module, schedule, weight_decay: float, *,
                   gradient_accumulate_every: int = 1, layer_specific_lr: bool = False,
                   predictor_weight_decay: float = 0.02, n_layers: int = 3,
                   max_grad_norm: Optional[float] = None, plateau: bool = False) -> Optimizer:
    """`module`'s optimizer (common.py:222-271): with `layer_specific_lr`,
    tag_predictor_i and tag_projector_i form group head_i (LR x (1 + 0.1 i),
    decay predictor_weight_decay / (1 + 0.2 i)), the rest group base."""
    if not layer_specific_lr:
        return Optimizer(module.parameters(), schedule, weight_decay, max_grad_norm,
                         accumulate_every=gradient_accumulate_every, plateau=plateau)
    by_label = {"base": []}
    by_label.update({f"head_{i}": [] for i in range(n_layers)})
    for path, p, _ in flax_named_parameters(module):
        top = path.split("/")[0]
        label = "base"
        for i in range(n_layers):
            if top in (f"tag_predictor_{i}", f"tag_projector_{i}"):
                label = f"head_{i}"
        by_label[label].append(p)
    groups = [("base", by_label["base"], 1.0, weight_decay)]
    groups += [(f"head_{i}", by_label[f"head_{i}"], 1.0 + i * 0.1,
                predictor_weight_decay / (1 + i * 0.2)) for i in range(n_layers)]
    return Optimizer(None, schedule, weight_decay, max_grad_norm, groups=groups,
                     accumulate_every=gradient_accumulate_every, plateau=plateau)


def chunk_events(start_iter: int, n_steps: int, cadences: Sequence[int], log_every: int):
    """The JAX chunked loop (transformer.py:536-613; hidvae.py:634-710):
    chunks of max(1, min(log_every, *cadences, n_steps)) steps, yielding
    (first, end, cadences crossed; all at the end)."""
    chunk = max(1, min([log_every, *cadences, n_steps]))
    end = start_iter + n_steps
    it = start_iter
    while it < end:
        first, it = it, min(it + chunk, end)
        fired = tuple(i for i, every in enumerate(cadences)
                      if first // every != it // every or it == end)
        yield first, it, fired


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one training step: a function of (seed, step) only,
    so a step's sample, crop and dropout draws do not depend on history."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0x7FFFFFFF) << 32 | STEP_SALT << 16) ^ (step & 0xFFFFFFFF))
    return g


def sync(device):
    """Wait for `device`'s work (a no-op off CUDA)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_chunks(step, readback, *, device, start_iter: int, n_steps: int, log_every: int,
               loss_key: str, events=(), log=None) -> dict:
    """The trainers' loop: steps start_iter .. + n_steps - 1 in the JAX
    chunks. `step(it)` returns (loss, extra), device tensors, not synced. At
    a chunk's end `readback(end, losses, extra)` reads the chunk's losses
    (fp32) and the last step's extra back to the host, records the
    trainer's history and returns (the losses as floats, `tail`); the loop
    logs the window mean and `tail(ms per step, seconds since the first
    step)`, runs each (every, fn) of `events` whose cadence the chunk
    crosses, then syncs, keeping their time out of ms per step. Spans: a
    root `train.step` a step, `train.readback` in a chunk's last. Returns
    iterations, each chunk's last loss under `loss_key`, ms_per_step,
    window_mean and collective_bytes_per_step."""
    log = log or (lambda line: None)
    history = {"iterations": [], loss_key: [], "ms_per_step": []}
    moved = 0
    window = deque(maxlen=LOSS_WINDOW)
    sync(device)
    t_start = t_last = time.perf_counter()
    it_last = start_iter
    for first, done, fired in chunk_events(start_iter, n_steps, [every for every, _ in events],
                                           log_every):
        losses = []
        moved -= collective_bytes()
        for it in range(first, done):
            with span("train.step", device=device, step=it):
                loss, extra = step(it)
                losses.append(loss)
                if it < done - 1:
                    continue
                with span("train.readback"):
                    values, tail = readback(done, torch.stack(losses).float(), extra)
                    moved += collective_bytes()
                    now = time.perf_counter()
                    ms = (now - t_last) * 1e3 / (done - it_last)
                    if not math.isfinite(values[-1]):
                        raise FloatingPointError(
                            f"non-finite loss {values[-1]} at iteration {done - 1}")
                    window.extend(values)
                    history["iterations"].append(done - 1)
                    history[loss_key].append(values[-1])
                    history["ms_per_step"].append(ms)
                    log(f"iter {done - 1}: loss={values[-1]:.4f} (window mean "
                        f"{np.mean(window):.4f}) {tail(ms, now - t_start)}")
                    for i in fired:
                        events[i][1](done)
                    if fired:
                        sync(device)
                    t_last, it_last = time.perf_counter(), done
    history["window_mean"] = float(np.mean(window)) if window else None
    # A resumed run too runs n_steps steps (start_iter .. + n_steps - 1).
    history["collective_bytes_per_step"] = moved / max(n_steps, 1)
    return history


# ---------------- checkpoints ----------------

META_KEYS = ("model_config", "metrics", "plateau")  # the payload keys meta.json holds


def save_checkpoint(save_dir: str, name: str, payload: dict) -> str:
    """`payload` as the export `save_dir/name` (common.py:274-303): arrays
    under their payload key, scalars 0-d, META_KEYS in meta.json. Returns
    its path."""
    from hidvae_tpu_torch.bridge import write_export

    path = os.path.abspath(os.path.join(save_dir, name))
    arrays = {}
    for key, value in payload.items():
        if key in META_KEYS:
            continue
        if isinstance(value, dict):
            arrays.update({f"{key}/{k}": np.asarray(v) for k, v in value.items()})
        else:
            arrays[key] = np.asarray(value, np.int32 if key == "step" else None)
    meta = {k: payload[k] for k in META_KEYS if k in payload}
    return write_export(path, arrays, meta or None)


def restore_checkpoint(path: str, module: torch.nn.Module,
                       optimizer: Optional[Optimizer] = None) -> tuple:
    """A stage-2 checkpoint into `module` (as `restore_export`) and
    `optimizer` (transformer.py:400-414), which stays fresh, with a warning,
    where the export has no state. Returns (step, meta)."""
    from hidvae_tpu_torch.bridge import load_export_arrays

    log = logging.getLogger("hidvae_tpu_torch.checkpoint")
    meta = restore_export(path, module)
    arrays = load_export_arrays(path, "opt_state/")
    if optimizer is not None:
        state = {k.removeprefix("opt_state/"): v for k, v in arrays.items()}
        if optimizer.count_key() not in state:
            log.warning(f"checkpoint {path} holds no optimizer state of this optimizer; "
                        f"keeping the initialized AdamW state")
        else:
            for leaf in optimizer.load_state_dict(module, state):
                log.warning(f"checkpoint missing opt_state moments of {leaf}; keeping "
                            f"initialized value")
    step = load_export_arrays(path, "step").get("step")
    return (0 if step is None else int(step)), meta


def restore_export(path: str, module: torch.nn.Module, *,
                   mismatch_tolerance: float = 0.1) -> dict:
    """An export into `module` leniently (common.py:306-407): a missing or
    misshapen leaf keeps its value, warned; over max(mismatch_tolerance *
    leaves, 8) raise ValueError. Returns the meta."""
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


# ---------------- run logging ----------------


@contextlib.contextmanager
def run_logging(save_dir: str):
    """A run's logging (hidvae_tpu/train/hidvae.py:56): inside the block
    `save_dir/train.log` gets every root record, the console the package's;
    the file handler goes at the end, so runs keep separate logs."""
    os.makedirs(save_dir, exist_ok=True)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    root = logging.getLogger()
    file_handler = logging.FileHandler(os.path.join(save_dir, "train.log"))
    file_handler.setFormatter(fmt)
    root.addHandler(file_handler)
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler) for h in root.handlers):
        console = logging.StreamHandler()
        console.setFormatter(fmt)
        console.addFilter(lambda r: r.name.startswith("hidvae_tpu_torch"))
        root.addHandler(console)
    root.setLevel(logging.INFO)
    try:
        yield
    finally:
        root.removeHandler(file_handler)
        file_handler.close()


def log_operative_config(logger, values: dict):
    """Every bound scalar, string, sequence, None or enum argument on one
    sorted line of train.log (common.py:410)."""
    items = []
    for k in sorted(values):
        if k.startswith("_"):
            continue
        v = values[k]
        if isinstance(v, (bool, int, float, str, list, tuple, type(None), enum.Enum)):
            items.append(f"{k}={v!r}")
    logger.info("operative config: " + " ".join(items))


# ---------------- structural model config ----------------

# Stage-1 fields that change forward semantics or shapes; a frozen tokenizer
# takes its checkpoint's (a wrong codebook_normalize restores leniently but
# skews every distance, collapsing the corpus table).
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


def structural_model_config(model) -> dict:
    """The STRUCTURAL_VAE_KEYS values of an RqVae / HRqVae as JSON values
    (common.py:446), saved in every stage-1 checkpoint's meta."""
    cfg = {}
    for key in STRUCTURAL_VAE_KEYS:
        if not hasattr(model, key):
            continue
        v = getattr(model, key)
        if isinstance(v, (tuple, list)):
            v = [int(x) for x in v]
        elif isinstance(v, np.integer):
            v = int(v)
        cfg[key] = v
    return cfg


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
    """The checkpoint's structural config over the requested one, each
    difference logged; legacy strings ("768", "true") normalized first."""
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


def reconcile_decoder_geometry(path: str, sem_id_dim: int, *, decoder_embed_dim: int,
                               attn_embed_dim: int, attn_heads: int, attn_layers: int,
                               logger=None) -> dict:
    """The decoder export's widths over the requested ones, as
    `reconcile_vae_config` (other heads keep every shape and drift in
    meaning); an export trained on another sem_id_dim than the frozen
    tokenizer's is refused (ValueError)."""
    rec = reconcile_vae_config(path, {"decoder_embed_dim": decoder_embed_dim,
                                      "attn_embed_dim": attn_embed_dim,
                                      "attn_heads": attn_heads, "attn_layers": attn_layers},
                               logger)
    saved_d = (load_checkpoint_model_config(path) or {}).get("sem_id_dim")
    if saved_d is not None and int(saved_d) != int(sem_id_dim):
        raise ValueError(
            f"decoder checkpoint {path} was trained with sem_id_dim={saved_d} but the frozen "
            f"tokenizer produces {sem_id_dim} — the stage-1 checkpoint / ID-layout flags do "
            f"not match the one this decoder was trained against."
        )
    return rec


# ---------------- corpus audit ----------------


def tokenizer_sem_cols(tokenizer):
    """The semantic digits' columns of a corpus table ([0, 2, 4, ...]
    interleaved, else the first n_layers): a collapse audit drops the tag
    and dedup columns, which vary per item even in a collapsed index."""
    d = tokenizer.sem_ids_dim
    if getattr(tokenizer, "use_interleaved_ids", False):
        return [2 * i for i in range(tokenizer.n_layers) if 2 * i < d]
    return list(range(min(tokenizer.n_layers, d)))


def audit_rebuilt_corpus(tokenizer, corpus_ids, stage1_checkpoint, log=None):
    """A rebuilt table's diversity, guarded against the stage-1 export's
    repetition rate (RuntimeError). Returns (div_full, div_sem)."""
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
    """An error when a rebuilt table's diversity contradicts the recorded
    repetition rate (under 0.1 recorded, over 0.5 rebuilt), else None."""
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
    """Unique-tuple entropy, most duplicates of a tuple, codebook usage per
    `sem_cols` level (default the first n_sem_layers), repetition rate."""
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
