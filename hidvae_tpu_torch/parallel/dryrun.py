"""The port's multi-rank dry run (counterpart of
__graft_entry__.dryrun_multichip) and its rank launcher.

    python -m hidvae_tpu_torch.parallel.dryrun 4

spawns 4 Gloo CPU ranks on a (n/2, 2) mesh, runs a DP x TP step of the tiny
decoder and a DP step of the tiny HiD-VAE, holds every rank's losses to
one process's and prints `dryrun_multichip OK: ...`."""

import os
import re
import socket
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

FLAGSHIP = dict(k=64, d=3, attn=64, heads=4, layers=2, emb=32, max_pos=64)
TINY_HIDVAE = dict(input_dim=32, embed_dim=8, hidden_dims=(16,), codebook_size=16, n_layers=3,
                   n_cat_features=0, tag_class_counts=(4, 6, 8), tag_embed_dim=16)
HISTORY = 4    # items per history in the dry run's batch
LOSS_RTOL = 1e-5  # fp32: the ranks' sums differ from one process's in order only


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(argv: Sequence[str], world: int, timeout: float,
                 env: Optional[dict] = None, cwd: Optional[str] = None) -> list:
    """`argv` as `world` torchrun-style processes, a CPU thread each; their
    stdouts by rank. A timeout or failure kills all (RuntimeError)."""
    port = free_port()
    procs = []
    for rank in range(world):
        penv = dict(os.environ if env is None else env)
        penv.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                    MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(list(argv), env=penv, cwd=cwd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if outs is None:
        raise RuntimeError(f"{world} ranks of {list(argv)} did not end within {timeout} s")
    failed = [(r, p.returncode, err[-3000:]) for r, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks failed: {failed}")
    return [out for out, _ in outs]


def flagship_batch(b: int, k: int = FLAGSHIP["k"], d: int = FLAGSHIP["d"], n: int = HISTORY,
                   seed: int = 3):
    """A seeded batch of b histories of n items (some ragged) with targets."""
    from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch

    rng = np.random.RandomState(seed)
    sem_ids = rng.randint(0, k, (b, n * d))
    mask = np.arange(n * d)[None, :] < (d * rng.randint(1, n + 1, b))[:, None]
    ttids = np.tile(np.arange(d), (b, n))
    return TokenizedSeqBatch(
        user_ids=torch.from_numpy(rng.randint(0, 2000, b)),
        sem_ids=torch.from_numpy(np.where(mask, sem_ids, -1)),
        sem_ids_fut=torch.from_numpy(rng.randint(0, k, (b, d))),
        seq_mask=torch.from_numpy(mask),
        token_type_ids=torch.from_numpy(ttids),
        token_type_ids_fut=torch.from_numpy(np.tile(np.arange(d), (b, 1))),
    )


def flagship_step(mesh, batch_size: int, device="cpu") -> float:
    """One AdamW step of the seeded flagship decoder on `mesh` over a
    seeded global batch; returns the loss before the update, on every rank."""
    from hidvae_tpu_torch.models.init import init_params_
    from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
    from hidvae_tpu_torch.ops.dropout import RowShard
    from hidvae_tpu_torch.parallel.collectives import all_reduce_
    from hidvae_tpu_torch.parallel.mesh import shard_rows, shard_stage2_
    from hidvae_tpu_torch.train.common import Optimizer
    from hidvae_tpu_torch.train.transformer import train_step

    f = FLAGSHIP
    model = init_params_(EncoderDecoderRetrievalModel(
        f["emb"], f["attn"], f["heads"], f["layers"], f["k"], f["d"], max_pos=f["max_pos"],
        dropout=0.1), torch.Generator().manual_seed(0)).to(device)
    optimizer = Optimizer(model.parameters(), 1e-3, 0.01)
    shard_stage2_(model, mesh, optimizer)
    rows = shard_rows(batch_size, mesh)
    batch = flagship_batch(batch_size)
    batch = batch.replace(**{name: getattr(batch, name)[rows].to(device)
                             for name in batch.__dataclass_fields__})
    g = torch.Generator(device=device).manual_seed(2)
    loss, _ = train_step(model, optimizer, batch, RowShard(g, rows.start, batch_size), mesh)
    if rows.stop - rows.start < batch_size:
        loss = all_reduce_(loss.clone(), mesh.data_group) / mesh.n_data
    if not torch.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {float(loss)}")
    return float(loss)


def stage1_step(mesh, batch_size: int, device="cpu") -> float:
    """One AdamW step (lr 1e-3, decay 1e-4) of the seeded tiny HiD-VAE over
    the data ranks; the global loss before it, on every rank."""
    from hidvae_tpu_torch.models.hrqvae import HRqVae
    from hidvae_tpu_torch.models.init import init_params_
    from hidvae_tpu_torch.parallel.mesh import batch_rows, shard_rows
    from hidvae_tpu_torch.train.common import Optimizer
    from hidvae_tpu_torch.train.hidvae import make_train_step

    model = init_params_(HRqVae(**TINY_HIDVAE), torch.Generator().manual_seed(7)).to(device)
    optimizer = Optimizer(model.parameters(), 1e-3, 1e-4)
    rng = np.random.RandomState(5)
    t = TINY_HIDVAE
    x = torch.from_numpy(rng.randn(batch_size, t["input_dim"]).astype(np.float32))
    te = torch.from_numpy(rng.randn(batch_size, t["n_layers"], t["tag_embed_dim"])
                          .astype(np.float32))
    ti = torch.zeros((batch_size, t["n_layers"]), dtype=torch.int32)
    rows = shard_rows(batch_size, mesh)
    step = make_train_step(model, optimizer, None, 0.2)
    metrics = step(x[rows].to(device), te[rows].to(device), ti[rows].to(device),
                   torch.Generator(device=device).manual_seed(11), np.random.default_rng(11),
                   batch_rows(batch_size, mesh))
    loss = metrics["loss"]
    if not torch.isfinite(loss):
        raise FloatingPointError(f"non-finite stage-1 loss {float(loss)}")
    return float(loss)


def dryrun_multichip(n: int, timeout: float = 300.0) -> dict:
    """A stage-2 DP x TP and a stage-1 DP step on n Gloo ranks, each held to
    one process's. Returns {"mesh", "loss", "one_rank_loss", "stage1_loss",
    "stage1_one_rank_loss"}."""
    from hidvae_tpu_torch.parallel.mesh import make_mesh

    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // n_model
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    outs = launch_ranks([sys.executable, "-m", "hidvae_tpu_torch.parallel.dryrun", "--rank",
                         str(n_model)], n, timeout, env=env, cwd=repo)
    got = {}
    for stage, want in (("", flagship_step(make_mesh(), 2 * n_data)),
                        ("STAGE1_", stage1_step(make_mesh(), 2 * n))):
        losses = [float(re.search(rf"DRYRUN_{stage}LOSS (\S+)", out).group(1)) for out in outs]
        if len(set(losses)) != 1:
            raise AssertionError(f"the ranks' {stage or 'STAGE2_'}losses differ: {losses}")
        if abs(losses[0] - want) > LOSS_RTOL * abs(want):
            raise AssertionError(f"{stage or 'STAGE2_'}mesh loss {losses[0]} against one "
                                 f"process's {want}")
        got[stage] = (losses[0], want)
    mesh = {"data": n_data, "model": n_model}
    (s2, one2), (s1, one1) = got[""], got["STAGE1_"]
    print(f"dryrun_multichip OK: mesh={mesh} stage2_loss={s2:.4f} stage1_loss={s1:.4f} "
          f"(one process: {one2:.4f}, {one1:.4f})", flush=True)
    return {"mesh": mesh, "loss": s2, "one_rank_loss": one2, "stage1_loss": s1,
            "stage1_one_rank_loss": one1}


def _rank_main(n_model: int):
    from hidvae_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    try:
        mesh = make_mesh(n_model=n_model)
        print(f"DRYRUN_LOSS {flagship_step(mesh, 2 * mesh.n_data)!r}", flush=True)
        s1 = make_mesh()
        print(f"DRYRUN_STAGE1_LOSS {stage1_step(s1, 2 * s1.n_data)!r}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "--rank":
        _rank_main(int(sys.argv[2]))
    else:
        dryrun_multichip(int(sys.argv[1]))
