"""Ranks of the port's multi-rank tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_trainer.py).

`run(scenario, world, workdir)` starts `world` processes of this module
(hidvae_tpu_torch.parallel.dryrun.launch_ranks: the environment torchrun
gives its ranks, a timeout); each joins a Gloo process group on the CPU,
runs the scenario on the inputs the test saved in workdir/inputs.pt and
writes its results to workdir/rank<r>.npz. The functions that build a run
are shared with the tests, which call them on one process for the
reference. Imports nothing of JAX."""

import copy
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from hidvae_tpu_torch.bridge import flax_named_parameters, state_dict_to_flax
from hidvae_tpu_torch.ops.dropout import RowShard
from hidvae_tpu_torch.parallel.dryrun import launch_ranks
from hidvae_tpu_torch.parallel.mesh import gather_stage2_flat, make_mesh, shard_rows
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from hidvae_tpu_torch.train import transformer as trainer
from hidvae_tpu_torch.train.common import Optimizer, inverse_sqrt_schedule, restore_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300


def run(scenario: str, world: int, workdir: str) -> list:
    """The results of every rank, as {name: array} dicts in rank order."""
    env = dict(os.environ, PYTHONPATH=REPO)
    launch_ranks([sys.executable, "-m", "tests._torch_parallel_worker", scenario, workdir],
                 world, TIMEOUT_S, env=env, cwd=REPO)
    out = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


# ---- runs shared by the ranks and the one-process references ----

def tokenizers(inp, chunk=40):
    """The H and plain tokenizers of the saved stage-1 modules."""
    h = HSemanticIdTokenizer(copy.deepcopy(inp["vae_h"]), corpus_chunk_size=chunk,
                             device="cpu", **inp["tok_kw"])
    kw = inp["tok_kw"]
    plain = SemanticIdTokenizer(copy.deepcopy(inp["vae_plain"]), n_layers=kw["n_layers"],
                                codebook_size=kw["codebook_size"], corpus_chunk_size=chunk,
                                device="cpu")
    return h, plain


def engine(inp, mesh=None, shard_params=False):
    h, _ = tokenizers(inp)
    return RetrievalEngine(copy.deepcopy(inp["decoder"]), h, inp["feats"],
                           max_seq_len=inp["max_seq_len"], batch_buckets=inp["buckets"],
                           device="cpu", mesh=mesh, shard_params=shard_params)


def recommend(eng, inp) -> dict:
    out = eng.recommend(inp["hist"], top_k=10)
    return {"items": out["items"], "scores": out["scores"], "sem_ids": out["sem_ids"],
            "corpus": eng.corpus_ids.numpy()}


def whole_params(model, layout, mesh) -> dict:
    """The model's flax-named params, the model-sharded ones gathered."""
    return gather_stage2_flat(state_dict_to_flax(model)[0], layout, mesh, "cpu")


def whole_grads(model, layout, mesh) -> dict:
    flat = {}
    for path, p, transpose in flax_named_parameters(model):
        g = p.grad.detach().numpy()
        flat[path] = np.ascontiguousarray(g.T if transpose else g)
    return gather_stage2_flat(flat, layout, mesh, "cpu")


def arrays_run(inp, **kw) -> dict:
    """train_arrays on the saved arrays; the logged losses and the whole
    params."""
    a = inp["arrays"]
    args = dict(inp["arrays_kw"], device="cpu")
    args.update(kw)
    res = trainer.train_arrays(a["feats"], a["users"], a["items"], a["fut"],
                               vae=copy.deepcopy(a["vae"]), eval_users=a["users"][:12],
                               eval_items=a["items"][:12], eval_fut=a["fut"][:12], **args)
    h = res["history"]
    return {"loss": np.asarray(h["train_loss"]), "eval_loss": np.asarray(h["eval_loss"]),
            **{f"p/{k}": v for k, v in whole_params(res["model"], res["layout"],
                                                    res["mesh"]).items()}}


def fixed_step(inp, mesh, max_grad_norm=None, generator_seed=5, export=None) -> dict:
    """One AdamW update of the seeded decoder on the saved fixed batch
    (`export`: of the decoder restored from it, on the JAX run's batch), the
    batch's rows split over the data ranks and the dropout drawn from a
    seeded generator (none with `export`); the whole gradients (after the
    clip) and params."""
    c = inp["fixed" if export is None else "jax_fixed"]
    model = trainer.build_model(**c["model_kw"], dtype=torch.float32)
    opt = Optimizer(model.parameters(), inverse_sqrt_schedule(c["lr"], 3), 0.035,
                    max_grad_norm=max_grad_norm)
    if export is not None:
        restore_checkpoint(export, model, opt)
    layout = trainer._shard(model, opt, mesh)
    batch = c["batch"]
    n = batch.sem_ids.shape[0]
    rows = shard_rows(n, mesh)
    mine = batch.replace(**{k: getattr(batch, k)[rows] for k in batch.__dataclass_fields__})
    g = None if export is not None else RowShard(torch.Generator().manual_seed(generator_seed),
                                                 rows.start, n)
    trainer.train_step(model, opt, mine, g, mesh)
    return {**{f"g/{k}": v for k, v in whole_grads(model, layout, mesh).items()},
            **{f"p/{k}": v for k, v in whole_params(model, layout, mesh).items()}}


def disk_run(inp, tag, **kw) -> dict:
    """`train` on the saved on-disk dataset: losses, eval losses, the last
    full eval's and the TEST eval's metrics, the whole params, the saved
    paths."""
    args = dict(inp["disk_kw"], device="cpu", save_dir_root=os.path.join(inp["workdir"], tag))
    args.update(kw)
    res = trainer.train(**args)
    h = res["history"]
    metrics = {}
    for name, m in (("full", h["full_eval_metrics"][-1] if h["full_eval_metrics"] else {}),
                    ("test", h["test_eval_metrics"] or {})):
        metrics.update({f"{name}/{k}": np.float64(v) for k, v in m.items()})
    return {"loss": np.asarray(h["train_loss"]), "eval_loss": np.asarray(h["eval_loss"]),
            "saved": np.asarray(res["saved_paths"][-1] if res["saved_paths"] else ""),
            **metrics,
            **{f"p/{k}": v for k, v in whole_params(res["model"], res["layout"],
                                                    res["mesh"]).items()}}


def prefixed(prefix, d):
    return {f"{prefix}:{k}": v for k, v in d.items()}


# ---- scenarios ----

def serve(inp) -> dict:
    """World 2: the sharded sweep on both tokenizer routes, the engine at DP 2
    and at TP 2 with shard_params, and the stage-1 trainers' refusals."""
    from hidvae_tpu_torch.train import hidvae, rqvae

    mesh = make_mesh()
    h, plain = tokenizers(inp)
    out = {"table_h": h.precompute_corpus_ids(inp["feats"], mesh=mesh).numpy(),
           "table_plain": plain.precompute_corpus_ids(inp["feats"], mesh=mesh).numpy()}
    out.update(prefixed("dp", recommend(engine(inp, make_mesh(n_data=2)), inp)))
    tp = engine(inp, make_mesh(n_model=2), shard_params=True)
    out.update(prefixed("tp", recommend(tp, inp)))
    out.update({f"tp:shape/{k}": np.asarray(p.shape) for k, p in tp.model.named_parameters()})
    for name, fn in (("hidvae", hidvae.train), ("rqvae", rqvae.train)):
        try:
            fn(device="cpu")
            out[f"refusal_{name}"] = np.asarray("")
        except NotImplementedError as e:
            out[f"refusal_{name}"] = np.asarray(str(e))
    return out


def train_ranks(inp) -> dict:
    """World 4: DP 4, DP 2 x TP 2 and TP 4 runs of train_arrays (fp32,
    dropout on); DP 2 x TP 2 in bf16; a batch 4 does not divide; one fixed
    step with and without the clip; `train` with split_batches=False and
    evals; a TP 2 run that saves; a one-process checkpoint resumed at TP 2;
    the JAX TP checkpoint's next update."""
    out = {}
    for k in (1, 2, 4):
        out.update(prefixed(f"arrays_tp{k}", arrays_run(inp, n_model_shards=k)))
    out.update(prefixed("arrays_bf16", arrays_run(inp, n_model_shards=2,
                                                  mixed_precision_type="bf16")))
    out.update(prefixed("arrays_ragged", arrays_run(inp, batch_size=6)))
    mesh = make_mesh(n_model=2)
    out.update(prefixed("fixed", fixed_step(inp, mesh)))
    out.update(prefixed("fixed_clip", fixed_step(inp, mesh, max_grad_norm=0.05)))
    out.update(prefixed("split", disk_run(inp, "split", split_batches=False, n_model_shards=2,
                                          batch_size=inp["disk_kw"]["batch_size"] // 2)))
    out.update(prefixed("tp_save", disk_run(inp, "tp_save", n_model_shards=2, iterations=2,
                                            save_model_every=2)))
    out.update(prefixed("tp_resume", disk_run(inp, "tp_resume", n_model_shards=2, iterations=2,
                                              pretrained_decoder_path=inp["one_ckpt"])))
    if inp.get("jax_export"):
        out.update(prefixed("jax", fixed_step(inp, mesh, export=inp["jax_export"])))
    return out


SCENARIOS = {"serve": serve, "train": train_ranks}


def main():
    scenario, workdir = sys.argv[1:3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        out = SCENARIOS[scenario](inp)
        np.savez(os.path.join(workdir, f"rank{dist.get_rank()}.npz"), **out)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
