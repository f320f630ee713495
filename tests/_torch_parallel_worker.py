"""Ranks of the multi-rank tests: `run(scenario, world, workdir)` starts
`world` processes of this module (dryrun.launch_ranks, a timeout); each
joins a Gloo group on the CPU, runs the scenario on workdir/inputs.pt and
writes workdir/rank<r>.npz. No JAX.
"""

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
    """One AdamW update of the seeded (or `export`ed) decoder on the fixed
    batch split over the data ranks: gradients and params."""
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
    """World 2: the sharded sweep on both tokenizer routes, and the engine at
    DP 2 and at TP 2 with shard_params."""
    mesh = make_mesh()
    h, plain = tokenizers(inp)
    out = {"table_h": h.precompute_corpus_ids(inp["feats"], mesh=mesh).numpy(),
           "table_plain": plain.precompute_corpus_ids(inp["feats"], mesh=mesh).numpy()}
    out.update(prefixed("dp", recommend(engine(inp, make_mesh(n_data=2)), inp)))
    tp = engine(inp, make_mesh(n_model=2), shard_params=True)
    out.update(prefixed("tp", recommend(tp, inp)))
    out.update({f"tp:shape/{k}": np.asarray(p.shape) for k, p in tp.model.named_parameters()})
    return out


def train_ranks(inp) -> dict:
    """World 4: train_arrays at DP 4, DP 2 x TP 2 and TP 4, fixed steps,
    `train` runs, TP saves and resumes, the JAX TP checkpoint's update."""
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


# ---- stage 1 ----

def _leaf(t):
    return t.detach().numpy().copy()


def _param_grads(module, prefix):
    return {f"{prefix}/p/{k}": _leaf(p.grad) for k, p in module.named_parameters()
            if p.grad is not None}


def stage1_terms(inp, rows=None) -> dict:
    """Each coupled stage-1 term on this rank's rows of inp["terms"]
    (`rows` None: the whole batch): its value and gradients of its row inputs
    and parameters."""
    from hidvae_tpu_torch.models.hrqvae import FlaxBatchNorm, TagProjector
    from hidvae_tpu_torch.models.losses import (
        mixup_draw,
        tag_alignment_loss,
        tag_prediction_loss,
        uniqueness_loss,
    )
    from hidvae_tpu_torch.parallel.collectives import all_reduce_sum

    t = inp["terms"]
    part = slice(None) if rows is None else slice(rows.start, rows.stop)
    group = None if rows is None else rows.group

    def local(name):
        return t[name][part].clone().requires_grad_(t[name].is_floating_point())

    out = {}
    # 1. BatchNorm: the projector's output weighted by a fixed matrix, summed.
    for name, module in (("bn", FlaxBatchNorm(t["bn_x"].shape[1])),
                         ("projector", TagProjector(t["bn_x"].shape[1], 12, 8,
                                                    dropout_rate=0.25))):
        module.load_state_dict(t[f"{name}_state"])
        x = local("bn_x")
        g = torch.Generator().manual_seed(7)
        y = (module(x, True, rows) if name == "bn" else
             module(x, True, g if rows is None else RowShard(g, rows.start, rows.total), rows))
        w = t[f"{name}_w"][part]
        value = all_reduce_sum(torch.sum(y * w), group)
        value.backward()
        out.update({f"{name}/value": _leaf(value), f"{name}/x_grad": _leaf(x.grad),
                    **_param_grads(module, name)})
        bn = module if name == "bn" else module.bn
        out.update({f"{name}/running_mean": _leaf(bn.running_mean),
                    f"{name}/running_var": _leaf(bn.running_var)})
    # 2. InfoNCE.
    cb, tg = local("cb"), local("tg")
    value = tag_alignment_loss(cb, tg, layer_idx=1, alignment_weight=0.7, rows=rows)
    value.backward()
    out.update({"nce/value": _leaf(value), "nce/cb_grad": _leaf(cb.grad),
                "nce/tg_grad": _leaf(tg.grad)})
    # 3. Uniqueness over planted collisions.
    enc = local("enc")
    value = uniqueness_loss(t["ids"][part], enc, margin=0.1, weight=1.5, rows=rows)
    value.backward()
    out.update({"uniq/value": _leaf(value), "uniq/enc_grad": _leaf(enc.grad)})
    # 4. The tag loss: focal with class counts and plain CE with its KL term,
    #    both with mixup over the whole batch and invalid targets.
    for name, focal in (("focal", True), ("ce", False)):
        logits = local("logits")
        g = torch.Generator().manual_seed(11)
        draw = mixup_draw(t["logits"].shape[0], 0.2, g, np.random.default_rng(3))
        p = tag_prediction_loss(logits, t["targets"][part], layer_idx=1, use_focal_loss=focal,
                                class_counts=t["class_counts"] if focal else None,
                                mixup=draw, training=True, rows=rows)
        p.loss.backward()
        out.update({f"{name}/value": _leaf(p.loss), f"{name}/accuracy": _leaf(p.accuracy),
                    f"{name}/logits_grad": _leaf(logits.grad)})
    # 5. The whole HiD-VAE loss with mined pairs and isolation.
    for case in inp["model_cases"]:
        out.update(stage1_model_loss(inp, case, rows))
    return out


def stage1_model_loss(inp, case, rows=None) -> dict:
    """The HiD-VAE train loss of case["batch"] rows with case["pairs"]
    mined pairs (isolation, dropout, Gumbel, mixup on): every metric and
    gradient."""
    from hidvae_tpu_torch.models.losses import mixup_draw
    from hidvae_tpu_torch.parallel.collectives import Rows

    t, name = inp["terms"], case["name"]
    model = copy.deepcopy(inp["model"])
    b = case["batch"]
    if rows is not None:
        rows = Rows.even(rows.group, rows.rank, len(rows.sizes), b)
    part = slice(0, b) if rows is None else slice(rows.start, rows.stop)
    x = t["model_x"][part].clone().requires_grad_(True)
    g = torch.Generator().manual_seed(13)
    host = np.random.default_rng(5)

    def mixup(level, batch):
        return mixup_draw(batch, model.mixup_alpha, g, host)

    out = model(x, t["model_tags_emb"][part], t["model_tags"][part], 0.2, train=True,
                class_counts=t["class_counts_model"], n_mined_pairs=case["pairs"],
                generator=g, mixup=mixup, rows=rows)
    out.loss.backward()
    res = {f"{name}/p_unique_ids": _leaf(out.p_unique_ids),
           f"{name}/embs_norm": _leaf(out.embs_norm), f"{name}/x_grad": _leaf(x.grad),
           **_param_grads(model, name)}
    for k in ("loss", "reconstruction_loss", "rqvae_loss", "tag_align_loss", "tag_pred_loss",
              "tag_pred_accuracy", "sem_id_uniqueness_loss", "mined_pair_collision_rate"):
        res[f"{name}/{k}"] = _leaf(getattr(out, k))
    for k in ("tag_align_loss_by_layer", "tag_pred_loss_by_layer",
              "tag_pred_accuracy_by_layer"):
        res[f"{name}/{k}"] = _leaf(getattr(out, k))
    res.update({f"{name}/buffer/{k}": _leaf(v) for k, v in model.named_buffers()})
    return res


def gather_modes(inp, rows) -> dict:
    """The InfoNCE gradient of this rank's code rows computed whole from
    "sum" gathers (wrong) and by rows against gathered columns (right)."""
    from hidvae_tpu_torch.models.losses import tag_alignment_loss
    from hidvae_tpu_torch.ops.normalize import l2norm
    from hidvae_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_sum

    t, part = inp["terms"], slice(rows.start, rows.stop)
    cb = t["cb"][part].clone().requires_grad_(True)
    tg = t["tg"][part].clone().requires_grad_(True)
    tag_alignment_loss(all_gather_rows(cb, rows, "sum"), all_gather_rows(tg, rows, "sum"),
                       layer_idx=1, alignment_weight=0.7).backward()
    out = {"modes/whole_sum_cb_grad": _leaf(cb.grad)}
    cb = t["cb"][part].clone().requires_grad_(True)
    tg = t["tg"][part].clone().requires_grad_(True)
    c, cols = l2norm(cb, dim=-1), l2norm(all_gather_rows(tg, rows, "sum"), dim=-1)
    logits = c @ cols.T / 0.1
    diag = logits[torch.arange(len(c)), torch.arange(rows.start, rows.stop)]
    part_sum = torch.sum(diag - torch.logsumexp(logits, dim=-1))
    value = -all_reduce_sum(part_sum, rows.group) / rows.total * 0.7 / 1.5
    value.backward()
    out.update({"modes/rows_value": _leaf(value), "modes/rows_cb_grad": _leaf(cb.grad),
                "modes/rows_tg_grad": _leaf(tg.grad)})
    return out


def terms(inp) -> dict:
    from hidvae_tpu_torch.parallel.collectives import Rows

    mesh = make_mesh()
    n = inp["terms"]["bn_x"].shape[0]
    rows = Rows.even(mesh.data_group, mesh.data_rank, mesh.n_data, n)
    return {**stage1_terms(inp, rows), **gather_modes(inp, rows)}


def stage1_run(inp, name, trainer, **kw) -> dict:
    """Stage-1 `trainer`'s `train` on the saved dataset (JAX's batches with
    kw["jax_batches"]): its results, keys prefixed "name:"."""
    from hidvae_tpu_torch.models import hrqvae
    from hidvae_tpu_torch.train import hidvae, rqvae
    from hidvae_tpu_torch.train.device_data import DeviceItemData

    mod = hidvae if trainer == "hidvae" else rqvae
    args = dict(inp[f"{trainer}_kw"], device="cpu",
                save_dir_root=os.path.join(inp["workdir"], name))
    jax_batches = kw.pop("jax_batches", None)
    args.update(kw)
    saved = DeviceItemData.sample, hrqvae.drop
    if jax_batches is not None:
        order = iter(sorted(jax_batches))
        DeviceItemData.sample = lambda self, g, b, n=0: self.gather(jax_batches[next(order)])
        hrqvae.drop = lambda x, p, g: x
    try:
        res = mod.train(**args)
    finally:
        DeviceItemData.sample, hrqvae.drop = saved
    h = res["history"]
    out = {k: np.asarray(h[k], np.float64) for k in (
        "total_loss", "reconstruction_loss", "rqvae_loss", "tag_pred_loss", "tag_pred_accuracy",
        "eval_total_loss", "eval_tag_pred_accuracy", "repetition_rate", "rqvae_entropy")
        if k in h}
    out["iterations"] = np.asarray(h["iterations"])
    out["bytes_per_step"] = np.float64(h["collective_bytes_per_step"])
    out["table"] = np.asarray(res["corpus_ids"])
    out["saved"] = np.asarray(res["saved_paths"][-1] if res["saved_paths"] else "")
    if res["data"].mining_pairs is not None:
        out["pool"] = res["data"].mining_pairs.numpy()
    params, stats = state_dict_to_flax(res["model"])
    out.update({f"p/{k}": v for k, v in params.items()})
    out.update({f"s/{k}": v for k, v in stats.items()})
    return prefixed(name, out)


def stage1(inp) -> dict:
    """The stage-1 runs of inp["stage1_runs"] ([(name, trainer, kwargs)]) on
    this world's stage-1 mesh, in order."""
    out = {}
    for name, trainer, kw in inp["stage1_runs"][dist.get_world_size()]:
        kw = dict(kw)
        if kw.get("pretrained_from"):
            kw[{"hidvae": "pretrained_hrqvae_path", "rqvae": "pretrained_rqvae_path"}[trainer]] \
                = str(inp["paths"][kw.pop("pretrained_from")])
        out.update(stage1_run(inp, name, trainer, **kw))
    return out


SCENARIOS = {"serve": serve, "train": train_ranks, "terms": terms, "stage1": stage1}


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
