"""Stage-1 trainer of the plain RQ-VAE, TIGER's tokenizer (counterpart of
hidvae_tpu/train/rqvae.py).

`train` takes the JAX gin surface (:40-75, same defaults) and `device`:
reads the splits (:87-100), refusing items not vae_input_dim wide before
any step; restores or k-means-initializes (:143-162); trains in the JAX
chunks (:234-276); evaluates and audits at eval_every (:278-320); saves
`checkpoint_{it - 1}` exports (:322-345). `wandb_logging` is ignored.
Under a process group it is data-parallel as the HiD-VAE trainer
(rqvae.py:169-179, :233-252)."""

import contextlib
import logging
import os

import numpy as np
import torch

from hidvae_tpu_torch.bridge import state_dict_to_flax
from hidvae_tpu_torch.data.processed import ItemData, RecDataset, load_or_build
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.models.quantize import QuantizeForwardMode
from hidvae_tpu_torch.models.rqvae import RqVae
from hidvae_tpu_torch.parallel.mesh import batch_rows, make_mesh, shard_rows
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from hidvae_tpu_torch.train import plots
from hidvae_tpu_torch.train.common import (
    GUMBEL_T,
    global_batch,
    id_diversity_metrics,
    kmeans_init_,
    local_rows,
    log_operative_config,
    make_lr_schedule,
    make_optimizer,
    reduce_gradients_,
    restore_checkpoint,
    run_chunks,
    run_logging,
    run_stamp,
    save_checkpoint,
    save_on_main,
    step_generator,
    structural_model_config,
)
from hidvae_tpu_torch.train.device_data import DeviceItemData
from hidvae_tpu_torch.utils.runtime import resolve_device

logger = logging.getLogger("hidvae_tpu_torch.train.rqvae")

SCALAR_METRICS = ("loss", "reconstruction_loss", "rqvae_loss", "p_unique_ids")
EVAL_METRICS = ("loss", "reconstruction_loss", "rqvae_loss")


def build_model(*, vae_input_dim, vae_embed_dim, vae_hidden_dims, vae_codebook_size,
                vae_codebook_normalize, vae_sim_vq, vae_codebook_mode, vae_n_layers,
                vae_n_cat_feats, commitment_weight, dtype=None, seed=42) -> RqVae:
    """The RqVae of rqvae.py:115-127 with seeded flax-distributed weights
    (models/init.py), on the CPU."""
    model = RqVae(
        vae_input_dim, vae_embed_dim, tuple(vae_hidden_dims), vae_codebook_size,
        codebook_normalize=vae_codebook_normalize, codebook_sim_vq=vae_sim_vq,
        n_layers=vae_n_layers, commitment_weight=commitment_weight,
        codebook_mode=vae_codebook_mode, n_cat_features=vae_n_cat_feats, dtype=dtype,
    )
    return init_params_(model, torch.Generator().manual_seed(seed))


def build_optimizer(model, *, learning_rate, weight_decay, gradient_accumulate_every,
                    max_grad_norm):
    """The optimizer of `train`'s bindings (rqvae.py:129-133): one AdamW at
    a constant rate, after the optional clip, accumulated in mini-steps."""
    return make_optimizer(model, make_lr_schedule(learning_rate), weight_decay,
                          gradient_accumulate_every=gradient_accumulate_every,
                          max_grad_norm=max_grad_norm)


def make_train_step(model, optimizer, gumbel_t: float = GUMBEL_T):
    """One mini-step (with `rows` gradients summed over the ranks). Returns
    the batch's metrics as 0-d device tensors, not synced."""

    def train_step(x, generator, rows=None):
        optimizer.zero_grad()
        out = model(x, gumbel_t, train=True, generator=generator, rows=rows)
        out.loss.backward()
        if rows is not None:
            reduce_gradients_(optimizer.params, rows.group)
        optimizer.step()
        return {k: getattr(out, k).detach() for k in SCALAR_METRICS}

    return train_step


def make_eval_step(model, gumbel_t: float = GUMBEL_T):
    """The eval forward's losses (rqvae.py:207-214)."""

    @torch.no_grad()
    def eval_step(x):
        out = model(x, gumbel_t, train=False)
        return {k: getattr(out, k) for k in EVAL_METRICS}

    return eval_step


def _run_eval(eval_step, eval_dataset, batch_size, eval_batches, device):
    """Eval losses over the eval split's in-order batches, weighted by each
    batch's length (rqvae.py:303-315)."""
    sums, n = {}, 0
    for bi, batch in enumerate(eval_dataset.iter_eval_batches(batch_size)):
        if eval_batches is not None and bi >= eval_batches:
            break
        m = eval_step(torch.from_numpy(np.asarray(batch.x, np.float32)).to(device))
        values = torch.stack([m[k].float() for k in EVAL_METRICS]).tolist()  # one read-back
        for k, v in zip(EVAL_METRICS, values):
            sums[k] = sums.get(k, 0.0) + v * len(batch.x)
        n += len(batch.x)
    return {k: v / max(n, 1) for k, v in sums.items()}


def audit_diversity(model, index_feats, *, n_layers, codebook_size, use_dedup_dim, device,
                    mesh=None):
    """The corpus audit (rqvae.py:292-301), each chunk split over the data
    ranks. Returns (diversity, the numpy table)."""
    tokenizer = SemanticIdTokenizer(model, n_layers=n_layers, codebook_size=codebook_size,
                                    use_dedup_dim=use_dedup_dim, device=device)
    corpus = tokenizer.precompute_corpus_ids(index_feats, mesh=mesh).cpu().numpy()
    div = id_diversity_metrics(corpus[:, :n_layers], codebook_size, n_layers)
    if use_dedup_dim:
        div["max_duplicates"] = int(corpus[:, -1].max()) + 1
    return div, corpus


def train(
    iterations=50_000,
    batch_size=64,
    learning_rate=0.0001,
    weight_decay=0.01,
    max_grad_norm=None,
    dataset_folder="dataset/synthetic",
    dataset=RecDataset.SYNTHETIC,
    pretrained_rqvae_path=None,
    save_dir_root="out/",
    use_kmeans_init=True,
    split_batches=True,
    amp=False,
    do_eval=True,
    force_dataset_process=False,
    mixed_precision_type="bf16",
    gradient_accumulate_every=1,
    save_model_every=1_000,
    eval_every=5_000,
    commitment_weight=0.25,
    vae_n_cat_feats=18,
    vae_input_dim=768,
    vae_embed_dim=32,
    vae_hidden_dims=(512, 256, 128),
    vae_codebook_size=256,
    vae_codebook_normalize=False,
    vae_codebook_mode=QuantizeForwardMode.GUMBEL_SOFTMAX,
    vae_sim_vq=False,
    vae_n_layers=3,
    dataset_split="beauty",
    use_dedup_dim=False,
    wandb_logging=False,
    seed=42,
    log_every=100,
    eval_batches=None,
    make_plots=True,
    device=None,
):
    """`python train_rqvae.py CONFIG.gin`; `iterations` counts updates.
    Returns {"model", "optimizer", "step", "save_dir", "history",
    "saved_paths", "data", "corpus_ids", "mesh"}; history: the JAX keys,
    ms_per_step, window_mean, collective_bytes_per_step."""
    mesh = make_mesh()
    device = resolve_device(device)
    save_dir = os.path.join(save_dir_root, f"rqvae_{dataset.name}_{run_stamp(mesh, device)}")
    config = {k: v for k, v in locals().items() if k != "mesh"}
    with run_logging(save_dir) if mesh.is_main else contextlib.nullcontext():
        log_operative_config(logger, config)
        batch_size = global_batch(batch_size, split_batches, mesh, logger)
        arrays = load_or_build(dataset_folder, dataset, dataset_split, force_dataset_process)
        width = arrays.item_features.shape[1]
        if width != vae_input_dim:  # JAX fails at the first reconstruction loss
            raise ValueError(f"the items of {dataset.name} are {width} wide, but vae_input_dim "
                             f"is {vae_input_dim}: the decoder reconstructs vae_input_dim "
                             f"columns, so the two must agree")
        train_dataset = ItemData(dataset_folder, dataset, arrays=arrays,
                                 train_test_split="train" if do_eval else "all")
        eval_dataset = (ItemData(dataset_folder, dataset, arrays=arrays, train_test_split="eval")
                        if do_eval else None)

        compute_dtype = (torch.bfloat16 if amp and str(mixed_precision_type).lower() in (
            "bf16", "bfloat16", "fp16", "float16") else None)
        model = build_model(
            vae_input_dim=vae_input_dim, vae_embed_dim=vae_embed_dim,
            vae_hidden_dims=vae_hidden_dims, vae_codebook_size=vae_codebook_size,
            vae_codebook_normalize=vae_codebook_normalize, vae_sim_vq=vae_sim_vq,
            vae_codebook_mode=vae_codebook_mode, vae_n_layers=vae_n_layers,
            vae_n_cat_feats=vae_n_cat_feats, commitment_weight=commitment_weight,
            dtype=compute_dtype, seed=seed,
        ).to(device)
        optimizer = build_optimizer(model, learning_rate=learning_rate,
                                    weight_decay=weight_decay,
                                    gradient_accumulate_every=gradient_accumulate_every,
                                    max_grad_norm=max_grad_norm)

        start_iter = 0
        if pretrained_rqvae_path is not None:
            # Params, the optimizer state (accumulator, count) and the step.
            start_iter, _ = restore_checkpoint(pretrained_rqvae_path, model, optimizer)
            logger.info(f"Restored RqVae from {pretrained_rqvae_path} (iter {start_iter})")
        elif use_kmeans_init:
            kmeans_init_(model, train_dataset.item_features, len(train_dataset), seed, device,
                         mesh)
            logger.info("K-means codebook initialization complete")

        ddata = DeviceItemData(x=torch.from_numpy(train_dataset.item_features).to(device),
                               tags_emb=None, tags_indices=None)
        index_feats = torch.from_numpy(np.asarray(arrays.item_features, np.float32)).to(device)
        train_step = make_train_step(model, optimizer)
        eval_step = make_eval_step(model)

        def audit():
            return audit_diversity(model, index_feats, n_layers=vae_n_layers,
                                   codebook_size=vae_codebook_size,
                                   use_dedup_dim=use_dedup_dim, device=device, mesh=mesh)

        history = {k: [] for k in [
            "reconstruction_loss", "rqvae_loss", "eval_iterations", "eval_total_loss",
            "rqvae_entropy", "max_id_duplicates", "repetition_rate",
        ]}
        rows, layout = shard_rows(batch_size, mesh), batch_rows(batch_size, mesh)
        saved_paths = []
        total_steps = iterations * gradient_accumulate_every
        last_audit = (None, None, None)  # (iteration, diversity, table) of the newest audit

        def step(it):
            g = step_generator(seed, it, device)
            x, _, _ = local_rows(ddata.sample(g, batch_size), rows)
            metrics = train_step(x, g, layout)
            return metrics["loss"], metrics

        def readback(done, losses, metrics):
            m = dict(zip(SCALAR_METRICS,
                         torch.stack([metrics[k].float() for k in SCALAR_METRICS]).tolist()))
            history["reconstruction_loss"].append(m["reconstruction_loss"])
            history["rqvae_loss"].append(m["rqvae_loss"])
            return losses.tolist(), lambda ms, seconds: (
                f"recon={m['reconstruction_loss']:.4f} rq={m['rqvae_loss']:.4f} "
                f"p_unique={m['p_unique_ids']:.4f} "
                f"({(done - start_iter) * batch_size / seconds:.0f} items/s)")

        def evaluate(it):
            """Eval and the corpus audit (rqvae.py:278-320)."""
            nonlocal last_audit
            if not do_eval:
                return
            if eval_dataset is not None and len(eval_dataset) > 0:
                eval_metrics = _run_eval(eval_step, eval_dataset, batch_size, eval_batches,
                                         device)
                history["eval_iterations"].append(it)
                history["eval_total_loss"].append(eval_metrics["loss"])
                logger.info(f"eval @ {it}: {eval_metrics}")
            div, table = audit()
            history["rqvae_entropy"].append(div["rqvae_entropy"])
            history["max_id_duplicates"].append(div["max_id_duplicates"])
            history["repetition_rate"].append(div["repetition_rate"])
            last_audit = (it, div, table)
            logger.info(f"diversity @ {it}: {div}")

        def save(it):
            nonlocal last_audit
            # For stage 2's collapse guard, unless this chunk's is newest.
            if last_audit[0] != it:
                last_audit = (it, *audit())
                logger.info(f"diversity @ save {it}: {last_audit[1]}")
            div = last_audit[1]
            payload = {
                "step": it,
                "params": state_dict_to_flax(model)[0],
                "opt_state": optimizer.state_dict(model),
                "model_config": structural_model_config(model),
                "metrics": {"repetition_rate": div["repetition_rate"],
                            "rqvae_entropy": div["rqvae_entropy"]},
            }
            name = f"checkpoint_{it - 1}"
            saved_paths.append(save_on_main(mesh, save_dir, name,
                                            lambda: save_checkpoint(save_dir, name, payload)))

        history.update(run_chunks(step, readback, device=device, start_iter=start_iter,
                                  n_steps=total_steps, log_every=log_every,
                                  loss_key="total_loss", log=logger.info,
                                  events=((eval_every, evaluate), (save_model_every, save))))
        if make_plots and mesh.is_main:
            plots.save_plots(plots.plot_rqvae_history, history, save_dir, logger)

        return {"model": model, "optimizer": optimizer, "step": start_iter + total_steps,
                "save_dir": save_dir, "history": history, "saved_paths": saved_paths,
                "data": ddata, "corpus_ids": last_audit[2], "mesh": mesh}
