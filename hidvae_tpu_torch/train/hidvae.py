"""Stage-1 HiD-VAE trainer (counterpart of hidvae_tpu/train/hidvae.py).

`train` takes the JAX gin surface (:229-303, same defaults) and `device`:
reads the splits, reconciles tag levels, remaps rare tags (:317-376);
restores or k-means-initializes the HRqVae (:484-532); builds the
optimizer (:440-479); trains in the JAX chunks, a generator per (seed,
step) (PARITY.md deviation 13), with `sem_id_mining` each batch opening
with pairs from a pool re-harvested at every audit (:555-629, :747-761);
evaluates, audits through `rq_assign` and saves `latest` (:711-801) as
exports. `ensemble_predictions`, `use_concatenated_ids`,
`use_interleaved_ids` and `wandb_logging` are ignored, as in JAX.

Under a process group each rank computes its `shard_rows` of the global
batch (:541-553), the model couples the whole-batch terms, gradients sum
in one all-reduce; rank 0 writes log, remap, checkpoints and plots."""

import contextlib
import logging
import os

import numpy as np
import torch

from hidvae_tpu_torch.bridge import load_export_arrays, state_dict_to_flax
from hidvae_tpu_torch.data.processed import ItemData, RecDataset, load_or_build
from hidvae_tpu_torch.models.hrqvae import HRqVae
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.models.losses import mixup_draw
from hidvae_tpu_torch.models.quantize import QuantizeForwardMode
from hidvae_tpu_torch.parallel.mesh import batch_rows, make_mesh, shard_rows
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.train import plots
from hidvae_tpu_torch.train.common import (
    GUMBEL_T,
    STEP_SALT,
    ReduceLROnPlateau,
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
from hidvae_tpu_torch.train.device_data import DeviceItemData, harvest_duplicate_pairs
from hidvae_tpu_torch.train.tags import (
    apply_tag_remap,
    compute_rare_tag_remap,
    post_remap_class_counts,
    reconcile_tag_layers,
)
from hidvae_tpu_torch.utils.runtime import resolve_device

logger = logging.getLogger("hidvae_tpu_torch.train.hidvae")

TTA_AUGMENTATIONS = 5  # passes of the test-time augmentation, noise 0.02 * i
TTA_SALT = 0x77A      # seeds the augmentation noise, the same for every eval
SCALAR_METRICS = ("loss", "reconstruction_loss", "rqvae_loss", "tag_align_loss",
                  "tag_pred_loss", "tag_pred_accuracy", "p_unique_ids",
                  "sem_id_uniqueness_loss", "mined_pair_collision_rate")
MINING_SALT = 1_000_003  # the harvest of the audit at step `it` draws from (seed * salt + it)


def build_model(*, vae_input_dim, vae_embed_dim, vae_hidden_dims, vae_codebook_size,
                vae_codebook_normalize, vae_sim_vq, vae_codebook_mode, vae_n_layers,
                vae_n_cat_feats, commitment_weight, tag_alignment_weight,
                tag_prediction_weight, tag_class_counts, tag_embed_dim, use_focal_loss,
                focal_loss_gamma_base, focal_loss_alpha_base, dropout_rate, use_batch_norm,
                alignment_temperature, sem_id_uniqueness_weight, sem_id_uniqueness_margin,
                use_label_smoothing=True, label_smoothing_alpha=0.1, use_mixup=True,
                mixup_alpha=0.2, dtype=None, sem_id_mining_margin=None,
                mined_loss_isolation=False, seed=42) -> HRqVae:
    """The HRqVae of hidvae.py:73-135 with seeded flax-distributed weights
    (models/init.py), on the CPU."""
    model = HRqVae(
        vae_input_dim, vae_embed_dim, tuple(vae_hidden_dims), vae_codebook_size,
        codebook_normalize=vae_codebook_normalize, codebook_sim_vq=vae_sim_vq,
        n_layers=vae_n_layers, commitment_weight=commitment_weight,
        tag_class_counts=tuple(tag_class_counts) if tag_class_counts else None,
        tag_embed_dim=tag_embed_dim, use_batch_norm=use_batch_norm,
        codebook_mode=vae_codebook_mode, n_cat_features=vae_n_cat_feats,
        tag_alignment_weight=tag_alignment_weight, tag_prediction_weight=tag_prediction_weight,
        use_focal_loss=use_focal_loss, focal_gamma_base=focal_loss_gamma_base,
        focal_alpha_base=focal_loss_alpha_base, dropout_rate=dropout_rate,
        alignment_temperature=alignment_temperature,
        sem_id_uniqueness_weight=sem_id_uniqueness_weight,
        sem_id_uniqueness_margin=sem_id_uniqueness_margin,
        use_label_smoothing=use_label_smoothing, label_smoothing_alpha=label_smoothing_alpha,
        use_mixup=use_mixup, mixup_alpha=mixup_alpha, dtype=dtype,
        sem_id_mining_margin=sem_id_mining_margin, mined_loss_isolation=mined_loss_isolation,
    )
    return init_params_(model, torch.Generator().manual_seed(seed))


def step_rngs(seed: int, step: int, device):
    """A mini-step's draws from (seed, step): on `device` (batch, Gumbel,
    dropout, mixup permutations) and on the host (mixup's Beta lambdas)."""
    host = np.random.default_rng([seed & 0x7FFFFFFF, STEP_SALT, int(step)])
    return step_generator(seed, step, device), host


def make_train_step(model, optimizer, class_counts, gumbel_t: float = GUMBEL_T,
                    n_mined_pairs: int = 0):
    """One mini-step (the first 2 * n_mined_pairs rows mined pairs; with
    `rows` gradients summed over the ranks). Returns the batch's metrics as
    0-d device tensors (emb_norms [L]), not synced."""

    def train_step(x, tags_emb, tags_indices, generator, host, rows=None):
        def mixup(level, batch):
            return mixup_draw(batch, model.mixup_alpha, generator, host, x.device)

        optimizer.zero_grad()
        out = model(x, tags_emb, tags_indices, gumbel_t, train=True, class_counts=class_counts,
                    n_mined_pairs=n_mined_pairs, generator=generator, mixup=mixup, rows=rows)
        out.loss.backward()
        if rows is not None:
            reduce_gradients_(optimizer.params, rows.group)
        optimizer.step()
        m = {k: getattr(out, k).detach() for k in SCALAR_METRICS}
        m["emb_norms"] = torch.mean(out.embs_norm.detach(), dim=0)
        return m

    return train_step


def make_eval_step(model, class_counts, gumbel_t: float = GUMBEL_T):
    """The eval forward's losses and tag accuracy (hidvae.py:179-197)."""

    @torch.no_grad()
    def eval_step(x, tags_emb, tags_indices):
        out = model(x, tags_emb, tags_indices, gumbel_t, train=False, class_counts=class_counts)
        return {k: getattr(out, k) for k in ("loss", "reconstruction_loss", "rqvae_loss",
                                             "tag_align_loss", "tag_pred_loss",
                                             "tag_pred_accuracy")}

    return eval_step


def make_tta_predict(model, eval_tta: bool, eval_temperature: float,
                     n_aug: int = TTA_AUGMENTATIONS):
    """Tag softmax at `eval_temperature` over the clean pass and, with
    eval_tta, n_aug - 1 passes with noise of scale 0.02 * i from
    `generator`, averaged (hidvae.py:200-226)."""

    @torch.no_grad()
    def predict(x, generator):
        def probs_of(noise, scale):
            out = model.predict_tags(x, noise=noise, noise_scale=scale)
            return [torch.softmax(lg / eval_temperature, dim=-1) for lg in out["logits"]]

        probs = probs_of(None, 0.0)
        if eval_tta:
            for i in range(n_aug - 1):
                noise = torch.randn(x.shape, generator=generator, device=x.device)
                probs = [a + b for a, b in zip(probs, probs_of(noise, 0.02 * (i + 1)))]
            probs = [p / n_aug for p in probs]
        return [torch.argmax(p, dim=-1) for p in probs]

    return predict


def _to_device(batch, has_tags, device):
    x = torch.from_numpy(np.asarray(batch.x, np.float32)).to(device)
    if not has_tags:
        return x, None, None
    return (x, torch.from_numpy(np.asarray(batch.tags_emb, np.float32)).to(device),
            torch.from_numpy(np.asarray(batch.tags_indices, np.int32)).to(device))


def _run_eval(eval_step, tta_predict, eval_dataset, batch_size, has_tags, eval_batches,
              device, tta_seed):
    """Row-weighted eval losses and the augmented tag accuracy per level
    (hidvae.py:823-864), noise from one generator seeded `tta_seed`."""
    sums, n = {}, 0
    tta_correct = tta_valid = None
    for bi, batch in enumerate(eval_dataset.iter_eval_batches(batch_size)):
        if eval_batches is not None and bi >= eval_batches:
            break
        x, te, ti = _to_device(batch, has_tags, device)
        m = eval_step(x, te, ti)
        values = torch.stack([m[k].float() for k in m]).tolist()  # one read-back
        for k, v in zip(m, values):
            sums[k] = sums.get(k, 0.0) + v * len(batch.x)
        n += len(batch.x)
        if tta_predict is not None:
            g = torch.Generator(device=device).manual_seed(tta_seed)
            pred_mat = torch.stack(tta_predict(x, g), dim=1).cpu().numpy()
            tgt = np.asarray(batch.tags_indices)[:, : pred_mat.shape[1]]
            valid = tgt >= 0
            correct = (pred_mat == tgt) & valid
            if tta_correct is None:
                tta_correct = correct.sum(0).astype(np.float64)
                tta_valid = valid.sum(0).astype(np.float64)
            else:
                tta_correct += correct.sum(0)
                tta_valid += valid.sum(0)
    out = {k: v / max(n, 1) for k, v in sums.items()}
    if tta_correct is not None:
        per_layer = tta_correct / np.maximum(tta_valid, 1.0)
        out["tta_accuracy_by_layer"] = per_layer.tolist()
        out["tta_accuracy"] = float(per_layer.mean())
    return out


def build_optimizer(model, *, learning_rate, weight_decay, gradient_accumulate_every,
                    layer_specific_lr, predictor_weight_decay, vae_n_layers, use_lr_scheduler,
                    lr_scheduler_type, lr_scheduler_T_max, lr_scheduler_eta_min,
                    lr_scheduler_step_size, lr_scheduler_gamma, lr_scheduler_factor,
                    lr_scheduler_patience):
    """The optimizer of `train`'s bindings (hidvae.py:440-479) and its
    ReduceLROnPlateau controller (None unless that is the scheduler)."""
    schedule = make_lr_schedule(learning_rate, use_lr_scheduler, lr_scheduler_type,
                                lr_scheduler_T_max, lr_scheduler_eta_min,
                                lr_scheduler_step_size, lr_scheduler_gamma)
    plateau = use_lr_scheduler and lr_scheduler_type == "reduce_on_plateau"
    plateau_ctl = (ReduceLROnPlateau(factor=lr_scheduler_factor,
                                     patience=lr_scheduler_patience) if plateau else None)
    if plateau:
        logger.info(f"Using ReduceLROnPlateau scheduler: factor={lr_scheduler_factor}, "
                    f"patience={lr_scheduler_patience} (stepped on eval loss)")
    elif use_lr_scheduler and not callable(schedule):
        logger.warning(f"Unsupported learning rate scheduler type: {lr_scheduler_type}. "
                       f"Not using a scheduler.")
    optimizer = make_optimizer(
        model, schedule, weight_decay, gradient_accumulate_every=gradient_accumulate_every,
        layer_specific_lr=layer_specific_lr, predictor_weight_decay=predictor_weight_decay,
        n_layers=vae_n_layers, plateau=plateau)
    return optimizer, plateau_ctl


def _save(save_dir, name, step, model, optimizer, eval_metrics, rep, plateau_ctl=None,
          mining_pairs=None):
    """A checkpoint of the whole trainer state (hidvae.py:867-886)."""
    params, stats = state_dict_to_flax(model)
    payload = {
        "step": step,
        "params": params,
        "batch_stats": stats,
        "opt_state": optimizer.state_dict(model),
        "model_config": structural_model_config(model),
        "metrics": {**eval_metrics, "repetition_rate": rep},
    }
    if plateau_ctl is not None:
        payload["plateau"] = plateau_ctl.state_dict()
    if mining_pairs is not None:
        payload["mining_pairs"] = mining_pairs.cpu().numpy()
    return save_checkpoint(save_dir, name, payload)


def train(
    iterations=50_000,
    batch_size=64,
    learning_rate=0.0001,
    weight_decay=0.01,
    dataset_folder="dataset/synthetic",
    dataset=RecDataset.SYNTHETIC,
    pretrained_hrqvae_path=None,
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
    tag_alignment_weight=0.5,
    tag_prediction_weight=0.5,
    vae_n_cat_feats=18,
    vae_input_dim=768,
    vae_embed_dim=128,
    vae_hidden_dims=(512, 256),
    vae_codebook_size=512,
    vae_codebook_normalize=False,
    vae_codebook_mode=QuantizeForwardMode.GUMBEL_SOFTMAX,
    vae_sim_vq=False,
    vae_n_layers=3,
    dataset_split="beauty",
    tag_class_counts=None,
    tag_embed_dim=768,
    use_focal_loss=True,
    focal_loss_gamma_base=2.0,
    focal_loss_alpha_base=0.25,
    rare_tag_threshold=30,
    dropout_rate=0.3,
    use_batch_norm=True,
    alignment_temperature=0.1,
    predictor_weight_decay=0.02,
    layer_specific_lr=False,
    use_label_smoothing=True,
    label_smoothing_alpha=0.1,
    use_mixup=True,
    mixup_alpha=0.2,
    eval_tta=True,
    eval_temperature=0.8,
    ensemble_predictions=True,
    use_lr_scheduler=True,
    lr_scheduler_type="cosine",
    lr_scheduler_T_max=400_000,
    lr_scheduler_eta_min=1e-7,
    lr_scheduler_step_size=100_000,
    lr_scheduler_gamma=0.5,
    lr_scheduler_factor=0.5,
    lr_scheduler_patience=10,
    sem_id_uniqueness_weight=0.5,
    sem_id_uniqueness_margin=0.5,
    id_repetition_threshold=0.03,
    use_concatenated_ids=True,
    use_interleaved_ids=False,
    wandb_logging=False,
    seed=42,
    log_every=100,
    eval_batches=None,
    make_plots=True,
    device_data_dtype="float32",
    sem_id_mining=False,
    sem_id_mining_frac=0.25,
    sem_id_mining_pool=32768,
    sem_id_mining_margin=None,
    sem_id_mining_isolate=False,
    device=None,
):
    """`python train_hidvae.py CONFIG.gin`; `iterations` counts updates.
    Returns {"model", "optimizer", "step", "save_dir", "history",
    "tag_class_counts", "rare_tags", "best_eval_accuracy", "saved_paths",
    "data", "class_counts", "n_pair_rows", "mining_pool_start",
    "corpus_ids", "mesh"}; history: the JAX keys, ms_per_step,
    window_mean, mined_pair_collision_rate, mining_pool_refreshed,
    collective_bytes_per_step."""
    mesh = make_mesh()
    device = resolve_device(device)
    save_dir = os.path.join(save_dir_root, f"hrqvae_{dataset.name}_{run_stamp(mesh, device)}")
    config = {k: v for k, v in locals().items() if k != "mesh"}
    with run_logging(save_dir) if mesh.is_main else contextlib.nullcontext():
        log_operative_config(logger, config)
        batch_size = global_batch(batch_size, split_batches, mesh, logger)
        # ---- data (hidvae.py:317-376): the .npz read once, for every split ----
        arrays = load_or_build(dataset_folder, dataset, dataset_split, force_dataset_process)
        train_dataset = ItemData(dataset_folder, dataset, arrays=arrays,
                                 train_test_split="train" if do_eval else "all")
        eval_dataset = (ItemData(dataset_folder, dataset, arrays=arrays, train_test_split="eval")
                        if do_eval else None)
        has_tags = train_dataset.has_tags
        if not has_tags:
            logger.warning("Dataset has no tags; disabling tag supervision.")
            tag_alignment_weight = 0.0
            tag_prediction_weight = 0.0

        class_counts = None
        rare_tags_dict = {}
        if has_tags:
            train_dataset.tags_emb, train_dataset.tags_indices = reconcile_tag_layers(
                train_dataset.tags_emb, train_dataset.tags_indices, vae_n_layers)
            if eval_dataset is not None:
                eval_dataset.tags_emb, eval_dataset.tags_indices = reconcile_tag_layers(
                    eval_dataset.tags_emb, eval_dataset.tags_indices, vae_n_layers)
            if tag_class_counts is None:
                tag_class_counts = [int(train_dataset.tags_indices[:, i].max()) + 1
                                    for i in range(vae_n_layers)]
            tag_class_counts = list(tag_class_counts)[:vae_n_layers]
            if use_focal_loss:
                new_counts, id_mappings, rare_tags_dict = compute_rare_tag_remap(
                    train_dataset.tags_indices, tag_class_counts, rare_tag_threshold)
                train_dataset.tags_indices = apply_tag_remap(train_dataset.tags_indices,
                                                             id_mappings)
                if eval_dataset is not None:
                    eval_dataset.tags_indices = apply_tag_remap(eval_dataset.tags_indices,
                                                                id_mappings)
                tag_class_counts = new_counts
                logger.info(f"Rare-tag remap -> tag_class_counts={tag_class_counts}")
                if mesh.is_main:
                    tags_dir = os.path.join(save_dir_root, "special_tags_files")
                    os.makedirs(tags_dir, exist_ok=True)
                    np.savez(os.path.join(tags_dir, "rare_tags.npz"),
                             **{str(k): v for k, v in rare_tags_dict.items()})
                class_counts = tuple(
                    torch.from_numpy(c).to(device)
                    for c in post_remap_class_counts(train_dataset.tags_indices,
                                                     tag_class_counts))

        # ---- model (hidvae.py:385-437) ----
        compute_dtype = (torch.bfloat16 if amp and str(mixed_precision_type).lower() in (
            "bf16", "bfloat16", "fp16", "float16") else None)
        model = build_model(
            vae_input_dim=vae_input_dim, vae_embed_dim=vae_embed_dim,
            vae_hidden_dims=vae_hidden_dims, vae_codebook_size=vae_codebook_size,
            vae_codebook_normalize=vae_codebook_normalize, vae_sim_vq=vae_sim_vq,
            vae_codebook_mode=vae_codebook_mode, vae_n_layers=vae_n_layers,
            vae_n_cat_feats=vae_n_cat_feats, commitment_weight=commitment_weight,
            tag_alignment_weight=tag_alignment_weight,
            tag_prediction_weight=tag_prediction_weight, tag_class_counts=tag_class_counts,
            tag_embed_dim=tag_embed_dim, use_focal_loss=use_focal_loss,
            focal_loss_gamma_base=focal_loss_gamma_base,
            focal_loss_alpha_base=focal_loss_alpha_base, dropout_rate=dropout_rate,
            use_batch_norm=use_batch_norm, alignment_temperature=alignment_temperature,
            sem_id_uniqueness_weight=sem_id_uniqueness_weight,
            sem_id_uniqueness_margin=sem_id_uniqueness_margin,
            use_label_smoothing=use_label_smoothing, label_smoothing_alpha=label_smoothing_alpha,
            use_mixup=use_mixup, mixup_alpha=mixup_alpha, dtype=compute_dtype,
            sem_id_mining_margin=sem_id_mining_margin, mined_loss_isolation=sem_id_mining_isolate,
            seed=seed,
        ).to(device)

        optimizer, plateau_ctl = build_optimizer(
            model, learning_rate=learning_rate, weight_decay=weight_decay,
            gradient_accumulate_every=gradient_accumulate_every,
            layer_specific_lr=layer_specific_lr, predictor_weight_decay=predictor_weight_decay,
            vae_n_layers=vae_n_layers, use_lr_scheduler=use_lr_scheduler,
            lr_scheduler_type=lr_scheduler_type, lr_scheduler_T_max=lr_scheduler_T_max,
            lr_scheduler_eta_min=lr_scheduler_eta_min,
            lr_scheduler_step_size=lr_scheduler_step_size,
            lr_scheduler_gamma=lr_scheduler_gamma, lr_scheduler_factor=lr_scheduler_factor,
            lr_scheduler_patience=lr_scheduler_patience)

        start_iter = 0
        pool_start = None
        if pretrained_hrqvae_path is not None:
            # Params, batch statistics, optimizer state, step (:484-522).
            start_iter, meta = restore_checkpoint(pretrained_hrqvae_path, model, optimizer)
            if sem_id_mining:
                # No pool of this size (or pairs outside the split): uniform.
                cand = load_export_arrays(pretrained_hrqvae_path, "mining_pairs").get(
                    "mining_pairs")
                if (cand is not None and cand.shape == (sem_id_mining_pool, 2)
                        and (cand >= 0).all() and int(cand.max()) < len(train_dataset)):
                    pool_start = cand
                    logger.info(f"Restored mining pool from checkpoint ({len(cand)} pair slots)")
                else:
                    logger.warning("Checkpoint has no usable mining pool; re-seeding uniform "
                                   "until the next corpus audit")
            if plateau_ctl is not None and meta.get("plateau") is not None:
                plateau_ctl.load_state_dict(meta["plateau"])
                logger.info(f"Restored ReduceLROnPlateau state: {plateau_ctl.state_dict()}")
            logger.info(f"Restored pretrained HRqVae from {pretrained_hrqvae_path} "
                        f"(iter {start_iter})")
        elif use_kmeans_init:
            kmeans_init_(model, train_dataset.item_features, len(train_dataset), seed, device,
                         mesh)
            logger.info("K-means codebook initialization complete")

        # ---- device data and steps ----
        ddtype = (torch.bfloat16 if str(device_data_dtype).lower() in ("bf16", "bfloat16")
                  else torch.float32)
        n_pair_rows = int(batch_size * sem_id_mining_frac) // 2 if sem_id_mining else 0
        pairs = None
        if n_pair_rows:
            if pool_start is None:  # uniform until the first audit (hidvae.py:612-617)
                pool_start = np.random.RandomState(seed).randint(
                    0, len(train_dataset), (sem_id_mining_pool, 2)).astype(np.int32)
            pairs = torch.from_numpy(pool_start).to(device)
            logger.info(f"Semantic-ID duplicate mining ON: {n_pair_rows} pairs/batch "
                        f"({2 * n_pair_rows}/{batch_size} rows), pool {sem_id_mining_pool}")
        ddata = DeviceItemData(  # cast on the device, not on the host
            x=torch.from_numpy(train_dataset.item_features).to(device).to(ddtype),
            tags_emb=(torch.from_numpy(train_dataset.tags_emb).to(device).to(ddtype)
                      if has_tags else None),
            tags_indices=(torch.from_numpy(train_dataset.tags_indices).to(device)
                          if has_tags else None),
            mining_pairs=pairs,
        )
        index_feats = torch.from_numpy(np.asarray(arrays.item_features, np.float32)).to(device)
        train_step = make_train_step(model, optimizer, class_counts, n_mined_pairs=n_pair_rows)
        eval_step = make_eval_step(model, class_counts)
        tta_predict = make_tta_predict(model, eval_tta, eval_temperature) if has_tags else None

        history = {k: [] for k in [
            "reconstruction_loss", "rqvae_loss", "tag_align_loss", "tag_pred_loss",
            "tag_pred_accuracy", "eval_iterations", "eval_total_loss", "eval_tag_pred_accuracy",
            "rqvae_entropy", "max_id_duplicates", "repetition_rate", "mined_pair_collision_rate",
            "mining_pool_refreshed",
        ]}
        history["emb_norms"] = [[] for _ in range(vae_n_layers)]
        history["codebook_usage"] = [[] for _ in range(vae_n_layers)]
        rows, layout = shard_rows(batch_size, mesh), batch_rows(batch_size, mesh)
        corpus_ids = None
        best_eval_accuracy = 0.0
        saved_paths = []
        last_audit = (None, None)  # (iteration, repetition) of the newest audit
        total_steps = iterations * gradient_accumulate_every

        def step(it):
            g, host = step_rngs(seed, it, device)
            x, te, ti = local_rows(ddata.sample(g, batch_size, n_pair_rows), rows)
            metrics = train_step(x, te, ti, g, host, layout)
            return metrics["loss"], metrics

        def readback(done, losses, metrics):
            last = torch.cat([torch.stack([metrics[k].float() for k in SCALAR_METRICS]),
                              metrics["emb_norms"].float()]).tolist()
            m = dict(zip(SCALAR_METRICS, last))
            for k in ("reconstruction_loss", "rqvae_loss", "tag_align_loss", "tag_pred_loss",
                      "tag_pred_accuracy", "mined_pair_collision_rate"):
                history[k].append(m[k])
            for level in range(vae_n_layers):
                history["emb_norms"][level].append(last[len(SCALAR_METRICS) + level])
            return losses.tolist(), lambda ms, seconds: (
                f"recon={m['reconstruction_loss']:.4f} rq={m['rqvae_loss']:.4f} "
                f"align={m['tag_align_loss']:.4f} pred={m['tag_pred_loss']:.4f} "
                f"acc={m['tag_pred_accuracy']:.4f} p_unique={m['p_unique_ids']:.4f} "
                + (f"mined_coll={m['mined_pair_collision_rate']:.3f} " if n_pair_rows else "")
                + f"({(done - start_iter) * batch_size / seconds:.0f} items/s)")

        def evaluate(it):
            """Eval, plateau, the corpus audit, the mining harvest and the
            gated checkpoint (hidvae.py:711-791)."""
            nonlocal ddata, corpus_ids, best_eval_accuracy, last_audit
            if not do_eval or eval_dataset is None or len(eval_dataset) == 0:
                return
            eval_metrics = _run_eval(eval_step, tta_predict, eval_dataset, batch_size,
                                     has_tags, eval_batches, device, seed ^ TTA_SALT)
            history["eval_iterations"].append(it)
            history["eval_total_loss"].append(eval_metrics["loss"])
            history["eval_tag_pred_accuracy"].append(eval_metrics["tag_pred_accuracy"])
            logger.info(f"eval @ {it}: {eval_metrics}")
            if plateau_ctl is not None:
                old_scale = plateau_ctl.scale
                new_scale = plateau_ctl.step(eval_metrics["loss"])
                if new_scale != old_scale:
                    optimizer.plateau_scale = new_scale
                    logger.info(f"ReduceLROnPlateau: eval loss plateaued, LR scale "
                                f"{old_scale:.3g} -> {new_scale:.3g} "
                                f"(lr = {learning_rate * new_scale:.3g})")
            # The corpus audit (hidvae.py:738-771).
            tokenizer = HSemanticIdTokenizer(
                model, n_layers=vae_n_layers, codebook_size=vae_codebook_size,
                tag_class_counts=tag_class_counts, device=device)
            corpus_ids = tokenizer.precompute_corpus_ids(index_feats, mesh=mesh).cpu().numpy()
            div = id_diversity_metrics(corpus_ids, vae_codebook_size, vae_n_layers)
            if n_pair_rows:
                # By (seed, step): a resumed run harvests the same pool; the
                # next step samples from it.
                harvested = harvest_duplicate_pairs(
                    corpus_ids, train_dataset.indices, sem_id_mining_pool,
                    np.random.RandomState((seed * MINING_SALT + it) % (2 ** 31)))
                if harvested is not None:
                    ddata = ddata._replace(mining_pairs=torch.from_numpy(harvested).to(device))
                    history["mining_pool_refreshed"].append(it)
                    logger.info(f"Mining pool refreshed from audit @ {it}: "
                                f"{len(harvested)} pair slots")
            history["rqvae_entropy"].append(div["rqvae_entropy"])
            history["max_id_duplicates"].append(div["max_id_duplicates"])
            history["repetition_rate"].append(div["repetition_rate"])
            for level in range(vae_n_layers):
                history["codebook_usage"][level].append(div["codebook_usage"][level])
            logger.info(f"diversity @ {it}: {div}")
            eval_acc = eval_metrics.get("tta_accuracy",
                                        eval_metrics.get("tag_pred_accuracy", 0.0))
            rep = div["repetition_rate"]
            last_audit = (it, rep)
            # The quality-gated checkpoint (hidvae.py:778-791).
            gate_ok = (not has_tags or eval_acc > 0.60) and rep < id_repetition_threshold
            if gate_ok and eval_acc >= best_eval_accuracy:
                best_eval_accuracy = eval_acc
                name = (f"hrqvae_ACC{eval_acc:.4f}_"
                        f"RQLOSS{eval_metrics['rqvae_loss']:.4f}_DUPR{rep:.4f}")
                path = save_on_main(mesh, save_dir, name, lambda: _save(
                    save_dir, name, it, model, optimizer, eval_metrics, rep, plateau_ctl,
                    ddata.mining_pairs))
                saved_paths.append(path)
                logger.info(f"Gated checkpoint saved: {path}")

        def save(it):
            # This chunk's audit, if any, for stage 2's collapse guard.
            rep_now = last_audit[1] if last_audit[0] == it else None
            saved_paths.append(save_on_main(mesh, save_dir, "latest", lambda: _save(
                save_dir, "latest", it, model, optimizer, {}, rep_now, plateau_ctl,
                ddata.mining_pairs)))

        history.update(run_chunks(step, readback, device=device, start_iter=start_iter,
                                  n_steps=total_steps, log_every=log_every,
                                  loss_key="total_loss", log=logger.info,
                                  events=((eval_every, evaluate), (save_model_every, save))))
        if make_plots and mesh.is_main:
            plots.save_plots(plots.plot_hidvae_history, history, save_dir, logger)

        return {"model": model, "optimizer": optimizer, "step": start_iter + total_steps,
                "save_dir": save_dir, "history": history, "tag_class_counts": tag_class_counts,
                "rare_tags": rare_tags_dict, "best_eval_accuracy": best_eval_accuracy,
                "saved_paths": saved_paths, "data": ddata, "class_counts": class_counts,
                "n_pair_rows": n_pair_rows, "mesh": mesh, "corpus_ids": corpus_ids,
                "mining_pool_start": pool_start if n_pair_rows else None}
