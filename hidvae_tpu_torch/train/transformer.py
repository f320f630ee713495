"""Stage-2 decoder trainer (counterpart of hidvae_tpu/train/transformer.py).

`train` takes the JAX gin surface (:193-246, same defaults) and `device`:
reads the splits (:284-301); rebuilds the frozen tokenizer from an export,
sweeps and audits the corpus (:331-342); adopts a pretrained decoder
(:345-414); trains (`run_loop`, a generator per (seed, step), :542) with
the partial and generation evals and checkpoints in the JAX chunks
(:612-672); ends with the TEST eval, plots and train.log. `train_arrays`:
the loop over in-memory arrays. Contexts of 2048+ tokens take the flash
route; `remat` rematerializes every block; `wandb_logging` and
`model_jagged_mode` are ignored, as in JAX.

Multi-GPU (:416-464): over `make_mesh(n_model=n_model_shards)` each rank
draws the global batch and keeps its rows; model ranks cut the ID table,
`out_proj` and the FF kernels; gradients average over the data ranks;
rank 0 writes whole-array checkpoints, which resume on any mesh."""

import contextlib
import logging
import os
import time
from dataclasses import fields
from typing import Optional, Sequence

import numpy as np
import torch

from hidvae_tpu_torch.bridge import state_dict_to_flax
from hidvae_tpu_torch.data.processed import ItemData, RecDataset, SeqData
from hidvae_tpu_torch.evaluate.metrics import NDCGAccumulator, TopKAccumulator
from hidvae_tpu_torch.models.attention import takes_flash_route
from hidvae_tpu_torch.models.hrqvae import HRqVae
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from hidvae_tpu_torch.models.rqvae import RqVae
from hidvae_tpu_torch.ops.dropout import RowShard
from hidvae_tpu_torch.ops.flash_attention import check_head_dim
from hidvae_tpu_torch.ops.prefix_search import tries_on_device
from hidvae_tpu_torch.parallel.collectives import all_reduce_
from hidvae_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    gather_stage2_flat,
    make_mesh,
    shard_rows,
    shard_stage2_,
    sharded_params,
)
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from hidvae_tpu_torch.train import plots
from hidvae_tpu_torch.train.common import (
    Optimizer,
    audit_rebuilt_corpus,
    global_batch,
    inverse_sqrt_schedule,
    log_operative_config,
    reconcile_decoder_geometry,
    reconcile_vae_config,
    reduce_gradients_,
    restore_checkpoint,
    restore_export,
    run_chunks,
    run_stamp,
    save_checkpoint,
    run_logging,
    step_generator,
)
from hidvae_tpu_torch.train.device_data import (
    DeviceSeqData,
    crop_uniforms,
    random_crop_windows,
    tokenize_on_device,
)
from hidvae_tpu_torch.utils.debug import compute_debug_metrics, span
from hidvae_tpu_torch.utils.runtime import resolve_device

logger = logging.getLogger("hidvae_tpu_torch.train.transformer")

EVAL_KS = (1, 5, 10)  # hit@K and NDCG@K of the full eval


def _build_tokenizer(
    *,
    use_h_tokenizer,
    pretrained_rqvae_path,
    vae_input_dim,
    vae_embed_dim,
    vae_hidden_dims,
    vae_codebook_size,
    vae_n_layers,
    vae_n_cat_feats,
    vae_codebook_normalize,
    vae_sim_vq,
    tag_class_counts,
    tag_embed_dim,
    use_dedup_dim,
    use_concatenated_ids,
    use_interleaved_ids,
    commitment_weight,
    device=None,
    seed=42,
):
    """The frozen stage-1 model from the export `pretrained_rqvae_path` (its
    structural config winning, loudly; restored leniently, eval mode; without
    a path seeded from `seed`, as JAX keeps its init), and its tokenizer."""
    rec = {
        "input_dim": vae_input_dim,
        "embed_dim": vae_embed_dim,
        "hidden_dims": list(vae_hidden_dims),
        "codebook_size": vae_codebook_size,
        "codebook_normalize": vae_codebook_normalize,
        "codebook_sim_vq": vae_sim_vq,
        "n_layers": vae_n_layers,
        "n_cat_features": vae_n_cat_feats,
        "tag_class_counts": (
            list(tag_class_counts) if tag_class_counts is not None else None
        ),
        "tag_embed_dim": tag_embed_dim,
    }
    if pretrained_rqvae_path is not None:
        rec = reconcile_vae_config(pretrained_rqvae_path, rec, logger)
    vae_n_layers = rec["n_layers"]
    vae_codebook_size = rec["codebook_size"]
    tag_class_counts = rec["tag_class_counts"]
    # n_cat_features shapes only the reconstruction loss, not the eval model.
    widths = (rec["input_dim"], rec["embed_dim"], tuple(rec["hidden_dims"]), vae_codebook_size)
    common = dict(codebook_normalize=rec["codebook_normalize"],
                  codebook_sim_vq=rec["codebook_sim_vq"], n_layers=vae_n_layers,
                  commitment_weight=commitment_weight)
    if use_h_tokenizer:
        model = HRqVae(*widths, tag_class_counts=tag_class_counts,
                       tag_embed_dim=rec["tag_embed_dim"], use_batch_norm=True, **common)
    else:
        model = RqVae(*widths, **common)
    if pretrained_rqvae_path is None:
        logger.warning("no pretrained_rqvae_path: the frozen tokenizer keeps seeded random "
                       "weights")
        init_params_(model, torch.Generator().manual_seed(seed))
    else:
        restore_export(pretrained_rqvae_path, model)
    model.eval()
    if use_h_tokenizer:
        return HSemanticIdTokenizer(
            model, n_layers=vae_n_layers, codebook_size=vae_codebook_size,
            tag_class_counts=tag_class_counts, use_dedup_dim=use_dedup_dim,
            use_concatenated_ids=use_concatenated_ids, use_interleaved_ids=use_interleaved_ids,
            device=device,
        )
    return SemanticIdTokenizer(model, n_layers=vae_n_layers, codebook_size=vae_codebook_size,
                               use_dedup_dim=use_dedup_dim, device=device)


def build_model(*, sem_id_dim: int, max_seq_len: int, vae_codebook_size: int = 256,
                vae_n_layers: int = 3, decoder_embed_dim: int = 128, dropout_p: float = 0.3,
                attn_heads: int = 8, attn_embed_dim: int = 512, attn_layers: int = 8,
                use_interleaved_ids: bool = False, dtype=torch.float32, remat: bool = False,
                seed: int = 42):
    """The stage-2 model with seeded flax-distributed weights, on the CPU
    (transformer.py:371-389; max_pos = max_seq_len * sem_id_dim, :382)."""
    model = EncoderDecoderRetrievalModel(
        decoder_embed_dim, attn_embed_dim, attn_heads, attn_layers, vae_codebook_size,
        sem_id_dim, max_pos=max_seq_len * sem_id_dim, n_sem_layers=vae_n_layers,
        use_interleaved_ids=use_interleaved_ids, dropout=dropout_p, dtype=dtype, remat=remat,
    )
    return init_params_(model, torch.Generator().manual_seed(seed))


def sample_batch(data: DeviceSeqData, table, batch_size: int, generator: torch.Generator,
                 subsample: bool = True, rows: slice = slice(None)):
    """One step's rows, windows cropped when `subsample`, tokenized by
    gather (transformer.py:543-548); of the `batch_size` drawn, this rank's
    `rows`."""
    u, hist, target = data.sample_rows(generator, batch_size)
    if subsample:
        u1, u2 = crop_uniforms(generator, batch_size, table.device)
        hist, target = random_crop_windows(u1[rows], u2[rows], hist[rows], target[rows])
    else:
        hist, target = hist[rows], target[rows]
    return tokenize_on_device(table, u[rows], hist, target)


def train_step(model, optimizer: Optimizer, batch, generator, mesh: Optional[Mesh] = None):
    """One AdamW update; dropout from `generator` (None: deterministic),
    gradients averaged over the data ranks (a missing one as zeros).
    Returns this rank's (loss, loss_d), not synced."""
    with span("train.forward"):
        optimizer.zero_grad()
        out = model(batch, generator)
    with span("train.backward"):
        out.loss.backward()
    if mesh is not None and mesh.data_group is not None:
        with span("train.grad_average"):
            for p in optimizer.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            reduce_gradients_(optimizer.params, mesh.data_group, mesh.n_data)
    with span("train.optimizer"):
        optimizer.step()
    return out.loss.detach(), out.loss_d.detach()


def as_seq_data(users, items, fut, device) -> DeviceSeqData:
    """Histories as int32 tensors on `device`."""
    def put(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.int32)

    return DeviceSeqData(put(users), put(items), put(fut))


def device_batches(data: DeviceSeqData, batch_size: int):
    """In-order batches (user ids, histories, targets) of device data, the
    last one ragged."""
    for start in range(0, data.n, batch_size):
        sl = slice(start, min(start + batch_size, data.n))
        yield data.user_ids[sl], data.items[sl], data.fut[sl]


@torch.no_grad()
def eval_loss(model, table, batches, eval_batches: Optional[int] = None,
              mesh: Optional[Mesh] = None):
    """Row-weighted mean eval loss over `batches` of (users, histories,
    targets) (transformer.py:615-636), the data ranks splitting every batch
    after the first. Returns (loss, the first batch's debug metrics)."""
    total, rows, dbg = 0.0, 0, {}
    for bi, arrays in enumerate(batches):
        if eval_batches is not None and bi >= eval_batches:
            break
        users, items, fut = (torch.as_tensor(a).to(table.device) for a in arrays)
        n = items.shape[0]
        part = shard_rows(n, mesh) if mesh is not None and bi > 0 else slice(0, n)
        batch = tokenize_on_device(table, users[part], items[part], fut[part])
        out = model(batch)
        if part.stop - part.start == n:
            total += float(out.loss) * n
        else:
            local = torch.tensor(float(out.loss) * (part.stop - part.start),
                                 dtype=torch.float64, device=table.device)
            total += float(all_reduce_(local, mesh.data_group))
        rows += n
        if bi == 0:
            dbg = compute_debug_metrics(batch, out, prefix="eval")
    return total / max(rows, 1), dbg


def _pad_rows(arrays, n: int):
    """Each array padded to n rows with row 0 (transformer.py:709-720): one
    shape for every eval batch; callers slice back."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        out.append(a[np.concatenate([np.arange(len(a)), np.zeros(n - len(a), np.int64)])])
    return tuple(out)


@torch.no_grad()
def full_eval(generate, tokenizer, eval_seq, batch_size: int, eval_batches=None,
              prefix_tries=None, log=None, mesh: Optional[Mesh] = None):
    """Constrained-generation eval (transformer.py:723-752): `eval_seq`'s
    batches through `generate(batch, prefix_index, prefix_tries)`, hit@K and
    NDCG@K per digit and prefix, rows split over the data ranks."""
    topk = TopKAccumulator(ks=list(EVAL_KS))
    ndcg = NDCGAccumulator(ks=list(EVAL_KS))
    table, index = tokenizer.cached_ids, tokenizer.prefix_index
    for bi, arrays in enumerate(eval_seq.iter_eval_batches(batch_size)):
        if eval_batches is not None and bi >= eval_batches:
            break
        n_valid = len(arrays[0])
        if n_valid < batch_size:
            arrays = _pad_rows(arrays, batch_size)
        users, items, fut = (torch.from_numpy(np.asarray(a)).to(table.device) for a in arrays)
        tok = tokenize_on_device(table, users, items, fut)
        if mesh is None:
            gen_ids = generate(tok, index, prefix_tries).sem_ids
        else:
            part = shard_rows(batch_size, mesh)
            mine = tok.replace(**{f.name: getattr(tok, f.name)[part] for f in fields(tok)})
            gen_ids = gather_rows(generate(mine, index, prefix_tries).sem_ids, batch_size, mesh)
        actual = tok.sem_ids_fut[:n_valid].cpu().numpy()
        top_k_ids = gen_ids[:n_valid].cpu().numpy()
        topk.accumulate(actual, top_k_ids)
        ndcg.accumulate(actual, top_k_ids)
        if bi == 0 and log is not None:
            for s in range(min(3, len(actual))):
                log(f"eval sample {s}: actual={actual[s].tolist()} "
                    f"top3={[row.tolist() for row in top_k_ids[s, :3]]} "
                    f"hit@10={bool((top_k_ids[s, :10] == actual[s]).all(-1).any())}")
    return {**topk.reduce(), **ndcg.reduce()}


def run_loop(model, optimizer: Optimizer, data: DeviceSeqData, table, *, seed: int,
             start_iter: int, iterations: int, batch_size: int, subsample: bool,
             log_every: int, events=(), log=None, mesh: Optional[Mesh] = None) -> dict:
    """Steps start_iter .. + iterations - 1 with `step_generator(seed, step)`
    in `run_chunks`, the losses logged with loss_d and the rate (:576-587),
    split rows' averaged over the data ranks first. Returns the history."""
    device = table.device
    rows = slice(0, batch_size) if mesh is None else shard_rows(batch_size, mesh)
    split = rows.stop - rows.start < batch_size

    def step(it):
        with span("train.sample"):
            g = step_generator(seed, it, device)
            batch = sample_batch(data, table, batch_size, g, subsample, rows)
        # A batch every data rank runs whole needs no gradient average.
        return train_step(model, optimizer, batch,
                          RowShard(g, rows.start, batch_size) if split else g,
                          mesh if split else None)

    def readback(done, losses, loss_d):
        if split:  # the rows' means -> the global batch's (equal parts)
            n = len(losses)
            losses = all_reduce_(torch.cat([losses, loss_d.float()]), mesh.data_group)
            losses, loss_d = (losses / mesh.n_data).split([n, len(loss_d)])
        loss_d = [round(x, 3) for x in loss_d.float().tolist()]
        return losses.tolist(), lambda ms, _: (f"loss_d={loss_d} ({ms:.1f} ms/step, "
                                               f"{batch_size * 1e3 / ms:.0f} seqs/s)")

    return run_chunks(step, readback, device=device, start_iter=start_iter, n_steps=iterations,
                      log_every=log_every, loss_key="train_loss", events=events, log=log)


def _shard(model, optimizer: Optimizer, mesh: Mesh):
    """Cut the model and its moments over the mesh's model ranks; the clip
    then sums the cut leaves' squares over them. Returns the layout."""
    layout = shard_stage2_(model, mesh, optimizer)
    if mesh.n_model > 1:
        optimizer.model_parts = ({id(p) for p in sharded_params(model)}, mesh.model_group)
        logger.info(f"Tensor-parallel params over {mesh.n_model} shards "
                    f"(mesh {mesh.shape})")
    return layout


def _check_flash_width(attn_embed_dim, attn_heads, max_seq_len, sem_id_dim, device):
    head_dim = attn_embed_dim // attn_heads
    if takes_flash_route(head_dim, 1 + max_seq_len * sem_id_dim):  # user + history tokens
        check_head_dim(head_dim, device.type)


def train(
    iterations=200_000,
    batch_size=64,
    learning_rate=0.0003,
    weight_decay=0.035,
    max_grad_norm=None,
    dataset_folder="dataset/synthetic",
    dataset=RecDataset.SYNTHETIC,
    pretrained_rqvae_path=None,
    pretrained_decoder_path=None,
    save_dir_root="out/decoder/",
    split_batches=True,
    amp=False,
    force_dataset_process=False,
    mixed_precision_type="bf16",
    save_model_every=1_000_000,
    partial_eval_every=5_000,
    full_eval_every=10_000,
    vae_input_dim=768,
    vae_embed_dim=32,
    vae_hidden_dims=(512, 256, 128),
    vae_codebook_size=256,
    vae_codebook_normalize=False,
    vae_sim_vq=False,
    vae_n_cat_feats=18,
    vae_n_layers=3,
    decoder_embed_dim=128,
    dropout_p=0.3,
    attn_dropout=None,
    attn_heads=8,
    attn_embed_dim=512,
    attn_layers=8,
    dataset_split="beauty",
    use_h_tokenizer=True,
    tag_alignment_weight=0.5,
    tag_prediction_weight=0.5,
    tag_class_counts=None,
    tag_embed_dim=768,
    use_dedup_dim=False,
    use_concatenated_ids=False,
    use_interleaved_ids=False,
    commitment_weight=0.25,
    model_jagged_mode=True,
    wandb_logging=False,
    seed=42,
    log_every=100,
    eval_batches=None,
    generation_temperature=1.0,
    warmup_steps=10_000,
    remat=False,
    make_plots=True,
    n_model_shards=1,
    device=None,
):
    """`python train_transformer.py CONFIG.gin`. Returns {"model", "optimizer",
    "step", "tokenizer", "save_dir", "history", "saved_paths", "mesh", "layout"};
    history: the JAX keys, ms_per_step, window_mean, collective_bytes_per_step,
    full_eval_seconds, save_seconds."""
    device = resolve_device(device)
    mesh = make_mesh(n_model=n_model_shards)
    if use_h_tokenizer and use_dedup_dim and use_interleaved_ids:
        raise ValueError(
            "use_dedup_dim and use_interleaved_ids are mutually exclusive for the "
            "hierarchical tokenizer (dedup ranks are a plain-SemanticID feature)")
    if not use_h_tokenizer and use_interleaved_ids:
        # PARITY.md #12: the plain tokenizer has no tags to interleave.
        logger.warning("use_interleaved_ids=True has no effect with the plain tokenizer "
                       "(no tags to interleave) — ignoring it")
        use_interleaved_ids = False
    if attn_dropout is not None:
        dropout_p = attn_dropout
    save_dir = os.path.join(save_dir_root, f"decoder_{dataset.name}_{run_stamp(mesh, device)}")
    config = {k: v for k, v in locals().items() if k != "mesh"}
    with run_logging(save_dir) if mesh.is_main else contextlib.nullcontext():
        log_operative_config(logger, config)
        batch_size = global_batch(batch_size, split_batches, mesh, logger)
        # ---- data (transformer.py:284-301) ----
        item_dataset = ItemData(dataset_folder, dataset, train_test_split="all",
                                split=dataset_split, force_process=force_dataset_process)
        train_seq = SeqData(dataset_folder, dataset, is_train=True, subsample=True,
                            split=dataset_split)
        eval_seq = SeqData(dataset_folder, dataset, is_train=False, split=dataset_split)
        test_seq = SeqData(dataset_folder, dataset, split=dataset_split, seq_split="test")

        # ---- tokenizer (frozen stage 1), corpus table and audit ----
        tokenizer = _build_tokenizer(
            use_h_tokenizer=use_h_tokenizer, pretrained_rqvae_path=pretrained_rqvae_path,
            vae_input_dim=vae_input_dim, vae_embed_dim=vae_embed_dim,
            vae_hidden_dims=vae_hidden_dims, vae_codebook_size=vae_codebook_size,
            vae_n_layers=vae_n_layers, vae_n_cat_feats=vae_n_cat_feats,
            vae_codebook_normalize=vae_codebook_normalize, vae_sim_vq=vae_sim_vq,
            tag_class_counts=tag_class_counts, tag_embed_dim=tag_embed_dim,
            use_dedup_dim=use_dedup_dim, use_concatenated_ids=use_concatenated_ids,
            use_interleaved_ids=use_interleaved_ids, commitment_weight=commitment_weight,
            device=device, seed=seed,
        )
        # The checkpoint-reconciled geometry, not the possibly stale gin values.
        vae_codebook_size, vae_n_layers = tokenizer.codebook_size, tokenizer.n_layers
        corpus_ids = tokenizer.precompute_corpus_ids(item_dataset.item_features, mesh=mesh)
        sem_id_dim = tokenizer.sem_ids_dim
        logger.info(f"Corpus table: {tuple(corpus_ids.shape)}, sem_ids_dim={sem_id_dim}")
        audit_rebuilt_corpus(tokenizer, corpus_ids.cpu().numpy(), pretrained_rqvae_path, log=logger)

        # ---- model ----
        if pretrained_decoder_path is not None:
            rec = reconcile_decoder_geometry(
                pretrained_decoder_path, sem_id_dim, decoder_embed_dim=decoder_embed_dim,
                attn_embed_dim=attn_embed_dim, attn_heads=attn_heads, attn_layers=attn_layers,
                logger=logger)
            attn_embed_dim, attn_heads = rec["attn_embed_dim"], rec["attn_heads"]
            attn_layers, decoder_embed_dim = rec["attn_layers"], rec["decoder_embed_dim"]
        max_seq_len = train_seq.max_seq_len
        _check_flash_width(attn_embed_dim, attn_heads, max_seq_len, sem_id_dim, device)
        compute_dtype = (torch.bfloat16 if (amp or mixed_precision_type == "bf16")
                         else torch.float32)
        model = build_model(
            sem_id_dim=sem_id_dim, max_seq_len=max_seq_len, vae_codebook_size=vae_codebook_size,
            vae_n_layers=vae_n_layers, decoder_embed_dim=decoder_embed_dim, dropout_p=dropout_p,
            attn_heads=attn_heads, attn_embed_dim=attn_embed_dim, attn_layers=attn_layers,
            use_interleaved_ids=use_interleaved_ids, dtype=compute_dtype, remat=remat, seed=seed,
        ).to(device)
        optimizer = Optimizer(model.parameters(),
                              inverse_sqrt_schedule(learning_rate, warmup_steps), weight_decay,
                              max_grad_norm=max_grad_norm)
        start_iter = 0
        if pretrained_decoder_path is not None:
            # Params, moments, both counts and the step, as JAX's TrainState.
            start_iter, _ = restore_checkpoint(pretrained_decoder_path, model, optimizer)
            logger.info(f"Restored decoder from {pretrained_decoder_path} (iter {start_iter})")
        layout = _shard(model, optimizer, mesh)

        data = as_seq_data(train_seq.users, train_seq.items, train_seq.fut, device)
        table = corpus_ids.to(torch.int32)
        prefix_caps = tuple(tokenizer.prefix_caps) if tokenizer.prefix_caps else None
        prefix_tries = tries_on_device(tokenizer.prefix_tries(model.num_embeddings), device)

        def generate(batch, index, tries):
            return model.generate_next_sem_id(batch, index, temperature=generation_temperature,
                                              prefix_caps=prefix_caps, prefix_tries=tries)

        history = {"eval_iterations": [], "eval_loss": [], "full_eval_iterations": [],
                   "full_eval_metrics": [], "test_eval_metrics": None,
                   "full_eval_seconds": [], "save_seconds": []}
        saved = []

        def partial(it):
            loss, dbg = eval_loss(model, table, eval_seq.iter_eval_batches(batch_size),
                                  eval_batches, mesh)
            history["eval_iterations"].append(it)
            history["eval_loss"].append(loss)
            logger.info(f"partial eval @ {it}: loss={loss:.4f} "
                        + " ".join(f"{k}={v:.3g}" for k, v in dbg.items()))

        def full(it):
            t0 = time.perf_counter()
            metrics = full_eval(generate, tokenizer, eval_seq, batch_size,
                                eval_batches=eval_batches, prefix_tries=prefix_tries,
                                log=logger.info, mesh=mesh)
            history["full_eval_seconds"].append(time.perf_counter() - t0)  # ends in read-backs
            history["full_eval_iterations"].append(it)
            history["full_eval_metrics"].append(metrics)
            logger.info(f"full eval @ {it}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(metrics.items()) if "slice" in k or "pos" in k))

        def save(it):
            t0 = time.perf_counter()  # the state read back to the host, then written
            payload = {
                "step": it,
                # Whole arrays: a model-sharded leaf is gathered on every rank.
                "params": gather_stage2_flat(state_dict_to_flax(model)[0], layout, mesh, device),
                "opt_state": gather_stage2_flat(optimizer.state_dict(model), layout, mesh,
                                                device),
                # The full structural config: serving and a decoder resume
                # reconcile against it.
                "model_config": {
                    "attn_dim": attn_embed_dim,  # legacy key, kept for old readers
                    "attn_embed_dim": attn_embed_dim,
                    "attn_heads": attn_heads,
                    "attn_layers": attn_layers,
                    "decoder_embed_dim": decoder_embed_dim,
                    "sem_id_dim": sem_id_dim,
                    "num_embeddings": int(vae_codebook_size),
                    "n_sem_layers": int(vae_n_layers),
                    "use_interleaved_ids": bool(use_interleaved_ids),
                    "max_pos": int(max_seq_len * sem_id_dim),
                },
                "metrics": {},
            }
            name = f"checkpoint_{it}"
            saved.append(save_checkpoint(save_dir, name, payload) if mesh.is_main
                          else os.path.abspath(os.path.join(save_dir, name)))
            history["save_seconds"].append(time.perf_counter() - t0)

        events = ((partial_eval_every, partial), (full_eval_every, full), (save_model_every, save))
        history.update(run_loop(model, optimizer, data, table, seed=seed, start_iter=start_iter,
                                iterations=iterations, batch_size=batch_size,
                                subsample=train_seq.subsample,
                                log_every=log_every, events=events, log=logger.info, mesh=mesh))

        # The held-out TEST split (targets items[-1]), once after training.
        if len(test_seq) > 0:
            test_metrics = full_eval(generate, tokenizer, test_seq, batch_size,
                                     eval_batches=eval_batches, prefix_tries=prefix_tries,
                                     mesh=mesh)
            history["test_eval_metrics"] = test_metrics
            logger.info("TEST eval (items[-1] targets): " + ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(test_metrics.items())
                if "slice" in k or "pos" in k))

        if make_plots and mesh.is_main:
            plots.save_plots(plots.plot_transformer_history, history, save_dir, logger)

        return {"model": model, "optimizer": optimizer, "step": start_iter + iterations,
                "tokenizer": tokenizer, "save_dir": save_dir, "history": history,
                "saved_paths": saved, "mesh": mesh, "layout": layout}


def train_arrays(
    item_features,
    users,
    items,
    fut,
    *,
    vae,
    iterations: int = 200_000,
    batch_size: int = 64,
    learning_rate: float = 0.0003,
    weight_decay: float = 0.035,
    max_grad_norm: Optional[float] = None,
    amp: bool = False,
    mixed_precision_type: str = "bf16",
    partial_eval_every: int = 5_000,
    vae_codebook_size: int = 256,
    vae_n_layers: int = 3,
    decoder_embed_dim: int = 128,
    dropout_p: float = 0.3,
    attn_dropout: Optional[float] = None,
    attn_heads: int = 8,
    attn_embed_dim: int = 512,
    attn_layers: int = 8,
    tag_class_counts: Optional[Sequence[int]] = None,
    use_dedup_dim: bool = False,
    use_concatenated_ids: bool = False,
    use_interleaved_ids: bool = False,
    seed: int = 42,
    log_every: int = 100,
    eval_batches: Optional[int] = None,
    warmup_steps: int = 10_000,
    remat: bool = False,
    subsample: bool = True,
    eval_users=None,
    eval_items=None,
    eval_fut=None,
    n_model_shards: int = 1,
    device=None,
    log=None,
):
    """`train`'s loop over arrays (histories `items`, targets `fut`, `users`;
    `item_features` tokenized by the frozen `vae`), an eval loss every
    `partial_eval_every` steps and at the end. Returns {"model", "tokenizer",
    "optimizer", "history", "mesh", "layout"}."""
    device = resolve_device(device)
    mesh = make_mesh(n_model=n_model_shards)
    if attn_dropout is not None:
        dropout_p = attn_dropout
    log = log or (lambda line: None)

    tokenizer = HSemanticIdTokenizer(
        vae, n_layers=vae_n_layers, codebook_size=vae_codebook_size,
        tag_class_counts=tag_class_counts, use_dedup_dim=use_dedup_dim,
        use_concatenated_ids=use_concatenated_ids, use_interleaved_ids=use_interleaved_ids,
        device=device,
    )
    table = tokenizer.precompute_corpus_ids(item_features, mesh=mesh).to(torch.int32)
    sem_id_dim = tokenizer.sem_ids_dim
    log(f"Corpus table: {tuple(table.shape)}, sem_ids_dim={sem_id_dim}")

    data = as_seq_data(users, items, fut, device)
    eval_data = (None if eval_items is None
                 else as_seq_data(eval_users, eval_items, eval_fut, device))
    max_seq_len = data.items.shape[1]
    _check_flash_width(attn_embed_dim, attn_heads, max_seq_len, sem_id_dim, device)
    compute_dtype = (torch.bfloat16 if (amp or mixed_precision_type == "bf16")
                     else torch.float32)
    model = build_model(
        sem_id_dim=sem_id_dim, max_seq_len=max_seq_len, vae_codebook_size=vae_codebook_size,
        vae_n_layers=vae_n_layers, decoder_embed_dim=decoder_embed_dim, dropout_p=dropout_p,
        attn_heads=attn_heads, attn_embed_dim=attn_embed_dim, attn_layers=attn_layers,
        use_interleaved_ids=use_interleaved_ids, dtype=compute_dtype, remat=remat, seed=seed,
    ).to(device)
    optimizer = Optimizer(model.parameters(), inverse_sqrt_schedule(learning_rate, warmup_steps),
                          weight_decay, max_grad_norm=max_grad_norm)
    layout = _shard(model, optimizer, mesh)

    history = {"eval_iterations": [], "eval_loss": []}

    def partial(it):
        loss, _ = eval_loss(model, table, device_batches(eval_data, batch_size), eval_batches,
                            mesh)
        history["eval_iterations"].append(it)
        history["eval_loss"].append(loss)
        log(f"partial eval @ {it}: loss={loss:.4f}")

    events = () if eval_data is None else ((partial_eval_every, partial),)
    history.update(run_loop(model, optimizer, data, table, seed=seed, start_iter=0,
                            iterations=iterations, batch_size=batch_size, subsample=subsample,
                            log_every=log_every, events=events, log=log, mesh=mesh))
    return {"model": model, "tokenizer": tokenizer, "optimizer": optimizer,
            "history": history, "mesh": mesh, "layout": layout}
