"""Stage-2 decoder trainer (counterpart of hidvae_tpu/train/transformer.py
`train`, :193-248 for the keywords).

The frozen stage-1 HiD-VAE comes in as a module and the data as in-memory
arrays (`item_features`, and the training histories `users`, `items`, `fut`)
in place of `dataset_folder`. Steps, as in the JAX trainer:
  * the tokenizer sweeps the corpus into the ID table (`rq_assign`: the CUDA
    kernel on the card), transformer.py:331;
  * the model (:371-389) and AdamW under the inverse-sqrt schedule;
  * per step, a generator derived from (seed, step), as :542 folds the step
    into its key: sample rows, random-crop windows (when `subsample`),
    tokenize by gather, one train step with dropout (:556-568);
  * an eval-loss pass over the eval arrays (:478) when the step count
    crosses `partial_eval_every` and at the end;
  * a sliding window of the last 1000 per-step losses (:576-587), and the
    history dict. Each step's 0-d loss stays on the device; the log step
    stacks them and reads them back in one sync.

The encoder's self-attention takes the flash route (CUDA kernels on the
card) exactly where the JAX package takes its flash kernel: at contexts of
at least 2048 tokens. A head width the kernels are not built for is refused
before the first step on a CUDA device.

`_build_tokenizer` rebuilds the frozen stage-1 tokenizer from an exported
checkpoint (transformer.py:51-190), on either route; serving's
`from_artifacts` calls it.

Not ported yet: saving checkpoints and resume, the full generation eval,
tensor parallelism, remat, plots, and training from a gin file and the
on-disk dataset.
"""

import logging
import math
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from hidvae_tpu_torch.models.attention import takes_flash_route
from hidvae_tpu_torch.models.hrqvae import HRqVae
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from hidvae_tpu_torch.models.rqvae import RqVae
from hidvae_tpu_torch.ops.flash_attention import check_head_dim
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from hidvae_tpu_torch.train.common import (
    Optimizer,
    inverse_sqrt_schedule,
    reconcile_vae_config,
    restore_export,
)
from hidvae_tpu_torch.train.device_data import (
    DeviceSeqData,
    crop_uniforms,
    random_crop_windows,
    tokenize_on_device,
)
from hidvae_tpu_torch.utils.runtime import resolve_device

logger = logging.getLogger("hidvae_tpu_torch.train.transformer")

STEP_SALT = 0x5EED  # the JAX trainer's fold_in constant for per-step keys
LOSS_WINDOW = 1000  # per-step losses in the window mean (transformer.py:576)


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
):
    """The frozen stage-1 model restored from the exported checkpoint
    `pretrained_rqvae_path`, and its tokenizer service, on `device` (`cuda`
    unless given).

    The structural VAE values are first reconciled against the
    checkpoint's recorded model_config (checkpoint values win, loudly), so a
    decoder config that omits e.g. vae_codebook_normalize does not rebuild
    the quantizer with other distance semantics. Then the HiD-VAE (H route)
    or the plain RQ-VAE is built in eval mode and restored leniently from
    the export, BatchNorm running statistics included. The JAX function's
    training-only arguments (quantizer forward mode, dropout, focal loss,
    mixup, label smoothing, loss weights) change nothing in eval and are
    not taken."""
    rec = reconcile_vae_config(
        pretrained_rqvae_path,
        {
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
        },
        logger,
    )
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


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one training step: a function of (seed, step) only,
    so a step's sample, crop and dropout draws do not depend on history."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0x7FFFFFFF) << 32 | STEP_SALT << 16) ^ (step & 0xFFFFFFFF))
    return g


def build_model(*, sem_id_dim: int, max_seq_len: int, vae_codebook_size: int = 256,
                vae_n_layers: int = 3, decoder_embed_dim: int = 128, dropout_p: float = 0.3,
                attn_heads: int = 8, attn_embed_dim: int = 512, attn_layers: int = 8,
                use_interleaved_ids: bool = False, dtype=torch.float32, seed: int = 42):
    """The stage-2 model with seeded flax-distributed weights, on the CPU
    (transformer.py:371-389; max_pos = max_seq_len * sem_id_dim, :382)."""
    model = EncoderDecoderRetrievalModel(
        decoder_embed_dim, attn_embed_dim, attn_heads, attn_layers, vae_codebook_size,
        sem_id_dim, max_pos=max_seq_len * sem_id_dim, n_sem_layers=vae_n_layers,
        use_interleaved_ids=use_interleaved_ids, dropout=dropout_p, dtype=dtype,
    )
    return init_params_(model, torch.Generator().manual_seed(seed))


def sample_batch(data: DeviceSeqData, table, batch_size: int, generator: torch.Generator,
                 subsample: bool = True):
    """One step's batch: sample rows, random-crop windows when `subsample`,
    tokenize by gather from the corpus table (transformer.py:543-548)."""
    u, hist, target = data.sample_rows(generator, batch_size)
    if subsample:
        u1, u2 = crop_uniforms(generator, batch_size, table.device)
        hist, target = random_crop_windows(u1, u2, hist, target)
    return tokenize_on_device(table, u, hist, target)


def train_step(model, optimizer: Optimizer, batch, generator: Optional[torch.Generator]):
    """One AdamW update on `batch`; dropout draws from `generator` (None runs
    the forward deterministically). Returns (loss, loss_d), not synced."""
    optimizer.zero_grad()
    out = model(batch, generator)
    out.loss.backward()
    optimizer.step()
    return out.loss.detach(), out.loss_d.detach()


@torch.no_grad()
def eval_loss(model, table, data: DeviceSeqData, batch_size: int,
              eval_batches: Optional[int] = None) -> float:
    """Row-weighted mean eval loss over the data in order, in batches
    (transformer.py:478, the partial eval)."""
    total, rows = 0.0, 0
    for bi, start in enumerate(range(0, data.n, batch_size)):
        if eval_batches is not None and bi >= eval_batches:
            break
        sl = slice(start, min(start + batch_size, data.n))
        batch = tokenize_on_device(table, data.user_ids[sl], data.items[sl], data.fut[sl])
        n = sl.stop - sl.start
        total += float(model(batch).loss) * n
        rows += n
    return total / max(rows, 1)


def as_seq_data(users, items, fut, device) -> DeviceSeqData:
    """Histories as int32 tensors on `device`."""
    def put(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.int32)

    return DeviceSeqData(put(users), put(items), put(fut))


def train(
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
    subsample: bool = True,
    eval_users=None,
    eval_items=None,
    eval_fut=None,
    device=None,
    log=None,
):
    """Train the stage-2 decoder on histories `items` [n, max_seq_len] (-1
    padded) with targets `fut` [n] and user ids `users` [n], over the catalog
    `item_features` [n_items, F], tokenized by the frozen HiD-VAE `vae`.

    `log_every` sets how often the loss is read back (a device sync) and
    logged; `log(str)` receives the lines. Returns {"model", "tokenizer",
    "optimizer", "history"}; history holds the logged iterations, train loss
    and host-clock ms per step, the eval iterations and losses, and the
    mean of the last LOSS_WINDOW per-step train losses."""
    device = resolve_device(device)
    if attn_dropout is not None:
        dropout_p = attn_dropout
    log = log or (lambda line: None)

    tokenizer = HSemanticIdTokenizer(
        vae, n_layers=vae_n_layers, codebook_size=vae_codebook_size,
        tag_class_counts=tag_class_counts, use_dedup_dim=use_dedup_dim,
        use_concatenated_ids=use_concatenated_ids, use_interleaved_ids=use_interleaved_ids,
        device=device,
    )
    table = tokenizer.precompute_corpus_ids(item_features).to(torch.int32)
    sem_id_dim = tokenizer.sem_ids_dim
    log(f"Corpus table: {tuple(table.shape)}, sem_ids_dim={sem_id_dim}")

    data = as_seq_data(users, items, fut, device)
    eval_data = (None if eval_items is None
                 else as_seq_data(eval_users, eval_items, eval_fut, device))
    max_seq_len = data.items.shape[1]
    head_dim = attn_embed_dim // attn_heads
    if takes_flash_route(head_dim, 1 + max_seq_len * sem_id_dim):  # user + history tokens
        check_head_dim(head_dim, device.type)
    compute_dtype = (torch.bfloat16 if (amp or mixed_precision_type == "bf16")
                     else torch.float32)
    model = build_model(
        sem_id_dim=sem_id_dim, max_seq_len=max_seq_len, vae_codebook_size=vae_codebook_size,
        vae_n_layers=vae_n_layers, decoder_embed_dim=decoder_embed_dim, dropout_p=dropout_p,
        attn_heads=attn_heads, attn_embed_dim=attn_embed_dim, attn_layers=attn_layers,
        use_interleaved_ids=use_interleaved_ids, dtype=compute_dtype, seed=seed,
    ).to(device)
    optimizer = Optimizer(model.parameters(), inverse_sqrt_schedule(learning_rate, warmup_steps),
                          weight_decay, max_grad_norm=max_grad_norm)

    history = {"iterations": [], "train_loss": [], "ms_per_step": [],
               "eval_iterations": [], "eval_loss": [], "window_mean": None}
    loss_window = deque(maxlen=LOSS_WINDOW)
    step_losses = []  # this log interval's 0-d losses, still on the device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_last, it_last = time.perf_counter(), 0
    for it in range(iterations):
        g = step_generator(seed, it, device)
        batch = sample_batch(data, table, batch_size, g, subsample)
        loss, loss_d = train_step(model, optimizer, batch, g)
        step_losses.append(loss)

        done = it + 1
        if done % log_every == 0 or done == iterations:
            losses = torch.stack(step_losses).float().tolist()  # syncs
            step_losses.clear()
            loss_f = losses[-1]
            now = time.perf_counter()
            ms = (now - t_last) * 1e3 / (done - it_last)
            t_last, it_last = now, done
            if not math.isfinite(loss_f):
                raise FloatingPointError(f"non-finite loss {loss_f} at iteration {it}")
            loss_window.extend(losses)
            history["iterations"].append(it)
            history["train_loss"].append(loss_f)
            history["ms_per_step"].append(ms)
            log(f"iter {it}: loss={loss_f:.4f} (window mean {np.mean(loss_window):.4f}) "
                f"loss_d={[round(x, 3) for x in loss_d.float().tolist()]} ({ms:.1f} ms/step)")

        crossed = (it // partial_eval_every) != (done // partial_eval_every) or done == iterations
        if eval_data is not None and crossed:
            el = eval_loss(model, table, eval_data, batch_size, eval_batches)
            history["eval_iterations"].append(done)
            history["eval_loss"].append(el)
            log(f"partial eval @ {done}: loss={el:.4f}")
            t_last = time.perf_counter()  # keep eval time out of ms per step

    history["window_mean"] = float(np.mean(loss_window)) if loss_window else None
    return {"model": model, "tokenizer": tokenizer, "optimizer": optimizer,
            "history": history}
