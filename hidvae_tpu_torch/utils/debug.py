"""Debug metrics of the stage-2 partial eval (counterpart of
`compute_debug_metrics`, hidvae_tpu/utils/debug.py:20): sequence-length
quantiles of a tokenized batch and, given a model output, its per-digit
losses. The JAX module's profiler hook (`profile_trace`) and `StepTimer`
are not ported; torch.profiler and the trainer's ms per step stand in."""

import numpy as np
import torch


def _host(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def compute_debug_metrics(batch, model_output=None, prefix: str = "") -> dict:
    """{"<prefix>_seq_length_p<q>": quantile of the per-row token counts of
    `batch.seq_mask`, q in 0.25, 0.5, 0.75, 0.9, 1} and, when `model_output`
    carries `loss_d`, {"<prefix>_loss_<d>": that digit's mean loss}."""
    seq_lengths = _host(batch.seq_mask).sum(axis=1).astype(np.float64)
    p = (prefix + "_") if prefix else ""
    out = {
        f"{p}seq_length_p{q}": float(np.quantile(seq_lengths, q))
        for q in [0.25, 0.5, 0.75, 0.9, 1]
    }
    if model_output is not None and getattr(model_output, "loss_d", None) is not None:
        loss_d = _host(model_output.loss_d)
        out.update({f"{p}loss_{d}": float(loss_d[d]) for d in range(len(loss_d))})
    return out
