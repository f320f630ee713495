"""Debug metrics and profiling hooks (counterpart of
hidvae_tpu/utils/debug.py): `compute_debug_metrics` of the stage-2 partial
eval, `profile_trace` (torch.profiler around a block) and `StepTimer`."""

import contextlib
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("hidvae_tpu_torch.debug")


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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None, enabled: Optional[bool] = None):
    """torch.profiler (CPU, and CUDA where there is a card) around a block,
    its Chrome trace written to `log_dir` (default ./profile_traces) as
    trace_<time>_<pid>.json. On when `enabled` or HIDVAE_PROFILE=1; yields
    the profiler, or None when off."""
    if enabled is None:
        enabled = os.environ.get("HIDVAE_PROFILE") == "1"
    if not enabled:
        yield None
        return
    log_dir = log_dir or os.path.join(os.getcwd(), "profile_traces")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    logger.info(f"Capturing a torch.profiler trace to {path}")
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
    prof.trace_path = path


class StepTimer:
    """Exponential moving average of step times."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None

    def update(self, seconds: float) -> float:
        self.ema = (seconds if self.ema is None
                    else self.alpha * seconds + (1 - self.alpha) * self.ema)
        return self.ema
