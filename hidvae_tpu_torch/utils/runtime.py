"""Device choice and fp32 policy for the port.

Counterpart of hidvae_tpu/utils/runtime.py for what serving needs: the JAX
package runs wherever JAX's default backend is; the port names its device
explicitly and never falls back from the card to the CPU.
"""

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names one.

    Raises when `cuda` is asked for (explicitly or by default) and there is
    no card, so a missing card never silently becomes a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU"
            )
        if dev.index is None:  # a concrete index, so device comparisons hold
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def full_fp32():
    """Run fp32 matmuls at full precision (no TF32), restoring the caller's
    settings on exit. The quantizer's argmin must not flip on TF32 rounding:
    the JAX package computes it at Precision.HIGHEST (ops/distances.py:34)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
