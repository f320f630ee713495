"""Device choice and fp32 policy (counterpart of hidvae_tpu/utils/
runtime.py): the port names its device and never falls back to the CPU."""

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless named; raises when `cuda` is asked for without a card."""
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
    """fp32 matmuls without TF32 inside, restored after: the quantizer's
    argmin is JAX's Precision.HIGHEST (ops/distances.py:34)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
