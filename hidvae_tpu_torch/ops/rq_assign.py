"""Fused residual quantization (counterpart of
hidvae_tpu/ops/pallas/rq_kernels.py): `rq_assign` launches csrc/rq_assign.cu
(`_rq_kernel`, :32), `rq_assign_reference` is the plain version,
`rq_assign_auto` picks by device (CUDA never the plain one). x [B, D],
codebooks [L, K, D] -> ids [B, L] int32, qsum [B, D]."""

import ctypes

import torch

from hidvae_tpu_torch.utils.runtime import full_fp32

SOURCE = "rq_assign.cu"
SUPPORTED_DIMS = (16, 32, 64, 128)  # the widths the CUDA kernel is built for
MAX_SHARED_BYTES = 227 * 1024  # per block on Hopper


def rq_assign_reference(x, codebooks):
    """Plain PyTorch residual quantization: per level, the expanded L2
    distance in full fp32, argmin (first index on ties), gather, subtract."""
    res = x.float()
    qsum = torch.zeros_like(res)
    ids = []
    with full_fp32():
        for level in range(codebooks.shape[0]):
            cb = codebooks[level].float()
            x2 = torch.sum(res * res, dim=-1, keepdim=True)
            c2 = torch.sum(cb * cb, dim=-1)[None, :]
            dist = x2 + c2 - 2.0 * (res @ cb.T)
            idx = torch.argmin(dist, dim=-1)
            emb = cb[idx]
            ids.append(idx.to(torch.int32))
            qsum = qsum + emb
            res = res - emb
    return torch.stack(ids, dim=-1), qsum


def check_dim(dim: int, device_type: str):
    """Refuse, before any work, a code width with no kernel on
    `device_type`; the plain version takes any."""
    if device_type == "cuda" and dim not in SUPPORTED_DIMS:
        raise ValueError(f"rq_assign supports D in {SUPPORTED_DIMS} on CUDA (the widths "
                         f"its kernel is built for), got D {dim}")


def build():
    """Compile (at first use) and load the kernel; returns
    cuda_build.BuiltLibrary."""
    from hidvae_tpu_torch.utils.cuda_build import load_library

    built = load_library(SOURCE)
    fn = built.lib.rq_assign_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = built.lib.rq_assign_min_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    fn = built.lib.rq_assign_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return built


def staging(dim: int, n_levels: int, n_embed: int) -> dict:
    """This card's staging at this width: {"resident": all levels in shared
    memory (else streamed by level), "warps" a block, "smem_bytes"}."""
    slots, warps, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    err = build().lib.rq_assign_plan(dim, n_levels, n_embed, ctypes.byref(slots),
                                     ctypes.byref(warps), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"rq_assign_plan failed: cudaError {err}")
    return {"resident": slots.value == n_levels, "warps": warps.value,
            "smem_bytes": smem.value}


def rq_assign(x, codebooks):
    """The kernel on CUDA x [B, D], codebooks [L, K, D]; raises on a CPU
    tensor, a bad shape or type, a failed build or launch. Counts
    `rq_assign.launches`."""
    if not (x.is_cuda and codebooks.is_cuda):
        raise ValueError("rq_assign launches the CUDA kernel: pass CUDA tensors")
    if x.device != codebooks.device:
        raise ValueError(f"x on {x.device} but codebooks on {codebooks.device}")
    if x.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError(f"rq_assign takes float32, got {x.dtype}, {codebooks.dtype}")
    if x.dim() != 2 or codebooks.dim() != 3 or x.shape[1] != codebooks.shape[2]:
        raise ValueError(f"shapes x {tuple(x.shape)}, codebooks {tuple(codebooks.shape)}")
    b, d = x.shape
    n_levels, n_embed, _ = codebooks.shape
    check_dim(d, x.device.type)
    lib = build().lib
    # The least footprint (csrc/rq_assign.cu smem_bytes): one level's padded
    # codebook and norms, one warp's two row buffers and scratch; a launch
    # takes as many warps as fit, up to its width's.
    if lib.rq_assign_min_smem(d, n_levels, n_embed) > MAX_SHARED_BYTES:
        raise ValueError(f"a [{n_embed}, {d}] codebook does not fit in shared memory")
    x = x.contiguous()
    codebooks = codebooks.contiguous()
    if x.data_ptr() % 16 or codebooks.data_ptr() % 16:
        raise ValueError("rq_assign needs 16-byte aligned inputs")
    ids = torch.empty((b, n_levels), dtype=torch.int32, device=x.device)
    qsum = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if b == 0 or n_levels == 0:
        return ids, qsum.zero_()
    fn = lib.rq_assign_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), codebooks.data_ptr(), ids.data_ptr(), qsum.data_ptr(),
                 b, d, n_levels, n_embed, stream)
    if err != 0:
        raise RuntimeError(f"rq_assign kernel launch failed: cudaError {err}")
    rq_assign.launches += 1
    return ids, qsum


rq_assign.launches = 0


def rq_assign_auto(x, codebooks):
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return rq_assign(x, codebooks)
    if x.device.type != "cpu":
        raise ValueError(f"rq_assign_auto: no kernel for device {x.device}")
    return rq_assign_reference(x, codebooks)
