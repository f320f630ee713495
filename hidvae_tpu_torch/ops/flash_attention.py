"""Flash attention with segment-id masking: CUDA kernels, plain versions
and the autograd Function joining them (counterpart of the `jax` library's
Pallas `flash_attention`, jax 0.9.0's flash_attention.py:140, reached from
hidvae_tpu/models/attention.py:75).

  flash_fwd      forward, O and the row statistics m, l  (library :331)
  flash_bwd_dkv  dK, dV                                  (library :796)
  flash_bwd_dq   dQ                                      (library :1146)

q, k, v [B, H, N, Dh], segment ids [B, N] int32: kernels on CUDA (Dh 64,
128; bf16 on tensor cores, rounding P and dS as the library; fp32 FFMA),
`flash_attention_reference` on the CPU. The backward recomputes
P = exp(s - m) / l (:900-904); a keyless row gets uniform weights, as
`mha_reference`; masked logits -0.7 * fp32 max (:29, :437)."""

import ctypes
from typing import NamedTuple, Optional

import torch

from hidvae_tpu_torch.utils.runtime import full_fp32

SOURCE = "flash_attention.cu"
HEAD_DIMS = (64, 128)  # the head widths the kernels are built for
MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class SegmentIds(NamedTuple):
    """Segment ids of the query and key sequences, [B, Nq] and [B, Nk]
    int32; a query attends only keys of its own segment."""

    q: torch.Tensor
    kv: torch.Tensor


# ---- plain versions ---------------------------------------------------------

def _allowed(seg_q, seg_kv, causal: bool, nq: int, nk: int):
    """[B, 1, Nq, Nk] bool: where a query may attend a key."""
    mask = (seg_q[:, :, None] == seg_kv[:, None, :])[:, None]
    if causal:
        rows = torch.arange(nq, device=seg_q.device)[:, None]
        cols = torch.arange(nk, device=seg_q.device)[None, :]
        mask = mask & (cols <= rows)[None, None]
    return mask


def _logits(q, k, seg_q, seg_kv, causal, sm_scale):
    """The library's masked, scaled fp32 logits [B, H, Nq, Nk]."""
    with full_fp32():
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    allowed = _allowed(seg_q, seg_kv, causal, q.shape[2], k.shape[2])
    return s + torch.where(allowed, 0.0, MASK_VALUE)


def _segments(q, k, segment_ids):
    if segment_ids is None:
        b = q.shape[0]
        return (torch.ones((b, q.shape[2]), dtype=torch.int32, device=q.device),
                torch.ones((b, k.shape[2]), dtype=torch.int32, device=q.device))
    return segment_ids.q, segment_ids.kv


def flash_attention_reference(q, k, v, *, segment_ids: Optional[SegmentIds] = None,
                              causal: bool = False, sm_scale: float = 1.0):
    """Plain PyTorch flash attention: fp32 logits and softmax, output in the
    input dtype. Differentiable by autograd."""
    seg_q, seg_kv = _segments(q, k, segment_ids)
    weights = torch.softmax(_logits(q, k, seg_q, seg_kv, causal, sm_scale), dim=-1)
    with full_fp32():
        return torch.einsum("bhqk,bhkd->bhqd", weights, v.float()).to(q.dtype)


def flash_fwd_reference(q, k, v, seg_q, seg_kv, causal: bool, sm_scale: float):
    """The forward's plain version: (O in q's dtype, m the row max of the
    masked, scaled logits, l = sum exp(s - m)), m and l fp32 [B, H, Nq]."""
    s = _logits(q, k, seg_q, seg_kv, causal, sm_scale)
    m = torch.amax(s, dim=-1)
    e = torch.exp(s - m[..., None])
    l = torch.sum(e, dim=-1)
    with full_fp32():
        o = torch.einsum("bhqk,bhkd->bhqd", e / l[..., None], v.float())
    return o.to(q.dtype), m, l


def _p_ds(q, k, v, seg_q, seg_kv, do, m, l, di, causal, sm_scale):
    """P = exp(s - m) / l and dS = P (dO V^T - di) * sm_scale, fp32
    [B, H, Nq, Nk]."""
    s = _logits(q, k, seg_q, seg_kv, causal, sm_scale)
    p = torch.exp(s - m[..., None]) / l[..., None]
    with full_fp32():
        dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - di[..., None]) * sm_scale


def flash_bwd_dkv_reference(q, k, v, seg_q, seg_kv, do, m, l, di, causal: bool,
                            sm_scale: float):
    """Plain version of the dK/dV kernel: (dK, dV) in k's dtype."""
    p, ds = _p_ds(q, k, v, seg_q, seg_kv, do, m, l, di, causal, sm_scale)
    with full_fp32():
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
        dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(k.dtype)


def flash_bwd_dq_reference(q, k, v, seg_q, seg_kv, do, m, l, di, causal: bool,
                           sm_scale: float):
    """Plain version of the dQ kernel: dQ in q's dtype."""
    _, ds = _p_ds(q, k, v, seg_q, seg_kv, do, m, l, di, causal, sm_scale)
    with full_fp32():
        return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


# ---- kernels -------------------------------------------------------------

def bind(lib: ctypes.CDLL):
    """Declare the C entry points' argument types on a loaded library."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # B, H, Nq, Nk, head_dim, dtype, causal, scale, stream
    tail = [i32, i32, i32, i32, i32, i32, i32, f32, ptr]
    for name, n_ptrs in (("flash_fwd_launch", 8), ("flash_bwd_dkv_launch", 11),
                         ("flash_bwd_dq_launch", 10)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptrs + tail
        fn.restype = ctypes.c_int


def build():
    """Compile (at first use) and load the kernels; returns
    cuda_build.BuiltLibrary."""
    from hidvae_tpu_torch.utils.cuda_build import load_library

    built = load_library(SOURCE)
    bind(built.lib)
    return built


def check_head_dim(head_dim: int, device_type: str):
    """Refuse, before any work, a head width with no kernel on
    `device_type`; the plain version takes any width."""
    if device_type == "cuda" and head_dim not in HEAD_DIMS:
        raise ValueError(f"the flash kernels are built for head widths {HEAD_DIMS}; "
                         f"got {head_dim}")


def _check(q, k, v, seg_q, seg_kv, *extra):
    """Validate what the kernels take; returns the dtype code."""
    tensors = (q, k, v, seg_q, seg_kv, *extra)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the flash kernels launch on the card: pass CUDA tensors")
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention inputs lie on different devices")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels take float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash kernels take [B, H, N, Dh] q, k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    check_head_dim(q.shape[3], "cuda")
    b, _, nq, _ = q.shape
    if seg_q.shape != (b, nq) or seg_kv.shape != (b, k.shape[2]) \
            or seg_q.dtype != torch.int32 or seg_kv.dtype != torch.int32:
        raise ValueError("segment ids must be int32 [B, Nq] and [B, Nk]")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash kernels need contiguous, 16-byte aligned tensors")
    return _DTYPE_CODES[q.dtype]


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def flash_fwd(q, k, v, seg_q, seg_kv, causal: bool, sm_scale: float):
    """The forward kernel: (O like q, m, l) as `flash_fwd_reference`; counts
    `flash_fwd.launches`."""
    code = _check(q, k, v, seg_q, seg_kv)
    b, h, nq, _ = q.shape
    o = torch.empty_like(q)
    m, l = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device) for _ in range(2))
    if o.numel() == 0:
        return o, m, l
    fn = build().lib.flash_fwd_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
                 o.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, nq, k.shape[2], q.shape[3],
                 code, int(causal), float(sm_scale), _stream(q.device))
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return o, m, l


def _backward_args(q, k, v, seg_q, seg_kv, do, m, l, di):
    """Checks a backward kernel's inputs; returns (dtype code, 1/l), one
    reciprocal a row rather than one an element."""
    code = _check(q, k, v, seg_q, seg_kv, do, m, l, di)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO must match q in shape and dtype")
    for t in (m, l, di):
        if t.dtype != torch.float32 or t.shape != q.shape[:3]:
            raise ValueError(f"m, l and di must be float32 {tuple(q.shape[:3])}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    return code, torch.reciprocal(l)


def flash_bwd_dkv(q, k, v, seg_q, seg_kv, do, m, l, di, causal: bool, sm_scale: float):
    """Launch the dK/dV kernel: returns (dK, dV) like k. Adds one to
    `flash_bwd_dkv.launches`."""
    code, inv_l = _backward_args(q, k, v, seg_q, seg_kv, do, m, l, di)
    b, h, nq, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    fn = build().lib.flash_bwd_dkv_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
                 do.data_ptr(), m.data_ptr(), inv_l.data_ptr(), di.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, h, nq, k.shape[2], q.shape[3], code, int(causal),
                 float(sm_scale), _stream(q.device))
    _raise_on(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, seg_q, seg_kv, do, m, l, di, causal: bool, sm_scale: float):
    """Launch the dQ kernel (in bf16 `flash_bwd_dq_tc_kernel`, on tensor
    cores): returns dQ like q. Adds one to `flash_bwd_dq.launches`."""
    code, inv_l = _backward_args(q, k, v, seg_q, seg_kv, do, m, l, di)
    b, h, nq, _ = q.shape
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    fn = build().lib.flash_bwd_dq_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
                 do.data_ptr(), m.data_ptr(), inv_l.data_ptr(), di.data_ptr(), dq.data_ptr(),
                 b, h, nq, k.shape[2], q.shape[3], code, int(causal), float(sm_scale),
                 _stream(q.device))
    _raise_on(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
KERNELS = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the CUDA kernels."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal, sm_scale):
        o, m, l = flash_fwd(q, k, v, seg_q, seg_kv, causal, sm_scale)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, o, m, l)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_kv, o, m, l = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        di = torch.sum(o.float() * do.float(), dim=-1)
        dk, dv = flash_bwd_dkv(q, k, v, seg_q, seg_kv, do, m, l, di, ctx.causal, ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, seg_q, seg_kv, do, m, l, di, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, segment_ids: Optional[SegmentIds] = None,
                    causal: bool = False, sm_scale: float = 1.0):
    """softmax(q k^T * sm_scale, masked by segment ids) v, q [B, H, Nq, Dh],
    k, v [B, H, Nk, Dh]: kernels on CUDA, the plain version on the CPU;
    differentiable in q, k, v."""
    if q.is_cuda:
        seg_q, seg_kv = _segments(q, k, segment_ids)
        return _FlashAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(),
            seg_q.to(torch.int32).contiguous(), seg_kv.to(torch.int32).contiguous(),
            bool(causal), float(sm_scale))
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_reference(q, k, v, segment_ids=segment_ids, causal=causal,
                                     sm_scale=sm_scale)
