"""Routed experts of models/mla_moe.py `MoE`, sorted rows to output:
`grouped_swiglu` (three Triton launches), `grouped_swiglu_plain` (two
`torch._grouped_mm`; the CPU runs it). Replaces no TPU kernel (the JAX
package has no MoE): the passes around `_grouped_mm` took two thirds of
the MoE span. Bound: compute, ~0.86 TFLOP of routed products a decode call
(8,192 tokens, top 6) against 1.1 GB of weights. A program takes BLOCK_M
sorted rows of one expert, found on the device from `ends` (no host wait,
no padding; an expert's tiles adjacent, its weights read about once); the
combine sums in a fixed order (no atomics)."""

from __future__ import annotations

import functools
import os

import torch
from torch.nn import functional as F

from hidvae_tpu_torch.utils.cuda_build import BUILD_DIR
from hidvae_tpu_torch.utils.debug import count, tracing

BLOCK_M = 128
GATE_UP = dict(BLOCK_N=128, BLOCK_K=64, num_warps=8, num_stages=3)
DOWN = dict(BLOCK_N=256, BLOCK_K=64, num_warps=8, num_stages=3)


def grouped_swiglu_plain(x, w, order, ends, gate_up, down, shared):
    """x [T, C], weights w [T, k] fp32, `order` (rows t * k + j by expert),
    `ends` [E] int32, gate_up [E, 2W, C], down [E, C, W], shared experts'
    output [T, C] -> [T, C] as x."""
    t, k = w.shape
    g, u = torch._grouped_mm(x[order // k], gate_up.transpose(1, 2), offs=ends).chunk(2, -1)
    y = torch._grouped_mm(F.silu(g) * u, down.transpose(1, 2), offs=ends)
    routed = torch.empty_like(y)
    routed[order] = y
    out = (routed.view(t, k, -1).float() * w[..., None]).sum(1)
    return (out + shared.float()).to(x.dtype)


@functools.cache
def kernels():
    """(triton, TMA descriptor, the three kernels); Triton imported on a
    card only, a kernel compiled at its first launch."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))  # as nvcc's builds
    import triton
    import triton.language as tl
    from triton.tools.tensor_descriptor import TensorDescriptor

    @triton.jit
    def _tile(ends_ptr, N, E: tl.constexpr, E_P: tl.constexpr, BLOCK_M: tl.constexpr,
              BLOCK_N: tl.constexpr):
        """This program's (expert, first row, rows, live rows, first column,
        columns): row tile m (expert E when spare) by column tile n of N."""
        pid = tl.program_id(0)
        pid_m, n0 = pid // tl.cdiv(N, BLOCK_N), pid % tl.cdiv(N, BLOCK_N) * BLOCK_N
        lanes = tl.arange(0, E_P)
        end = tl.load(ends_ptr + lanes, mask=lanes < E, other=0)
        start = tl.load(ends_ptr + lanes - 1, mask=(lanes > 0) & (lanes < E), other=0)
        tiles = (end - start + BLOCK_M - 1) // BLOCK_M
        last = tl.cumsum(tiles, 0)
        e = tl.sum((last <= pid_m).to(tl.int32), 0)
        at = lanes == e
        lo = tl.sum(tl.where(at, start + (pid_m - last + tiles) * BLOCK_M, 0), 0)
        rows = lo + tl.arange(0, BLOCK_M)
        live = rows < tl.sum(tl.where(at, end, 0), 0)
        return e, lo, rows, live, n0, n0 + tl.arange(0, BLOCK_N)

    @triton.jit
    def _gate_up_kernel(x_ptr, order_ptr, ends_ptr, w_desc, h_ptr, C, W,
                        TOP_K: tl.constexpr, E: tl.constexpr, E_P: tl.constexpr,
                        BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr, BLOCK_K: tl.constexpr):
        """h[i, j] = silu(x[t] . w[e, j]) * (x[t] . w[e, W + j]), row i of
        expert e, t = order[i] // TOP_K; w [E * 2W, C] by TMA."""
        e, _, rows, live, n0, cols = _tile(ends_ptr, W, E, E_P, BLOCK_M, BLOCK_N)
        if e >= E:
            return
        tok = tl.load(order_ptr + rows, mask=live, other=0) // TOP_K
        ks = tl.arange(0, BLOCK_K)
        a_ptrs = x_ptr + tok[:, None] * C + ks[None, :]
        gate = e * 2 * W + n0  # rows past W reach only the masked columns
        g = tl.zeros((BLOCK_M, BLOCK_N), dtype=tl.float32)
        u = tl.zeros((BLOCK_M, BLOCK_N), dtype=tl.float32)
        for k0 in range(0, C, BLOCK_K):
            a = tl.load(a_ptrs, mask=live[:, None] & (ks + k0 < C)[None, :], other=0.0)
            g = tl.dot(a, w_desc.load([gate, k0]).T, g)
            u = tl.dot(a, w_desc.load([gate + W, k0]).T, u)
            a_ptrs += BLOCK_K
        h = g * tl.sigmoid(g) * u
        tl.store(h_ptr + rows[:, None] * W + cols[None, :], h.to(h_ptr.dtype.element_ty),
                 mask=live[:, None] & (cols < W)[None, :])

    @triton.jit
    def _down_kernel(h_desc, order_ptr, ends_ptr, w_desc, y_ptr, C, W,
                     E: tl.constexpr, E_P: tl.constexpr, BLOCK_M: tl.constexpr,
                     BLOCK_N: tl.constexpr, BLOCK_K: tl.constexpr):
        """y[order[i], n] = h[i] . w[e, n], row i of expert e; h and w
        [E * C, W] by TMA (rows past e's end reach only masked rows)."""
        e, lo, rows, live, n0, cols = _tile(ends_ptr, C, E, E_P, BLOCK_M, BLOCK_N)
        if e >= E:
            return
        slot = tl.load(order_ptr + rows, mask=live, other=0)
        acc = tl.zeros((BLOCK_M, BLOCK_N), dtype=tl.float32)
        for k0 in range(0, W, BLOCK_K):
            acc = tl.dot(h_desc.load([lo, k0]), w_desc.load([e * C + n0, k0]).T, acc)
        tl.store(y_ptr + slot[:, None] * C + cols[None, :], acc.to(y_ptr.dtype.element_ty),
                 mask=live[:, None] & (cols < C)[None, :])

    @triton.jit
    def _combine_kernel(y_ptr, w_ptr, s_ptr, out_ptr, C, TOP_K: tl.constexpr,
                        BLOCK_C: tl.constexpr):
        """out[t] = sum over j of w[t, j] * y[t * TOP_K + j], + s[t], in fp32."""
        t = tl.program_id(0)
        cols = tl.arange(0, BLOCK_C)
        live = cols < C
        acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
        for j in tl.static_range(TOP_K):
            y = tl.load(y_ptr + (t * TOP_K + j) * C + cols, mask=live, other=0.0)
            acc += tl.load(w_ptr + t * TOP_K + j) * y.to(tl.float32)
        acc += tl.load(s_ptr + t * C + cols, mask=live, other=0.0).to(tl.float32)
        tl.store(out_ptr + t * C + cols, acc.to(out_ptr.dtype.element_ty), mask=live)

    return triton, TensorDescriptor.from_tensor, _gate_up_kernel, _down_kernel, _combine_kernel


def grouped_swiglu(x, w, order, ends, gate_up, down, shared):
    """The kernels on CUDA bf16 tensors, arguments as the plain version's;
    raises on others. Adds 3 to `.launches`; counts `moe.tile_rows`."""
    tensors = (x, w, order, ends, gate_up, down, shared)
    if not all(a.is_cuda and a.device == x.device for a in tensors):
        raise ValueError("grouped_swiglu takes tensors of one card")
    if torch.is_grad_enabled() and any(a.requires_grad for a in tensors):
        raise RuntimeError("grouped_swiglu has no backward")
    t, c = x.shape
    k = w.shape[1]
    e, width = down.shape[0], down.shape[2]
    if ({x.dtype, gate_up.dtype, down.dtype, shared.dtype} != {torch.bfloat16}
            or w.dtype != torch.float32 or ends.dtype != torch.int32
            or gate_up.shape != (e, 2 * width, c) or down.shape != (e, c, width)
            or w.shape != (t, k) or shared.shape != x.shape or order.shape != (t * k,)
            or ends.shape != (e,)):
        raise TypeError(f"x {x.dtype} {x.shape}, w {w.dtype} {w.shape}, ends {ends.dtype}, "
                        f"{gate_up.dtype} {gate_up.shape}, {down.shape}")
    if c % 8 or width % 8 or t * k * max(c, width) >= 1 << 31:
        raise ValueError(f"C {c}, W {width} (TMA: multiples of 8), {t} tokens (32-bit rows)")
    triton, desc, gate_up_kernel, down_kernel, combine_kernel = kernels()
    x, w, order, ends, gate_up, down, shared = (a.contiguous() for a in tensors)
    out = torch.empty_like(x)
    if t == 0:
        return out
    if tracing():  # rows the tiles cover, padding included
        rows = torch.diff(ends, prepend=ends.new_zeros(1))
        count("moe.tile_rows", ((rows + BLOCK_M - 1) // BLOCK_M).sum() * BLOCK_M)
    h = x.new_empty((t * k, width))
    y = x.new_empty((t * k, c))
    n_m = triton.cdiv(t * k, BLOCK_M) + e
    sizes = dict(E=e, E_P=triton.next_power_of_2(e), BLOCK_M=BLOCK_M)
    with torch.cuda.device(x.device):
        gate_up_kernel[(n_m * triton.cdiv(width, GATE_UP["BLOCK_N"]),)](
            x, order, ends, desc(gate_up.view(-1, c), [GATE_UP["BLOCK_N"], GATE_UP["BLOCK_K"]]),
            h, c, width, TOP_K=k, **sizes, **GATE_UP)
        down_kernel[(n_m * triton.cdiv(c, DOWN["BLOCK_N"]),)](
            desc(h, [BLOCK_M, DOWN["BLOCK_K"]]), order, ends,
            desc(down.view(-1, width), [DOWN["BLOCK_N"], DOWN["BLOCK_K"]]), y, c, width, **sizes,
            **DOWN)
        combine_kernel[(t,)](y, w, shared, out, c, TOP_K=k,
                             BLOCK_C=triton.next_power_of_2(c), num_warps=4)
    grouped_swiglu.launches += 3
    return out


grouped_swiglu.launches = 0
