"""The port's CUDA and Triton kernels against their plain versions, on the
card; every test skips without one. Imports no JAX:

    python -m pytest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import MOE_ROUTINGS, MOE_TINY, compare_ids, moe_errors, moe_inputs, near_tie_levels
from hidvae_tpu_torch.ops import moe_experts as moe
from hidvae_tpu_torch.ops import rq_assign as rq
from hidvae_tpu_torch.utils import debug

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,d,n_levels,k", [
    (1001, 32, 3, 256), (4096, 32, 4, 256), (1001, 64, 3, 256), (300, 32, 2, 16), (1, 32, 3, 256),
    (1001, 128, 3, 256), (300, 128, 2, 16),
    # One row either side of a warp's 16-row tile (at each width), one sweep
    # chunk, a small codebook at four levels, K not a whole number of passes.
    (15, 32, 3, 256), (17, 32, 3, 256), (15, 64, 3, 256), (17, 128, 3, 256), (8192, 32, 3, 256),
    (300, 32, 4, 16), (1001, 64, 1, 100),
    # Levels streamed through one codebook slot (D 64) over several rounds
    # of row tiles; K 512, too large for 12 warps beside it (9 then).
    (40000, 64, 3, 256), (40000, 64, 3, 512),
])
def test_rq_assign_matches_plain(cuda, b, d, n_levels, k):
    rng = np.random.RandomState(b + d)
    x = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(cuda)
    cbs = torch.from_numpy(rng.randn(n_levels, k, d).astype(np.float32)).to(cuda)
    before = rq.rq_assign.launches
    ids, qsum = rq.rq_assign_auto(x, cbs)
    torch.cuda.synchronize()
    assert rq.rq_assign.launches == before + 1
    ids_r, qsum_r = rq.rq_assign_reference(x, cbs)
    # Rows may differ only where the plain version's best two distances tie
    # to within rounding; the sums agree wherever the ids do.
    _, not_ties = compare_ids(ids, ids_r, near_tie_levels(x, cbs))
    assert not_ties == 0
    agree = (ids == ids_r).all(dim=-1)
    np.testing.assert_allclose(qsum[agree].cpu().numpy(), qsum_r[agree].cpu().numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("t,sizes,rows", [(8192, {}, None), (12400, {}, None), (37, MOE_TINY, None)]
                         + [(sum(r) // 2, dict(MOE_TINY, experts=len(r)), r) for r in MOE_ROUTINGS])
def test_grouped_swiglu_against_fp32(cuda, t, sizes, rows):
    """Decode, prefill and tiny ragged widths, skewed or edge routings (a row
    no tile covers, or two do, is far off): error against fp32 at most 1.25
    x the plain version's, 3 launches, rows all in tiles."""
    args = moe_inputs(t, cuda, torch.Generator(device=cuda).manual_seed(t), rows=rows, **sizes)
    got = torch.diff(args["ends"], prepend=args["ends"].new_zeros(1))
    assert got.tolist() == rows if rows else got[1] == 0 and 4 * got.max() >= got.sum()
    before = moe.grouped_swiglu.launches
    debug.clear()
    with torch.profiler.profile(), debug.span("call", device=cuda):
        moe.grouped_swiglu(**args)
    assert moe.grouped_swiglu.launches == before + 3
    assert debug.records()[0]["counts"]["moe.tile_rows"] >= got.sum()
    err, plain_err = moe_errors(**args)
    assert err <= 1.25 * plain_err, (err, plain_err)


@pytest.mark.parametrize("d", [32, 64])
def test_rq_assign_duplicate_codes_give_the_first(cuda, d):
    """Codes 3, 130 and 255 identical at every level (the same thread, two
    warps and, at D 64, two passes apart): argmin names 3, never the others."""
    from chip_smoke import DUPLICATE_CODES, duplicate_codes_

    g = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(1001, d, device=cuda, generator=g)
    cbs = torch.randn(3, 256, d, device=cuda, generator=g)
    rows = duplicate_codes_(x, cbs, g)
    ids, _ = rq.rq_assign(x, cbs)
    ids_r, _ = rq.rq_assign_reference(x, cbs)
    assert (ids[rows, 0] == DUPLICATE_CODES[0]).all()
    assert not torch.isin(ids, ids.new_tensor(DUPLICATE_CODES[1:])).any()
    _, not_ties = compare_ids(ids, ids_r, near_tie_levels(x, cbs))
    assert not_ties == 0


def test_rq_assign_exact_codebook_points(cuda):
    rng = np.random.RandomState(2)
    cbs = torch.from_numpy(rng.randn(2, 256, 32).astype(np.float32)).to(cuda)
    x = cbs[0][torch.tensor([3, 7, 11, 255], device=cuda)].contiguous()
    ids, _ = rq.rq_assign(x, cbs)
    assert ids[:, 0].tolist() == [3, 7, 11, 255]


def test_rq_assign_refuses_what_it_cannot_run(cuda):
    x = torch.zeros(4, 12, device=cuda)
    with pytest.raises(ValueError, match="supports D"):
        rq.rq_assign(x, torch.zeros(2, 16, 12, device=cuda))
    with pytest.raises(TypeError):
        rq.rq_assign(torch.zeros(4, 32, device=cuda, dtype=torch.float64),
                     torch.zeros(2, 16, 32, device=cuda))


# ---- flash attention ------------------------------------------------------

def _kernels_against_plain(fa, q, k, v, do, ids, causal, scale):
    """One launch of each kernel; O, dQ, dK, dV finite and within FLASH_RTOL
    of the plain version. Returns (O, grads)."""
    from chip_smoke import FLASH_RTOL

    before = [fn.launches for fn in fa.KERNELS]
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, segment_ids=ids, causal=causal, sm_scale=scale)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert [fn.launches - n0 for fn, n0 in zip(fa.KERNELS, before)] == [1, 1, 1]
    qr, kr, vr = (t.float().requires_grad_() for t in (q, k, v))
    ref = fa.flash_attention_reference(qr, kr, vr, segment_ids=ids, causal=causal,
                                       sm_scale=scale)
    ref_grads = torch.autograd.grad(ref, (qr, kr, vr), do.float())
    for got, want in zip((out, *grads), (ref, *ref_grads)):
        assert torch.isfinite(got).all() and got.dtype == q.dtype
        err = float((got.detach().float() - want.detach()).abs().max())
        assert err <= FLASH_RTOL[q.dtype] * float(want.abs().max()), err
    return out, grads


def test_flash_kernels_refuse_what_they_cannot_run(cuda):
    from hidvae_tpu_torch.ops import flash_attention as fa

    seg = torch.ones((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="64"):
        x = torch.zeros(1, 1, 8, 32, device=cuda)
        fa.flash_fwd(x, x, x, seg, seg, False, 1.0)
    with pytest.raises(TypeError):
        x = torch.zeros(1, 1, 8, 64, device=cuda, dtype=torch.float16)
        fa.flash_fwd(x, x, x, seg, seg, False, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        x = torch.zeros(1, 1, 8, 64)
        fa.flash_fwd(x, x, x, seg.cpu(), seg.cpu(), False, 1.0)


def _segments(b, n, mode, rng):
    """(seg_q, seg_kv, keyless rows [b, n]): "pad" one id set as the model
    gives them (a padded tail and stretch), "full" no padding; "cross"
    queries in segments 1-3, keys in 1-2."""
    if mode != "cross":
        seg = torch.ones((b, n), dtype=torch.int32)
        if mode == "pad":
            seg[0, n - n // 3:] = 0
            seg[-1, n // 4: n // 4 + 5] = 0
        return seg, seg, torch.zeros((b, n), dtype=torch.bool)
    seg_q = torch.from_numpy(rng.randint(1, 4, (b, n)).astype(np.int32))
    seg_q[:, 0] = 3
    seg_kv = torch.from_numpy(rng.randint(1, 3, (b, n)).astype(np.int32))
    return seg_q, seg_kv, seg_q == 3


@pytest.mark.parametrize("b,h,n,dh,causal,dtype,mode", [
    (2, 2, 200, 64, False, torch.float32, "pad"),
    (2, 2, 200, 64, True, torch.float32, "pad"),
    (1, 3, 130, 64, False, torch.bfloat16, "pad"),
    (1, 1, 64, 64, True, torch.bfloat16, "full"),
    (2, 1, 257, 64, False, torch.bfloat16, "full"),
    (1, 2, 130, 64, False, torch.bfloat16, "pad"),     # ragged N
    (2, 1, 257, 64, False, torch.bfloat16, "cross"),   # rows with no key of their segment
    (2, 1, 257, 64, True, torch.bfloat16, "pad"),      # causal, ragged
    (2, 2, 2432, 64, False, torch.bfloat16, "pad"),    # the trainer's full length
    (1, 2, 200, 128, True, torch.bfloat16, "pad"),     # head width 128
    (1, 2, 130, 128, False, torch.bfloat16, "cross"),
    (1, 2, 200, 128, False, torch.float32, "pad"),
    (1, 1, 257, 128, True, torch.float32, "pad"),
    (1, 2, 65, 64, False, torch.bfloat16, "pad"),      # one key past a tile
    (2, 1, 65, 64, True, torch.bfloat16, "pad"),
    (1, 2, 65, 128, False, torch.bfloat16, "cross"),
    (1, 3, 257, 128, True, torch.bfloat16, "pad"),
    (1, 2, 2432, 64, True, torch.bfloat16, "pad"),
    (1, 2, 2432, 64, False, torch.bfloat16, "cross"),
    (1, 1, 2432, 128, False, torch.bfloat16, "pad"),
    (1, 2, 200, 64, False, torch.float32, "cross"),
    # Causal, with rows that see no key: the kernels must visit the key tiles
    # above the diagonal for them, whatever the tile sizes.
    (2, 1, 65, 64, True, torch.bfloat16, "cross"),
    (1, 2, 65, 128, True, torch.bfloat16, "cross"),
    (2, 1, 65, 64, True, torch.float32, "cross"),
    (1, 2, 65, 128, True, torch.float32, "cross"),
    (2, 1, 257, 64, True, torch.bfloat16, "cross"),
    (1, 2, 257, 128, True, torch.bfloat16, "cross"),
    (1, 2, 257, 64, True, torch.float32, "cross"),
    (1, 1, 257, 128, True, torch.float32, "cross"),
    (1, 2, 2432, 64, True, torch.bfloat16, "cross"),
    (1, 1, 2432, 128, True, torch.bfloat16, "cross"),
    (1, 1, 2432, 64, True, torch.float32, "cross"),
    (1, 1, 2432, 128, True, torch.float32, "cross"),
])
def test_flash_kernels_match_plain_at_each_width(cuda, b, h, n, dh, causal, dtype, mode):
    """Each kernel against the plain version under a nonzero cotangent,
    keyless rows (uniform weights) included, causal or not."""
    from chip_smoke import FLASH_RTOL
    from hidvae_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(n + dh)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, n, dh).astype(np.float32)).to(dtype)
                   for _ in range(4))
    seg_q, seg_kv, no_key = _segments(b, n, mode, rng)
    q, k, v, do, seg_q, seg_kv = (t.to(cuda) for t in (q, k, v, do, seg_q, seg_kv))
    out, _ = _kernels_against_plain(fa, q, k, v, do, fa.SegmentIds(seg_q, seg_kv), causal,
                                    dh ** -0.5)
    if no_key.any():
        mean_v = v.float().mean(dim=2, keepdim=True).expand(b, h, n, dh)
        rows = no_key.to(cuda)[:, None, :].expand(b, h, n)
        err = float((out.detach().float()[rows] - mean_v[rows]).abs().max())
        assert err <= FLASH_RTOL[dtype] * float(mean_v.abs().max()), err


def test_bf16_dq_launches_the_tensor_core_kernel(cuda):
    """A bf16 flash_bwd_dq runs flash_bwd_dq_tc_kernel and no FFMA dQ; fp32
    runs the FFMA flash_bwd_dq_kernel."""
    from hidvae_tpu_torch.ops import flash_attention as fa

    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(1, 2, 130, 64, device=cuda).to(dtype)
        seg = torch.ones((1, 130), dtype=torch.int32, device=cuda)
        _, m, l = fa.flash_fwd(x, x, x, seg, seg, False, 0.125)
        di = torch.zeros_like(m)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fa.flash_bwd_dq(x, x, x, seg, seg, x, m, l, di, False, 0.125)
            torch.cuda.synchronize()
        names[dtype] = [e.key for e in prof.key_averages() if "flash_bwd_dq" in e.key]
    assert len(names[torch.bfloat16]) == 1 and "flash_bwd_dq_tc_kernel" in names[torch.bfloat16][0]
    assert len(names[torch.float32]) == 1 and "flash_bwd_dq_kernel" in names[torch.float32][0]
    assert "_tc_" not in names[torch.float32][0]
