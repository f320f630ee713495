"""Flash attention's plain versions against the `jax` library's
`mha_reference` and `jax.grad` through `mha_reference_no_custom_vjp`, fp32,
on the CPU (the kernels: tests/test_torch_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from hidvae_tpu.models.attention import MultiHeadAttention as JMHA
from hidvae_tpu_torch.bridge import load_flax_weights
from hidvae_tpu_torch.models import attention
from hidvae_tpu_torch.ops import flash_attention as fa
from tests._torch_common import random_variables, unflat

TOL = 1e-5
SCALE = 64 ** -0.5


def _inputs(b, h, n, pad, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, n, 64).astype(np.float32) for _ in range(4))
    seg = np.ones((b, n), np.int32)
    if pad:  # a padded tail and a padded stretch inside
        seg[0, n - n // 3:] = 0
        seg[-1, n // 4: n // 4 + 5] = 0
    return q, k, v, do, seg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_grads(q, k, v, ids, causal, do):
    """The library's reference gradients of sum(O * dO) in q, k, v."""
    def loss(q_, k_, v_):
        out = jfa.mha_reference_no_custom_vjp(q_, k_, v_, None, ids, causal=causal,
                                              sm_scale=SCALE)
        return jnp.sum(out * jnp.asarray(do))

    return jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))

def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [  # (B, H, N, causal, padding): N not a multiple of 128 except one
    (2, 2, 200, False, True),
    (2, 2, 200, True, True),
    (1, 3, 130, True, False),
    (2, 1, 257, False, False),
    (1, 2, 256, False, True),
]


@pytest.mark.parametrize("b,h,n,causal,pad", CASES)
def test_forward_matches_mha_reference(b, h, n, causal, pad):
    q, k, v, _, seg = _inputs(b, h, n, pad, n + h)
    want = jfa.mha_reference(*_j(q, k, v), None, jfa.SegmentIds(*_j(seg, seg)),
                             causal=causal, sm_scale=SCALE)
    got = fa.flash_attention(*_t(q, k, v), segment_ids=fa.SegmentIds(*_t(seg, seg)),
                             causal=causal, sm_scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("b,h,n,causal,pad", CASES)
def test_gradients_match_jax_grad(b, h, n, causal, pad):
    q, k, v, do, seg = _inputs(b, h, n, pad, 2 * n + h)
    _grads_match_jax(q, k, v, do, seg, seg, causal)


def _grads_match_jax(q, k, v, do, seg_q, seg_kv, causal):
    """flash_attention's autograd gradients against jax.grad's."""
    want = _jax_grads(q, k, v, jfa.SegmentIds(*_j(seg_q, seg_kv)), causal, do)
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention(qt, kt, vt, segment_ids=fa.SegmentIds(*_t(seg_q, seg_kv)),
                             causal=causal, sm_scale=SCALE)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def _plain_kernels_against_library(q, k, v, do, seg_q, seg_kv, causal):
    """Each kernel's plain version (forward with m and l, then dK/dV and dQ
    given those) against the library and jax.grad; returns (O, m, l)."""
    ids = jfa.SegmentIds(*_j(seg_q, seg_kv))
    o_j, l_j, m_j = jfa.mha_reference_no_custom_vjp(*_j(q, k, v), None, ids, causal=causal,
                                                    sm_scale=SCALE, save_residuals=True)
    qt, kt, vt, dot, sq, skv = _t(q, k, v, do, seg_q, seg_kv)
    o, m, l = fa.flash_fwd_reference(qt, kt, vt, sq, skv, causal, SCALE)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j), atol=TOL, rtol=TOL)

    dq_j, dk_j, dv_j = _jax_grads(q, k, v, ids, causal, do)
    di = torch.sum(o * dot, dim=-1)  # the library's di = rowsum(dO * O)
    dk, dv = fa.flash_bwd_dkv_reference(qt, kt, vt, sq, skv, dot, m, l, di, causal, SCALE)
    dq = fa.flash_bwd_dq_reference(qt, kt, vt, sq, skv, dot, m, l, di, causal, SCALE)
    for g, w in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    return o, m, l


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_plain_versions_match_library(causal):
    """Each kernel's plain version (forward with m and l, dK/dV, dQ) against
    the library's residuals and gradients."""
    q, k, v, do, seg = _inputs(2, 2, 200, True, 7)
    _plain_kernels_against_library(q, k, v, do, seg, seg, causal)


@pytest.mark.parametrize("b,h,n,causal", [(2, 2, 200, False), (2, 2, 200, True),
                                          (1, 3, 130, True)])
def test_keyless_rows_match_library(b, h, n, causal):
    """Keyless rows under a nonzero cotangent get the library's uniform
    weights, P = 1/N from m and l apart, in every plain version."""
    q, k, v, do, _ = _inputs(b, h, n, False, 5 * n + h)
    rng = np.random.RandomState(n)
    seg_q = rng.randint(1, 4, (b, n)).astype(np.int32)
    seg_q[:, 0] = 3  # at least one keyless row per batch row
    seg_kv = rng.randint(1, 3, (b, n)).astype(np.int32)
    keyless = seg_q == 3
    assert np.abs(do[np.broadcast_to(keyless[:, None, :, None], do.shape)]).max() > 0.5

    o, m, l = _plain_kernels_against_library(q, k, v, do, seg_q, seg_kv, causal)
    rows = np.broadcast_to(keyless[:, None, :], m.shape)
    np.testing.assert_array_equal(m.numpy()[rows], np.float32(fa.MASK_VALUE))
    if not causal:  # every key is visible: l = N and O is the mean of V
        np.testing.assert_array_equal(l.numpy()[rows], n)
        mean_v = np.broadcast_to(v.mean(axis=2, keepdims=True), v.shape)
        np.testing.assert_allclose(o.numpy()[rows], mean_v[rows], atol=TOL)
    _grads_match_jax(q, k, v, do, seg_q, seg_kv, causal)


def test_no_segment_ids_attends_everything():
    q, k, v, _, _ = _inputs(1, 2, 100, False, 3)
    want = jfa.mha_reference(*_j(q, k, v), None, None, sm_scale=SCALE)
    got = fa.flash_attention(*_t(q, k, v), sm_scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


# ---- the attention module's flash route ------------------------------------

def _mha_pair(seed=0):
    """(JAX MultiHeadAttention, its variables, torch twin): 1 head of 64."""
    jm = JMHA(d_out=64, num_heads=1)
    params = random_variables(jm, (jnp.zeros((2, 4, 64)),), {"is_causal": False},
                              seed=seed)["params"]
    tm = attention.MultiHeadAttention(64, 64, 1)
    load_flax_weights(tm, params)
    return jm, {"params": unflat(params)}, tm


def _masked_input(b, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, 64).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, n - n // 5:] = False  # a ragged history
    return x, mask


@pytest.mark.parametrize("n,use_flash", [(2101, None), (50, True)])
def test_module_flash_route_matches_jax_dense(n, use_flash):
    """At >= 2048 tokens (or use_flash=True) the port's flash route and
    JAX's dense path agree on valid query rows."""
    jm, jvars, tm = _mha_pair()
    tm.use_flash = use_flash
    x, mask = _masked_input(2, n, n)
    want = jax.jit(lambda v, a, m: jm.apply(v, a, kv_padding_mask=m, is_causal=False))(
        jvars, jnp.asarray(x), jnp.asarray(mask))
    calls = []
    real = attention.flash_self_attention
    try:
        attention.flash_self_attention = lambda *a: calls.append(1) or real(*a)
        got = tm(torch.from_numpy(x), kv_padding_mask=torch.from_numpy(mask), is_causal=False)
    finally:
        attention.flash_self_attention = real
    assert calls == [1]
    np.testing.assert_allclose(got.detach().numpy()[mask], np.asarray(want)[mask], atol=TOL)


@pytest.mark.parametrize("n,heads,d_out,cross,use_flash,expect", [
    (2047, 1, 64, False, None, False),  # below the auto threshold
    (2048, 1, 64, False, None, True),
    (2048, 2, 64, False, None, False),  # head width 32: not a multiple of 64
    (40, 1, 64, False, False, False),
    (40, 1, 64, True, True, False),     # cross-attention never takes it
    (1, 1, 64, False, True, False),     # one query row never takes it
])
def test_flash_switch_follows_the_jax_rule(n, heads, d_out, cross, use_flash, expect,
                                           monkeypatch):
    calls = []
    monkeypatch.setattr(attention, "flash_self_attention",
                        lambda q, *a: calls.append(1) or q)
    tm = attention.MultiHeadAttention(d_out, d_out, heads, cross_attn=cross,
                                      use_flash=use_flash)
    x = torch.zeros(1, n, d_out)
    with torch.no_grad():
        tm(x, x if cross else None, is_causal=False)
    assert bool(calls) == expect
