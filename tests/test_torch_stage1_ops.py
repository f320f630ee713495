"""Stage-1 ops against JAX: Gumbel, every loss (values, gradients), mixup,
the quantizer's train modes; losses to LOSS_RTOL, the rest REL_TOL of
each array's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.models import losses as jl
from hidvae_tpu.models.quantize import Quantize as JQuantize
from hidvae_tpu.models.quantize import QuantizeForwardMode as JMode
from hidvae_tpu.ops import gumbel as jg
from hidvae_tpu_torch.models import losses as tl
from hidvae_tpu_torch.models.quantize import Quantize, QuantizeForwardMode
from hidvae_tpu_torch.ops import gumbel as tg
from tests._torch_common import assert_rel as _assert_rel

LOSS_RTOL = 1e-5
REL_TOL = 1e-4


def assert_rel(got, want, tol=REL_TOL, err_msg=""):
    _assert_rel(got, want, tol, err_msg)


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def torch_value_and_grads(fn, *arrays):
    ts = [t(a, torch.float32).requires_grad_(True) for a in arrays]
    value = fn(*ts)
    value.backward()
    return value.detach(), [x.grad for x in ts]


# ---- gumbel -----------------------------------------------------------------

def test_gumbel_with_jax_draws():
    key = jax.random.key(3)
    shape = (16, 12)
    u = np.asarray(jax.random.uniform(key, shape))
    want = np.asarray(jg.sample_gumbel(key, shape))
    assert_rel(tg.sample_gumbel(shape, uniforms=t(u)), want, 1e-6)
    logits = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jg.gumbel_softmax_sample(key, jnp.asarray(logits), 0.2))
    got = tg.gumbel_softmax_sample(t(logits), 0.2, noise=t(np.asarray(jg.sample_gumbel(key, shape))))
    assert_rel(got, want, 1e-5)
    js, ts = jg.TemperatureScheduler(1.0, 0.1, 1e-3, 5), tg.TemperatureScheduler(1.0, 0.1, 1e-3, 5)
    np.testing.assert_allclose([ts.get_t(i) for i in range(60)], [js.get_t(i) for i in range(60)],
                               rtol=1e-6)


def test_gumbel_draws_are_gumbel():
    """200,000 draws from a generator: mean Euler's gamma, variance pi^2 / 6
    (standard errors 0.0029 and 0.012), and softmax rows summing to 1."""
    g = torch.Generator().manual_seed(0)
    x = tg.sample_gumbel((200_000,), g).double()
    assert abs(float(x.mean()) - 0.5772157) < 0.015
    assert abs(float(x.var()) - np.pi ** 2 / 6) < 0.06
    w = tg.gumbel_softmax_sample(torch.zeros(4, 7), 0.5, g)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


# ---- losses -----------------------------------------------------------------

def _rng(seed=0):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("n_cat", [0, 5])
def test_reconstruction_losses(n_cat):
    r = _rng(1)
    x_hat, x = r.randn(6, 20).astype(np.float32), r.rand(6, 20).astype(np.float32)
    jfn = ((lambda a, b: jnp.sum(jl.categorical_reconstruction_loss(a, b, n_cat))) if n_cat
           else (lambda a, b: jnp.sum(jl.reconstruction_loss(a, b))))
    tfn = ((lambda a, b: torch.sum(tl.categorical_reconstruction_loss(a, b, n_cat))) if n_cat
           else (lambda a, b: torch.sum(tl.reconstruction_loss(a, b))))
    want, wgrads = jax.value_and_grad(jfn, argnums=(0, 1))(x_hat, x)
    got, grads = torch_value_and_grads(tfn, x_hat, x)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for a, b in zip(grads, wgrads):
        assert_rel(a, b)


def test_quantize_loss_stop_gradients():
    """Both terms, and the stop-gradients: the query gets beta times the
    commitment gradient, the value the codebook gradient."""
    r = _rng(2)
    q, v = r.randn(5, 8).astype(np.float32), r.randn(5, 8).astype(np.float32)
    want, wgrads = jax.value_and_grad(lambda a, b: jnp.sum(jl.quantize_loss(a, b, 0.4)),
                                      argnums=(0, 1))(q, v)
    got, grads = torch_value_and_grads(lambda a, b: torch.sum(tl.quantize_loss(a, b, 0.4)), q, v)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for a, b in zip(grads, wgrads):
        assert_rel(a, b)
    assert_rel(grads[0], 0.4 * 2 * (q - v), 1e-6)


@pytest.mark.parametrize("layer_idx", [0, 2])
def test_tag_alignment_loss(layer_idx):
    r = _rng(3)
    cb, tgt = r.randn(12, 16).astype(np.float32), r.randn(12, 16).astype(np.float32)
    want, wgrads = jax.value_and_grad(
        lambda a, b: jl.tag_alignment_loss(a, b, layer_idx, 0.15, 0.1), argnums=(0, 1))(cb, tgt)
    got, grads = torch_value_and_grads(
        lambda a, b: tl.tag_alignment_loss(a, b, layer_idx, 0.15, 0.1), cb, tgt)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for a, b in zip(grads, wgrads):
        assert_rel(a, b)


@pytest.mark.parametrize("collide", [True, False], ids=["collisions", "none"])
def test_uniqueness_loss(collide):
    r = _rng(4)
    ids = r.randint(0, 3 if collide else 1000, (16, 3)).astype(np.int32)
    if not collide:
        ids[:, 0] = np.arange(16)
    enc = r.randn(16, 8).astype(np.float32)
    want, wgrad = jax.value_and_grad(lambda e: jl.uniqueness_loss(ids, e, 0.0, 1.5))(enc)
    got, (grad,) = torch_value_and_grads(lambda e: tl.uniqueness_loss(t(ids), e, 0.0, 1.5), enc)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=1e-7)
    assert (float(want) > 0) == collide
    assert_rel(grad, wgrad)


TAG_CASES = {
    "focal_counts": dict(use_focal_loss=True, counts=True, n_classes=24),
    "focal_counts_wide": dict(use_focal_loss=True, counts=True, n_classes=160),
    "focal_plain": dict(use_focal_loss=True, counts=False, n_classes=24),
    "smoothed_ce": dict(use_focal_loss=False, counts=False, n_classes=24),
}


@pytest.mark.parametrize("mixup", [False, True], ids=["no_mixup", "mixup"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", list(TAG_CASES))
def test_tag_prediction_loss(case, training, mixup):
    """Values, accuracy and logit gradients at layer 1, with invalid (-1)
    targets; mixup with the permutation and lambda that JAX draws from the
    same key (:175-179), handed to the port."""
    c = TAG_CASES[case]
    r = _rng(5)
    b, n = 20, c["n_classes"]
    logits = (2 * r.randn(b, n)).astype(np.float32)
    targets = r.randint(0, n, b).astype(np.int32)
    targets[[3, 11]] = -1
    counts = r.randint(0, 50, n).astype(np.float32) if c["counts"] else None
    key = jax.random.key(9)
    kw = dict(use_focal_loss=c["use_focal_loss"], focal_gamma=2.7, focal_alpha=0.24,
              use_label_smoothing=True, label_smoothing_alpha=0.13, use_mixup=True,
              training=training)

    def jfn(lg):
        out = jl.tag_prediction_loss(lg, targets, 1, class_counts=None if counts is None
                                     else jnp.asarray(counts), rng=key if mixup else None,
                                     mixup_alpha=0.2, **kw)
        return out.loss, out.accuracy

    (want, want_acc), wgrad = jax.value_and_grad(jfn, has_aux=True)(logits)
    draw = None
    if mixup:
        rng_perm, rng_lam = jax.random.split(key)
        draw = (t(np.asarray(jax.random.permutation(rng_perm, b))),
                float(jax.random.beta(rng_lam, 0.2, 0.2)))

    def tfn(lg):
        out = tl.tag_prediction_loss(lg, t(targets), 1, class_counts=None if counts is None
                                     else t(counts), mixup=draw, **kw)
        tfn.acc = out.accuracy
        return out.loss

    got, (grad,) = torch_value_and_grads(tfn, logits)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tfn.acc), float(want_acc), rtol=LOSS_RTOL)
    assert_rel(grad, wgrad)


def test_tag_prediction_loss_without_valid_targets():
    out = tl.tag_prediction_loss(torch.randn(4, 5), torch.full((4,), -1), use_focal_loss=True,
                                 training=True)
    assert float(out.loss) == 0.0 and float(out.accuracy) == 0.0


def test_mixup_draws():
    """Mixup draws a permutation and lambda ~ Beta(0.2, 0.2): over 20,000
    draws mean 0.5 and variance 0.1786."""
    g, host = torch.Generator().manual_seed(1), np.random.default_rng(1)
    lams = []
    for _ in range(20_000):
        perm, lam = tl.mixup_draw(8, 0.2, g, host)
        lams.append(lam)
    assert sorted(perm.tolist()) == list(range(8))
    lams = np.asarray(lams)
    assert abs(lams.mean() - 0.5) < 0.015
    assert abs(lams.var() - 1 / (4 * 1.4)) < 0.004


# ---- quantizer train modes --------------------------------------------------

QUANT_CASES = [
    ("gumbel", QuantizeForwardMode.GUMBEL_SOFTMAX, False, False),
    ("ste", QuantizeForwardMode.STE, True, False),
    ("rotation", QuantizeForwardMode.ROTATION_TRICK, True, False),
    ("rotation_simvq", QuantizeForwardMode.ROTATION_TRICK, False, True),
]


@pytest.mark.parametrize("name,mode,normalize,sim_vq", QUANT_CASES,
                         ids=[c[0] for c in QUANT_CASES])
def test_quantize_train_modes(name, mode, normalize, sim_vq):
    """Equal ids; the estimator's output, loss and gradients against
    jax.grad, Gumbel on JAX's noise."""
    d, k, b = 8, 16, 24
    jm = JQuantize(embed_dim=d, n_embed=k, codebook_normalize=normalize, sim_vq=sim_vq,
                   commitment_weight=0.4, forward_mode=JMode[mode.name])
    r = _rng(6)
    x = r.randn(b, d).astype(np.float32)
    cot = r.randn(b, d).astype(np.float32)
    rngs = {"gumbel": jax.random.key(5)}
    variables = jm.init({"params": jax.random.key(0), **rngs}, jnp.asarray(x), 0.2, train=True)
    params = variables["params"]

    def jloss(p, xx):
        out = jm.apply({"params": p}, xx, 0.2, train=True, rngs=rngs)
        return jnp.sum(out.embeddings * cot) + jnp.sum(out.loss), out

    (_, jout), (pgrad, xgrad) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    noise = None
    if mode == QuantizeForwardMode.GUMBEL_SOFTMAX:
        noise = t(np.asarray(jm.apply({"params": params}, rngs=rngs, method=lambda m: (
            jg.sample_gumbel(m.make_rng("gumbel"), (b, k))))))

    tm = Quantize(d, k, codebook_normalize=normalize, sim_vq=sim_vq, commitment_weight=0.4,
                  forward_mode=mode)
    with torch.no_grad():  # a lone level's path has no quantize_i prefix for the bridge
        tm.embedding.copy_(t(params["embedding"]))
        if sim_vq:
            tm.out_proj.weight.copy_(t(params["out_proj"]["kernel"]).T)
    xt = t(x).requires_grad_(True)
    out = tm(xt, 0.2, train=True, noise=noise)
    np.testing.assert_array_equal(out.ids.numpy(), np.asarray(jout.ids))
    assert_rel(out.embeddings, jout.embeddings)
    np.testing.assert_allclose(out.loss.detach().numpy(), np.asarray(jout.loss), rtol=LOSS_RTOL,
                               atol=1e-6)
    (torch.sum(out.embeddings * t(cot)) + torch.sum(out.loss)).backward()
    assert_rel(xt.grad, xgrad)
    assert_rel(tm.embedding.grad, pgrad["embedding"])
    if sim_vq:
        assert_rel(tm.out_proj.weight.grad.T, pgrad["out_proj"]["kernel"])


def test_rotation_trick_transform():
    from hidvae_tpu.models.quantize import rotation_trick_transform as jrot

    from hidvae_tpu_torch.models.quantize import rotation_trick_transform

    r = _rng(7)
    u, q, e = (r.randn(6, 8).astype(np.float32) for _ in range(3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    want, wgrad = jax.value_and_grad(lambda ee: jnp.sum(jrot(u, q, ee) ** 2))(e)
    got, grads = torch_value_and_grads(lambda uu, qq, ee: torch.sum(
        rotation_trick_transform(uu, qq, ee) ** 2), u, q, e)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert_rel(grads[2], wgrad)
    assert grads[0] is None and grads[1] is None  # u and q carry no gradient
