"""The stage-1 model against JAX on bridged weights (dropout off): the
train forward, eval, bf16, BatchNorm after K_STEPS steps, predict_tags,
k-means init, the tag reconcile and remap."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hidvae_tpu.models.hrqvae import HRqVae as JHRqVae
from hidvae_tpu.models.quantize import QuantizeForwardMode as JMode
from hidvae_tpu.ops.kmeans import kmeans as jkmeans
from hidvae_tpu.train import tags as jtags
from hidvae_tpu.train.init import kmeans_init_codebooks as jkmeans_init
from hidvae_tpu_torch.bridge import (
    flax_named_parameters,
    flax_param_key,
    load_flax_weights,
    state_dict_to_flax,
)
from hidvae_tpu_torch.data.processed import ItemData
from hidvae_tpu_torch.models.hrqvae import HRqVae
from hidvae_tpu_torch.models.quantize import QuantizeForwardMode
from hidvae_tpu_torch.ops.kmeans import kmeans
from hidvae_tpu_torch.train import tags as ttags
from hidvae_tpu_torch.train.common import Optimizer
from hidvae_tpu_torch.train.device_data import DeviceItemData
from hidvae_tpu_torch.train.init import kmeans_init_codebooks
from tests._torch_common import assert_rel as _assert_rel
from tests._torch_common import flat, random_variables, unflat

LOSS_RTOL = 1e-5
REL_TOL = 1e-4
STATS_ATOL = 1e-5
BF16_RTOL = 3e-2  # bf16 products (8-bit mantissa) through a 3-layer MLP and 3 tag heads
K_STEPS = 3
B, F, TD = 24, 32, 12
COUNTS = (4, 6, 9)
KW = dict(input_dim=F, embed_dim=8, hidden_dims=(32, 16), codebook_size=16, n_layers=3,
          codebook_normalize=True, n_cat_features=0, tag_class_counts=COUNTS, tag_embed_dim=TD)
LOSS_KW = dict(commitment_weight=0.4, tag_alignment_weight=0.15, tag_prediction_weight=0.55,
               use_focal_loss=True, dropout_rate=0.4, alignment_temperature=0.1,
               sem_id_uniqueness_weight=1.5, sem_id_uniqueness_margin=0.0,
               use_label_smoothing=True, label_smoothing_alpha=0.13, use_mixup=True,
               mixup_alpha=0.2)


def assert_rel(got, want, tol=REL_TOL, err_msg=""):
    _assert_rel(got, want, tol, err_msg)


def assert_forward_as_jax(tm, out, jout, jgrad, jstats, loss_rtol, train=True):
    """The port's forward `out` (its backward run) against JAX's: losses,
    embs_norm, every gradient and the batch statistics."""
    for name in ("loss", "reconstruction_loss", "rqvae_loss", "tag_align_loss", "tag_pred_loss",
                 "tag_pred_accuracy", "p_unique_ids", "sem_id_uniqueness_loss"):
        np.testing.assert_allclose(float(getattr(out, name).detach()), float(getattr(jout, name)),
                                   rtol=loss_rtol, atol=1e-7, err_msg=name)
    assert_rel(out.embs_norm, jout.embs_norm, err_msg="embs_norm")
    grads = flat(jgrad)
    for path, p, transpose in flax_named_parameters(tm):
        g = p.grad.T if transpose else p.grad
        if train and path.startswith("tag_projector_") and path.endswith("dense_0/bias"):
            # A bias before a train-mode BatchNorm has an exact gradient of 0:
            # both sides hold rounding only, small beside the kernel's.
            bound = REL_TOL * np.max(np.abs(grads[path.replace("/bias", "/kernel")]))
            assert np.max(np.abs(g.numpy())) <= bound and np.max(np.abs(grads[path])) <= bound
        else:
            assert_rel(g, grads[path], err_msg=path)
    stats = state_dict_to_flax(tm)[1]
    for k, want in flat(jstats).items():
        np.testing.assert_allclose(stats[k], want, rtol=0, atol=STATS_ATOL, err_msg=k)


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def make_pair(mode="ROTATION_TRICK", dtype=None, seed=0, **overrides):
    """(JAX HRqVae, flat variables, torch HRqVae on the same weights)."""
    kw = dict(LOSS_KW, **overrides)
    jm = JHRqVae(**KW, codebook_mode=JMode[mode], focal_gamma_base=2.7, focal_alpha_base=0.24,
                 dtype=jnp.float32 if dtype is None else jnp.bfloat16, **kw)
    v = random_variables(jm, (jnp.zeros((4, F)), jnp.zeros((4, 3, TD)),
                              jnp.zeros((4, 3), jnp.int32), 0.2), {"train": False}, seed)
    tm = HRqVae(F, 8, (32, 16), 16, codebook_normalize=True, n_layers=3,
                tag_class_counts=COUNTS, tag_embed_dim=TD, n_cat_features=0,
                codebook_mode=QuantizeForwardMode[mode], focal_gamma_base=2.7,
                focal_alpha_base=0.24, dtype=None if dtype is None else torch.bfloat16, **kw)
    load_flax_weights(tm, v["params"], v["batch_stats"])
    return jm, v, tm


def make_batch(seed=1, b=B):
    r = np.random.RandomState(seed)
    x = r.randn(b, F).astype(np.float32)
    te = r.randn(b, 3, TD).astype(np.float32)
    ti = np.stack([r.randint(0, c, b) for c in COUNTS], axis=1).astype(np.int32)
    ti[[2, 7], 1] = -1
    counts = [np.bincount(ti[:, i][ti[:, i] >= 0], minlength=c).astype(np.float32) + 1
              for i, c in enumerate(COUNTS)]
    return x, te, ti, counts


def jax_mixup_draws(jm, v, key, b=B):
    """The (permutation, lambda) of each level, as JAX draws them: the
    HRqVae scope's "mixup" stream, split as tag_prediction_loss splits it."""
    keys = jm.apply({"params": unflat(v["params"])}, rngs={"mixup": key},
                    method=lambda m: [m.make_rng("mixup") for _ in range(3)])
    out = []
    for k in keys:
        rp, rl = jax.random.split(k)
        out.append((torch.from_numpy(np.array(jax.random.permutation(rp, b))),
                    float(jax.random.beta(rl, 0.2, 0.2))))
    return out


def _jax_loss(jm, batch, train, key=None):
    x, te, ti = (jnp.asarray(a) for a in batch[:3])
    counts = batch[3]
    cc = tuple(jnp.asarray(c) for c in counts)

    def fn(params, stats):
        kw = dict(train=train, class_counts=cc)
        if train:
            out, upd = jm.apply({"params": params, "batch_stats": stats}, x, te, ti, 0.2,
                                rngs={"mixup": key, "dropout": jax.random.key(0),
                                      "gumbel": jax.random.key(1)},
                                mutable=["batch_stats"], **kw)
            return out.loss, (out, upd["batch_stats"])
        out = jm.apply({"params": params, "batch_stats": stats}, x, te, ti, 0.2, **kw)
        return out.loss, (out, stats)

    return fn


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_train_forward_and_gradients(train, no_flax_dropout):
    jm, v, tm = make_pair()
    batch = make_batch()
    key = jax.random.key(4)
    (jloss, (jout, jstats)), jgrad = jax.jit(jax.value_and_grad(
        _jax_loss(jm, batch, train, key), has_aux=True))(unflat(v["params"]),
                                                         unflat(v["batch_stats"]))
    draws = jax_mixup_draws(jm, v, key)
    x, te, ti, counts = batch
    out = tm(torch.from_numpy(x), torch.from_numpy(te), torch.from_numpy(ti), 0.2, train=train,
             class_counts=[torch.from_numpy(c) for c in counts],
             mixup=lambda level, b: draws[level])
    out.loss.backward()
    for name in ("tag_align_loss_by_layer", "tag_pred_loss_by_layer"):
        assert_rel(getattr(out, name), getattr(jout, name), err_msg=name)
    assert_forward_as_jax(tm, out, jout, jgrad, jstats, LOSS_RTOL, train)


def test_ids_in_train_mode_equal_jax(no_flax_dropout):
    """Train-mode digits differ from the eval cascade's (hrqvae.py:467-478):
    train IDs equal JAX's train IDs, eval IDs its eval IDs."""
    jm, v, tm = make_pair()
    x = make_batch()[0]
    variables = {"params": unflat(v["params"]), "batch_stats": unflat(v["batch_stats"])}
    for train in (True, False):
        want = jm.apply(variables, jnp.asarray(x), train=train,
                        method=lambda m, x, train: m.get_semantic_ids(m.encode(x), train=train))
        got = tm.get_semantic_ids(tm.encode(torch.from_numpy(x)), train=train)
        np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))


def test_batch_stats_and_params_after_k_steps(no_flax_dropout):
    """K_STEPS AdamW updates: BatchNorm statistics within STATS_ATOL,
    parameters within REL_TOL but the biases feeding a BatchNorm."""
    jm, v, tm = make_pair(mode="STE", use_mixup=False)
    tx = optax.adamw(1e-3, weight_decay=0.015)
    params, stats = unflat(v["params"]), unflat(v["batch_stats"])
    opt_state = tx.init(params)
    opt = Optimizer(tm.parameters(), 1e-3, 0.015)

    @jax.jit
    def jax_step(params, stats, opt_state, batch):
        (_, (_, stats)), grads = jax.value_and_grad(
            _jax_loss(jm, batch, True, jax.random.key(0)), has_aux=True)(params, stats)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state

    for k in range(K_STEPS):
        batch = make_batch(seed=10 + k)
        params, stats, opt_state = jax_step(params, stats, opt_state, batch)
        x, te, ti, counts = batch
        opt.zero_grad()
        tm(torch.from_numpy(x), torch.from_numpy(te), torch.from_numpy(ti), 0.2, train=True,
           class_counts=[torch.from_numpy(c) for c in counts]).loss.backward()
        opt.step()
    got_params, got_stats = state_dict_to_flax(tm)
    for k, want in flat(stats).items():
        np.testing.assert_allclose(got_stats[k], want, rtol=0, atol=STATS_ATOL, err_msg=k)
    for k, want in flat(params).items():
        if k.startswith("tag_projector_") and k.endswith("dense_0/bias"):
            # The bias before a train-mode BatchNorm has a gradient of 0 up to
            # rounding, which Adam scales to a step of up to the learning rate.
            np.testing.assert_allclose(got_params[k], want, rtol=0, atol=2 * K_STEPS * 1e-3)
        else:
            assert_rel(got_params[k], want, err_msg=k)


def test_bf16_products_track_flax():
    """AMP (MLP and tag-head products bf16, quantizer and losses fp32):
    eval loss within BF16_RTOL of flax's."""
    jm, v, tm = make_pair(dtype="bf16")
    batch = make_batch()
    jloss, _ = jax.jit(_jax_loss(jm, batch, False))(unflat(v["params"]),
                                                    unflat(v["batch_stats"]))
    x, te, ti, counts = batch
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(te), torch.from_numpy(ti), 0.2,
                 class_counts=[torch.from_numpy(c) for c in counts])
    assert tm.encode(torch.from_numpy(x)).dtype == torch.float32
    np.testing.assert_allclose(float(out.loss), float(jloss), rtol=BF16_RTOL)


def test_predict_tags_with_noise():
    jm, v, tm = make_pair()
    x = make_batch()[0]
    key = jax.random.key(7)
    variables = {"params": unflat(v["params"]), "batch_stats": unflat(v["batch_stats"])}
    for scale in (0.0, 0.04):
        want = jm.apply(variables, jnp.asarray(x), method=lambda m, x: m.predict_tags(
            x, noise_rng=key, noise_scale=scale))
        noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape)))
        with torch.no_grad():
            got = tm.predict_tags(torch.from_numpy(x), noise=noise, noise_scale=scale)
        np.testing.assert_array_equal(got["predictions"].numpy(), np.asarray(want["predictions"]))
        for a, b in zip(got["logits"], want["logits"]):
            assert_rel(a, b)


def _jax_kmeans_draws(key, b, k, iters):
    init_rng, loop_rng = jax.random.split(key)
    init = torch.from_numpy(np.array(jax.random.choice(init_rng, b, shape=(k,), replace=False)))
    reseed = [torch.from_numpy(np.array(jax.random.randint(
        jax.random.fold_in(loop_rng, it), (k,), 0, b))) for it in range(iters)]
    return init, lambda it: reseed[it]


def test_kmeans_with_jax_draws():
    x = np.random.RandomState(3).randn(300, 8).astype(np.float32)
    x[:40] = x[0]  # a dense duplicate block: clusters empty out and re-seed
    key = jax.random.key(11)
    want = jkmeans(key, jnp.asarray(x), k=16, max_iters=30)
    init, reseed = _jax_kmeans_draws(key, 300, 16, 30)
    got = kmeans(torch.from_numpy(x), 16, max_iters=30, init_idx=init, reseed_idx=reseed)
    np.testing.assert_array_equal(got.assignment.numpy(), np.asarray(want.assignment))
    assert_rel(got.centroids, want.centroids)


def test_kmeans_init_pass_with_jax_draws():
    """The codebook init pass level by level on the residuals: every level's
    codebook equals JAX's with the same draws (split per level, as
    init.py:43-44)."""
    jm, v, tm = make_pair()
    x = np.random.RandomState(4).randn(200, F).astype(np.float32)
    key = jax.random.key(12)
    variables = {"params": unflat(v["params"]), "batch_stats": unflat(v["batch_stats"])}
    want = flat(jkmeans_init(jm, variables, jnp.asarray(x), key)["params"])
    draws, rng = [], key
    for _ in range(3):
        rng, sub = jax.random.split(rng)
        draws.append(_jax_kmeans_draws(sub, 200, 16, 100))
    kmeans_init_codebooks(tm, torch.from_numpy(x), draws=draws)
    for i in range(3):
        path = f"quantize_{i}/embedding"
        key_, _ = flax_param_key(path)
        assert_rel(tm.state_dict()[key_], want[path], err_msg=path)


def test_tag_reconcile_and_rare_remap():
    r = np.random.RandomState(5)
    idx = np.stack([r.randint(0, 6, 500), r.zipf(1.6, 500) % 40, r.randint(0, 80, 500)],
                   axis=1).astype(np.int32)
    idx[::17, 2] = -1
    emb = r.randn(500, 3, 4).astype(np.float32)
    for n_layers in (2, 3, 4):
        for a, b in zip(ttags.reconcile_tag_layers(emb, idx, n_layers),
                        jtags.reconcile_tag_layers(emb, idx, n_layers)):
            np.testing.assert_array_equal(a, b)
    counts, maps, rare = ttags.compute_rare_tag_remap(idx, [6, 30, 80], 8)
    j_counts, j_maps, j_rare = jtags.compute_rare_tag_remap(idx, [6, 30, 80], 8)
    assert counts == j_counts and counts[1] < 40
    for i in j_maps:
        np.testing.assert_array_equal(maps[i], j_maps[i])
        np.testing.assert_array_equal(rare[i], j_rare[i])
    remapped = ttags.apply_tag_remap(idx, maps)
    np.testing.assert_array_equal(remapped, jtags.apply_tag_remap(idx, j_maps))
    for a, b in zip(ttags.post_remap_class_counts(remapped, counts),
                    jtags.post_remap_class_counts(remapped, counts)):
        np.testing.assert_array_equal(a, b)


def test_item_batches_and_device_sampling():
    from hidvae_tpu_torch.data.processed import ProcessedArrays

    r = np.random.RandomState(6)
    n = 50
    arr = ProcessedArrays(item_features=r.randn(n, 4).astype(np.float32),
                          item_is_train=np.arange(n) % 5 != 0,
                          seq_users=np.zeros(1, np.int32), seq_items=np.zeros((1, 2), np.int32),
                          seq_fut=np.zeros(1, np.int32), seq_is_train=np.ones(1, bool),
                          tags_emb=r.randn(n, 3, 2).astype(np.float32),
                          tags_indices=r.randint(0, 4, (n, 3)).astype(np.int32))
    train, ev = (ItemData("", arrays=arr, train_test_split=s) for s in ("train", "eval"))
    assert len(train) == 40 and len(ev) == 10
    batches = list(ev.iter_eval_batches(4))
    assert [len(b.x) for b in batches] == [4, 4, 2]
    np.testing.assert_array_equal(batches[1].tags_indices, ev.tags_indices[4:8])
    shuffled = next(train.iter_batches(8, np.random.RandomState(0)))
    assert len(set(shuffled.ids[:, 0].tolist())) == 8
    data = DeviceItemData(torch.from_numpy(train.item_features).to(torch.bfloat16), None, None)
    x, te, ti = data.sample(torch.Generator().manual_seed(0), 4000)
    assert x.dtype == torch.bfloat16 and te is None and ti is None
    rows = {tuple(row) for row in x.float().numpy().tolist()}
    assert len(rows) == 40  # uniform with replacement: every item drawn
