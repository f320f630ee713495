"""Stage-2 training against JAX: loss and gradients (dense; flash's plain
version at 2,050 tokens), 3 updates against optax with and without the
clip, schedule, crops, dropout, the Dense init."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from hidvae_tpu.train.common import inverse_sqrt_schedule as j_schedule
from hidvae_tpu.train.common import make_optimizer as j_make_optimizer
from hidvae_tpu.train.device_data import random_crop_windows as j_crop
from hidvae_tpu_torch.bridge import flax_param_key
from hidvae_tpu_torch.models import attention
from hidvae_tpu_torch.models.init import TRUNC_NORMAL_STD, init_params_, lecun_normal_
from hidvae_tpu_torch.ops.dropout import dropout
from hidvae_tpu_torch.train import common
from hidvae_tpu_torch.train import transformer as trainer
from hidvae_tpu_torch.train.common import Optimizer, clip_by_global_norm_, inverse_sqrt_schedule
from hidvae_tpu_torch.train.device_data import DeviceSeqData, random_crop_windows
from tests._torch_common import batch_pair, flat, retrieval_pair

K = 16
# fp32 both sides. The optimizers get JAX's gradients: Adam would turn
# rounding noise in near-zero gradients into a share of lr.
LOSS_TOL = 1e-4
GRAD_TOL = 1e-5
PARAM_TOL = 1e-6


# The stage-1 model and catalog of the train_arrays runs, and their decoder.
TINY_VAE = dict(input_dim=48, hidden_dims=(32, 16), embed_dim=8, codebook_size=16, n_layers=3,
                codebook_normalize=True, tag_class_counts=(4, 6, 20), tag_embed_dim=12,
                n_items=300)
TINY_DECODER = dict(vae_codebook_size=16, decoder_embed_dim=16, attn_layers=2,
                    tag_class_counts=(4, 6, 20), use_concatenated_ids=True)


def _batches(b, n, d, seed):
    return batch_pair(b, n, d, seed, K, {0: n // 2, b - 1: n - 1})


def _compare_leaves(jax_tree, torch_named, atol, rtol=0.0):
    """Every flax leaf against its torch counterpart through the bridge."""
    leaves = flat(jax_tree)
    assert len(leaves) == len(torch_named)
    for path, want in leaves.items():
        key, transpose = flax_param_key(path)
        got = torch_named[key].detach().numpy()
        np.testing.assert_allclose(got.T if transpose else got, want, atol=atol, rtol=rtol,
                                   err_msg=path)


def _pair(n, d=3, seed=0):
    return retrieval_pair(embedding_dim=16, attn_dim=64, num_heads=1, n_layers=2,
                          num_embeddings=K, sem_id_dim=d, max_pos=n * d, seed=seed)


@pytest.mark.parametrize("n,flash", [(6, False), (683, True)], ids=["dense", "flash_2050"])
def test_loss_and_gradients_match_jax(n, flash, monkeypatch):
    jm, params, tm = _pair(n)
    jb, tb = _batches(2, n, 3, seed=n)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jb, False).loss))(params)

    calls = []
    real = attention.flash_self_attention
    monkeypatch.setattr(attention, "flash_self_attention",
                        lambda *a: calls.append(1) or real(*a))
    out = tm(tb)  # no generator: the deterministic forward
    out.loss.backward()
    assert len(calls) == (1 if flash else 0)  # one encoder layer
    np.testing.assert_allclose(float(out.loss.detach()), float(loss_j), atol=LOSS_TOL)
    _compare_leaves(grads_j, {k: p.grad for k, p in tm.named_parameters()}, GRAD_TOL)


@pytest.mark.parametrize("max_grad_norm", [None, 0.5])
def test_three_adamw_updates_match_optax(max_grad_norm):
    """Both optimizers fed the same gradients; then the port's own steps
    reach the JAX run's loss."""
    jm, params, tm = _pair(6, seed=1)
    start = {k: p.detach().clone() for k, p in tm.named_parameters()}
    jb, tb = _batches(3, 6, 3, seed=2)
    lr, wd, warmup = 1e-3, 0.035, 1  # updates 0, 1, 2 take lr, lr, lr * sqrt(1/2)
    tx = j_make_optimizer(j_schedule(lr, warmup), wd, max_grad_norm=max_grad_norm)
    loss_fn = jax.jit(lambda p: jm.apply({"params": p}, jb, False).loss)
    grad_fn = jax.jit(jax.grad(lambda p: jm.apply({"params": p}, jb, False).loss))
    state = tx.init(params)
    opt = Optimizer(tm.parameters(), inverse_sqrt_schedule(lr, warmup), wd,
                    max_grad_norm=max_grad_norm)
    named = dict(tm.named_parameters())
    for _ in range(3):
        grads = grad_fn(params)
        for path, g in flat(grads).items():
            key, transpose = flax_param_key(path)
            # a copy: the clip writes into the gradient in place
            named[key].grad = torch.from_numpy(np.array(g.T if transpose else g))
        opt.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        _compare_leaves(params, named, PARAM_TOL)
    assert opt.count == 3

    with torch.no_grad():
        for k, p in tm.named_parameters():
            p.copy_(start[k])
    opt = Optimizer(tm.parameters(), inverse_sqrt_schedule(lr, warmup), wd,
                    max_grad_norm=max_grad_norm)
    for _ in range(3):
        trainer.train_step(tm, opt, tb, None)
    with torch.no_grad():
        np.testing.assert_allclose(float(tm(tb).loss), float(loss_fn(params)), atol=LOSS_TOL)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.RandomState(0)
    grads = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads],
                                                            None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        clip_by_global_norm_(got, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_schedule_matches_jax_around_warmup():
    lr, warmup = 3e-4, 10
    port, ref = inverse_sqrt_schedule(lr, warmup), j_schedule(lr, warmup)
    for step in [0, 1, 2, 9, 10, 11, 12, 40, 10_000]:
        np.testing.assert_allclose(port(step), float(ref(jnp.asarray(step))), rtol=1e-6)
    assert port(0) == port(1) == lr and port(warmup + 1) < lr


def test_random_crop_windows_match_jax_from_shared_uniforms():
    rng = np.random.RandomState(5)
    b, n = 200, 12
    items = rng.randint(0, 50, (b, n)).astype(np.int32)
    lengths = rng.randint(0, n + 1, b)  # includes empty and short rows (left unchanged)
    items[np.arange(n)[None, :] >= lengths[:, None]] = -1
    fut = rng.randint(0, 50, b).astype(np.int32)
    key = jax.random.key(9)
    want_items, want_fut = j_crop(key, jnp.asarray(items), jnp.asarray(fut))
    r1, r2 = jax.random.split(key)  # the uniforms j_crop draws
    u1, u2 = (torch.from_numpy(np.array(jax.random.uniform(r, (b,)))) for r in (r1, r2))
    got_items, got_fut = random_crop_windows(u1, u2, torch.from_numpy(items),
                                             torch.from_numpy(fut))
    np.testing.assert_array_equal(got_items.numpy(), np.asarray(want_items))
    np.testing.assert_array_equal(got_fut.numpy(), np.asarray(want_fut))
    assert (got_items.numpy() != items).any()  # the crop did change rows


def test_sample_rows_draws_whole_rows():
    n = 50
    data = DeviceSeqData(torch.arange(n, dtype=torch.int32) * 3,
                         torch.arange(n * 4, dtype=torch.int32).reshape(n, 4),
                         torch.arange(n, dtype=torch.int32) + 1000)
    users, items, fut = data.sample_rows(torch.Generator().manual_seed(0), 4000)
    rows = users // 3
    assert torch.equal(items[:, 0], rows * 4) and torch.equal(fut, rows + 1000)
    counts = torch.bincount(rows.long(), minlength=n)
    assert counts.min() > 40 and counts.max() < 130  # uniform with replacement: ~80 each


def test_dropout_keep_rate_and_scale():
    x = torch.ones(400_000)
    g = torch.Generator().manual_seed(0)
    for p in (0.3, 0.5):
        out = dropout(x, p, g)
        kept = out != 0
        assert abs(float(kept.float().mean()) - (1 - p)) < 0.005
        assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / (1 - p)))
    assert dropout(x, 0.3, None) is x and dropout(x, 0.0, g) is x
    with pytest.raises(ValueError):
        dropout(x, 1.0, g)


def test_dense_init_is_flax_truncated_lecun_normal():
    fan_in, fan_out = 1024, 512
    got = lecun_normal_(torch.empty(fan_out, fan_in), fan_in,
                        torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(nn.initializers.lecun_normal()(jax.random.key(0), (fan_in, fan_out)))
    std = 1 / np.sqrt(fan_in)
    edge = 2 * std / TRUNC_NORMAL_STD  # truncated at +-2 sigma of the raised sigma
    assert np.abs(got).max() <= edge * (1 + 1e-6)
    assert np.abs(got).max() > 0.99 * edge  # the tails reach the cut
    assert abs(got.std() / std - 1) < 0.01 and abs(want.std() / std - 1) < 0.01
    qs = [0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99]
    np.testing.assert_allclose(np.quantile(got, qs), np.quantile(want, qs), atol=0.02 * std)
    # init_params_ draws every Dense kernel this way.
    _, _, tm = _pair(6)
    init_params_(tm, torch.Generator().manual_seed(1))
    w = tm.transformer.encoder.block_0.ff.dense_0.weight
    assert float(w.detach().abs().max()) <= 2 / np.sqrt(w.shape[1]) / TRUNC_NORMAL_STD * (1 + 1e-6)


def test_train_is_a_function_of_its_seed():
    from chip_smoke import build_vae, seeded_sequences

    vae, feats = build_vae(TINY_VAE, torch.Generator().manual_seed(0))
    users, items, fut = seeded_sequences(TINY_VAE["n_items"], 64, 8, seed=1)

    def run(seed):
        return trainer.train_arrays(
            feats, users, items, fut, vae=vae, iterations=3, batch_size=4, seed=seed,
            attn_embed_dim=32, attn_heads=2, **TINY_DECODER,
            log_every=1, partial_eval_every=3, eval_users=users[:8], eval_items=items[:8],
            eval_fut=fut[:8], device="cpu", mixed_precision_type="fp32")["history"]

    a, b, c = run(0), run(0), run(1)
    assert a["train_loss"] == b["train_loss"] and a["eval_loss"] == b["eval_loss"]
    assert a["train_loss"] != c["train_loss"]
    assert len(a["train_loss"]) == 3 and len(a["eval_loss"]) == 1
    assert all(np.isfinite(a["train_loss"] + a["eval_loss"]))


@pytest.mark.parametrize("window", [common.LOSS_WINDOW, 4])
def test_window_mean_counts_every_step_loss(window, monkeypatch):
    """The window mean counts every step's loss (transformer.py:576-587),
    whatever the logging period."""
    from chip_smoke import build_vae, seeded_sequences

    monkeypatch.setattr(common, "LOSS_WINDOW", window)
    vae, feats = build_vae(TINY_VAE, torch.Generator().manual_seed(0))
    users, items, fut = seeded_sequences(TINY_VAE["n_items"], 64, 8, seed=1)

    def run(log_every):
        return trainer.train_arrays(
            feats, users, items, fut, vae=vae, iterations=7, batch_size=4, seed=3,
            attn_embed_dim=32, attn_heads=2, **TINY_DECODER,
            log_every=log_every, partial_eval_every=100, device="cpu",
            mixed_precision_type="fp32")["history"]

    every, third = run(1), run(3)
    assert len(every["train_loss"]) == 7 and third["iterations"] == [2, 5, 6]
    assert third["train_loss"] == [every["train_loss"][i] for i in (2, 5, 6)]
    np.testing.assert_allclose(every["window_mean"], np.mean(every["train_loss"][-window:]),
                               rtol=1e-12)
    assert third["window_mean"] == every["window_mean"]
