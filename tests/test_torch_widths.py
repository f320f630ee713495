"""The kernels' widths: flash at head widths 64 and 128, `rq_assign` at 16,
32, 64 and 128; the plain versions take any, CUDA refuses others first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.models.attention import MultiHeadAttention as JMHA
from hidvae_tpu.ops.pallas import rq_kernels as jrq
from hidvae_tpu_torch.bridge import load_flax_weights
from hidvae_tpu_torch.models import attention
from hidvae_tpu_torch.ops import flash_attention as fa
from hidvae_tpu_torch.ops import rq_assign as rq
from hidvae_tpu_torch.tokenizer import h_semids, semids
from hidvae_tpu_torch.train import transformer as trainer
from tests._torch_common import random_variables, unflat
from tests.test_torch_train import TINY_DECODER, TINY_VAE

TOL = 1e-5  # fp32 on both sides, summation order only


@pytest.mark.parametrize("head_dim,built", [(64, True), (128, True), (192, False),
                                            (256, False)])
def test_flash_head_width_check(head_dim, built):
    fa.check_head_dim(head_dim, "cpu")  # the plain version runs any width
    if built:
        fa.check_head_dim(head_dim, "cuda")
    else:
        with pytest.raises(ValueError, match=r"built for head widths \(64, 128\)"):
            fa.check_head_dim(head_dim, "cuda")


@pytest.mark.parametrize("dim,built", [(16, True), (32, True), (64, True), (128, True),
                                       (48, False), (256, False)])
def test_rq_assign_width_check(dim, built):
    rq.check_dim(dim, "cpu")
    if built:
        rq.check_dim(dim, "cuda")
    else:
        with pytest.raises(ValueError, match=r"supports D in \(16, 32, 64, 128\)"):
            rq.check_dim(dim, "cuda")


@pytest.mark.parametrize("d_out", [128, 192])
def test_module_checks_the_width_and_matches_jax_dense(d_out, monkeypatch):
    """One head of 128 or 192 over 2,101 tokens: width checked, the flash
    route agreeing with JAX's dense path on valid rows."""
    jm = JMHA(d_out=d_out, num_heads=1)
    params = random_variables(jm, (jnp.zeros((2, 4, d_out)),), {"is_causal": False},
                              seed=d_out)["params"]
    tm = attention.MultiHeadAttention(d_out, d_out, 1)
    load_flax_weights(tm, params)
    rng = np.random.RandomState(d_out)
    n = 2101
    x = rng.randn(2, n, d_out).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[0, n - n // 5:] = False
    want = jax.jit(lambda v, a, m: jm.apply(v, a, kv_padding_mask=m, is_causal=False))(
        {"params": unflat(params)}, jnp.asarray(x), jnp.asarray(mask))
    checked = []
    real = attention.check_head_dim
    monkeypatch.setattr(attention, "check_head_dim",
                        lambda d, dev: checked.append((d, dev)) or real(d, dev))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), kv_padding_mask=torch.from_numpy(mask), is_causal=False)
    assert checked == [(d_out, "cpu")]
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], atol=TOL)


def test_trainer_refuses_a_width_without_kernel_before_the_first_step(monkeypatch):
    """At 2,053 tokens (flash route) the trainer refuses 1 head of 192
    before any step, on a check asked as for CUDA; 128 passes."""
    from chip_smoke import build_vae, seeded_sequences

    vae, feats = build_vae(TINY_VAE, torch.Generator().manual_seed(0))
    users, items, fut = seeded_sequences(TINY_VAE["n_items"], 8, 342, seed=1)  # 1 + 342 * 6 tokens
    checked, steps = [], []
    monkeypatch.setattr(trainer, "check_head_dim",
                        lambda d, dev: checked.append(d) or fa.check_head_dim(d, "cuda"))
    monkeypatch.setattr(trainer, "train_step", lambda *a: steps.append(1))

    def run(width):
        return trainer.train_arrays(
            feats, users, items, fut, vae=vae, iterations=1, batch_size=2,
            attn_embed_dim=width, attn_heads=1, **TINY_DECODER,
            device="cpu", mixed_precision_type="fp32")

    with pytest.raises(ValueError, match="head widths"):
        run(192)
    assert checked == [192] and steps == []
    with pytest.raises(TypeError):  # the stubbed step returns no loss: the check passed
        run(128)
    assert checked == [192, 128] and steps == [1]


@pytest.mark.parametrize("tagged", [True, False], ids=["hierarchical", "plain"])
def test_tokenizer_checks_the_code_width(tagged, monkeypatch):
    """The check runs in the plain tokenizer's constructor, which the
    hierarchical one extends."""
    from chip_smoke import build_vae

    cfg = dict(input_dim=48, hidden_dims=(32,), embed_dim=48, codebook_size=16, n_layers=2,
               codebook_normalize=tagged, tag_class_counts=(4, 6) if tagged else None,
               tag_embed_dim=12, n_items=64)
    vae, _ = build_vae(cfg, torch.Generator().manual_seed(0))
    checked = []
    monkeypatch.setattr(semids, "check_dim",
                        lambda d, dev: checked.append((d, dev)) or rq.check_dim(d, "cuda"))
    tok = h_semids.HSemanticIdTokenizer if tagged else semids.SemanticIdTokenizer
    with pytest.raises(ValueError, match="supports D"):
        tok(vae, n_layers=2, codebook_size=16, device="cpu")
    assert checked == [(48, "cpu")]


@pytest.mark.parametrize("seed,b,k,d,l", [(0, 64, 32, 128, 3), (1, 37, 16, 128, 2)])
def test_rq_assign_plain_matches_jax_kernel_at_d128(seed, b, k, d, l):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, d).astype(np.float32)
    cbs = rng.randn(l, k, d).astype(np.float32)
    ids, qsum = rq.rq_assign_auto(torch.from_numpy(x), torch.from_numpy(cbs))
    ids_k, qsum_k = jrq.rq_assign(jnp.asarray(x), jnp.asarray(cbs), block_b=16, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_k))
    np.testing.assert_allclose(qsum.numpy(), np.asarray(qsum_k), atol=TOL)
