"""The retrieval model against flax at bf16 compute on the CPU: loss,
logits, gradients at 19 tokens (dense) and 2,050 (flash route, valid rows).
The frameworks round at other places, so layers agree to a few percent; a
wrong weight, mask or transpose moves tens of percent."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from hidvae_tpu.models.retrieval import EncoderDecoderRetrievalModel as JModel
from hidvae_tpu_torch.bridge import flax_param_key, load_flax_weights
from hidvae_tpu_torch.models import attention
from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from tests._torch_common import jax_example_batch, random_variables, unflat
from tests.test_torch_train import _batches

K, D = 16, 3  # codebook size, digits per item
LOSS_RTOL = 4e-3   # measured 2.2e-4 (19 tokens), 4.4e-4 (2,050)
LOGIT_RTOL = 1.5e-2  # measured 4.4e-3, 3.4e-3; the encoder output likewise
GRAD_RTOL = 5e-2   # worst leaf measured 2.0e-2, 1.6e-2


def _pair(n_items, seed=0):
    """(flax model, params, port model) at bf16 compute with the same weights:
    embed 16, one head of 64 (the flash route's width), two layers."""
    kw = dict(embedding_dim=16, attn_dim=64, num_heads=1, n_layers=2, num_embeddings=K,
              sem_id_dim=D, max_pos=n_items * D)
    jm = JModel(dropout=0.1, dtype=jnp.bfloat16, **kw)
    example = jax_example_batch(D)
    params = random_variables(jm, (example, False), seed=seed)["params"]
    tm = EncoderDecoderRetrievalModel(
        kw["embedding_dim"], kw["attn_dim"], kw["num_heads"], kw["n_layers"], K, D,
        max_pos=kw["max_pos"], dtype=torch.bfloat16)
    load_flax_weights(tm, params)
    return jm, unflat(params), tm.eval()


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("n,flash", [(6, False), (683, True)], ids=["dense_19", "flash_2050"])
def test_bf16_loss_logits_and_gradients_match_jax(n, flash, monkeypatch):
    jm, params, tm = _pair(n)
    jb, tb = _batches(2, n, D, seed=n)

    def jloss(p):
        out = jm.apply({"params": p}, jb, False)
        return out.loss, out.logits

    (loss_j, logits_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    enc_j, valid = jax.jit(lambda p: jm.apply({"params": p}, jb, False,
                                              method=jm.encode_context))(params)

    calls = []
    real = attention.flash_self_attention
    monkeypatch.setattr(attention, "flash_self_attention",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        enc, _ = tm.encode_context(tb)
    out = tm(tb)  # the deterministic forward
    out.loss.backward()
    assert calls == ([1, 1] if flash else [])  # one encoder layer, twice
    assert out.logits.dtype == torch.bfloat16 and logits_j.dtype == jnp.bfloat16

    valid = np.asarray(valid)
    assert _rel_err(enc.float().numpy()[valid], np.asarray(enc_j, np.float32)[valid]) \
        <= LOGIT_RTOL
    assert abs(float(out.loss.detach()) / float(loss_j) - 1) <= LOSS_RTOL
    # Logits come from the decoder, which attends every valid encoder row;
    # padded encoder rows never reach them, so all logits compare.
    assert _rel_err(out.logits.detach().float().numpy(), logits_j) <= LOGIT_RTOL

    named = {k: p.grad for k, p in tm.named_parameters()}
    flat = traverse_util.flatten_dict(grads_j, sep="/")
    assert len(flat) == len(named)
    for path, want in flat.items():
        key, transpose = flax_param_key(path)
        got = named[key].numpy()
        err = _rel_err(got.T if transpose else got, want)
        assert err <= GRAD_RTOL, (path, err)
