"""The H tokenizer's table-free methods against JAX's on the same weights:
predict_tags on [B, F] and [B, N, F]; tokenize_features in every layout,
with and without target and mask; __call__ with and without a table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.tokenizer import HSemanticIdTokenizer as JTokenizer
from hidvae_tpu_torch.data.schemas import SeqBatch
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from tests._torch_common import hrqvae_pair

F, D, K, L = 32, 8, 16, 3
TAGS = (4, 6, 20)
B, N = 5, 4
CONF_RTOL = 1e-5
LAYOUTS = {
    "semantic": {},
    "semantic_dedup": dict(use_dedup_dim=True),
    "concatenated": dict(use_concatenated_ids=True),
    "interleaved": dict(use_interleaved_ids=True),
}


@pytest.fixture(scope="module")
def pair():
    return hrqvae_pair(input_dim=F, embed_dim=D, hidden_dims=(16,), codebook_size=K,
                       n_layers=L, tag_class_counts=TAGS, seed=5)


def _tokenizers(pair, layout):
    jm, jvars, tm = pair
    kw = dict(n_layers=L, codebook_size=K, tag_class_counts=TAGS, **LAYOUTS[layout])
    return JTokenizer(jm, jvars, **kw), HSemanticIdTokenizer(tm, device="cpu", **kw)


def _inputs(seed=3):
    r = np.random.RandomState(seed)
    x = r.randn(B, N, F).astype(np.float32)
    x_fut = r.randn(B, 1, F).astype(np.float32)
    mask = r.rand(B, N) < 0.7
    mask[:, 0] = True
    return x, x_fut, mask, np.arange(B, dtype=np.int32) * 3


@pytest.mark.parametrize("shape", [(B * N, F), (B, N, F)], ids=["items", "sequences"])
def test_predict_tags_matches_jax(pair, shape):
    jtok, ttok = _tokenizers(pair, "concatenated")
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = jtok.predict_tags(jnp.asarray(x))
    got = ttok.predict_tags(x)
    np.testing.assert_array_equal(got["predictions"].numpy(), np.asarray(want["predictions"]))
    np.testing.assert_allclose(got["confidences"].numpy(), np.asarray(want["confidences"]),
                               rtol=CONF_RTOL)


@pytest.mark.parametrize("full", [True, False], ids=["fut-mask", "bare"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tokenize_features_matches_jax(pair, layout, full):
    jtok, ttok = _tokenizers(pair, layout)
    x, x_fut, mask, users = _inputs()
    kw = dict(x_fut=x_fut, seq_mask=mask, user_ids=users) if full else {}
    want = jtok.tokenize_features(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in kw.items()})
    got = ttok.tokenize_features(x, **kw)
    d = L + (len(TAGS) if layout in ("concatenated", "interleaved") else 0)
    assert got.sem_ids.shape == (B, N * d)
    for name in ("user_ids", "sem_ids", "sem_ids_fut", "seq_mask", "token_type_ids",
                 "token_type_ids_fut"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if full:
        assert (got.sem_ids.numpy()[~np.repeat(mask, d, axis=1)] == -1).all()


def test_call_without_a_table_tokenizes_features(pair):
    _, ttok = _tokenizers(pair, "concatenated")
    x, x_fut, mask, users = _inputs(seed=4)
    ids = np.where(mask, np.arange(B * N).reshape(B, N), -1)
    batch = SeqBatch(user_ids=torch.from_numpy(users), ids=torch.from_numpy(ids),
                     ids_fut=torch.full((B, 1), B * N), x=torch.from_numpy(x),
                     x_fut=torch.from_numpy(x_fut), seq_mask=torch.from_numpy(mask))
    direct = ttok.tokenize_features(x, x_fut, mask, users)
    untabled = ttok(batch)
    # With a table of the same items (the target last), the gather agrees.
    ttok.precompute_corpus_ids(np.concatenate([x.reshape(B * N, F), x_fut[:, 0]])[: B * N + 1])
    gathered = ttok(batch)
    for out in (untabled, gathered):
        for name in ("user_ids", "sem_ids", "seq_mask", "token_type_ids"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          getattr(direct, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(untabled.sem_ids_fut.numpy(), direct.sem_ids_fut.numpy())
    np.testing.assert_array_equal(gathered.sem_ids_fut.numpy()[0],
                                  direct.sem_ids_fut.numpy()[0])
