"""Stage-2 parity: attention, embedder slots, the retrieval model's CE
forward and its constrained beam search against the JAX model on the same
weights, plus the on-device tokenization gather."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.models import attention as jattn
from hidvae_tpu.models.embedder import compute_embedding_slots as j_slots
from hidvae_tpu.ops.prefix_search import build_prefix_index as j_index
from hidvae_tpu.ops.prefix_search import build_prefix_tries as j_tries
from hidvae_tpu.train.device_data import tokenize_on_device as j_tokenize
from hidvae_tpu_torch.models import attention
from hidvae_tpu_torch.models.embedder import compute_embedding_slots
from hidvae_tpu_torch.models.retrieval import top_k_first_index
from hidvae_tpu_torch.ops.prefix_search import build_prefix_index
from hidvae_tpu_torch.tokenizer.h_semids import interleave_ids
from hidvae_tpu_torch.train.device_data import tokenize_on_device
from tests._torch_common import batch_pair, japply, retrieval_pair

B, N, K = 4, 6, 16
LOGIT_TOL = 1e-4


def _np(t):
    return t.detach().cpu().numpy()


def _batches(d, seed=0):
    return batch_pair(B, N, d, seed, K, {1: N - 2})


class TestAttention:
    def test_dense_and_grouped(self):
        rng = np.random.RandomState(0)
        q = rng.randn(6, 2, 3, 8).astype(np.float32)
        k = rng.randn(6, 2, 5, 8).astype(np.float32)
        v = rng.randn(6, 2, 5, 8).astype(np.float32)
        pad = rng.rand(6, 5) > 0.3
        pad[0] = False  # a fully masked row: uniform weights in both
        jm = jattn.make_attention_mask(3, 5, causal=True, kv_padding_mask=jnp.asarray(pad))
        tm = attention.make_attention_mask(3, 5, causal=True, kv_padding_mask=torch.from_numpy(pad))
        np.testing.assert_array_equal(_np(tm), np.asarray(jm))
        np.testing.assert_allclose(
            _np(attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)), mask=tm)),
            np.asarray(jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)), mask=jm)),
            atol=1e-5)
        # 3 query rows per key row, no repeat of k or v.
        np.testing.assert_allclose(
            _np(attention.grouped_cross_attention(
                torch.from_numpy(q), torch.from_numpy(k[:2]), torch.from_numpy(v[:2]),
                kv_padding_mask=torch.from_numpy(pad[:2]))),
            np.asarray(jattn.grouped_cross_attention(
                jnp.asarray(q), jnp.asarray(k[:2]), jnp.asarray(v[:2]),
                kv_padding_mask=jnp.asarray(pad[:2]))),
            atol=1e-5)


class TestSlotsAndTokenize:
    @pytest.mark.parametrize("interleaved", [False, True])
    def test_embedding_slots(self, interleaved):
        rng = np.random.RandomState(1)
        sem = rng.randint(-1, 40, (3, 12)).astype(np.int32)
        tt = np.tile(np.arange(6, dtype=np.int32), (3, 2))
        mask = rng.rand(3, 12) > 0.2
        kw = dict(num_embeddings=16, n_sem_layers=3, n_tag_layers=2,
                  use_interleaved_ids=interleaved, padding_idx=999)
        got = compute_embedding_slots(torch.from_numpy(sem), torch.from_numpy(tt),
                                      valid_mask=torch.from_numpy(mask), **kw)
        want = j_slots(jnp.asarray(sem), jnp.asarray(tt), valid_mask=jnp.asarray(mask), **kw)
        np.testing.assert_array_equal(_np(got), np.asarray(want))

    def test_tokenize_on_device_and_interleave(self):
        rng = np.random.RandomState(2)
        table = rng.randint(0, 16, (30, 4)).astype(np.int32)
        items = rng.randint(-1, 30, (5, 6)).astype(np.int32)
        fut = rng.randint(0, 30, (5,)).astype(np.int32)
        got = tokenize_on_device(torch.from_numpy(table), torch.arange(5), torch.from_numpy(items),
                                 torch.from_numpy(fut))
        want = j_tokenize(jnp.asarray(table), jnp.arange(5), jnp.asarray(items), jnp.asarray(fut))
        for name in ("sem_ids", "sem_ids_fut", "seq_mask", "token_type_ids", "token_type_ids_fut"):
            np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)))
        from hidvae_tpu.tokenizer.h_semids import interleave_ids as j_interleave

        np.testing.assert_array_equal(
            _np(interleave_ids(torch.from_numpy(table[:, :3]), torch.from_numpy(table[:, 3:]))),
            np.asarray(j_interleave(jnp.asarray(table[:, :3]), jnp.asarray(table[:, 3:]))))

    def test_top_k_ties_take_the_lower_index(self):
        scores = torch.tensor([[1.0, 3.0, 3.0, -1e9, -1e9, 3.0, -1e9]])
        vals, idx = top_k_first_index(scores, 5)
        jv, ji = jax.lax.top_k(jnp.asarray(scores.numpy()), 5)
        np.testing.assert_array_equal(_np(idx), np.asarray(ji))
        np.testing.assert_array_equal(_np(vals), np.asarray(jv))


@pytest.fixture(scope="module", params=[3, 5], ids=["semantic_d3", "tagged_d5"])
def pair(request):
    d = request.param
    return d, retrieval_pair(sem_id_dim=d, n_sem_layers=3, max_pos=N * d, seed=d)


class TestRetrievalModel:
    def test_ce_forward(self, pair):
        d, (jm, params, tm) = pair
        jb, tb = _batches(d)
        want = japply(jm, {"params": params}, lambda m, b: m(b, False), jb)
        with torch.no_grad():
            got = tm(tb)
        np.testing.assert_allclose(_np(got.logits), np.asarray(want.logits), atol=LOGIT_TOL)
        np.testing.assert_allclose(float(got.loss), float(want.loss), atol=LOGIT_TOL)
        np.testing.assert_allclose(_np(got.loss_d), np.asarray(want.loss_d), atol=LOGIT_TOL)

    @pytest.mark.parametrize("constraint", ["none", "tries", "caps", "heuristic"])
    def test_generate_next_sem_id(self, pair, constraint):
        d, (jm, params, tm) = pair
        jb, tb = _batches(d, seed=3)
        rng = np.random.RandomState(4)
        corpus = rng.randint(0, K, (40, d)).astype(np.int32)
        corpus[:, 3:] = rng.randint(0, 20, (40, d - 3))  # tag digits may exceed K
        j_sorted, t_sorted = j_index(jnp.asarray(corpus)), build_prefix_index(torch.from_numpy(corpus))
        kw_j, kw_t = {}, {}
        if constraint == "tries":
            tries = j_tries(np.asarray(j_sorted), K)
            kw_j["prefix_tries"] = {i: tuple(map(jnp.asarray, t)) for i, t in tries.items()}
            kw_t["prefix_tries"] = {i: tuple(map(torch.from_numpy, t)) for i, t in tries.items()}
        elif constraint == "caps":
            caps = [int(np.unique(corpus[:, :p], axis=0, return_counts=True)[1].max())
                    for p in range(1, d)]
            kw_j["prefix_caps"] = kw_t["prefix_caps"] = tuple(caps)
        index_j = None if constraint == "none" else j_sorted
        index_t = None if constraint == "none" else t_sorted

        warns = (pytest.warns(UserWarning, match="heuristic cap") if constraint == "heuristic"
                 else contextlib.nullcontext())
        with warns:
            want = japply(jm, {"params": params},
                          lambda m, b, idx: m.generate_next_sem_id(b, idx, **kw_j), jb, index_j)
        with warns, torch.no_grad():
            got = tm.generate_next_sem_id(tb, index_t, **kw_t)
        np.testing.assert_array_equal(_np(got.sem_ids), np.asarray(want.sem_ids))
        np.testing.assert_allclose(_np(got.log_probas), np.asarray(want.log_probas),
                                   atol=LOGIT_TOL, rtol=1e-6)
        if constraint != "none":
            table = {tuple(r) for r in corpus.tolist()}
            best = _np(got.sem_ids)[:, 0]
            assert all(tuple(r) in table for r in best.tolist())
