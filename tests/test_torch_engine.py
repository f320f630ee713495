"""Serving end to end on the CPU: the port's tokenizer and engine against a
JAX engine built as tests/test_serve.py does, same weights and inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.serve import RetrievalEngine as JEngine
from hidvae_tpu.tokenizer import HSemanticIdTokenizer as JTokenizer
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.tokenizer.sweep import features_fingerprint
from tests._torch_common import hrqvae_pair, retrieval_pair

F, D, K, L = 32, 8, 16, 3
TAGS = (4, 6, 20)  # the last level's tag digits can exceed the decoder vocab K
N_ITEMS = 96
MAX_SEQ = 6
LAYOUTS = {
    "concatenated": dict(use_concatenated_ids=True),
    "interleaved": dict(use_interleaved_ids=True),
    "semantic_dedup": dict(use_dedup_dim=True),
}


def _np(t):
    return t.detach().cpu().numpy()


def _features(seed=20):
    return np.random.RandomState(seed).randn(N_ITEMS, F).astype(np.float32)


def _histories():
    rng = np.random.RandomState(1)
    hist = rng.randint(0, N_ITEMS, (7, 9)).astype(np.int64)
    hist[rng.rand(*hist.shape) < 0.3] = -1  # interior holes
    hist[0] = -1                            # empty history
    hist[1] = np.arange(9)                  # longer than MAX_SEQ
    return hist


def _tokenizers(layout):
    jm, jvars, tm = hrqvae_pair(input_dim=F, embed_dim=D, hidden_dims=(16,), codebook_size=K,
                                n_layers=L, tag_class_counts=TAGS, seed=5)
    kw = dict(n_layers=L, codebook_size=K, tag_class_counts=TAGS, corpus_chunk_size=40,
              **LAYOUTS[layout])
    return JTokenizer(jm, jvars, **kw), HSemanticIdTokenizer(tm, device="cpu", **kw)


@pytest.fixture(scope="module", params=["concatenated", "interleaved"])
def engines(request):
    layout = request.param
    jtok, ttok = _tokenizers(layout)
    d = ttok.sem_ids_dim
    jm, params, tm = retrieval_pair(
        sem_id_dim=d, num_embeddings=K, n_sem_layers=L, max_pos=MAX_SEQ * d,
        use_interleaved_ids=layout == "interleaved", seed=6)
    feats = _features()
    j_engine = JEngine(jm, params, jtok, jnp.asarray(feats), max_seq_len=MAX_SEQ,
                       batch_buckets=(4, 8))
    t_engine = RetrievalEngine(tm, ttok, feats, max_seq_len=MAX_SEQ, batch_buckets=(4, 8),
                               device="cpu")
    return j_engine, t_engine


class TestCorpusTable:
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_table_caps_and_tries_match_jax(self, layout):
        jtok, ttok = _tokenizers(layout)
        feats = _features()
        want = np.asarray(jtok.precompute_corpus_ids(jnp.asarray(feats)))
        got = _np(ttok.precompute_corpus_ids(feats))
        assert got.shape == (N_ITEMS, jtok.sem_ids_dim) == (N_ITEMS, ttok.sem_ids_dim)
        np.testing.assert_array_equal(got, want)
        assert ttok.cached_ids_fingerprint == jtok.cached_ids_fingerprint
        np.testing.assert_array_equal(_np(ttok.prefix_index), np.asarray(jtok.prefix_index))
        assert ttok.prefix_caps == jtok.prefix_caps
        for lvl, t in jtok.prefix_tries(K).items():
            np.testing.assert_array_equal(ttok.prefix_tries(K)[lvl][0], t[0])
            np.testing.assert_array_equal(ttok.prefix_tries(K)[lvl][1], t[1])
        np.testing.assert_array_equal(
            _np(ttok.exists_prefix(got[:5, :2])),
            np.asarray(jtok.exists_prefix(jnp.asarray(want[:5, :2]))))

    def test_tokenize_seq_batch_matches_jax(self):
        from hidvae_tpu.data.schemas import SeqBatch as JSeqBatch

        from hidvae_tpu_torch.data.schemas import SeqBatch

        jtok, ttok = _tokenizers("concatenated")
        feats = _features()
        jtok.precompute_corpus_ids(jnp.asarray(feats))
        ttok.precompute_corpus_ids(feats)
        hist = _histories()[:, :MAX_SEQ].astype(np.int32)
        fut = np.arange(7, dtype=np.int32)[:, None]
        mask = hist >= 0
        want = jtok(JSeqBatch(user_ids=jnp.arange(7), ids=jnp.asarray(hist),
                              ids_fut=jnp.asarray(fut), x=None, x_fut=None,
                              seq_mask=jnp.asarray(mask)))
        got = ttok(SeqBatch(user_ids=torch.arange(7), ids=torch.from_numpy(hist),
                            ids_fut=torch.from_numpy(fut), x=None, x_fut=None,
                            seq_mask=torch.from_numpy(mask)))
        for name in ("sem_ids", "sem_ids_fut", "seq_mask", "token_type_ids",
                     "token_type_ids_fut"):
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          np.asarray(getattr(want, name)))

    def test_fingerprint_of_tensor_and_array_agree(self):
        feats = _features()
        assert features_fingerprint(torch.from_numpy(feats)) == features_fingerprint(feats)


class TestEngineParity:
    def test_recommend_matches_jax(self, engines):
        j_engine, t_engine = engines
        np.testing.assert_array_equal(_np(t_engine.corpus_ids), np.asarray(j_engine.corpus_ids))
        hist = _histories()
        want = j_engine.recommend(hist, top_k=10)
        got = t_engine.recommend(hist, top_k=10)
        np.testing.assert_array_equal(got["items"], want["items"])
        np.testing.assert_array_equal(got["sem_ids"], want["sem_ids"])
        np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4, rtol=1e-6)
        assert (got["items"] >= 0).any()

    def test_pad_histories_matches_jax(self, engines):
        j_engine, t_engine = engines
        hist = _histories()
        np.testing.assert_array_equal(t_engine._pad_histories(hist),
                                      j_engine._pad_histories(hist))
        np.testing.assert_array_equal(t_engine._pad_histories(np.zeros((2, 0), np.int64)),
                                      np.full((2, MAX_SEQ), -1, np.int32))


class TestEngineServing:
    def test_buckets_chunks_and_resolution(self, engines):
        _, t_engine = engines
        rng = np.random.RandomState(2)
        hist = rng.randint(0, N_ITEMS, (11, 4))  # > top bucket 8: two chunks
        out = t_engine.recommend(hist, top_k=4)
        assert out["items"].shape == (11, 4)
        solo = t_engine.recommend(hist[:4], top_k=4)  # exact bucket 4
        np.testing.assert_array_equal(out["items"][:4], solo["items"])
        corpus = _np(t_engine.corpus_ids)
        ok = out["items"] >= 0
        np.testing.assert_array_equal(corpus[out["items"][ok]], out["sem_ids"][ok])
        assert (np.diff(out["scores"], axis=1) <= 1e-6).all()
        empty = t_engine.recommend(np.zeros((0, 3), np.int64), top_k=4)
        assert empty["items"].shape == (0, 4)

    def test_cached_table_reuse_by_fingerprint(self, engines, monkeypatch):
        _, t_engine = engines
        tok = t_engine.tokenizer

        def boom(*a, **k):
            raise AssertionError("swept")

        monkeypatch.setattr(type(tok), "precompute_corpus_ids", boom)
        again = RetrievalEngine(t_engine.model, tok, _features().copy(), max_seq_len=MAX_SEQ,
                                batch_buckets=(4,), device="cpu")
        np.testing.assert_array_equal(_np(again.corpus_ids), _np(t_engine.corpus_ids))
        for feats, reuse in ((_features(), False), (np.zeros((N_ITEMS, F), np.float32), True)):
            with pytest.raises(AssertionError, match="swept"):
                RetrievalEngine(t_engine.model, tok, feats, max_seq_len=MAX_SEQ,
                                batch_buckets=(4,), device="cpu", reuse_cached_ids=reuse)

    def test_default_device_is_the_card(self, engines):
        _, t_engine = engines
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid here")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RetrievalEngine(t_engine.model, t_engine.tokenizer, _features(),
                            max_seq_len=MAX_SEQ)
