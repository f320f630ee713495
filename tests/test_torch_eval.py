"""The stage-2 generation eval against JAX on the CPU: accumulators,
`full_eval` on the tracked synthetic eval split, one-beam search, Gumbel
sampling by distribution, debug metrics."""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from hidvae_tpu.data.processed import RecDataset as JRecDataset
from hidvae_tpu.data.processed import SeqData as JSeqData
from hidvae_tpu.evaluate.metrics import NDCGAccumulator as JNDCG
from hidvae_tpu.evaluate.metrics import TopKAccumulator as JTopK
from hidvae_tpu.models.retrieval import EncoderDecoderRetrievalModel as JModel
from hidvae_tpu.ops.prefix_search import build_prefix_index as j_index
from hidvae_tpu.ops.prefix_search import build_prefix_tries as j_tries
from hidvae_tpu.tokenizer.semids import SemanticIdTokenizer as JTokenizer
from hidvae_tpu.train.transformer import full_eval as j_full_eval
from hidvae_tpu.utils.debug import compute_debug_metrics as j_debug
from hidvae_tpu_torch.data.processed import RecDataset, SeqData
from hidvae_tpu_torch.evaluate.metrics import NDCGAccumulator, TopKAccumulator
from hidvae_tpu_torch.ops.prefix_search import build_prefix_index, build_prefix_tries
from hidvae_tpu_torch.train import transformer as trainer
from hidvae_tpu_torch.utils.debug import compute_debug_metrics
from tests._torch_common import japply, retrieval_pair
from tests.test_torch_retrieval import _batches

ROOT = Path(__file__).resolve().parent.parent
SYNTHETIC = ROOT / "dataset/synthetic"
K = 16
NDCG_TOL = 1e-9
LOGP_TOL = 1e-5
SAMPLE_DRAWS = 2000
CHI2_P = 1e-3


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("d,n_cand,ks", [
    (3, 32, (1, 5, 10)),
    (4, 32, (1, 5, 10)),
    (3, 8, (1, 5, 10, 20)),   # k above the candidate count: NDCG skips it
    (4, 1, (1, 5, 10)),       # one beam
])
def test_metrics_match_jax(d, n_cand, ks):
    rng = np.random.RandomState(d * 100 + n_cand)
    b = 50
    actual = rng.randint(0, 3, (b, d))
    top_k = rng.randint(0, 3, (b, n_cand, d))
    top_k[::4, min(2, n_cand - 1)] = actual[::4]  # some hits at a known rank
    ports, jaxes = (TopKAccumulator(ks), NDCGAccumulator(ks)), (JTopK(ks), JNDCG(ks))
    for _ in range(2):  # two batches accumulate
        for acc in (*ports, *jaxes):
            acc.accumulate(actual, top_k)
    for port, ref in zip(ports, jaxes):
        got, want = port.reduce(), ref.reduce()
        assert got == want
        assert any(v > 0 for v in got.values())


class _JTokenizer:
    """The JAX tokenizer's table side over a given corpus table: `__call__`
    is JAX's SemanticIdTokenizer.__call__ (a gather from cached_ids)."""

    __call__ = JTokenizer.__call__

    def __init__(self, table):
        self.cached_ids = jnp.asarray(table)
        self.prefix_index = j_index(self.cached_ids)


def test_full_eval_matches_jax():
    """Both packages' full_eval over the tracked synthetic eval split (a
    ragged last batch), constrained with caps and tries: equal hits, NDCG
    within NDCG_TOL."""
    d, batch_size, n_digits = 3, 48, 8
    jm, params, tm = retrieval_pair(embedding_dim=16, attn_dim=32, num_heads=4, n_layers=2,
                                    num_embeddings=n_digits, sem_id_dim=d, max_pos=20 * d,
                                    seed=11)
    table = np.random.RandomState(12).randint(0, n_digits, (2000, d)).astype(np.int32)
    caps = tuple(int(np.unique(table[:, :p], axis=0, return_counts=True)[1].max())
                 for p in range(1, d))

    jtok = _JTokenizer(table)
    tries = j_tries(np.asarray(jtok.prefix_index), n_digits)
    j_tries_dev = {i: None if t is None else tuple(map(jnp.asarray, t)) for i, t in tries.items()}
    generate = jax.jit(lambda p, batch, index, tr: jm.apply(
        {"params": p}, batch, index, temperature=1.0, prefix_caps=caps, prefix_tries=tr,
        method=JModel.generate_next_sem_id))
    j_eval = JSeqData(str(SYNTHETIC), JRecDataset.SYNTHETIC, is_train=False)
    assert len(j_eval) % batch_size != 0
    want = j_full_eval(generate, params, jtok, j_eval, batch_size, prefix_tries=j_tries_dev)

    t_table = torch.from_numpy(table)
    ttok = SimpleNamespace(cached_ids=t_table, prefix_index=build_prefix_index(t_table))
    t_tries = {i: None if t is None else tuple(map(torch.from_numpy, t))
               for i, t in build_prefix_tries(_np(ttok.prefix_index), n_digits).items()}
    lines = []
    got = trainer.full_eval(
        lambda batch, index, tr: tm.generate_next_sem_id(
            batch, index, temperature=1.0, prefix_caps=caps, prefix_tries=tr),
        ttok, SeqData(str(SYNTHETIC), RecDataset.SYNTHETIC, is_train=False), batch_size,
        prefix_tries=t_tries, log=lines.append)

    assert set(got) == set(want)
    for key, value in want.items():
        if key.startswith("h@"):
            assert got[key] == value, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=0, atol=NDCG_TOL, err_msg=key)
    assert want[f"h@10_slice_:{d}"] > 0 and want[f"ndcg@10_slice_:{d}"] > 0
    assert len(lines) == 3 and lines[0].startswith("eval sample 0: actual=")


@pytest.mark.parametrize("constrained", [False, True], ids=["free", "constrained"])
def test_one_beam_search_matches_jax(constrained):
    d = 3
    jm, params, tm = retrieval_pair(sem_id_dim=d, n_sem_layers=3, max_pos=6 * d, seed=d)
    jb, tb = _batches(d, seed=5)
    corpus = np.random.RandomState(6).randint(0, K, (40, d)).astype(np.int32)
    index_j = j_index(jnp.asarray(corpus)) if constrained else None
    index_t = build_prefix_index(torch.from_numpy(corpus)) if constrained else None
    caps = tuple(int(np.unique(corpus[:, :p], axis=0, return_counts=True)[1].max())
                 for p in range(1, d))
    want = japply(jm, {"params": params}, lambda m, b, idx: m.generate_next_sem_id(
        b, idx, top_k=False, prefix_caps=caps), jb, index_j)
    with torch.no_grad():
        got = tm.generate_next_sem_id(tb, index_t, top_k=False, prefix_caps=caps)
    assert got.sem_ids.shape == (tb.sem_ids.shape[0], 1, d)
    np.testing.assert_array_equal(_np(got.sem_ids), np.asarray(want.sem_ids))
    np.testing.assert_allclose(_np(got.log_probas), np.asarray(want.log_probas),
                               rtol=0, atol=LOGP_TOL)
    if constrained:
        table = {tuple(r) for r in corpus.tolist()}
        assert all(tuple(r) in table for r in _np(got.sem_ids)[:, 0].tolist())


def _one_history(d, n=6):
    """SAMPLE_DRAWS copies of one tokenized history (rows identical)."""
    _, tb = _batches(d, seed=8)
    rows = torch.zeros(SAMPLE_DRAWS, dtype=torch.long)
    return tb.replace(**{f: getattr(tb, f)[rows] for f in (
        "user_ids", "sem_ids", "sem_ids_fut", "seq_mask", "token_type_ids",
        "token_type_ids_fut")})


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_gumbel_sampling_draws_the_softmax(temperature):
    """Sampled one-beam searches: the first digit's frequencies against
    softmax(logits / T) by chi-square; greedy and generator-less sampling take
    the argmax."""
    d = 3
    _, _, tm = retrieval_pair(sem_id_dim=d, n_sem_layers=3, max_pos=6 * d, seed=21)
    batch = _one_history(d)
    with torch.no_grad():
        enc, mask = tm.encode_context(batch)
        empty = torch.zeros((SAMPLE_DRAWS, 0), dtype=torch.int32)
        logits = tm.decode_logits(enc[:1], mask[:1], empty[:1], empty[:1],
                                  last_only=True)[0, 0].float()
        probs = torch.softmax(logits / temperature, dim=-1).double().numpy()
        g = torch.Generator().manual_seed(13)
        out = tm.generate_next_sem_id(batch, temperature=temperature, top_k=False,
                                      sample=True, generator=g)
        greedy = tm.generate_next_sem_id(batch, temperature=temperature, top_k=False)
        unseeded = tm.generate_next_sem_id(batch, temperature=temperature, top_k=False,
                                           sample=True)
    first = _np(out.sem_ids)[:, 0, 0]
    observed = np.bincount(first, minlength=K).astype(np.float64)
    expected = SAMPLE_DRAWS * probs
    small = expected < 5
    obs = np.append(observed[~small], observed[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    exp *= obs.sum() / exp.sum()
    p_value = stats.chisquare(obs, exp).pvalue
    assert p_value > CHI2_P, (p_value, observed, expected)
    assert len(np.unique(first)) > 3  # it does sample
    argmax = int(np.argmax(probs))
    assert (_np(greedy.sem_ids)[:, 0, 0] == argmax).all()
    assert torch.equal(unseeded.sem_ids, greedy.sem_ids)


def test_debug_metrics_match_jax():
    rng = np.random.RandomState(3)
    mask = rng.rand(9, 12) > 0.4
    loss_d = rng.rand(4).astype(np.float32)
    batch = SimpleNamespace(seq_mask=torch.from_numpy(mask))
    out = SimpleNamespace(loss_d=torch.from_numpy(loss_d))
    want = j_debug(SimpleNamespace(seq_mask=jnp.asarray(mask)),
                   SimpleNamespace(loss_d=jnp.asarray(loss_d)), prefix="eval")
    assert compute_debug_metrics(batch, out, prefix="eval") == want
    assert compute_debug_metrics(batch) == j_debug(SimpleNamespace(seq_mask=mask))


def test_pad_rows_repeats_row_zero():
    users = np.array([5, 6, 7], np.int32)
    items = np.arange(6, dtype=np.int32).reshape(3, 2)
    pu, pi = trainer._pad_rows((users, items), 5)
    assert pu.tolist() == [5, 6, 7, 5, 5]
    assert pi.tolist() == [[0, 1], [2, 3], [4, 5], [0, 1], [0, 1]]
