"""Multi-rank serving on Gloo CPU ranks against one process and JAX: the
stage-2 layout, the sharded sweep, the engine at DP 2 and TP 2 against
JAX's on a (4, 2) mesh, `dryrun_multichip`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from hidvae_tpu.parallel.mesh import make_mesh as j_make_mesh
from hidvae_tpu.parallel.mesh import stage2_param_shardings
from hidvae_tpu.serve import RetrievalEngine as JEngine
from hidvae_tpu.tokenizer import HSemanticIdTokenizer as JTokenizer
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.models.rqvae import RqVae
from hidvae_tpu_torch.parallel.dryrun import dryrun_multichip
from hidvae_tpu_torch.parallel.mesh import Mesh, stage2_param_layout
from tests import _torch_parallel_worker as worker
from tests._torch_common import hrqvae_pair, retrieval_pair

F, D, K, L = 32, 8, 16, 3
TAGS = (4, 6, 20)
N_ITEMS = 97     # chunks of 40, 40 and 17 rows: the last split over 2 ranks after padding
MAX_SEQ = 6
# Scores of a sharded engine against one process's (sums in another order).
SCORE_ATOL = 1e-5
JAX_SCORE_ATOL = 1e-4  # port against JAX, as tests/test_torch_engine.py holds it


def _histories():
    rng = np.random.RandomState(1)
    hist = rng.randint(0, N_ITEMS, (7, 9)).astype(np.int64)
    hist[rng.rand(*hist.shape) < 0.3] = -1
    hist[0] = -1
    return hist


@pytest.mark.parametrize("k", [16, 15])  # 16: out_proj cut, table of 49 rows kept whole;
def test_layout_matches_jax_shardings(k):  # 15: table of 46 rows cut, out_proj kept whole
    _, params, tm = retrieval_pair(num_embeddings=k, sem_id_dim=3, n_sem_layers=3)
    specs = traverse_util.flatten_dict(
        stage2_param_shardings(j_make_mesh(n_data=4, n_model=2), params), sep="/")
    got = stage2_param_layout(Mesh(4, 2, 0), tm)
    assert got.keys() == specs.keys()
    for path, sharding in specs.items():
        spec = tuple(sharding.spec)
        want = None
        if "model" in spec:
            axis = spec.index("model")
            want = 1 - axis if path.endswith("kernel") else axis
        assert got[path] == want, (path, spec, got[path])
    cut = {p for p, dim in got.items() if dim is not None}
    assert any("ff/dense_0" in p for p in cut) and any("ff/dense_1" in p for p in cut)
    assert ("out_proj/kernel" in cut) == (k == 16)
    assert ("sem_id_embedder/emb/embedding" in cut) == (k == 15)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both tokenizer routes, a one-process engine, the JAX engine on a
    (4, 2) mesh with shard_params, and the 2-rank results."""
    workdir = tmp_path_factory.mktemp("serve_ranks")
    jm, jvars, vae_h = hrqvae_pair(input_dim=F, embed_dim=D, hidden_dims=(16,), codebook_size=K,
                                   n_layers=L, tag_class_counts=TAGS, seed=5)
    tok_kw = dict(n_layers=L, codebook_size=K, tag_class_counts=TAGS, use_concatenated_ids=True)
    d = L + len(TAGS)
    jdm, params, decoder = retrieval_pair(sem_id_dim=d, num_embeddings=K, n_sem_layers=L,
                                          max_pos=MAX_SEQ * d, seed=6)
    vae_plain = init_params_(RqVae(F, D, (16,), K, n_layers=L),
                             torch.Generator().manual_seed(9)).eval()
    feats = np.random.RandomState(20).randn(N_ITEMS, F).astype(np.float32)
    inp = dict(vae_h=vae_h, vae_plain=vae_plain, decoder=decoder, feats=feats,
               hist=_histories(), tok_kw=tok_kw, max_seq_len=MAX_SEQ, buckets=(4, 8))
    torch.save(inp, workdir / "inputs.pt")
    ranks = worker.run("serve", 2, str(workdir))
    one = worker.recommend(worker.engine(inp), inp)
    h, plain = worker.tokenizers(inp)
    tables = {"h": h.precompute_corpus_ids(feats).numpy(),
              "plain": plain.precompute_corpus_ids(feats).numpy()}
    j_engine = JEngine(jdm, params, JTokenizer(jm, jvars, corpus_chunk_size=40, **tok_kw),
                       jnp.asarray(feats), max_seq_len=MAX_SEQ, batch_buckets=(4, 8),
                       mesh=j_make_mesh(n_data=4, n_model=2), shard_params=True)
    want_jax = j_engine.recommend(inp["hist"], top_k=10)
    return ranks, one, tables, want_jax


@pytest.mark.parametrize("route", ["h", "plain"])
def test_sharded_sweep_is_the_one_process_table(served, route):
    ranks, _, tables, _ = served
    for r in ranks:
        np.testing.assert_array_equal(r[f"table_{route}"], tables[route])


@pytest.mark.parametrize("layout", ["dp", "tp"])
def test_sharded_engine_serves_one_process_items(served, layout):
    ranks, one, _, _ = served
    for r in ranks:
        np.testing.assert_array_equal(r[f"{layout}:corpus"], one["corpus"])
        np.testing.assert_array_equal(r[f"{layout}:items"], one["items"])
        np.testing.assert_array_equal(r[f"{layout}:sem_ids"], one["sem_ids"])
        np.testing.assert_allclose(r[f"{layout}:scores"], one["scores"], rtol=0, atol=SCORE_ATOL)
    assert (one["items"] >= 0).any()


def test_tp_engine_holds_half_of_each_cut_leaf(served):
    ranks, _, _, _ = served
    shapes = {k.split("/", 1)[1]: tuple(v) for k, v in ranks[0].items()
              if k.startswith("tp:shape/")}
    assert shapes["out_proj.weight"] == (K // 2, 32)
    assert shapes["transformer.encoder.block_0.ff.dense_0.weight"] == (512, 32)
    assert shapes["transformer.decoder.block_0.ff.dense_1.weight"] == (32, 512)
    table_rows = K * L + 1000 * len(TAGS) + 1  # odd: kept whole, as JAX's ok() keeps it
    assert shapes["sem_id_embedder.emb.weight"] == (table_rows, 16)


def test_one_process_engine_serves_the_jax_sharded_engines_items(served):
    _, one, _, want = served
    np.testing.assert_array_equal(one["items"], want["items"])
    np.testing.assert_array_equal(one["sem_ids"], want["sem_ids"])
    np.testing.assert_allclose(one["scores"], want["scores"], rtol=1e-6, atol=JAX_SCORE_ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_one_process(n, capsys):
    out = dryrun_multichip(n)
    assert out["mesh"] == ({"data": 2, "model": 2} if n == 4 else {"data": 2, "model": 1})
    line = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh=" in line and "stage1_loss=" in line
    np.testing.assert_allclose(out["loss"], out["one_rank_loss"], rtol=1e-5)
    np.testing.assert_allclose(out["stage1_loss"], out["stage1_one_rank_loss"], rtol=1e-5)
