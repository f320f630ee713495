"""Duplicate-pair mining against JAX on the CPU: harvest, pair rows, the
forward with mined pairs, a JAX run resumed in the port, pool re-seeding,
2N equal to N + a resumed N."""

import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.data.processed import RecDataset as JRecDataset
from hidvae_tpu.data.processed import processed_path as j_processed_path
from hidvae_tpu.data.synthetic import build_synthetic
from hidvae_tpu.models.quantize import QuantizeForwardMode as JMode
from hidvae_tpu.train import device_data as jdd
from hidvae_tpu.train import hidvae as jtrainer
from hidvae_tpu.utils import runtime as jruntime
from hidvae_tpu_torch.bridge import load_export_arrays, state_dict_to_flax
from hidvae_tpu_torch.data.processed import RecDataset
from hidvae_tpu_torch.models import hrqvae as thrqvae
from hidvae_tpu_torch.models.quantize import QuantizeForwardMode
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.train import hidvae as trainer
from hidvae_tpu_torch.train.common import restore_checkpoint
from hidvae_tpu_torch.train.device_data import DeviceItemData, harvest_duplicate_pairs
from tests._torch_common import assert_rel as _assert_rel
from tests._torch_common import flat, load_script, unflat
from tests.test_torch_stage1_model import (assert_forward_as_jax, jax_mixup_draws, make_batch,
                                           make_pair)
from tests.test_torch_stage1_trainer import TINY

LOSS_RTOL = 1e-4
REL_TOL = 1e-4
LR = 1e-3
POOL = 16
MINING = dict(
    batch_size=16, learning_rate=LR, weight_decay=0.015, vae_input_dim=32, vae_n_cat_feats=0,
    vae_hidden_dims=[32, 16], vae_embed_dim=8, vae_codebook_size=8,
    vae_codebook_normalize=True, vae_n_layers=3, tag_embed_dim=16, commitment_weight=0.4,
    layer_specific_lr=True, tag_alignment_weight=0.15, tag_prediction_weight=0.55,
    sem_id_uniqueness_weight=1.5, sem_id_uniqueness_margin=0.0, id_repetition_threshold=0.0,
    rare_tag_threshold=8, lr_scheduler_T_max=20, make_plots=False, seed=5, log_every=100,
    eval_batches=1, eval_every=2, save_model_every=2, dropout_rate=0.0, use_mixup=False,
    eval_tta=False, sem_id_mining=True, sem_id_mining_frac=0.25, sem_id_mining_pool=POOL,
    sem_id_mining_margin=0.9, sem_id_mining_isolate=True,
)
N_PAIR_ROWS = int(16 * 0.25) // 2


def assert_rel(got, want, tol=REL_TOL, err_msg=""):
    _assert_rel(got, want, tol, err_msg)


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


# ---- the harvest and the sampler --------------------------------------------

def _table(case):
    """(audit table, sorted split indices) of each case."""
    table = np.arange(80, dtype=np.int32).reshape(40, 2)  # no collision
    split = np.arange(40)
    if case == "outside":  # each colliding group holds an item outside the split
        table[5], table[30] = table[1], table[9]
        split = np.setdiff1d(split, [1, 9])
    elif case == "fewer":  # 3 pairs for a pool of 16: resampled with replacement
        table[[7, 21]] = table[3]
        table[11] = table[30]
    elif case == "more":  # 4 tuples over 40 items, 7 items outside the split
        r = np.random.RandomState(3)
        table = r.randint(0, 2, (40, 2)).astype(np.int32)
        split = np.sort(r.choice(40, 33, replace=False))
    return table, split


@pytest.mark.parametrize("case", ["none", "outside", "fewer", "more"])
def test_harvest_matches_jax(case):
    table, split = _table(case)
    want = jdd.harvest_duplicate_pairs(table, split, POOL, np.random.RandomState(9))
    got = harvest_duplicate_pairs(table, split, POOL, np.random.RandomState(9))
    if case in ("none", "outside"):
        assert want is None and got is None
        return
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (POOL, 2)
    glob = split[got]
    assert (table[glob[:, 0]] == table[glob[:, 1]]).all() and (glob[:, 0] != glob[:, 1]).all()
    assert len(np.unique(got, axis=0)) == (3 if case == "fewer" else POOL)


@pytest.mark.parametrize("n_pair_rows", [0, 3])
def test_sample_with_pair_rows_matches_jax(n_pair_rows, monkeypatch):
    """JAX's draws (the pool rows, then the uniform rows) handed to the
    port's sampler in the order it draws: the same batch."""
    r = np.random.RandomState(0)
    x = r.randn(50, 4).astype(np.float32)
    te = r.randn(50, 3, 5).astype(np.float32)
    ti = r.randint(0, 7, (50, 3)).astype(np.int32)
    pool = r.randint(0, 50, (9, 2)).astype(np.int32)
    key = jax.random.key(11)
    jdata = jdd.DeviceItemData(jnp.asarray(x), jnp.asarray(te), jnp.asarray(ti),
                               mining_pairs=jnp.asarray(pool))
    want = jdata.sample(key, 12, n_pair_rows)
    if n_pair_rows:
        r_pairs, r_rest = jax.random.split(key)
        draws = [jax.random.randint(r_pairs, (n_pair_rows,), 0, 9),
                 jax.random.randint(r_rest, (12 - 2 * n_pair_rows,), 0, 50)]
    else:
        draws = [jax.random.randint(key, (12,), 0, 50)]
    draws = iter(torch.from_numpy(np.array(d)).long() for d in draws)
    monkeypatch.setattr(torch, "randint", lambda *a, **k: next(draws))
    tdata = DeviceItemData(torch.from_numpy(x), torch.from_numpy(te), torch.from_numpy(ti),
                           mining_pairs=torch.from_numpy(pool))
    got = tdata.sample(torch.Generator(), 12, n_pair_rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if n_pair_rows:
        rows = got[0][: 2 * n_pair_rows].numpy()
        pairs = pool[np.array(jax.random.randint(jax.random.split(key)[0], (n_pair_rows,), 0,
                                                  9))]
        np.testing.assert_array_equal(rows, x[pairs.reshape(-1)])


# ---- the model --------------------------------------------------------------

N_PAIRS = 4  # rows 0-1 identical, 2-3 a near duplicate, 4-5 and 6-7 correlated


@pytest.mark.parametrize("margin,isolate", [(None, False), (0.9, False), (0.9, True)],
                         ids=["plain", "margin", "margin-isolate"])
def test_forward_with_mined_pairs_matches_jax(margin, isolate, no_flax_dropout):
    jm, v, tm = make_pair(sem_id_mining_margin=margin, mined_loss_isolation=isolate)
    x, te, ti, counts = make_batch()
    r = np.random.RandomState(2)
    x[1] = x[0]
    x[3] = x[2] + 1e-4 * r.randn(x.shape[1])
    x[5] = 0.7 * x[4] + 0.3 * r.randn(x.shape[1])  # close in encoder space, other IDs
    x[7] = 0.7 * x[6] + 0.3 * r.randn(x.shape[1])
    key = jax.random.key(4)
    cc = tuple(jnp.asarray(c) for c in counts)

    def loss_fn(params, stats):
        out, upd = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            jnp.asarray(te), jnp.asarray(ti), 0.2, train=True, class_counts=cc,
                            n_mined_pairs=N_PAIRS,
                            rngs={"mixup": key, "dropout": jax.random.key(0),
                                  "gumbel": jax.random.key(1)}, mutable=["batch_stats"])
        return out.loss, (out, upd["batch_stats"])

    (_, (jout, jstats)), jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        unflat(v["params"]), unflat(v["batch_stats"]))
    draws = jax_mixup_draws(jm, v, key, b=len(x) - (2 * N_PAIRS if isolate else 0))
    out = tm(torch.from_numpy(x), torch.from_numpy(te), torch.from_numpy(ti), 0.2, train=True,
             class_counts=[torch.from_numpy(c) for c in counts], n_mined_pairs=N_PAIRS,
             mixup=lambda level, b: draws[level])
    out.loss.backward()
    rate = float(out.mined_pair_collision_rate)
    assert rate == float(jout.mined_pair_collision_rate) and 0.5 <= rate < 1.0
    assert_forward_as_jax(tm, out, jout, jgrad, jstats, LOSS_RTOL)


# ---- the trainer ------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_mining"))
    build_synthetic(**TINY).save(j_processed_path(root, JRecDataset.SYNTHETIC))
    return root


def _port(root, tmp, name, **kw):
    args = dict(MINING, dataset=RecDataset.SYNTHETIC, dataset_folder=root,
                vae_codebook_mode=QuantizeForwardMode.ROTATION_TRICK,
                save_dir_root=str(tmp / name), device="cpu")
    args.update(kw)
    return trainer.train(**args)


def _pool(path):
    return load_export_arrays(path, "mining_pairs")["mining_pairs"]


@pytest.fixture(scope="module")
def jax_run(dataset_root, tmp_path_factory):
    """The JAX trainer with mining, 2 + 2 mini-steps; `latest` at 2 (after
    the first harvest) and at the end exported, the first with its state."""
    tmp = tmp_path_factory.mktemp("jax_mining")
    mp = pytest.MonkeyPatch()
    mp.setattr(jruntime, "_configured", True)  # keep the process PRNG and cache
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    save = jtrainer._save

    def keep_first(save_dir, name, state, *a, **k):
        path = save(save_dir, name, state, *a, **k)
        if name == "latest" and int(state.step) == 2:
            shutil.copytree(path, str(tmp / "latest_2"))
        return path

    mp.setattr(jtrainer, "_save", keep_first)
    try:
        run = jtrainer.train(**MINING, iterations=4, dataset=JRecDataset.SYNTHETIC,
                             dataset_folder=dataset_root, vae_codebook_mode=JMode.ROTATION_TRICK,
                             save_dir_root=str(tmp / "jax"))
    finally:
        mp.undo()
    converter = load_script("export_flax_checkpoint")
    mid, last = str(tmp / "export_2"), str(tmp / "export_4")
    converter.export_checkpoint(str(tmp / "latest_2"), mid, opt_state=True)
    converter.export_checkpoint(run["saved_paths"][-1], last, opt_state=True)
    return run, mid, last


def test_pool_converts_and_the_port_harvests_it(jax_run, dataset_root, tmp_path):
    """The converter carries the pool; the port's audit of the step-2 weights
    through rq_assign's plain version, harvested with the (seed, 2) draws,
    is JAX's pool."""
    run, mid, last = jax_run
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        raw = np.asarray(ckptr.restore(run["saved_paths"][-1])["mining_pairs"])
    np.testing.assert_array_equal(_pool(last), raw)
    pool = _pool(mid)
    assert pool.shape == (POOL, 2) and pool.dtype == np.int32
    probe = _port(dataset_root, tmp_path, "probe", iterations=0, use_kmeans_init=False)
    step, _ = restore_checkpoint(mid, probe["model"], probe["optimizer"])
    assert step == 2
    data = np.load(j_processed_path(dataset_root, JRecDataset.SYNTHETIC))
    tok = HSemanticIdTokenizer(probe["model"], n_layers=3, codebook_size=8,
                               tag_class_counts=probe["tag_class_counts"], device="cpu")
    table = tok.precompute_corpus_ids(data["item_features"]).numpy()
    split = np.nonzero(data["item_is_train"])[0]
    seed = MINING["seed"]
    got = harvest_duplicate_pairs(table, split, POOL,
                                  np.random.RandomState((seed * 1_000_003 + 2) % 2 ** 31))
    np.testing.assert_array_equal(got, pool)


def test_resume_follows_jax_and_harvests_its_pool(jax_run, dataset_root, tmp_path, monkeypatch):
    run, mid, last = jax_run
    monkeypatch.setattr(thrqvae, "drop", lambda x, p, g: x)
    n_train = int(np.load(j_processed_path(dataset_root, JRecDataset.SYNTHETIC))
                  ["item_is_train"].sum())
    root = jax.random.fold_in(jax.random.key(MINING["seed"]), 0x5EED)
    draws = {}
    for s in range(2, 4):  # hidvae.py:645 and device_data.py:52-66
        r_pairs, r_rest = jax.random.split(jax.random.split(jax.random.fold_in(root, s))[0])
        draws[s] = (torch.from_numpy(np.array(jax.random.randint(r_pairs, (N_PAIR_ROWS,), 0,
                                                                 POOL))).long(),
                    torch.from_numpy(np.array(jax.random.randint(
                        r_rest, (16 - 2 * N_PAIR_ROWS,), 0, n_train))).long())
    order = iter(range(2, 4))

    def sample(self, g, b, n):  # JAX's draws on the port's own pool
        pr, rest = draws[next(order)]
        return self.gather(torch.cat([self.mining_pairs[pr].reshape(-1).long(), rest]))

    monkeypatch.setattr(DeviceItemData, "sample", sample)
    port = _port(dataset_root, tmp_path, "port", iterations=2, pretrained_hrqvae_path=mid)
    jh, th = run["history"], port["history"]
    assert jh["iterations"] == [1, 3] and th["iterations"] == [3]
    assert th["eval_iterations"] == jh["eval_iterations"][-1:] == [4]
    assert th["mining_pool_refreshed"] == [4]
    assert th["repetition_rate"] == jh["repetition_rate"][-1:]
    for key in ("total_loss", "reconstruction_loss", "tag_pred_loss", "eval_total_loss"):
        np.testing.assert_allclose(th[key], jh[key][-1:], rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_array_equal(_pool(port["saved_paths"][-1]), _pool(last))
    np.testing.assert_array_equal(port["data"].mining_pairs.numpy(), _pool(last))
    params = state_dict_to_flax(port["model"])[0]
    for k, want in flat(run["state"].params).items():
        if k.startswith("tag_projector_") and k.endswith("dense_0/bias"):
            np.testing.assert_allclose(params[k], want, rtol=0, atol=2 * 2 * 1.3 * LR)
        else:
            assert_rel(params[k], want, err_msg=k)


@pytest.mark.parametrize("pool", [None, POOL // 2], ids=["no-pool", "other-size"])
def test_resume_without_a_usable_pool_reseeds(pool, dataset_root, tmp_path):
    """JAX re-seeds np.random.RandomState(seed).randint(0, n_train, (pool, 2))
    when the restored pool is the -1 sentinel (hidvae.py:493-508, :612-617)."""
    first = _port(dataset_root, tmp_path, "first", iterations=1, save_model_every=1,
                  eval_every=10, sem_id_mining=pool is not None,
                  sem_id_mining_pool=pool or POOL)
    resumed = _port(dataset_root, tmp_path, "resumed", iterations=1, save_model_every=1,
                    eval_every=10, do_eval=False, pretrained_hrqvae_path=first["saved_paths"][-1])
    n_train = len(resumed["data"].x)
    want = np.random.RandomState(MINING["seed"]).randint(0, n_train, (POOL, 2))
    np.testing.assert_array_equal(resumed["data"].mining_pairs.numpy(), want)
    np.testing.assert_array_equal(_pool(resumed["saved_paths"][-1]), want)
    assert resumed["history"]["mining_pool_refreshed"] == []


def test_port_resume_is_bitwise_with_the_pool(dataset_root, tmp_path):
    kw = dict(dropout_rate=0.3, use_mixup=True, eval_tta=True)
    full = _port(dataset_root, tmp_path, "full", iterations=4, **kw)
    half = _port(dataset_root, tmp_path, "half", iterations=2, **kw)
    resumed = _port(dataset_root, tmp_path, "resumed", iterations=2,
                    pretrained_hrqvae_path=half["saved_paths"][-1], **kw)
    assert full["history"]["mining_pool_refreshed"] == [2, 4]
    assert resumed["history"]["mining_pool_refreshed"] == [4]
    assert full["history"]["total_loss"][-1] == resumed["history"]["total_loss"][-1]
    assert full["history"]["mined_pair_collision_rate"][-1] == \
        resumed["history"]["mined_pair_collision_rate"][-1]
    np.testing.assert_array_equal(_pool(full["saved_paths"][-1]),
                                  _pool(resumed["saved_paths"][-1]))
    np.testing.assert_array_equal(full["data"].mining_pairs.numpy(),
                                  resumed["data"].mining_pairs.numpy())
    for a, b in (state_dict_to_flax(full["model"]), state_dict_to_flax(resumed["model"])), \
            ((full["optimizer"].state_dict(full["model"]),),
             (resumed["optimizer"].state_dict(resumed["model"]),)):
        for da, db in zip(a, b):
            assert da.keys() == db.keys()
            for k in da:
                np.testing.assert_array_equal(da[k], db[k], err_msg=k)
