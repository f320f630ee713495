"""The plain RQ-VAE model and trainer against JAX on the CPU: losses and
gradients; a JAX run resumed in the port; 2N = N + resumed N; stage 2 and
from_artifacts; the gin surface; rqvae_ml32m.gin's refusal."""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.data.processed import RecDataset as JRecDataset
from hidvae_tpu.data.processed import processed_path as j_processed_path
from hidvae_tpu.data.synthetic import build_synthetic
from hidvae_tpu.models.quantize import QuantizeForwardMode as JMode
from hidvae_tpu.models.rqvae import RqVae as JRqVae
from hidvae_tpu.train import rqvae as jtrainer
from hidvae_tpu.utils import runtime as jruntime
from hidvae_tpu_torch.bridge import flax_named_parameters, load_flax_weights, state_dict_to_flax
from hidvae_tpu_torch.data.processed import RecDataset
from hidvae_tpu_torch.models.quantize import QuantizeForwardMode
from hidvae_tpu_torch.models.rqvae import RqVae
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from hidvae_tpu_torch.train import rqvae as trainer
from hidvae_tpu_torch.train.common import restore_checkpoint
from hidvae_tpu_torch.train.device_data import DeviceItemData
from hidvae_tpu_torch.utils.config import parse_config_and_run
from tests._torch_common import assert_rel as _assert_rel
from tests._torch_common import (
    assert_keywords_as_jax,
    basenames,
    flat,
    jax_batch_indices,
    load_script,
    random_variables,
    spy,
    stage2_served,
    unflat,
    write_gin,
)
from tests.test_torch_stage1_trainer import TINY

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-4
REL_TOL = 1e-4
RQ = dict(batch_size=16, learning_rate=1e-3, weight_decay=0.015, max_grad_norm=0.5,
          vae_input_dim=32, vae_n_cat_feats=0, vae_hidden_dims=[32, 16], vae_embed_dim=8,
          vae_codebook_size=16, gradient_accumulate_every=2, commitment_weight=0.4,
          make_plots=False, seed=5, log_every=100, eval_batches=2, save_model_every=2,
          eval_every=2)


def assert_rel(got, want, tol=REL_TOL, err_msg=""):
    _assert_rel(got, want, tol, err_msg)


# ---- the model --------------------------------------------------------------

F = 40


@pytest.mark.parametrize("n_cat,mode,train", [
    (0, "ROTATION_TRICK", True), (6, "ROTATION_TRICK", True), (6, "STE", True),
    (0, "ROTATION_TRICK", False), (6, "ROTATION_TRICK", False),
], ids=["dense-rotation", "cat-rotation", "cat-ste", "dense-eval", "cat-eval"])
def test_forward_and_gradients_match_jax(n_cat, mode, train):
    kw = dict(input_dim=F, embed_dim=8, hidden_dims=(32, 16), codebook_size=16, n_layers=3,
              codebook_normalize=True, commitment_weight=0.3, n_cat_features=n_cat)
    jm = JRqVae(**kw, codebook_mode=JMode[mode])
    params = random_variables(jm, (jnp.zeros((4, F)), 0.2), {"train": False}, seed=3)["params"]
    tm = RqVae(F, 8, (32, 16), 16, codebook_normalize=True, n_layers=3, commitment_weight=0.3,
               n_cat_features=n_cat, codebook_mode=QuantizeForwardMode[mode])
    load_flax_weights(tm, params)
    r = np.random.RandomState(1)
    x = r.randn(24, F).astype(np.float32)
    if n_cat:
        x[:, -n_cat:] = r.randint(0, 2, (24, n_cat))

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), 0.2, train=train,
                       rngs={"gumbel": jax.random.key(0)})
        return out.loss, out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(unflat(params))
    out = tm(torch.from_numpy(x), 0.2, train=train)
    out.loss.backward()
    for name in ("loss", "reconstruction_loss", "rqvae_loss", "p_unique_ids"):
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), rtol=LOSS_RTOL, err_msg=name)
    assert_rel(out.embs_norm, jout.embs_norm, err_msg="embs_norm")
    grads = flat(jgrad)
    for path, p, transpose in flax_named_parameters(tm):
        assert_rel(p.grad.T if transpose else p.grad, grads[path], err_msg=path)


# ---- trainer runs -----------------------------------------------------------

@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_rqvae"))
    build_synthetic(**TINY).save(j_processed_path(root, JRecDataset.SYNTHETIC))
    return root


def _port(root, tmp, name, **kw):
    args = dict(RQ, dataset=RecDataset.SYNTHETIC, dataset_folder=root,
                save_dir_root=str(tmp / name), device="cpu")
    args.update(kw)
    return trainer.train(**args)


@pytest.fixture(scope="module")
def jax_run(dataset_root, tmp_path_factory):
    """The JAX trainer, 2 + 2 mini-steps (rotation trick), and the export of
    its checkpoint at 2 with the optimizer state."""
    tmp = tmp_path_factory.mktemp("jax_rqvae")
    mp = pytest.MonkeyPatch()
    mp.setattr(jruntime, "_configured", True)  # keep the process PRNG and cache
    try:
        run = jtrainer.train(**RQ, iterations=2, dataset=JRecDataset.SYNTHETIC,
                             dataset_folder=dataset_root, vae_codebook_mode=JMode.ROTATION_TRICK,
                             save_dir_root=str(tmp / "jax"))
    finally:
        mp.undo()
    export = str(tmp / "export")
    arrays = load_script("export_flax_checkpoint").export_checkpoint(
        run["saved_paths"][0], export, opt_state=True)
    return run, export, arrays


def test_jax_checkpoint_restores_bitwise(jax_run, dataset_root, tmp_path):
    run, export, arrays = jax_run
    assert basenames(run["saved_paths"]) == ["checkpoint_1", "checkpoint_3"]
    probe = _port(dataset_root, tmp_path, "probe", iterations=0, use_kmeans_init=False,
                  vae_codebook_mode=QuantizeForwardMode.ROTATION_TRICK)
    model, opt = probe["model"], probe["optimizer"]
    step, meta = restore_checkpoint(export, model, opt)
    assert step == 2 and meta["model_config"] == {
        "input_dim": 32, "embed_dim": 8, "hidden_dims": [32, 16], "codebook_size": 16,
        "codebook_normalize": False, "codebook_sim_vq": False, "n_layers": 3,
        "n_cat_features": 0}
    assert set(meta["metrics"]) == {"repetition_rate", "rqvae_entropy"}
    params = state_dict_to_flax(model)[0]
    want = {k[len("params/"):]: v for k, v in arrays.items() if k.startswith("params/")}
    assert params.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(params[k], want[k], err_msg=k)
    # The optimizer's names are those optax gives MultiSteps(chain(clip, adamw)).
    got_opt = opt.state_dict(model)
    want_opt = {k[len("opt_state/"):]: v for k, v in arrays.items() if k.startswith("opt_state/")}
    assert sorted(got_opt) == sorted(want_opt)
    for k in want_opt:
        np.testing.assert_array_equal(got_opt[k], want_opt[k], err_msg=k)


def test_resume_follows_jax(jax_run, dataset_root, tmp_path, monkeypatch):
    run, export, _ = jax_run
    n_train = int(np.load(j_processed_path(dataset_root, JRecDataset.SYNTHETIC))
                  ["item_is_train"].sum())
    idx = jax_batch_indices(RQ["seed"], range(2, 4), RQ["batch_size"], n_train)
    order = iter(range(2, 4))
    monkeypatch.setattr(DeviceItemData, "sample",
                        lambda self, g, b, n=0: self.gather(idx[next(order)]))
    port = _port(dataset_root, tmp_path, "resumed", iterations=1, pretrained_rqvae_path=export,
                 vae_codebook_mode=QuantizeForwardMode.ROTATION_TRICK)
    jh, th = run["history"], port["history"]
    assert jh["iterations"] == [1, 3] and th["iterations"] == [3]
    assert jh["eval_iterations"] == [2, 4] and th["eval_iterations"] == [4]
    assert basenames(port["saved_paths"]) == ["checkpoint_3"]
    assert th["repetition_rate"] == jh["repetition_rate"][-1:]
    assert th["max_id_duplicates"] == jh["max_id_duplicates"][-1:]
    for key in ("total_loss", "reconstruction_loss", "rqvae_loss", "eval_total_loss",
                "rqvae_entropy"):
        np.testing.assert_allclose(th[key], jh[key][-1:], rtol=LOSS_RTOL, err_msg=key)
    params = state_dict_to_flax(port["model"])[0]
    for k, want in flat(run["state"].params).items():
        assert_rel(params[k], want, err_msg=k)
    from flax import serialization, traverse_util

    want_opt = traverse_util.flatten_dict(serialization.to_state_dict(run["state"].opt_state),
                                          sep="/")
    got_opt = port["optimizer"].state_dict(port["model"])
    for k, want in want_opt.items():
        if "count" in k or "step" in k:
            assert int(got_opt[k]) == int(want), k
        else:
            assert_rel(got_opt[k], np.asarray(want), err_msg=k)
    with open(os.path.join(port["saved_paths"][-1], "meta.json")) as f:
        assert json.load(f)["metrics"]["repetition_rate"] == jh["repetition_rate"][-1]


@pytest.fixture(scope="module")
def port_runs(dataset_root, tmp_path_factory):
    """2N, N, and N resumed from N's checkpoint (N = 1 update = 2 mini-steps),
    Gumbel-softmax estimator, a dedup column in the audit."""
    tmp = tmp_path_factory.mktemp("port_rqvae")
    kw = dict(use_dedup_dim=True, make_plots=True)
    full = _port(dataset_root, tmp, "full", iterations=2, **kw)
    half = _port(dataset_root, tmp, "half", iterations=1, **kw)
    resumed = _port(dataset_root, tmp, "resumed", iterations=1,
                    pretrained_rqvae_path=half["saved_paths"][-1], **kw)
    return full, half, resumed


def test_port_resume_is_bitwise(port_runs):
    full, half, resumed = port_runs
    assert full["step"] == resumed["step"] == 4 and half["step"] == 2
    assert basenames(full["saved_paths"]) == ["checkpoint_1", "checkpoint_3"]
    assert basenames(resumed["saved_paths"]) == ["checkpoint_3"]
    for key in ("total_loss", "eval_total_loss", "repetition_rate", "rqvae_entropy"):
        assert full["history"][key][-1] == resumed["history"][key][-1], key
    a, b = state_dict_to_flax(full["model"])[0], state_dict_to_flax(resumed["model"])[0]
    oa = full["optimizer"].state_dict(full["model"])
    ob = resumed["optimizer"].state_dict(resumed["model"])
    for da, db in ((a, b), (oa, ob)):
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    assert (Path(full["save_dir"]) / "plots" / "losses.png").exists()
    assert "diversity @ 4" in (Path(full["save_dir"]) / "train.log").read_text()
    # The dedup column counts the items of the most shared tuple.
    table = full["corpus_ids"]
    _, counts = np.unique(table[:, :3], axis=0, return_counts=True)
    assert int(table[:, -1].max()) + 1 == counts.max()


def test_checkpoint_feeds_stage2_and_serving(port_runs, dataset_root, tmp_path):
    """The resumed run's checkpoint through the stage-2 entry's plain
    route (its table the RQ-VAE's own sweep) and from_artifacts."""
    _, _, resumed = port_runs
    s1 = resumed["saved_paths"][-1]
    out, feats = stage2_served(s1, dataset_root, tmp_path, "train.vae_codebook_size = 16",
                               "train.use_h_tokenizer = False")
    assert isinstance(out["tokenizer"], SemanticIdTokenizer)
    own = SemanticIdTokenizer(resumed["model"], n_layers=3, codebook_size=16, device="cpu")
    np.testing.assert_array_equal(out["tokenizer"].cached_ids.numpy(),
                                  own.precompute_corpus_ids(feats).numpy())


def test_entry_script_runs_the_gin(dataset_root, tmp_path):
    """scripts/torch_train_rqvae.py on rqvae_ml32m.gin cut small, synthetic
    data: trains, evaluates, audits, saves (re-auditing, rqvae.py:327-333)."""
    text = (ROOT / "configs/rqvae_ml32m.gin").read_text()
    over = {"iterations": "8", "batch_size": "16", "vae_input_dim": "32",
            "vae_hidden_dims": "[32, 16]", "vae_embed_dim": "8", "vae_codebook_size": "16",
            "save_model_every": "2", "eval_every": "4",
            "dataset_folder": f'"{dataset_root}"', "save_dir_root": f'"{tmp_path / "runs"}"',
            "eval_batches": "1"}
    gin = write_gin(tmp_path / "rq.gin", text, **over)
    script = load_script("torch_train_rqvae")
    with pytest.raises(FileNotFoundError, match="ML-32M raw data not found"):
        script.main([gin, "--device", "cpu"])
    gin = write_gin(gin, text, **over, dataset="%data.processed.RecDataset.SYNTHETIC",
                    force_dataset_process="False")
    out = script.main([gin, "--device", "cpu"])
    assert out["step"] == 8 and basenames(out["saved_paths"]) == [
        "checkpoint_1", "checkpoint_3", "checkpoint_5", "checkpoint_7"]
    assert out["history"]["eval_iterations"] == [4, 8]
    # The saves at 2 and 6 audit on their own (the audit at 4 is stale at 6);
    # those at 4 and 8 take the eval's.
    log = (Path(out["save_dir"]) / "train.log").read_text()
    assert [f"diversity @ save {s}:" in log for s in (2, 4, 6, 8)] == [True, False, True, False]
    assert np.isfinite(out["history"]["total_loss"]).all()


def test_ml32m_gin_refuses_built_ml32m_features_as_jax(tmp_path):
    """rqvae_ml32m.gin on a built ML-32M corpus (768 + genre columns): JAX
    fails at the loss, the port refuses first, naming both widths."""
    import chip_smoke

    jm = JRqVae(input_dim=8, embed_dim=4, hidden_dims=(16,), codebook_size=8, n_layers=2,
                n_cat_features=0, codebook_mode=JMode.ROTATION_TRICK)
    with pytest.raises(TypeError, match=r"\(5, 8\), \(5, 10\)"):
        random_variables(jm, (jnp.ones((5, 10)), 0.2), {"train": False})
    root = tmp_path / "ml32m"
    chip_smoke.write_movielens_drop(str(root), "32m", 60, 2000, seed=3)
    gin = write_gin(tmp_path / "rq.gin", (ROOT / "configs/rqvae_ml32m.gin").read_text(),
                    vae_hidden_dims="[32, 16]", vae_embed_dim="8", vae_codebook_size="16",
                    dataset_folder=f'"{root}"', save_dir_root=f'"{tmp_path / "runs"}"')
    with pytest.raises(ValueError, match=r"ML_32M are 7[6-9]\d wide, but vae_input_dim is 768"):
        load_script("torch_train_rqvae").main([gin, "--device", "cpu"])
    assert not list((tmp_path / "runs").glob("*/checkpoint_*"))


def test_gin_surface_binds_as_jax():
    """Every keyword of the JAX trainer, with its default, is a keyword of the
    port's; each rqvae gin of configs/ binds through the port's ginlite,
    its enums to the port's enums."""
    params = assert_keywords_as_jax(jtrainer.train, trainer.train)
    for name in ("rqvae_amazon", "rqvae_kuairand", "rqvae_ml32m"):
        bound = parse_config_and_run(spy(trainer.train), [str(ROOT / f"configs/{name}.gin")])
        assert set(bound) <= set(params), name
        assert isinstance(bound["dataset"], RecDataset), name
    assert bound["vae_codebook_mode"] is QuantizeForwardMode.ROTATION_TRICK
    assert bound["vae_embed_dim"] == 64 and bound["dataset"] is RecDataset.ML_32M
