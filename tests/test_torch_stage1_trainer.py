"""The stage-1 trainer against JAX: the optimizer against optax; a JAX run
resumed in the port; 2N = N + resumed N; the gin surface; stage 2 and
from_artifacts."""

import os
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from hidvae_tpu.data.processed import RecDataset as JRecDataset
from hidvae_tpu.data.processed import processed_path as j_processed_path
from hidvae_tpu.data.synthetic import build_synthetic
from hidvae_tpu.models.quantize import QuantizeForwardMode as JMode
from hidvae_tpu.train import hidvae as jtrainer
from hidvae_tpu.train.common import make_lr_schedule as j_schedule
from hidvae_tpu.train.common import make_optimizer as j_make_optimizer
from hidvae_tpu.train.common import set_plateau_scale
from hidvae_tpu.utils import runtime as jruntime
from hidvae_tpu_torch.bridge import flax_named_parameters, state_dict_to_flax
from hidvae_tpu_torch.data.processed import RecDataset
from hidvae_tpu_torch.models import hrqvae as thrqvae
from hidvae_tpu_torch.models.quantize import QuantizeForwardMode
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.train import hidvae as trainer
from hidvae_tpu_torch.train.common import make_lr_schedule, make_optimizer, restore_checkpoint
from hidvae_tpu_torch.train.device_data import DeviceItemData
from hidvae_tpu_torch.utils.config import parse_config_and_run
from tests._torch_common import assert_rel as _assert_rel
from tests._torch_common import (
    assert_keywords_as_jax,
    basenames,
    flat,
    jax_batch_indices,
    load_script,
    spy,
    stage2_served,
    unflat,
    write_gin,
)

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-4
REL_TOL = 1e-4
STATS_ATOL = 1e-5
LR = 1e-3
TINY = dict(n_items=300, n_users=40, feature_dim=32, tag_dim=16, max_seq_len=8, min_seq_len=4,
            level_branching=(4, 3, 3))
S1 = dict(
    batch_size=16, learning_rate=LR, weight_decay=0.015, vae_input_dim=32, vae_n_cat_feats=0,
    vae_hidden_dims=[32, 16], vae_embed_dim=8, vae_codebook_size=32,
    vae_codebook_normalize=True, vae_n_layers=3, tag_embed_dim=16, commitment_weight=0.4,
    gradient_accumulate_every=2, layer_specific_lr=True, predictor_weight_decay=0.015,
    tag_alignment_weight=0.15, tag_prediction_weight=0.55, sem_id_uniqueness_weight=1.5,
    sem_id_uniqueness_margin=0.0, id_repetition_threshold=0.06, rare_tag_threshold=8,
    focal_loss_gamma_base=2.7, focal_loss_alpha_base=0.24, label_smoothing_alpha=0.13,
    lr_scheduler_T_max=20, make_plots=False, seed=5, log_every=100, eval_batches=2,
)
DETERMINISTIC = dict(dropout_rate=0.0, use_mixup=False, eval_tta=False)


def assert_rel(got, want, tol=REL_TOL, err_msg=""):
    _assert_rel(got, want, tol, err_msg)


# ---- the optimizer ----------------------------------------------------------

def _tiny_model():
    return trainer.build_model(
        vae_input_dim=32, vae_embed_dim=8, vae_hidden_dims=[16], vae_codebook_size=16,
        vae_codebook_normalize=True, vae_sim_vq=False,
        vae_codebook_mode=QuantizeForwardMode.ROTATION_TRICK, vae_n_layers=3,
        vae_n_cat_feats=0, commitment_weight=0.25, tag_alignment_weight=0.5,
        tag_prediction_weight=0.5, tag_class_counts=[4, 6], tag_embed_dim=12,
        use_focal_loss=True, focal_loss_gamma_base=2.0, focal_loss_alpha_base=0.25,
        dropout_rate=0.2, use_batch_norm=True, alignment_temperature=0.1,
        sem_id_uniqueness_weight=0.5, sem_id_uniqueness_margin=0.5, seed=1)


@pytest.mark.parametrize("clip,plateau", [(None, False), (0.05, True)], ids=["plain", "clip_plateau"])
def test_optimizer_matches_optax(clip, plateau):
    """Two tag levels on three quantizer levels, 4 mini-steps of random
    gradients (2 updates), the plateau scale 0.5 before the second."""
    tm = _tiny_model()
    params = unflat(state_dict_to_flax(tm)[0])
    kw = dict(gradient_accumulate_every=2, layer_specific_lr=True, predictor_weight_decay=0.015,
              n_layers=3, max_grad_norm=clip, plateau=plateau)
    tx = j_make_optimizer(j_schedule(LR, True, "cosine", 6, 1e-7), 0.02, params_example=params,
                          **kw)
    state = tx.init(params)
    update = jax.jit(tx.update)
    opt = make_optimizer(tm, make_lr_schedule(LR, True, "cosine", 6, 1e-7), 0.02, **kw)
    named = flax_named_parameters(tm)
    r = np.random.RandomState(0)
    for step in range(4):
        grads = {path: r.randn(*p.shape[::-1] if t else p.shape).astype(np.float32)
                 for path, p, t in named}
        if plateau and step == 2:
            state = set_plateau_scale(state, 0.5)
            opt.plateau_scale = 0.5
        updates, state = update(unflat(grads), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for path, p, t in named:
            p.grad = torch.from_numpy(grads[path].T.copy() if t else grads[path])
        assert opt.step() == (step % 2 == 1)
        if step == 2:  # mid-accumulation: one gradient in the accumulator
            want = traverse_util.flatten_dict(serialization.to_state_dict(state), sep="/")
            got = opt.state_dict(tm)
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert got[k].dtype == np.asarray(v).dtype, k
                if "count" in k or "step" in k:
                    assert int(got[k]) == int(v), k
                else:
                    assert_rel(got[k], v, err_msg=k)
            assert int(got["mini_step"]) == 1 and int(got["gradient_step"]) == 1
    got = state_dict_to_flax(tm)[0]
    for k, v in flat(params).items():
        assert_rel(got[k], v, err_msg=k)


def test_optimizer_state_resumes_mid_accumulation():
    """state_dict after 3 mini-steps, loaded into a fresh optimizer: the 4th
    mini-step's update equals the uninterrupted one's, bitwise."""
    def run(split):
        tm = _tiny_model()
        opt = make_optimizer(tm, make_lr_schedule(LR, True, "cosine", 6, 1e-7), 0.02,
                             gradient_accumulate_every=2, layer_specific_lr=True)
        r = np.random.RandomState(1)
        for step in range(4):
            if step == split:
                state = opt.state_dict(tm)
                tm2 = _tiny_model()
                tm2.load_state_dict(tm.state_dict())
                opt = make_optimizer(tm2, make_lr_schedule(LR, True, "cosine", 6, 1e-7), 0.02,
                                     gradient_accumulate_every=2, layer_specific_lr=True)
                assert opt.load_state_dict(tm2, state) == []
                tm = tm2
            for p in tm.parameters():
                p.grad = torch.from_numpy(r.randn(*p.shape).astype(np.float32))
            opt.step()
        return state_dict_to_flax(tm)[0], opt.state_dict(tm)

    (p_a, s_a), (p_b, s_b) = run(None), run(3)
    for a, b in ((p_a, p_b), (s_a, s_b)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- trainer runs -----------------------------------------------------------

@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_stage1"))
    build_synthetic(**TINY).save(j_processed_path(root, JRecDataset.SYNTHETIC))
    return root


def _port(root, tmp, name, **kw):
    args = dict(S1, dataset=RecDataset.SYNTHETIC, dataset_folder=root,
                vae_codebook_mode=QuantizeForwardMode.ROTATION_TRICK,
                save_dir_root=str(tmp / name), device="cpu")
    args.update(kw)
    return trainer.train(**args)


def test_jax_checkpoint_resumes_and_follows_jax(dataset_root, tmp_path, monkeypatch):
    monkeypatch.setattr(jruntime, "_configured", True)  # keep the process PRNG and cache
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(thrqvae, "drop", lambda x, p, g: x)  # TagPredictor's deeper levels
    jkw = dict(S1, **DETERMINISTIC, dataset=JRecDataset.SYNTHETIC, dataset_folder=dataset_root,
               vae_codebook_mode=JMode.ROTATION_TRICK, iterations=2, save_model_every=2,
               eval_every=2)
    first = jtrainer.train(save_dir_root=str(tmp_path / "jax_a"), **jkw)
    assert basenames(first["saved_paths"]) == ["latest", "latest"]
    export = str(tmp_path / "export")
    load_script("export_flax_checkpoint").export_checkpoint(first["saved_paths"][-1], export,
                                                             opt_state=True)
    resumed_j = jtrainer.train(save_dir_root=str(tmp_path / "jax_b"),
                               pretrained_hrqvae_path=first["saved_paths"][-1], **jkw)

    # The restore alone is bitwise: params, batch stats, the optimizer state.
    port = _port(dataset_root, tmp_path, "probe", **DETERMINISTIC, iterations=0,
                 use_kmeans_init=False, eval_every=2, save_model_every=2)
    model, opt = port["model"], port["optimizer"]
    step, meta = restore_checkpoint(export, model, opt)
    assert step == int(first["state"].step) == 4
    assert meta["model_config"]["tag_class_counts"] == list(first["tag_class_counts"])
    params, stats = state_dict_to_flax(model)
    for got, want in ((params, flat(first["state"].params)),
                      (stats, flat(first["state"].batch_stats))):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want_opt = traverse_util.flatten_dict(
        serialization.to_state_dict(first["state"].opt_state), sep="/")
    got_opt = opt.state_dict(model)
    assert got_opt.keys() == want_opt.keys()
    for k in want_opt:
        np.testing.assert_array_equal(got_opt[k], np.asarray(want_opt[k]), err_msg=k)

    # The resume, fed JAX's batches.
    n_train = int(np.load(j_processed_path(dataset_root, JRecDataset.SYNTHETIC))
                  ["item_is_train"].sum())
    idx = jax_batch_indices(S1["seed"], range(4, 8), S1["batch_size"], n_train)
    order = iter(range(4, 8))
    monkeypatch.setattr(DeviceItemData, "sample",
                        lambda self, g, b, n=0: self.gather(idx[next(order)]))
    resumed = _port(dataset_root, tmp_path, "port", **DETERMINISTIC, iterations=2,
                    save_model_every=2, eval_every=2, pretrained_hrqvae_path=export)
    jh, th = resumed_j["history"], resumed["history"]
    assert th["iterations"] == jh["iterations"] == [5, 7]
    assert th["eval_iterations"] == jh["eval_iterations"] == [6, 8]
    assert basenames(resumed["saved_paths"]) == basenames(resumed_j["saved_paths"])
    assert resumed["tag_class_counts"] == list(resumed_j["tag_class_counts"])
    assert th["repetition_rate"] == jh["repetition_rate"]
    for key in ("total_loss", "reconstruction_loss", "tag_pred_loss", "eval_total_loss",
                "eval_tag_pred_accuracy"):
        np.testing.assert_allclose(th[key], jh[key], rtol=LOSS_RTOL, err_msg=key)
    params, stats = state_dict_to_flax(resumed["model"])
    for k, want in flat(resumed_j["state"].params).items():
        if k.startswith("tag_projector_") and k.endswith("dense_0/bias"):
            # A bias before a train-mode BatchNorm has a gradient of 0 up to
            # rounding, which Adam scales to a step of up to the learning rate.
            np.testing.assert_allclose(params[k], want, rtol=0, atol=2 * 2 * 1.3 * LR)
        else:
            assert_rel(params[k], want, err_msg=k)
    for k, want in flat(resumed_j["state"].batch_stats).items():
        np.testing.assert_allclose(stats[k], want, rtol=0, atol=STATS_ATOL, err_msg=k)
    rare = np.load(os.path.join(tmp_path / "port", "special_tags_files", "rare_tags.npz"))
    rare_j = np.load(os.path.join(tmp_path / "jax_b", "special_tags_files", "rare_tags.npz"))
    assert sorted(rare.files) == sorted(rare_j.files)
    for k in rare_j.files:
        np.testing.assert_array_equal(rare[k], rare_j[k])


@pytest.fixture(scope="module")
def port_runs(dataset_root, tmp_path_factory):
    """2N, N, and N resumed from N's `latest` (N = 2 updates = 4 mini-steps),
    with dropout, mixup and test-time augmentation on."""
    tmp = tmp_path_factory.mktemp("port_runs")
    kw = dict(save_model_every=4, eval_every=4, make_plots=True)
    full = _port(dataset_root, tmp, "full", iterations=4, **kw)
    half = _port(dataset_root, tmp, "half", iterations=2, **kw)
    resumed = _port(dataset_root, tmp, "resumed", iterations=2,
                    pretrained_hrqvae_path=half["saved_paths"][-1], **kw)
    return full, half, resumed


def test_port_resume_is_bitwise(port_runs):
    full, half, resumed = port_runs
    assert full["step"] == resumed["step"] == 8 and half["step"] == 4
    assert full["history"]["iterations"] == [3, 7] and resumed["history"]["iterations"] == [7]
    assert full["history"]["eval_iterations"] == [4, 8]
    assert full["history"]["total_loss"][-1] == resumed["history"]["total_loss"][-1]
    assert full["history"]["eval_total_loss"][-1] == resumed["history"]["eval_total_loss"][-1]
    assert full["history"]["repetition_rate"][-1] == resumed["history"]["repetition_rate"][-1]
    for a, b in ((state_dict_to_flax(full["model"]), state_dict_to_flax(resumed["model"])),
                 ((full["optimizer"].state_dict(full["model"]),),
                  (resumed["optimizer"].state_dict(resumed["model"]),))):
        for da, db in zip(a, b):
            assert da.keys() == db.keys()
            for k in da:
                np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    assert full["optimizer"].count == 4
    meta_dir = Path(full["saved_paths"][-1])
    assert meta_dir.name == "latest" and (meta_dir / "arrays.npz").exists()
    assert (Path(full["save_dir"]) / "plots" / "losses.png").exists()
    assert "iter 7:" in (Path(full["save_dir"]) / "train.log").read_text()


def test_gin_surface_binds_as_jax():
    """Every keyword of the JAX trainer, with its default, is a keyword of the
    port's; configs/h_rqvae_amazon.gin binds through the port's ginlite,
    its enums to the port's enums."""
    params = assert_keywords_as_jax(jtrainer.train, trainer.train)
    bound = parse_config_and_run(spy(trainer.train), [str(ROOT / "configs/h_rqvae_amazon.gin")])
    assert set(bound) <= set(params)
    assert bound["dataset"] is RecDataset.AMAZON
    assert bound["vae_codebook_mode"] is QuantizeForwardMode.ROTATION_TRICK
    assert bound["gradient_accumulate_every"] == 2 and bound["tag_class_counts"] == [38, 168, 348]


def test_checkpoint_feeds_stage2_and_serving(port_runs, dataset_root, tmp_path):
    """The resumed run's `latest` through the stage-2 entry (its table the
    model's own sweep) and from_artifacts."""
    _, _, resumed = port_runs
    s1 = resumed["saved_paths"][-1]
    meta = np.load(os.path.join(s1, "arrays.npz"))
    assert int(meta["step"]) == 8 and any(k.startswith("opt_state/") for k in meta.files)
    import json

    with open(os.path.join(s1, "meta.json")) as f:
        m = json.load(f)
    assert m["metrics"]["repetition_rate"] == resumed["history"]["repetition_rate"][-1]
    assert m["model_config"]["tag_class_counts"] == resumed["tag_class_counts"]
    # tag_class_counts healed from the stage-1 meta
    out, feats = stage2_served(s1, dataset_root, tmp_path, "train.vae_codebook_size = 32",
                               "train.tag_embed_dim = 16", "train.use_concatenated_ids = True")
    own = HSemanticIdTokenizer(resumed["model"], n_layers=3, codebook_size=32,
                               tag_class_counts=resumed["tag_class_counts"], device="cpu")
    sem = own.precompute_corpus_ids(feats).numpy()
    np.testing.assert_array_equal(out["tokenizer"].cached_ids.numpy()[:, :3], sem)


def test_entry_script_runs_the_gin(dataset_root, tmp_path):
    """scripts/torch_train_hidvae.py on a gin of every configs/h_rqvae_amazon.gin
    key at tiny widths: trains, writes `latest` and rare_tags.npz."""
    text = (ROOT / "configs/h_rqvae_amazon.gin").read_text()
    over = {"iterations": "1", "batch_size": "16", "vae_input_dim": "32",
            "vae_hidden_dims": "[32, 16]", "vae_embed_dim": "8", "vae_codebook_size": "32",
            "tag_embed_dim": "16", "tag_class_counts": "[4, 12, 36]", "save_model_every": "2",
            "eval_every": "2", "dataset": "%data.tags_processed.RecDataset.SYNTHETIC",
            "dataset_folder": f'"{dataset_root}"', "save_dir_root": f'"{tmp_path / "runs"}"',
            "rare_tag_threshold": "8", "eval_batches": "1"}
    gin = write_gin(tmp_path / "s1.gin", text, **over)
    out = load_script("torch_train_hidvae").main([gin, "--device", "cpu"])
    assert out["step"] == 2 and basenames(out["saved_paths"]) == ["latest"]
    assert (tmp_path / "runs" / "special_tags_files" / "rare_tags.npz").exists()
    assert out["history"]["eval_iterations"] == [2]
    assert np.isfinite(out["history"]["total_loss"]).all()
