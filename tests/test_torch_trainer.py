"""The stage-2 trainer on its gin surface, on the CPU: remat, bitwise resume,
a converted JAX checkpoint resumed, refusals, the plain RQ-VAE route, the
entry's checkpoint served."""

import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from hidvae_tpu.data.processed import RecDataset as JRecDataset
from hidvae_tpu.data.processed import processed_path as j_processed_path
from hidvae_tpu.data.synthetic import build_synthetic
from hidvae_tpu.train import transformer as jtrainer
from hidvae_tpu.train.common import inverse_sqrt_schedule as j_schedule
from hidvae_tpu.train.common import make_optimizer as j_make_optimizer
from hidvae_tpu.utils import runtime as jruntime
from hidvae_tpu.utils.ginlite import bind_to_kwargs as j_bind
from hidvae_tpu.utils.ginlite import parse_gin_file as j_parse
from hidvae_tpu_torch.bridge import save_export, state_dict_to_flax
from hidvae_tpu_torch.data.processed import RecDataset
from hidvae_tpu_torch.models import attention
from hidvae_tpu_torch.models import transformer as tmodels
from hidvae_tpu_torch.models.hrqvae import HRqVae
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from hidvae_tpu_torch.train import transformer as trainer
from hidvae_tpu_torch.train.common import (
    Optimizer,
    inverse_sqrt_schedule,
    restore_checkpoint,
    save_checkpoint,
)
from hidvae_tpu_torch.utils.config import parse_config_and_run
from tests._torch_common import (assert_keywords_as_jax, flat, load_script, norm,
                                 retrieval_pair, spy)
from tests.test_torch_train import _batches

ROOT = Path(__file__).resolve().parent.parent
K = 16
REMAT_RTOL = 1e-6
UPDATE_TOL = 1e-5
# tests/test_resume.py's dataset and stage-2 config.
TINY = dict(n_items=200, n_users=40, feature_dim=32, tag_dim=16, max_seq_len=8, min_seq_len=4,
            level_branching=(4, 2, 2))
COMMON = dict(
    batch_size=8, dataset=RecDataset.SYNTHETIC, partial_eval_every=10_000,
    full_eval_every=10_000, vae_input_dim=TINY["feature_dim"], vae_n_cat_feats=0,
    vae_hidden_dims=(32, 16), vae_embed_dim=8, vae_codebook_size=32, vae_n_layers=3,
    use_h_tokenizer=True, tag_embed_dim=TINY["tag_dim"], tag_class_counts=[4, 8, 16],
    decoder_embed_dim=16, attn_embed_dim=32, attn_heads=2, attn_layers=2, warmup_steps=3,
    log_every=2, make_plots=False, seed=7,
)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_trainer"))
    build_synthetic(**TINY).save(j_processed_path(root, JRecDataset.SYNTHETIC))
    return root


def _train(root, tmp, name, **kw):
    args = dict(COMMON, dataset_folder=root, save_dir_root=str(tmp / name),
                save_model_every=10_000, device="cpu")
    args.update(kw)
    return trainer.train(**args)


def _opt_flat(result):
    return result["optimizer"].state_dict(result["model"])


def _assert_same_state(a, b):
    pa, pb = state_dict_to_flax(a["model"])[0], state_dict_to_flax(b["model"])[0]
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    oa, ob = _opt_flat(a), _opt_flat(b)
    assert oa.keys() == ob.keys()
    for k in oa:
        np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
    assert a["step"] == b["step"]


# ---- remat ------------------------------------------------------------------

def _remat_run(n, remat, monkeypatch):
    d = 3
    model = trainer.build_model(sem_id_dim=d, max_seq_len=n, vae_codebook_size=K,
                                decoder_embed_dim=16, attn_heads=1, attn_embed_dim=64,
                                attn_layers=2, dropout_p=0.3, remat=remat, seed=3)
    _, tb = _batches(2, n, d, seed=n)
    calls = []
    real = attention.flash_self_attention
    monkeypatch.setattr(attention, "flash_self_attention",
                        lambda *a: calls.append(1) or real(*a))
    out = model(tb, torch.Generator().manual_seed(5))
    out.loss.backward()
    n_calls = len(calls)
    with torch.no_grad():
        eval_loss = float(model(tb).loss)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return float(out.loss.detach()), grads, n_calls, eval_loss


@pytest.mark.parametrize("n,flash", [(6, False), (683, True)], ids=["dense", "flash_2050"])
def test_remat_gradients_equal_plain(n, flash, monkeypatch):
    """fp32, dropout from one seed: remat's loss and gradients equal the
    plain model's; on the flash route the attention runs twice."""
    loss, grads, calls, eval_loss = _remat_run(n, False, monkeypatch)
    loss_r, grads_r, calls_r, _ = _remat_run(n, True, monkeypatch)
    assert loss != eval_loss  # dropout is on
    np.testing.assert_allclose(loss_r, loss, rtol=REMAT_RTOL, atol=0)
    assert grads.keys() == grads_r.keys()
    for k in grads:
        np.testing.assert_allclose(grads_r[k].numpy(), grads[k].numpy(), rtol=REMAT_RTOL,
                                   atol=0, err_msg=k)
    assert (calls, calls_r) == ((1, 2) if flash else (0, 0))


def test_remat_without_generator_replay_differs(monkeypatch):
    """The mutant: the recompute draws from the live generator, which the
    forward has moved on: the loss stays, the gradients do not."""
    loss, grads, _, _ = _remat_run(6, False, monkeypatch)
    monkeypatch.setattr(tmodels.GeneratorReplay, "__call__", lambda self: self.generator)
    loss_m, grads_m, _, _ = _remat_run(6, True, monkeypatch)
    assert loss_m == loss
    worst = max(float((grads_m[k] - grads[k]).abs().max()) for k in grads)
    assert worst > 1e-3


# ---- checkpoints ------------------------------------------------------------

@pytest.mark.parametrize("max_grad_norm", [None, 0.5])
def test_opt_state_names_are_jax_names(max_grad_norm):
    """The optimizer state's names, shapes and types are those of
    to_state_dict of the JAX optimizer built with the same arguments."""
    _, params, tm = retrieval_pair(embedding_dim=16, attn_dim=32, num_heads=2, n_layers=2,
                                   num_embeddings=K, sem_id_dim=3, max_pos=18)
    tx = j_make_optimizer(j_schedule(1e-3, 3), 0.035, max_grad_norm=max_grad_norm)
    want = traverse_util.flatten_dict(serialization.to_state_dict(tx.init(params)), sep="/")
    opt = Optimizer(tm.parameters(), inverse_sqrt_schedule(1e-3, 3), 0.035,
                    max_grad_norm=max_grad_norm)
    _, tb = _batches(2, 6, 3, seed=1)
    for state in (opt.state_dict(tm), None):
        if state is None:  # and after an update
            trainer.train_step(tm, opt, tb, None)
            state = opt.state_dict(tm)
        assert sorted(state) == sorted(want)
        for k, v in want.items():
            assert state[k].shape == v.shape and state[k].dtype == v.dtype, k


@pytest.mark.parametrize("max_grad_norm", [None, 0.5])
def test_checkpoint_round_trip_is_bitwise(tmp_path, max_grad_norm):
    d, n = 3, 6

    def fresh(seed):
        model = trainer.build_model(sem_id_dim=d, max_seq_len=n, vae_codebook_size=K,
                                    decoder_embed_dim=16, attn_heads=2, attn_embed_dim=32,
                                    attn_layers=2, seed=seed)
        return model, Optimizer(model.parameters(), inverse_sqrt_schedule(1e-3, 1), 0.035,
                                max_grad_norm=max_grad_norm)

    model, opt = fresh(0)
    _, tb = _batches(4, n, d, seed=2)
    for i in range(2):
        trainer.train_step(model, opt, tb, torch.Generator().manual_seed(i))
    path = save_checkpoint(str(tmp_path), "checkpoint_2", {
        "step": 2, "params": state_dict_to_flax(model)[0], "opt_state": opt.state_dict(model),
        "model_config": {"sem_id_dim": d}, "metrics": {}})
    other, other_opt = fresh(1)
    step, meta = restore_checkpoint(path, other, other_opt)
    assert step == 2 and meta["model_config"] == {"sem_id_dim": d} and other_opt.count == 2
    a = dict(model=model, optimizer=opt, step=2)
    b = dict(model=other, optimizer=other_opt, step=step)
    _assert_same_state(a, b)
    assert any(np.abs(v).sum() > 0 for k, v in opt.state_dict(model).items() if "/mu/" in k)
    for _ in range(2):  # the state is whole: the next updates agree bitwise too
        for m, o in ((model, opt), (other, other_opt)):
            trainer.train_step(m, o, tb, torch.Generator().manual_seed(9))
    _assert_same_state(a, dict(b, step=2))


def test_resume_in_the_port_is_bitwise(dataset_root, tmp_path):
    full = _train(dataset_root, tmp_path, "full", iterations=4)
    half = _train(dataset_root, tmp_path, "half", iterations=2)
    resumed = _train(dataset_root, tmp_path, "resumed", iterations=2,
                     pretrained_decoder_path=half["saved_paths"][-1])
    assert half["saved_paths"][-1].endswith("checkpoint_2") and resumed["step"] == 4
    assert resumed["optimizer"].count == 4
    assert any(np.abs(v).sum() > 0 for k, v in _opt_flat(resumed).items() if "/nu/" in k)
    _assert_same_state(full, resumed)
    assert full["history"]["train_loss"][-1] == resumed["history"]["train_loss"][-1]


def test_jax_checkpoint_resumes_in_the_port(dataset_root, tmp_path, monkeypatch):
    """A converted 2-step JAX run restores bitwise; one more AdamW update
    of both agrees within UPDATE_TOL."""
    monkeypatch.setattr(jruntime, "_configured", True)  # keep the process PRNG and cache
    jax_common = dict(COMMON, use_h_tokenizer=False, eval_batches=0)
    del jax_common["dataset"]
    jres = jtrainer.train(iterations=2, save_model_every=10_000, dataset=JRecDataset.SYNTHETIC,
                          dataset_folder=dataset_root, save_dir_root=str(tmp_path / "jax"),
                          mixed_precision_type="fp32", **jax_common)
    export = str(tmp_path / "export")
    load_script("export_flax_checkpoint").export_checkpoint(jres["saved_paths"][-1], export,
                                                             opt_state=True)

    d, lr = 3, 0.0003
    model = trainer.build_model(sem_id_dim=d, max_seq_len=TINY["max_seq_len"],
                                vae_codebook_size=32, decoder_embed_dim=16, attn_heads=2,
                                attn_embed_dim=32, attn_layers=2, seed=0)
    opt = Optimizer(model.parameters(), inverse_sqrt_schedule(lr, 3), 0.035)
    step, _ = restore_checkpoint(export, model, opt)
    state = jres["state"]
    assert step == int(state.step) == 2
    params = state_dict_to_flax(model)[0]
    want = flat(state.params)
    assert params.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(params[k], want[k], err_msg=k)
    want_opt = traverse_util.flatten_dict(serialization.to_state_dict(state.opt_state), sep="/")
    got_opt = opt.state_dict(model)
    assert got_opt.keys() == want_opt.keys()
    for k in want_opt:
        np.testing.assert_array_equal(got_opt[k], np.asarray(want_opt[k]), err_msg=k)

    jb, tb = _batches(4, TINY["max_seq_len"], d, seed=4)
    jb = jb.replace(sem_ids=jax.numpy.where(jb.sem_ids >= 0, jb.sem_ids * 2, -1),
                    sem_ids_fut=jb.sem_ids_fut * 2)
    tb = tb.replace(sem_ids=torch.where(tb.sem_ids >= 0, tb.sem_ids * 2, -1),
                    sem_ids_fut=tb.sem_ids_fut * 2)  # digits over all 32 codes
    jm = jres["model"]
    tx = j_make_optimizer(j_schedule(lr, 3), 0.035)
    grads = jax.grad(lambda p: jm.apply({"params": p}, jb, False).loss)(state.params)
    new_params = state.apply_gradients(grads=grads, tx=tx).params
    trainer.train_step(model, opt, tb, None)
    got = state_dict_to_flax(model)[0]
    for k, v in flat(new_params).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=UPDATE_TOL, err_msg=k)
    assert opt.count == 3


# ---- gin surface ------------------------------------------------------------

def test_gin_binds_as_jax(tmp_path):
    """Every keyword of the JAX trainer, with its default, is a keyword of the
    port's; the same gin binds the same values; an unknown key raises in
    both with the same message."""
    assert_keywords_as_jax(jtrainer.train, trainer.train)
    gin = tmp_path / "decoder.gin"
    gin.write_text((ROOT / "configs/decoder_amazon.gin").read_text()
                   + "train.remat = True\ntrain.max_grad_norm = 1.0\n")
    got = parse_config_and_run(spy(trainer.train), [str(gin)])
    want = j_bind(j_parse(str(gin)), "train", jtrainer.train)
    assert got.keys() == want.keys()
    assert {k: norm(v) for k, v in got.items()} == {k: norm(v) for k, v in want.items()}
    over = parse_config_and_run(spy(trainer.train), [str(gin)], device="cpu",
                                pretrained_decoder_path=None)
    assert over["device"] == "cpu" and "pretrained_decoder_path" not in over

    gin.write_text(gin.read_text() + "train.attn_head = 4\n")
    with pytest.raises(ValueError) as j_err:
        j_bind(j_parse(str(gin)), "train", jtrainer.train)
    with pytest.raises(ValueError) as t_err:
        parse_config_and_run(spy(trainer.train), [str(gin)])
    assert str(t_err.value).split(" — ")[0] == str(j_err.value).split(" — ")[0]


def test_resume_heals_geometry_and_refuses_sem_id_dim(dataset_root, tmp_path, caplog):
    half = _train(dataset_root, tmp_path, "half", iterations=1)
    ckpt = half["saved_paths"][-1]
    with caplog.at_level(logging.WARNING):
        healed = _train(dataset_root, tmp_path, "healed", iterations=1, attn_heads=4,
                        pretrained_decoder_path=ckpt)
    assert "attn_heads=2 but the config requests attn_heads=4" in caplog.text
    assert healed["model"].num_heads == 2 and healed["step"] == 2
    with pytest.raises(ValueError, match="was trained with sem_id_dim=3 but the frozen "
                                         "tokenizer produces 6"):
        _train(dataset_root, tmp_path, "wrong", iterations=1, use_concatenated_ids=True,
               pretrained_decoder_path=ckpt)


def test_refusals_and_default_device(dataset_root, tmp_path):
    # Forced, a raw dataset is rebuilt from its raw files, which this root lacks
    # (tests/test_torch_raw_builders.py builds them).
    with pytest.raises(FileNotFoundError, match="P5 data drop"):
        _train(str(tmp_path), tmp_path, "force", iterations=1, dataset=RecDataset.AMAZON,
               dataset_split="beauty", force_dataset_process=True)
    with pytest.raises(ValueError, match="n_model=2 needs at least 2 devices, have 1"):
        _train(dataset_root, tmp_path, "shards", iterations=1, n_model_shards=2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _train(dataset_root, tmp_path, "default", iterations=1, device=None)


# ---- routes -----------------------------------------------------------------

def test_plain_route_trains_and_evaluates(dataset_root, tmp_path):
    res = _train(dataset_root, tmp_path, "plain", iterations=2, use_h_tokenizer=False,
                 full_eval_every=2, partial_eval_every=1, eval_batches=2)
    assert isinstance(res["tokenizer"], SemanticIdTokenizer)
    assert not hasattr(res["tokenizer"], "hrq_vae")
    h = res["history"]
    assert h["eval_iterations"] == [1, 2] and h["full_eval_iterations"] == [2]
    assert all(np.isfinite(h["train_loss"] + h["eval_loss"]))
    for metrics in (h["full_eval_metrics"][-1], h["test_eval_metrics"]):
        assert 0.0 <= metrics["h@10_slice_:3"] <= 1.0
        assert 0.0 <= metrics["ndcg@10_slice_:3"] <= 1.0


def _stage1_export(root):
    vae = init_params_(HRqVae(TINY["feature_dim"], 8, (32, 16), 32, n_layers=3,
                              tag_class_counts=[4, 8, 16], tag_embed_dim=TINY["tag_dim"]),
                       torch.Generator().manual_seed(4)).eval()
    cfg = dict(input_dim=TINY["feature_dim"], embed_dim=8, hidden_dims=[32, 16],
               codebook_size=32, codebook_normalize=False, codebook_sim_vq=False, n_layers=3,
               n_cat_features=0, tag_class_counts=[4, 8, 16], tag_embed_dim=TINY["tag_dim"])
    return save_export(str(root / "stage1"), vae, {"model_config": cfg, "metrics": {}})


def test_entry_script_trains_resumes_and_serves(dataset_root, tmp_path, monkeypatch, caplog):
    """The entry with --stage1: 3 steps, --resume for 2 more, the checkpoint
    served by from_artifacts."""
    s1 = _stage1_export(tmp_path)
    lines = [f"train.{k} = {list(v) if isinstance(v, tuple) else v}"
             for k, v in COMMON.items() if k not in ("dataset", "make_plots")]
    lines += ["train.dataset = %data.processed.RecDataset.SYNTHETIC",
              f'train.dataset_folder = "{dataset_root}"',
              f'train.save_dir_root = "{tmp_path / "runs"}"',
              'train.mixed_precision_type = "fp32"', "train.iterations = 3",
              "train.full_eval_every = 3", "train.save_model_every = 3",
              "train.vae_codebook_normalize = True"]  # healed from the stage-1 meta
    gin = tmp_path / "decoder.gin"
    gin.write_text("import data.processed\n" + "\n".join(lines) + "\n")
    script = load_script("torch_train_transformer")

    first = script.main([str(gin), "--stage1", s1, "--device", "cpu"])
    save_dir = Path(first["save_dir"])
    assert (save_dir / "plots/losses.png").exists()
    assert (save_dir / "plots/eval_metrics.png").exists()
    assert "operative config:" in (save_dir / "train.log").read_text()
    assert first["saved_paths"][-1].endswith("checkpoint_3")

    from hidvae_tpu_torch.train import plots

    monkeypatch.setattr(plots, "plot_transformer_history",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("no display")))
    with caplog.at_level(logging.WARNING):
        gin.write_text(gin.read_text().replace("train.iterations = 3", "train.iterations = 2")
                       + "train.make_plots = True\n")
        second = script.main([str(gin), "--stage1", s1, "--resume", first["saved_paths"][-1],
                              "--device", "cpu"])
    assert "Plotting failed: no display" in caplog.text
    assert second["step"] == 5 and second["saved_paths"][-1].endswith("checkpoint_5")

    served = RetrievalEngine.from_artifacts(str(gin), s1, second["saved_paths"][-1],
                                            device="cpu", batch_buckets=(8,))
    tok = second["tokenizer"]
    feats = np.load(j_processed_path(dataset_root, JRecDataset.SYNTHETIC))["item_features"]
    direct = RetrievalEngine(second["model"], tok, feats, max_seq_len=TINY["max_seq_len"],
                             device="cpu", batch_buckets=(8,), stage1_checkpoint=s1)
    hist = np.load(j_processed_path(dataset_root, JRecDataset.SYNTHETIC))["seq_items"][:8]
    a, b = served.recommend(hist), direct.recommend(hist)
    np.testing.assert_array_equal(served.corpus_ids.numpy(), direct.corpus_ids.numpy())
    np.testing.assert_array_equal(a["items"], b["items"])
    np.testing.assert_array_equal(a["sem_ids"], b["sem_ids"])
    np.testing.assert_allclose(a["scores"], b["scores"], rtol=0, atol=1e-5)
    assert (a["items"] >= 0).any()
