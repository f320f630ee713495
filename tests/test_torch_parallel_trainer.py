"""The stage-2 trainer on 4 Gloo CPU ranks against one process: DP 4,
DP 2 x TP 2, TP 4; a fixed batch's gradients; `train` from its gin,
split_batches=False, TP resumes across meshes, torchrun; a JAX TP run
resumed at DP 2 x TP 2 within UPDATE_TOL of optax."""

import jax
import numpy as np
import pytest
import torch

from hidvae_tpu.data.processed import RecDataset as JRecDataset
from hidvae_tpu.data.processed import processed_path as j_processed_path
from hidvae_tpu.data.synthetic import build_synthetic
from hidvae_tpu.train import transformer as jtrainer
from hidvae_tpu.train.common import inverse_sqrt_schedule as j_schedule
from hidvae_tpu.train.common import make_optimizer as j_make_optimizer
from hidvae_tpu.utils import runtime as jruntime
from hidvae_tpu_torch.data.processed import RecDataset
from hidvae_tpu_torch.models.hrqvae import HRqVae
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.parallel.mesh import make_mesh
from tests import _torch_parallel_worker as worker
from tests._torch_common import assert_rel, flat, load_script, part, torchrun
from tests.test_torch_train import _batches
from tests.test_torch_trainer import TINY

# fp32: the ranks' sums (gradient averages, fp32 TP partials, loss means)
# differ from one process's in order only, ~1e-7 relative per sum; a few
# AdamW steps keep that near 1e-6.
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5    # max |got - want| over max |want|, per leaf
GRAD_TOL = 1e-5
NOISE_FLOOR = 10
LR = 0.0003
# bf16: a product rounded after other fp32 sums can land one bf16 step
# apart, which a few steps carry into the loss.
BF16_LOSS_RTOL = 5e-3
BF16_PARAM_TOL = 5e-3
UPDATE_TOL = 1e-5   # the port's update against optax's (tests/test_torch_trainer.py)
ARRAYS_KW = dict(iterations=4, batch_size=8, log_every=1, partial_eval_every=4,
                 mixed_precision_type="fp32", decoder_embed_dim=16, attn_embed_dim=32,
                 attn_heads=2, attn_layers=2, vae_codebook_size=16, vae_n_layers=3,
                 tag_class_counts=(4, 6, 8), use_concatenated_ids=True, warmup_steps=3, seed=7)
DISK_KW = dict(
    iterations=4, batch_size=8, dataset=RecDataset.SYNTHETIC, partial_eval_every=1,
    full_eval_every=2, save_model_every=10_000, eval_batches=2,
    vae_input_dim=TINY["feature_dim"], vae_n_cat_feats=0, vae_hidden_dims=(32, 16),
    vae_embed_dim=8, vae_codebook_size=32, vae_n_layers=3, use_h_tokenizer=True,
    tag_embed_dim=TINY["tag_dim"], tag_class_counts=[4, 8, 16], decoder_embed_dim=16,
    attn_embed_dim=32, attn_heads=2, attn_layers=2, warmup_steps=3, log_every=1,
    make_plots=False, seed=7, mixed_precision_type="fp32")
FIXED_MODEL = dict(sem_id_dim=3, max_seq_len=4, vae_codebook_size=15, decoder_embed_dim=16,
                   attn_heads=2, attn_embed_dim=32, attn_layers=2, dropout_p=0.3, seed=1)
JAX_MODEL = dict(sem_id_dim=3, max_seq_len=TINY["max_seq_len"], vae_codebook_size=32,
                 decoder_embed_dim=16, attn_heads=2, attn_embed_dim=32, attn_layers=2, seed=0)


def _fixed_batch(k, n=4, seed=4):
    """A [8, n * 3] batch of digits below k."""
    _, tb = _batches(8, n, 3, seed=seed)
    return tb.replace(sem_ids=torch.where(tb.sem_ids >= 0, tb.sem_ids % k, -1),
                      sem_ids_fut=tb.sem_ids_fut % k)


def _jax_run(root, tmp):
    """2 JAX steps at n_model_shards=2 (fp32, the plain tokenizer, no eval
    batch), converted with the optimizer state; and optax's next update on
    the fixed batch (digits over all 32 codes, no dropout)."""
    jax_kw = {k: v for k, v in DISK_KW.items() if k not in ("dataset", "iterations")}
    jax_kw.update(use_h_tokenizer=False, eval_batches=0, partial_eval_every=10_000,
                  full_eval_every=10_000)
    jres = jtrainer.train(iterations=2, dataset=JRecDataset.SYNTHETIC, dataset_folder=root,
                          save_dir_root=str(tmp / "jax"), n_model_shards=2, **jax_kw)
    export = str(tmp / "jax_export")
    load_script("export_flax_checkpoint").export_checkpoint(jres["saved_paths"][-1], export,
                                                             opt_state=True)
    jb, tb = _batches(4, TINY["max_seq_len"], 3, seed=4)
    jb = jb.replace(sem_ids=jax.numpy.where(jb.sem_ids >= 0, jb.sem_ids * 2, -1),
                    sem_ids_fut=jb.sem_ids_fut * 2)
    tb = tb.replace(sem_ids=torch.where(tb.sem_ids >= 0, tb.sem_ids * 2, -1),
                    sem_ids_fut=tb.sem_ids_fut * 2)
    state, jm = jres["state"], jres["model"]
    grads = jax.grad(lambda p: jm.apply({"params": p}, jb, False).loss)(state.params)
    new = state.apply_gradients(grads=grads, tx=j_make_optimizer(j_schedule(LR, 3), 0.035))
    return export, tb, flat(new.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process references and the 4 ranks' results."""
    monkey = pytest.MonkeyPatch()
    monkey.setattr(jruntime, "_configured", True)  # keep the process PRNG and cache
    tmp = tmp_path_factory.mktemp("train_ranks")
    root = str(tmp / "synth")
    build_synthetic(**TINY).save(j_processed_path(root, JRecDataset.SYNTHETIC))
    try:
        export, jax_batch, want_jax = _jax_run(root, tmp)
    finally:
        monkey.undo()
    vae = init_params_(HRqVae(32, 8, (16,), 16, n_layers=3, tag_class_counts=(4, 6, 8),
                              tag_embed_dim=12), torch.Generator().manual_seed(4)).eval()
    rng = np.random.RandomState(0)
    items = rng.randint(0, 120, (64, 6))
    items[rng.rand(*items.shape) < 0.25] = -1
    arrays = dict(vae=vae, feats=rng.randn(120, 32).astype(np.float32),
                  users=np.arange(64), items=items, fut=rng.randint(0, 120, 64))
    inp = dict(workdir=str(tmp), arrays=arrays, arrays_kw=ARRAYS_KW,
               disk_kw=dict(DISK_KW, dataset_folder=root),
               fixed=dict(model_kw=FIXED_MODEL, lr=LR, batch=_fixed_batch(15)),
               jax_fixed=dict(model_kw=JAX_MODEL, lr=LR, batch=jax_batch),
               jax_export=export)
    mesh = make_mesh()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs
    one = {
        "arrays": worker.arrays_run(inp),
        "arrays_bf16": worker.arrays_run(inp, mixed_precision_type="bf16"),
        "arrays_ragged": worker.arrays_run(inp, batch_size=6),
        "fixed": worker.fixed_step(inp, mesh),
        "fixed_clip": worker.fixed_step(inp, mesh, max_grad_norm=0.05),
        "disk": worker.disk_run(inp, "one"),
        "save": worker.disk_run(inp, "one_save", iterations=2, save_model_every=2),
    }
    one["disk_root"] = root
    inp["one_ckpt"] = str(one["save"]["saved"])
    torch.save(inp, tmp / "inputs.pt")
    ranks = worker.run("train", 4, str(tmp))
    one["resumed_tp"] = worker.disk_run(inp, "one_resume", iterations=2,
                                        pretrained_decoder_path=str(ranks[0]["tp_save:saved"]))
    torch.set_num_threads(threads)
    return one, ranks, want_jax


def _assert_params(got, want, tol, what):
    keys = [k for k in want if k.startswith("p/")]
    assert keys and {k for k in got if k.startswith("p/")} == set(keys)
    for k in keys:
        assert_rel(got[k], want[k], tol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_arrays_run_on_a_mesh_equals_one_process(runs, k):
    one, ranks, _ = runs
    for r in ranks:
        got = part(r, f"arrays_tp{k}")
        np.testing.assert_allclose(got["loss"], one["arrays"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["eval_loss"], one["arrays"]["eval_loss"], rtol=LOSS_RTOL)
        _assert_params(got, one["arrays"], PARAM_TOL, f"tp{k}")


def test_bf16_dp_tp_run_equals_one_process(runs):
    one, ranks, _ = runs
    got = part(ranks[3], "arrays_bf16")
    np.testing.assert_allclose(got["loss"], one["arrays_bf16"]["loss"], rtol=BF16_LOSS_RTOL)
    _assert_params(got, one["arrays_bf16"], BF16_PARAM_TOL, "bf16")


def test_batch_the_data_ranks_do_not_divide_runs_whole(runs):
    one, ranks, _ = runs
    got = part(ranks[1], "arrays_ragged")
    np.testing.assert_allclose(got["loss"], one["arrays_ragged"]["loss"], rtol=LOSS_RTOL)
    _assert_params(got, one["arrays_ragged"], PARAM_TOL, "ragged")


@pytest.mark.parametrize("name", ["fixed", "fixed_clip"])
def test_gradients_and_update_equal_one_process(runs, name):
    """Gradients within GRAD_TOL; params within PARAM_TOL, but an entry
    whose gradient lies under the noise floor may move up to 2 lr the other
    way (Adam's first update is about lr * sign(g))."""
    one, ranks, _ = runs
    want = one[name]
    grads = [k for k in want if k.startswith("g/")]
    assert "g/sem_id_embedder/emb/embedding" in grads
    for r in ranks:
        got = part(r, name)
        for k in grads:
            assert_rel(got[k], want[k], GRAD_TOL, err_msg=f"{name} {k}")
            p = "p/" + k[2:]
            g = np.abs(want[k])
            sure = g > NOISE_FLOOR * GRAD_TOL * g.max()
            scale = max(float(np.abs(want[p]).max()), 1e-12)
            np.testing.assert_allclose(got[p][sure], want[p][sure], rtol=0,
                                       atol=PARAM_TOL * scale, err_msg=f"{name} {p}")
            np.testing.assert_allclose(got[p], want[p], rtol=0, atol=2 * LR, err_msg=p)
    if name == "fixed_clip":  # the clip engaged: the clipped gradients are smaller
        norm = np.sqrt(sum(float(np.sum(want[k] ** 2)) for k in grads))
        np.testing.assert_allclose(norm, 0.05, rtol=1e-5)


def test_split_batches_false_takes_the_global_batch(runs):
    one, ranks, _ = runs
    got, want = part(ranks[2], "split"), one["disk"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=LOSS_RTOL)
    metrics = [k for k in want if k.startswith(("full/", "test/"))]
    assert any(k.startswith("full/") for k in metrics) and any(k.startswith("test/")
                                                               for k in metrics)
    for k in metrics:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    _assert_params(got, want, PARAM_TOL, "split")


@pytest.mark.parametrize("direction", ["tp_to_one", "one_to_tp"])
def test_checkpoint_resumes_across_meshes(runs, direction):
    one, ranks, _ = runs
    want = one["disk"]
    got = one["resumed_tp"] if direction == "tp_to_one" else part(ranks[0], "tp_resume")
    np.testing.assert_allclose(got["loss"], want["loss"][2:], rtol=LOSS_RTOL)
    _assert_params(got, want, PARAM_TOL, direction)


def test_jax_tp_checkpoint_resumes_at_dp_tp(runs):
    _, ranks, want = runs
    got = part(ranks[0], "jax")
    for k, v in want.items():
        np.testing.assert_allclose(got[f"p/{k}"], v, rtol=0, atol=UPDATE_TOL, err_msg=k)


def test_entry_script_under_torchrun(runs, tmp_path):
    """The gin entry under torchrun on 2 CPU ranks at --model-shards 2: rank
    0's checkpoint holds the one-process run's whole params."""
    from hidvae_tpu_torch.bridge import load_export_arrays

    one, _, _ = runs
    lines = ["import data.processed", "train.dataset = %data.processed.RecDataset.SYNTHETIC",
             f'train.save_dir_root = "{tmp_path / "runs"}"', "train.save_model_every = 4"]
    for k, v in dict(DISK_KW, dataset_folder=one["disk_root"]).items():
        if k not in ("dataset", "save_model_every"):
            v = list(v) if isinstance(v, tuple) else v
            lines.append(f"train.{k} = " + (f'"{v}"' if isinstance(v, str) else str(v)))
    out = torchrun("torch_train_transformer.py", tmp_path / "decoder.gin", lines,
                   "--model-shards", "2")
    assert "on mesh {'data': 1, 'model': 2}" in out
    (ckpt,) = (tmp_path / "runs").glob("decoder_SYNTHETIC_*/checkpoint_4")
    got = {f"p/{k.removeprefix('params/')}": v
           for k, v in load_export_arrays(str(ckpt), "params/").items()}
    _assert_params(got, one["disk"], PARAM_TOL, "torchrun")
