"""The stage-1 trainers on 2 and 4 Gloo ranks against one process and JAX:
losses, evals, audits, tables, pools, params; split_batches=False;
resumes across process counts; torchrun; JAX on 8 devices at DP 2."""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from hidvae_tpu.data.processed import RecDataset as JRecDataset
from hidvae_tpu.data.processed import processed_path as j_processed_path
from hidvae_tpu.data.synthetic import build_synthetic
from hidvae_tpu.models.quantize import QuantizeForwardMode as JMode
from hidvae_tpu.train import hidvae as jtrainer
from hidvae_tpu.train.common import save_checkpoint as j_save_checkpoint
from hidvae_tpu.utils import runtime as jruntime
from hidvae_tpu_torch.bridge import load_export_arrays
from hidvae_tpu_torch.data.processed import RecDataset
from hidvae_tpu_torch.models.quantize import QuantizeForwardMode
from hidvae_tpu_torch.train import hidvae
from tests import _torch_parallel_worker as worker
from tests._torch_common import flat, jax_batch_indices, part, torchrun, unflat
from tests.test_torch_stage1_trainer import TINY

# fp32: the ranks' sums (all-reduced statistics and means, summed gradients)
# differ from one process's in order only, ~1e-7 relative per sum.
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5    # max |got - want| over max |want|, per leaf
LR = 1e-3
# A bias before a train-mode BatchNorm: gradient 0 up to rounding, which
# Adam scales to steps of up to 1.3 lr (held so, 2 updates).
BN_BIAS_ATOL = 2 * 2 * 1.3 * LR
# Its noise-driven steps reach the eval losses through the running mean
# (1 % a mini-step): ~1e-4 relative per update.
BN_MEAN_ATOL = BN_BIAS_ATOL * (1 - 0.99 ** 4)
EVAL_RTOL = 1e-3
# The port against JAX, as tests/test_torch_stage1_trainer.py holds them.
JAX_LOSS_RTOL = 1e-4
JAX_REL_TOL = 1e-4
JAX_STATS_ATOL = 1e-5
WIDTHS = dict(vae_input_dim=32, vae_n_cat_feats=0, vae_hidden_dims=[32, 16], vae_embed_dim=8,
              vae_codebook_size=32, vae_n_layers=3)
HIDVAE = dict(
    WIDTHS, iterations=2, batch_size=16, learning_rate=LR, weight_decay=0.015,
    vae_codebook_normalize=True, tag_embed_dim=16, gradient_accumulate_every=2,
    layer_specific_lr=True, rare_tag_threshold=8, lr_scheduler_T_max=20, eval_every=2,
    save_model_every=2, eval_batches=2, log_every=1, make_plots=False, seed=5,
    dataset=RecDataset.SYNTHETIC, sem_id_mining=True, sem_id_mining_frac=0.375,
    sem_id_mining_pool=32, sem_id_mining_isolate=True)
RQVAE = dict(
    WIDTHS, iterations=2, batch_size=16, learning_rate=LR, gradient_accumulate_every=2,
    max_grad_norm=0.05, eval_every=2, save_model_every=2, eval_batches=2, log_every=1,
    make_plots=False, seed=5, dataset=RecDataset.SYNTHETIC)
DETERMINISTIC = dict(dropout_rate=0.0, use_mixup=False, eval_tta=False, sem_id_mining=False)
JAX_RUN = dict(DETERMINISTIC, iterations=2, eval_every=4, save_model_every=4)


def _jax_run(root, tmp):
    """The port's JAX_RUN, its `latest` as an Orbax checkpoint, the JAX
    trainer resumed from it: its result, the checkpoint, the JAX batches."""
    first = hidvae.train(**dict(HIDVAE, **JAX_RUN), dataset_folder=root, device="cpu",
                         vae_codebook_mode=QuantizeForwardMode.ROTATION_TRICK,
                         save_dir_root=str(tmp / "probe"))
    latest = first["saved_paths"][-1]
    arrays = load_export_arrays(latest)
    j_init = j_save_checkpoint(str(tmp), "jax_init", {
        **{key: unflat({k[len(key) + 1:]: v for k, v in arrays.items()
                        if k.startswith(key + "/")})
           for key in ("params", "batch_stats", "opt_state")},
        "step": np.int32(arrays["step"])})
    jkw = {k: v for k, v in dict(HIDVAE, **JAX_RUN).items() if k != "dataset"}
    monkey = pytest.MonkeyPatch()
    monkey.setattr(jruntime, "_configured", True)  # keep the process PRNG and cache
    monkey.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        assert len(jax.devices()) == 8
        jres = jtrainer.train(dataset=JRecDataset.SYNTHETIC, dataset_folder=root,
                              vae_codebook_mode=JMode.ROTATION_TRICK,
                              save_dir_root=str(tmp / "jax"), pretrained_hrqvae_path=j_init,
                              **jkw)
    finally:
        monkey.undo()
    n_train = int(np.load(j_processed_path(root, JRecDataset.SYNTHETIC))["item_is_train"].sum())
    start = int(arrays["step"])
    batches = jax_batch_indices(HIDVAE["seed"], range(start, 2 * start), HIDVAE["batch_size"],
                           n_train)
    return jres, latest, batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One-process references, the ranks' runs at DP 2 and DP 4, the JAX run."""
    tmp = tmp_path_factory.mktemp("stage1_ranks")
    root = str(tmp / "synth")
    build_synthetic(**TINY).save(j_processed_path(root, JRecDataset.SYNTHETIC))
    jres, port_init, jax_batches = _jax_run(root, tmp)
    inp = dict(workdir=str(tmp), hidvae_kw=dict(HIDVAE, dataset_folder=root),
               rqvae_kw=dict(RQVAE, dataset_folder=root), paths={"jax_init": port_init})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs
    one = {}
    for name, trainer, kw in (("h", "hidvae", {}), ("r", "rqvae", {}),
                              ("h_half", "hidvae", {"iterations": 1}),
                              ("r_ragged", "rqvae", {"batch_size": 6})):
        one.update(worker.stage1_run(inp, name, trainer, **kw))
    inp["paths"]["one_half"] = str(one["h_half:saved"])
    jax_port = dict(JAX_RUN, vae_codebook_mode=QuantizeForwardMode.ROTATION_TRICK,
                    jax_batches=jax_batches, pretrained_from="jax_init")
    inp["stage1_runs"] = {
        2: [("h2", "hidvae", {}), ("r2", "rqvae", {}),
            ("h_split", "hidvae", {"batch_size": 8, "split_batches": False}),
            ("h_dp_half", "hidvae", {"iterations": 1}),
            ("h_resume", "hidvae", {"iterations": 1, "pretrained_from": "one_half"}),
            ("jax", "hidvae", jax_port)],
        4: [("h4", "hidvae", {}), ("r4", "rqvae", {}),
            ("r_ragged4", "rqvae", {"batch_size": 6})],
    }
    torch.save(inp, tmp / "inputs.pt")
    ranks = {world: worker.run("stage1", world, str(tmp)) for world in (2, 4)}
    one.update(worker.stage1_run(inp, "h_dp_resumed", "hidvae", iterations=1,
                                 pretrained_hrqvae_path=str(ranks[2][0]["h_dp_half:saved"])))
    torch.set_num_threads(threads)
    return dict(one=one, ranks=ranks, jax=jres, root=root)


def _assert_run(got, want, what, steps=slice(None)):
    """Logged and eval metrics within LOSS_RTOL (at the reference's audits
    and last steps), table and pool equal, leaves within PARAM_TOL."""
    for k in ("total_loss", "reconstruction_loss", "rqvae_loss", "tag_pred_loss",
              "tag_pred_accuracy"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k][steps], rtol=LOSS_RTOL,
                                       err_msg=f"{what} {k}")
    for k in ("eval_total_loss", "eval_tag_pred_accuracy"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k][-len(got[k]):], rtol=EVAL_RTOL,
                                       err_msg=f"{what} {k}")
    for k in ("repetition_rate", "rqvae_entropy"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k][-len(got[k]):], err_msg=f"{what} {k}")
    for k in ("table", "pool"):
        assert (k in got) == (k in want), (what, k)
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    _assert_params(got, want, what)


def _assert_params(got, want, what):
    keys = [k for k in want if k.startswith(("p/", "s/"))]
    assert keys and set(keys) == {k for k in got if k.startswith(("p/", "s/"))}
    for k in keys:
        if k.startswith("p/tag_projector_") and k.endswith("dense_0/bias"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=BN_BIAS_ATOL, err_msg=k)
        elif k.startswith("s/tag_projector_") and k.endswith("bn/mean"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=BN_MEAN_ATOL, err_msg=k)
        else:
            scale = max(float(np.abs(want[k]).max()), 1e-12)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL * scale,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("trainer", ["hidvae", "rqvae"])
@pytest.mark.parametrize("world", [2, 4])
def test_dp_run_equals_one_process(runs, trainer, world):
    one, ranks = runs["one"], runs["ranks"][world]
    name = ("h" if trainer == "hidvae" else "r") + str(world)
    want = part(one, name[0])
    for r in ranks:
        got = part(r, name)
        _assert_run(got, want, f"{name} rank {r}")
        np.testing.assert_array_equal(got["iterations"], want["iterations"])
        assert got["bytes_per_step"] > 0 and want["bytes_per_step"] == 0
    if trainer == "hidvae":
        assert len(want["repetition_rate"]) == 2 and len(want["eval_total_loss"]) == 2


def test_batch_four_ranks_do_not_divide_runs_whole(runs):
    one, ranks = runs["one"], runs["ranks"][4]
    want = part(one, "r_ragged")
    for r in ranks:
        got = part(r, "r_ragged4")
        _assert_run(got, want, "ragged")
        assert got["bytes_per_step"] == 0  # no split, no gradient all-reduce


def test_split_batches_false_takes_the_global_batch(runs):
    want = part(runs["one"], "h")
    for r in runs["ranks"][2]:
        _assert_run(part(r, "h_split"), want, "split")


@pytest.mark.parametrize("direction", ["dp_to_one", "one_to_dp"])
def test_checkpoint_resumes_across_world_sizes(runs, direction):
    one = runs["one"]
    want = part(one, "h")
    got = (part(one, "h_dp_resumed") if direction == "dp_to_one"
           else part(runs["ranks"][2][0], "h_resume"))
    _assert_run(got, want, direction, steps=slice(2, None))


def test_entry_script_under_torchrun(runs, tmp_path):
    """The gin entry under torchrun on 2 CPU ranks: rank 0's `latest` holds
    the one-process run's params and statistics."""
    lines = ["import data.processed", "train.dataset = %data.processed.RecDataset.SYNTHETIC",
             f'train.dataset_folder = "{runs["root"]}"',
             f'train.save_dir_root = "{tmp_path / "runs"}"']
    for k, v in HIDVAE.items():
        if k != "dataset":
            lines.append(f"train.{k} = {v!r}")
    out = torchrun("torch_train_hidvae.py", tmp_path / "s1.gin", lines)
    assert out.count("trained to step 4") == 1  # rank 0 alone reports
    (ckpt,) = (tmp_path / "runs").glob("hrqvae_SYNTHETIC_*/latest")
    got = {k.replace("params/", "p/", 1).replace("batch_stats/", "s/", 1): v
           for k, v in load_export_arrays(str(ckpt)).items()
           if k.startswith(("params/", "batch_stats/"))}
    _assert_params(got, part(runs["one"], "h"), "torchrun")


def test_port_at_dp2_follows_the_jax_data_parallel_run(runs):
    jh = runs["jax"]["history"]
    got = part(runs["ranks"][2][0], "jax")
    np.testing.assert_array_equal(got["iterations"], jh["iterations"])
    for key in ("total_loss", "reconstruction_loss", "tag_pred_loss"):
        np.testing.assert_allclose(got[key], jh[key], rtol=JAX_LOSS_RTOL, err_msg=key)
    for key in ("eval_total_loss", "eval_tag_pred_accuracy"):
        np.testing.assert_allclose(got[key], jh[key], rtol=EVAL_RTOL, err_msg=key)
    np.testing.assert_array_equal(got["repetition_rate"], jh["repetition_rate"])
    state = runs["jax"]["state"]
    for k, want in flat(state.params).items():
        if k.startswith("tag_projector_") and k.endswith("dense_0/bias"):
            np.testing.assert_allclose(got[f"p/{k}"], want, rtol=0, atol=BN_BIAS_ATOL)
        else:
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(got[f"p/{k}"], want, rtol=0, atol=JAX_REL_TOL * scale,
                                       err_msg=k)
    for k, want in flat(state.batch_stats).items():
        atol = BN_MEAN_ATOL if k.endswith("bn/mean") else JAX_STATS_ATOL
        np.testing.assert_allclose(got[f"s/{k}"], want, rtol=0, atol=atol, err_msg=k)
