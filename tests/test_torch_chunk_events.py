"""The trainers' chunked loop against JAX: chunks of max(1,
min(log_every, every cadence, steps)) steps, cadences tested at chunk ends
(transformer.py:536-613; hidvae.py:634-710; rqvae.py:231-351)."""

import numpy as np
import pytest

from hidvae_tpu.data.processed import RecDataset as JRecDataset
from hidvae_tpu.data.processed import processed_path as j_processed_path
from hidvae_tpu.data.synthetic import build_synthetic
from hidvae_tpu.train import hidvae as jhidvae
from hidvae_tpu.train import rqvae as jrqvae
from hidvae_tpu.train import transformer as jtrainer
from hidvae_tpu.utils import runtime as jruntime
from hidvae_tpu_torch.data.processed import RecDataset
from hidvae_tpu_torch.train import hidvae, rqvae
from hidvae_tpu_torch.train import transformer as trainer
from hidvae_tpu_torch.train.common import chunk_events
from tests._torch_common import basenames
from tests.test_torch_trainer import TINY

COMMON = dict(
    batch_size=8, full_eval_every=10_000, vae_input_dim=32, vae_n_cat_feats=0,
    vae_hidden_dims=(32, 16), vae_embed_dim=8, vae_codebook_size=32, vae_n_layers=3,
    use_h_tokenizer=False, tag_embed_dim=16, decoder_embed_dim=16, attn_embed_dim=32,
    attn_heads=2, attn_layers=2, warmup_steps=3, make_plots=False, seed=7, eval_batches=0,
    mixed_precision_type="fp32",
)
STAGE1 = dict(
    batch_size=8, vae_input_dim=32, vae_n_cat_feats=0, vae_hidden_dims=(32, 16),
    vae_embed_dim=8, vae_codebook_size=16, vae_n_layers=3, make_plots=False, seed=7,
    eval_batches=1, iterations=40, log_every=10, eval_every=25, save_model_every=15,
)
# Per trainer: the JAX and port modules, the run's bindings and its (log,
# eval, save) iterations; then a port run's changed bindings and what they give.
CASES = {
    "transformer": (
        jtrainer, trainer,
        dict(COMMON, iterations=100, log_every=20, partial_eval_every=50, save_model_every=30),
        ([19, 39, 59, 79, 99], [60, 100], ["checkpoint_40", "checkpoint_60", "checkpoint_100"]),
        dict(log_every=100, save_model_every=10_000),
        ([49, 99], [50, 100], ["checkpoint_100"])),
    # No gated checkpoint: its name carries the run's accuracy.
    "hidvae": (
        jhidvae, hidvae, dict(STAGE1, tag_embed_dim=16, id_repetition_threshold=0.0),
        ([9, 19, 29, 39], [30, 40], ["latest"] * 3),
        # eval_every splits the chunks with the eval off.
        dict(do_eval=False, log_every=100, save_model_every=10_000),
        ([24, 39], [], ["latest"])),
    "rqvae": (
        jrqvae, rqvae, STAGE1,
        ([9, 19, 29, 39], [30, 40], ["checkpoint_19", "checkpoint_29", "checkpoint_39"]),
        dict(do_eval=False, log_every=100, save_model_every=10_000),
        ([24, 39], [], ["checkpoint_39"])),
}


def reference_events(start, n, cadences, log_every):
    """The JAX loop's bookkeeping, step for step (transformer.py:578-613)."""
    chunk = max(1, min(log_every, *cadences, n))
    it, out = start, []
    while it < start + n:
        n_now = min(chunk, start + n - it)
        prev, it = it, it + n_now
        out.append((prev, it, tuple(i for i, e in enumerate(cadences)
                                    if prev // e != it // e or it == start + n)))
    return out


@pytest.mark.parametrize("start,n,cadences,log_every", [
    (0, 100, (50, 10_000, 30), 20),
    (0, 100, (50,), 100),
    (7, 23, (5, 4), 100),
    (3, 1, (1000,), 100),
    (0, 9, (2, 3), 1),
])
def test_chunk_events_follow_the_jax_loop(start, n, cadences, log_every):
    assert list(chunk_events(start, n, cadences, log_every)) == reference_events(
        start, n, cadences, log_every)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_chunks"))
    build_synthetic(**TINY).save(j_processed_path(root, JRecDataset.SYNTHETIC))
    return root


@pytest.mark.parametrize("stage", list(CASES))
def test_stage2_events_fire_where_jax_fires_them(stage, dataset_root, tmp_path, monkeypatch):
    """Stage 2: 100 steps, log_every 20, eval every 50, saves every 30: both
    log at 19, 39, .., 99, evaluate at 60 and 100 and save at 40, 60 and
    100. Stage 1: 40 steps, log_every 10, eval every 25, saves every 15:
    both log at 9, 19, 29, 39, evaluate at 30 and 40 and save at 20, 30 and
    40."""
    monkeypatch.setattr(jruntime, "_configured", True)  # keep the process PRNG and cache
    jmod, mod, kw, (logs, evals, saves), then, then_want = CASES[stage]
    kw = dict(kw, dataset_folder=dataset_root)
    jres = jmod.train(dataset=JRecDataset.SYNTHETIC, save_dir_root=str(tmp_path / "jax"), **kw)
    tres = mod.train(dataset=RecDataset.SYNTHETIC, save_dir_root=str(tmp_path / "port"),
                     device="cpu", **kw)
    jh, th = jres["history"], tres["history"]
    assert th["iterations"] == jh["iterations"] == logs
    assert th["eval_iterations"] == jh["eval_iterations"] == evals
    assert basenames(tres["saved_paths"]) == basenames(jres["saved_paths"]) == saves
    assert np.isfinite(th["window_mean"])  # every step's loss

    kw.update(then)
    tres = mod.train(dataset=RecDataset.SYNTHETIC, save_dir_root=str(tmp_path / "port_then"),
                     device="cpu", **kw)
    logs, evals, saves = then_want
    assert tres["history"]["iterations"] == logs
    assert tres["history"]["eval_iterations"] == evals
    assert basenames(tres["saved_paths"]) == saves
