"""Stage-1 data parallelism term by term on 2 and 4 Gloo ranks against one
process on the whole batch: values bitwise, gradients per rank's rows and
summed."""

import copy

import numpy as np
import pytest
import torch

from hidvae_tpu_torch.models.hrqvae import FlaxBatchNorm, HRqVae, TagProjector
from hidvae_tpu_torch.models.init import init_params_
from hidvae_tpu_torch.train import hidvae, rqvae
from hidvae_tpu_torch.utils.config import parse_config_and_run
from tests import _torch_parallel_worker as worker

# fp32: the ranks' sums (all-reduced statistics and means, summed gradients)
# differ from one process's in order only.
TOL = 1e-5
# A bias right before a train-mode BatchNorm has a gradient of 0 up to
# rounding: it is held to TOL of its term's largest gradient entry instead.
BIAS_BEFORE_BN = "dense_0.bias"


def _term_inputs(b: int):
    rng = np.random.RandomState(b)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    bn = FlaxBatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * randn(6))
        bn.bias.copy_(0.1 * randn(6))
        bn.running_mean.copy_(randn(6))
        bn.running_var.copy_(1 + torch.from_numpy(rng.rand(6).astype(np.float32)))
    proj = init_params_(TagProjector(6, 12, 8), torch.Generator().manual_seed(1))
    ids = torch.from_numpy(rng.randint(0, 2, (b, 3)).astype(np.int32))  # 8 tuples: collisions
    targets = torch.from_numpy(rng.randint(0, 7, b).astype(np.int32))
    targets[rng.rand(b) < 0.25] = -1
    model = init_params_(HRqVae(
        32, 8, (16,), 16, n_layers=3, tag_class_counts=(4, 6, 8), tag_embed_dim=16,
        codebook_normalize=True, use_focal_loss=True, dropout_rate=0.2,
        sem_id_uniqueness_margin=0.0, sem_id_mining_margin=0.5, mined_loss_isolation=True),
        torch.Generator().manual_seed(2))
    x = randn(b, 32)
    x[1:8:2] = x[0:8:2] + 1e-4 * randn(4, 32)  # near-copies: the mined pairs collide
    x[b - 2] = x[b - 4]                         # and a collision among the main rows
    tags = torch.from_numpy(np.stack([rng.randint(0, c, b) for c in (4, 6, 8)], 1)
                            .astype(np.int32))
    tags[rng.rand(b, 3) < 0.2] = -1
    terms = dict(
        bn_x=2 + randn(b, 6), bn_state=bn.state_dict(), bn_w=randn(b, 6),
        projector_state=proj.state_dict(), projector_w=randn(b, 8),
        cb=randn(b, 16), tg=randn(b, 16), enc=randn(b, 8), ids=ids,
        logits=randn(b, 7), targets=targets, class_counts=torch.tensor([9, 1, 4, 30, 2, 7, 12]),
        model_x=x, model_tags_emb=randn(b, 3, 16), model_tags=tags,
        class_counts_model=tuple(torch.from_numpy(rng.randint(1, 20, c)) for c in (4, 6, 8)),
    )
    return terms, model


# (world, global batch, model cases): the 4-rank batch of 18 rows is cut
# 4, 5, 4, 5; "straddle" puts 3 mined pairs (6 rows) on ranks 0 and 1.
WORLDS = {
    2: (16, ({"name": "mined", "batch": 16, "pairs": 2}, {"name": "plain", "batch": 16,
                                                          "pairs": 0})),
    4: (18, ({"name": "straddle", "batch": 18, "pairs": 3}, {"name": "plain", "batch": 16,
                                                             "pairs": 0})),
}


@pytest.fixture(scope="module", params=sorted(WORLDS), ids=lambda n: f"world{n}")
def runs(request, tmp_path_factory):
    world = request.param
    b, cases = WORLDS[world]
    terms, model = _term_inputs(b)
    inp = {"terms": terms, "model": model, "model_cases": cases}
    workdir = tmp_path_factory.mktemp(f"stage1_terms_{world}")
    torch.save(inp, workdir / "inputs.pt")
    ranks = worker.run("terms", world, str(workdir))
    return ranks, worker.stage1_terms(copy.deepcopy(inp))


def _check(runs, prefix):
    """Each key under `prefix`: values bitwise equal across ranks, within TOL
    of one process's; row gradients concatenated, parameters' summed."""
    ranks, ref = runs
    keys = [k for k in ref if k.startswith(prefix + "/")]
    assert keys, prefix
    largest = max(float(np.abs(ref[k]).max()) for k in keys if "_grad" in k or "/p/" in k)
    for key in keys:
        want = ref[key]
        if key.endswith("_grad"):
            got = np.concatenate([r[key] for r in ranks])
        elif "/p/" in key:
            got = sum(r[key] for r in ranks)
        else:
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
            got = ranks[0][key]
        assert got.shape == want.shape, key
        scale = float(np.abs(want).max()) if want.size else 0.0
        if key.endswith(BIAS_BEFORE_BN):
            scale = largest
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(scale, 1e-12),
                                   err_msg=key)


@pytest.mark.parametrize("term", ["bn", "projector"])
def test_batchnorm_takes_global_statistics(runs, term):
    _check(runs, term)


def test_infonce_runs_against_the_global_columns(runs):
    _check(runs, "nce")


def test_uniqueness_covers_the_global_pairs(runs):
    _, ref = runs
    assert float(ref["uniq/value"]) > 0
    _check(runs, "uniq")


@pytest.mark.parametrize("loss", ["focal", "ce"])
def test_tag_loss_mixes_and_counts_over_the_global_batch(runs, loss):
    _check(runs, loss)


def test_mined_pairs_with_isolation(runs):
    ranks, ref = runs
    name = "mined" if len(ranks) == 2 else "straddle"
    assert float(ref[f"{name}/mined_pair_collision_rate"]) > 0
    _check(runs, name)


def test_whole_loss_without_mining(runs):
    _check(runs, "plain")


@pytest.mark.parametrize("consumer", ["whole_on_every_rank", "rows_on_each_rank"])
def test_gather_backward_modes(runs, consumer):
    """InfoNCE computed whole on every rank needs "slice" gathers ("sum"
    is off by the world size); by rows against gathered columns it needs
    "sum"."""
    ranks, ref = runs
    want = ref["nce/cb_grad"]
    if consumer == "whole_on_every_rank":
        got = np.concatenate([r["modes/whole_sum_cb_grad"] for r in ranks])
        np.testing.assert_allclose(got, len(ranks) * want, rtol=0,
                                   atol=TOL * len(ranks) * np.abs(want).max())
    else:
        np.testing.assert_allclose(ranks[0]["modes/rows_value"], ref["nce/value"], rtol=TOL)
        for key in ("cb_grad", "tg_grad"):
            got = np.concatenate([r[f"modes/rows_{key}"] for r in ranks])
            np.testing.assert_allclose(got, ref[f"nce/{key}"], rtol=0,
                                       atol=TOL * np.abs(ref[f"nce/{key}"]).max())


@pytest.mark.parametrize("trainer", [hidvae, rqvae], ids=["hidvae", "rqvae"])
def test_stage1_refuses_model_shards(trainer, tmp_path):
    gin = tmp_path / "shards.gin"
    gin.write_text("train.iterations = 1\ntrain.n_model_shards = 2\n")
    with pytest.raises(ValueError, match=r"Unknown gin binding.*n_model_shards"):
        parse_config_and_run(trainer.train, [str(gin)], device="cpu")
