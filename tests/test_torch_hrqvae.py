"""HRqVae eval parity through the weight bridge: encode -> get_semantic_ids
-> predict_tags_from_ids, the tag projector with BatchNorm statistics, and
the stacked codebooks, against the JAX model on the same weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.ops.pallas.rq_kernels import rq_assign_reference as jrq_reference
from hidvae_tpu_torch.bridge import flax_to_state_dict
from hidvae_tpu_torch.ops.rq_assign import rq_assign_reference
from tests._torch_common import flat, hrqvae_pair, japply

TOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module", params=[
    dict(codebook_normalize=True, sim_vq=False),
    dict(codebook_normalize=False, sim_vq=True),
], ids=["normalize", "simvq"])
def pair(request):
    return hrqvae_pair(**request.param)


def _features(n=48, f=32, seed=7):
    return np.random.RandomState(seed).randn(n, f).astype(np.float32)


class TestHRqVaeEval:
    def test_encode_and_codebooks(self, pair):
        jm, jvars, tm = pair
        x = _features()
        want = japply(jm, jvars, lambda m, x: m.encode(x), jnp.asarray(x))
        want_cb = japply(jm, jvars, lambda m: m.stacked_codebooks())
        with torch.no_grad():
            np.testing.assert_allclose(_np(tm.encode(torch.from_numpy(x))), np.asarray(want),
                                       atol=TOL)
            np.testing.assert_allclose(_np(tm.stacked_codebooks()), np.asarray(want_cb),
                                       atol=TOL)

    def test_semantic_ids_and_tags(self, pair):
        jm, jvars, tm = pair
        x = _features()

        def run(m, x):
            out = m.get_semantic_ids(m.encode(x))
            return out, m.predict_tags_from_ids(out.sem_ids)

        want, want_tags = japply(jm, jvars, run, jnp.asarray(x))
        with torch.no_grad():
            got = tm.get_semantic_ids(tm.encode(torch.from_numpy(x)))
            got_tags = tm.predict_tags_from_ids(got.sem_ids)
        np.testing.assert_array_equal(_np(got.sem_ids), np.asarray(want.sem_ids))
        np.testing.assert_allclose(_np(got.embeddings), np.asarray(want.embeddings), atol=TOL)
        np.testing.assert_allclose(_np(got.residuals), np.asarray(want.residuals), atol=TOL)
        np.testing.assert_allclose(_np(got.quantize_loss), np.asarray(want.quantize_loss),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(_np(got_tags["predictions"]),
                                      np.asarray(want_tags["predictions"]))
        np.testing.assert_allclose(_np(got_tags["confidences"]),
                                   np.asarray(want_tags["confidences"]), atol=TOL)
        # The sweep's fused route gives the cascade's IDs.
        with torch.no_grad():
            ids, _ = rq_assign_reference(tm.encode(torch.from_numpy(x)), tm.stacked_codebooks())
        np.testing.assert_array_equal(_np(ids), np.asarray(want.sem_ids))
        ids_j, _ = jrq_reference(japply(jm, jvars, lambda m, x: m.encode(x), jnp.asarray(x)),
                                 japply(jm, jvars, lambda m: m.stacked_codebooks()))
        np.testing.assert_array_equal(_np(ids), np.asarray(ids_j))

    def test_tag_projector_running_stats(self, pair):
        jm, jvars, tm = pair
        tags = np.random.RandomState(8).randn(10, 12).astype(np.float32)
        for i in range(tm.n_tag_levels):
            want = japply(jm, jvars, lambda m, t, i=i: m.tag_projectors[i](t, train=False),
                          jnp.asarray(tags))
            with torch.no_grad():
                got = tm.tag_projectors[i](torch.from_numpy(tags))
            np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)


class TestBridge:
    def test_every_leaf_maps_and_layouts(self, pair):
        jm, jvars, tm = pair
        params, stats = flat(jvars["params"]), flat(jvars["batch_stats"])
        sd = flax_to_state_dict(params, stats)
        assert set(sd) == set(tm.state_dict())
        k = "encoder/dense_0/kernel"
        np.testing.assert_array_equal(_np(sd["encoder.dense_0.weight"]), params[k].T)
        np.testing.assert_array_equal(_np(sd["quantize_0.embedding"]),
                                      params["quantize_0/embedding"])
        np.testing.assert_array_equal(_np(sd["tag_projector_0.bn.running_var"]),
                                      stats["tag_projector_0/bn/var"])
        np.testing.assert_array_equal(_np(sd["tag_predictor_0.feat_ln.weight"]),
                                      params["tag_predictor_0/feat_ln/scale"])

    def test_rejects_unknown_batch_stat(self):
        with pytest.raises(ValueError, match="batch_stats"):
            flax_to_state_dict({}, {"bn/other": np.zeros(3, np.float32)})
