"""The port's base ops and rq_assign's plain version against the JAX
package on the same seeded inputs (the kernel: tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.models.layers import MLP as JMLP
from hidvae_tpu.models.layers import RMSNorm as JRMSNorm
from hidvae_tpu.ops import distances as jdist
from hidvae_tpu.ops import normalize as jnorm
from hidvae_tpu.ops.pallas import rq_kernels as jrq
from hidvae_tpu_torch.bridge import load_flax_weights
from hidvae_tpu_torch.models.layers import MLP, RMSNorm
from hidvae_tpu_torch.ops import distances, normalize
from hidvae_tpu_torch.ops import rq_assign as rq
from tests._torch_common import flat

TOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


class TestNormalizeDistances:
    def test_l2norm_and_rms_norm(self):
        rng = np.random.RandomState(0)
        x = rng.randn(7, 12).astype(np.float32)
        x[0] = 0.0  # the eps clamp
        w = rng.randn(12).astype(np.float32)
        np.testing.assert_allclose(_np(normalize.l2norm(torch.from_numpy(x))),
                                   np.asarray(jnorm.l2norm(jnp.asarray(x))), atol=TOL)
        np.testing.assert_allclose(
            _np(normalize.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
            np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=TOL)

    @pytest.mark.parametrize("mode", ["L2", "COSINE"])
    def test_distances_and_nearest_code(self, mode):
        rng = np.random.RandomState(1)
        x = rng.randn(33, 8).astype(np.float32)
        cb = rng.randn(16, 8).astype(np.float32)
        got = distances.compute_distance(torch.from_numpy(x), torch.from_numpy(cb),
                                         distances.DistanceMode[mode])
        want = jdist.compute_distance(jnp.asarray(x), jnp.asarray(cb), jdist.DistanceMode[mode])
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(
            _np(distances.nearest_code(torch.from_numpy(x), torch.from_numpy(cb),
                                       distances.DistanceMode[mode])),
            np.asarray(jdist.nearest_code(jnp.asarray(x), jnp.asarray(cb),
                                          jdist.DistanceMode[mode])))


class TestLayers:
    def test_rmsnorm_module(self):
        rng = np.random.RandomState(2)
        x = rng.randn(3, 5, 16).astype(np.float32)
        jm = JRMSNorm(16)
        params = {"weight": rng.randn(16).astype(np.float32)}
        want = jm.apply({"params": {"weight": jnp.asarray(params["weight"])}}, jnp.asarray(x))
        tm = load_flax_weights(RMSNorm(16), params)
        np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), np.asarray(want), atol=TOL)

    @pytest.mark.parametrize("normalize_out", [False, True])
    def test_mlp_through_bridge(self, normalize_out):
        import jax

        rng = np.random.RandomState(3)
        x = rng.randn(9, 20).astype(np.float32)
        jm = JMLP(hidden_dims=(24, 12), out_dim=6, normalize=normalize_out)
        variables = jm.init(jax.random.key(0), jnp.asarray(x))
        want = jm.apply(variables, jnp.asarray(x))
        tm = load_flax_weights(MLP(20, (24, 12), 6, normalize=normalize_out),
                               flat(variables["params"]))
        with torch.no_grad():
            np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), np.asarray(want),
                                       atol=TOL)


def _rq_case(seed, b, k, d, n_levels):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, d).astype(np.float32),
            rng.randn(n_levels, k, d).astype(np.float32))


class TestRqAssignReference:
    """The cases of tests/test_pallas_kernels.py, through both packages."""

    @pytest.mark.parametrize("seed,b,k,d,l,block", [
        (0, 64, 32, 16, 3, 32), (0, 100, 64, 32, 2, 32), (1, 37, 16, 8, 3, 16),
        # K 100 (not a whole number of the CUDA kernel's 64-code passes), one
        # level, four levels of a small codebook.
        (1, 50, 100, 32, 3, 32), (2, 40, 64, 16, 1, 32), (3, 40, 16, 32, 4, 32),
    ])
    def test_matches_jax_kernel_and_reference(self, seed, b, k, d, l, block):
        x, cbs = _rq_case(seed, b, k, d, l)
        ids, qsum = rq.rq_assign_reference(torch.from_numpy(x), torch.from_numpy(cbs))
        ids_k, qsum_k = jrq.rq_assign(jnp.asarray(x), jnp.asarray(cbs), block_b=block,
                                      interpret=True)
        ids_r, qsum_r = jrq.rq_assign_reference(jnp.asarray(x), jnp.asarray(cbs))
        assert ids.dtype == torch.int32 and tuple(ids.shape) == (b, l)
        np.testing.assert_array_equal(_np(ids), np.asarray(ids_k))
        np.testing.assert_array_equal(_np(ids), np.asarray(ids_r))
        np.testing.assert_allclose(_np(qsum), np.asarray(qsum_r), atol=TOL)
        np.testing.assert_allclose(_np(qsum), np.asarray(qsum_k), atol=TOL)

    def test_exact_codebook_points(self):
        _, cbs = _rq_case(2, 1, 16, 8, 2)
        x = cbs[0][[3, 7, 11]]
        ids, qsum = rq.rq_assign_reference(torch.from_numpy(x), torch.from_numpy(cbs))
        np.testing.assert_array_equal(_np(ids[:, 0]), [3, 7, 11])
        ids_j, qsum_j = jrq.rq_assign_reference(jnp.asarray(x), jnp.asarray(cbs))
        np.testing.assert_array_equal(_np(ids), np.asarray(ids_j))
        np.testing.assert_allclose(_np(qsum), np.asarray(qsum_j), atol=TOL)

    def test_auto_dispatch_on_cpu(self):
        x, cbs = _rq_case(3, 16, 8, 8, 2)
        ids, qsum = rq.rq_assign_auto(torch.from_numpy(x), torch.from_numpy(cbs))
        ids_j, qsum_j = jrq.rq_assign_auto(jnp.asarray(x), jnp.asarray(cbs))
        np.testing.assert_array_equal(_np(ids), np.asarray(ids_j))
        np.testing.assert_allclose(_np(qsum), np.asarray(qsum_j), atol=TOL)

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        x, cbs = _rq_case(4, 8, 8, 8, 2)
        before = rq.rq_assign.launches
        with pytest.raises(ValueError, match="CUDA"):
            rq.rq_assign(torch.from_numpy(x), torch.from_numpy(cbs))
        assert rq.rq_assign.launches == before
