"""rq_assign's plain version on duplicated codes and the sweep's chunks
against JAX's `rq_assign_reference` and Pallas `rq_assign` (interpret)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.ops.pallas import rq_kernels as jrq
from hidvae_tpu_torch.ops import rq_assign as rq
from hidvae_tpu_torch.tokenizer.sweep import sweep_corpus

TOL = 1e-5  # fp32 on both sides, summation order only
DUPLICATES = (3, 130, 255)  # identical codes, far apart in K


def _case(seed, b, k, d, n_levels, duplicates=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, d).astype(np.float32)
    cbs = rng.randn(n_levels, k, d).astype(np.float32)
    if duplicates:  # every other row lies near code 3 of level 0
        for c in DUPLICATES[1:]:
            cbs[:, c] = cbs[:, DUPLICATES[0]]
        x[::2] = cbs[0, DUPLICATES[0]] + 1e-3 * rng.randn(len(x[::2]), d).astype(np.float32)
    return x, cbs


@pytest.mark.parametrize("seed,b,k,d,n_levels", [
    (0, 64, 256, 32, 3),    # codes 3, 130, 255 identical: the first wins
    (4, 33, 300, 64, 4),    # the same at K 300, D 64, L 4, B one past two 16-row tiles
], ids=["duplicate-codes", "k300-l4-duplicates"])
def test_duplicate_codes_give_the_first(seed, b, k, d, n_levels):
    x, cbs = _case(seed, b, k, d, n_levels, duplicates=True)
    ids, qsum = rq.rq_assign_reference(torch.from_numpy(x), torch.from_numpy(cbs))
    ids_k, qsum_k = jrq.rq_assign(jnp.asarray(x), jnp.asarray(cbs), block_b=32, interpret=True)
    ids_r, qsum_r = jrq.rq_assign_reference(jnp.asarray(x), jnp.asarray(cbs))
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (b, n_levels)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_k))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(qsum.numpy(), np.asarray(qsum_r), atol=TOL)
    np.testing.assert_allclose(qsum.numpy(), np.asarray(qsum_k), atol=TOL)
    np.testing.assert_array_equal(ids[::2, 0].numpy(), DUPLICATES[0])
    assert not np.isin(ids.numpy(), DUPLICATES[1:]).any()


def test_catalog_chunks_equal_one_call():
    """18,357 items (P5 Sports) swept in 8,192-row chunks, as the engine
    build launches the kernel, equal one call on all rows, and JAX's."""
    x, cbs = _case(5, 18357, 256, 32, 3)
    cbs_t = torch.from_numpy(cbs)
    chunks = []

    def encode(block):
        chunks.append(block.shape[0])
        ids, qsum = rq.rq_assign_reference(block, cbs_t)
        return torch.cat([ids.float(), qsum], dim=1)

    swept = sweep_corpus(encode, x, 8192, torch.device("cpu"))
    assert chunks == [8192, 8192, 1973]
    ids, qsum = rq.rq_assign_reference(torch.from_numpy(x), cbs_t)
    np.testing.assert_array_equal(swept[:, :3].numpy(), ids.float().numpy())
    np.testing.assert_array_equal(swept[:, 3:].numpy(), qsum.numpy())
    ids_r, qsum_r = jrq.rq_assign_reference(jnp.asarray(x), jnp.asarray(cbs))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(qsum.numpy(), np.asarray(qsum_r), atol=TOL)
