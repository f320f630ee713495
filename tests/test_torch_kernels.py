"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and nvcc; every test skips without a card. Imports no
JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import compare_ids, near_tie_levels
from hidvae_tpu_torch.ops import rq_assign as rq

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,d,n_levels,k", [
    (1001, 32, 3, 256), (4096, 32, 4, 256), (1001, 64, 3, 256), (300, 32, 2, 16), (1, 32, 3, 256),
])
def test_rq_assign_matches_plain(cuda, b, d, n_levels, k):
    rng = np.random.RandomState(b + d)
    x = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(cuda)
    cbs = torch.from_numpy(rng.randn(n_levels, k, d).astype(np.float32)).to(cuda)
    before = rq.rq_assign.launches
    ids, qsum = rq.rq_assign_auto(x, cbs)
    torch.cuda.synchronize()
    assert rq.rq_assign.launches == before + 1
    ids_r, qsum_r = rq.rq_assign_reference(x, cbs)
    # Rows may differ only where the plain version's best two distances tie
    # to within rounding; the sums agree wherever the ids do.
    _, not_ties = compare_ids(ids, ids_r, near_tie_levels(x, cbs))
    assert not_ties == 0
    agree = (ids == ids_r).all(dim=-1)
    np.testing.assert_allclose(qsum[agree].cpu().numpy(), qsum_r[agree].cpu().numpy(),
                               atol=1e-5)


def test_rq_assign_exact_codebook_points(cuda):
    rng = np.random.RandomState(2)
    cbs = torch.from_numpy(rng.randn(2, 256, 32).astype(np.float32)).to(cuda)
    x = cbs[0][torch.tensor([3, 7, 11, 255], device=cuda)].contiguous()
    ids, _ = rq.rq_assign(x, cbs)
    assert ids[:, 0].tolist() == [3, 7, 11, 255]


def test_rq_assign_refuses_what_it_cannot_run(cuda):
    x = torch.zeros(4, 12, device=cuda)
    with pytest.raises(ValueError, match="supports D"):
        rq.rq_assign(x, torch.zeros(2, 16, 12, device=cuda))
    with pytest.raises(TypeError):
        rq.rq_assign(torch.zeros(4, 32, device=cuda, dtype=torch.float64),
                     torch.zeros(2, 16, 32, device=cuda))
