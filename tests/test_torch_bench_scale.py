"""scripts/torch_bench_scale.py at 2,000 items on the CPU: the JAX
script's record keys (read from its source), launches, the table, every
item resolved on both paths; refusal without a card."""

import ast

import pytest
import torch

from hidvae_tpu_torch.ops.rq_assign import rq_assign_reference
from hidvae_tpu_torch.utils.runtime import full_fp32
from tests._torch_common import ROOT, load_script

SMALL_DECODER = dict(embedding_dim=16, attn_dim=32, num_heads=2, n_layers=1)


def _jax_keys():
    """The keys of the dict that scripts/bench_scale.py's bench_one returns."""
    tree = ast.parse((ROOT / "scripts/bench_scale.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "bench_one")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


def test_bench_one_on_the_cpu():
    keep = {}
    rec = load_script("torch_bench_scale").bench_one(
        2000, "cpu", request_users=8, big=8, knee_buckets=[4, 8], decoder=SMALL_DECODER,
        keep=keep)
    assert set(rec) == _jax_keys() | {"rq_assign_launches"}
    assert rec["n_items"] == 2000 and rec["rq_assign_launches"] == {"sweep": 0, "engine": 0}
    assert [r["bucket"] for r in rec["bucket_knee"]] == [4, 8]
    vae = keep["vae"]
    with torch.inference_mode(), full_fp32():
        ref = torch.cat([rq_assign_reference(vae.encode(keep["feats"][s:s + 512]),
                                             vae.stacked_codebooks())[0]
                         for s in range(0, 2000, 512)])
    assert torch.equal(keep["ids"], ref)
    assert torch.equal(keep["engine"].corpus_ids, ref)
    assert rec["top10_resolved_frac"] == 1.0 and keep["cap_resolved"] == 1.0


def test_bench_runs_on_the_card_only():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_script("torch_bench_scale").main([])
