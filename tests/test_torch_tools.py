"""The inspection tools against JAX: `profile_trace`, torch_view.py's
subcommands, torch_diag_mining.py, torch_train_profile.py --attrib, plain
`rq_assign` at width 16."""

import contextlib
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.data.synthetic import build_synthetic as j_build_synthetic
from hidvae_tpu.ops.pallas import rq_kernels as jrq
from hidvae_tpu.train.tags import compute_rare_tag_remap as j_remap
from hidvae_tpu_torch.ops import rq_assign as rq
from hidvae_tpu_torch.utils.debug import profile_trace, span
from tests._torch_common import load_script

ROOT = Path(__file__).resolve().parent.parent
STAGE1 = ROOT / "out/hrqvae/synthetic/hrqvae_SYNTHETIC_20260816_065118/latest"
view = load_script("torch_view")


def printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return out.getvalue(), result


def test_profile_trace_writes_trace_and_spans(tmp_path, monkeypatch):
    monkeypatch.delenv("HIDVAE_PROFILE", raising=False)
    with profile_trace(log_dir=str(tmp_path / "off")) as prof:
        torch.ones(2).sum()
    assert prof is None and not (tmp_path / "off").exists()
    monkeypatch.setenv("HIDVAE_PROFILE", "1")
    with profile_trace(log_dir=str(tmp_path / "on")) as prof:
        with span("outer", phase=1):
            with span("inner"):
                (torch.ones(4, 4) @ torch.ones(4, 4)).sum()
    trace = Path(prof.trace_path)
    assert trace.parent == tmp_path / "on" and "traceEvents" in json.loads(trace.read_text())
    spans = Path(prof.spans_path)
    assert spans.parent == trace.parent and spans.name == trace.name.replace("trace_", "spans_")
    written = json.loads(spans.read_text())
    assert written["dropped"] == 0
    assert [(r["name"], r["parent"], r["request"], r["fields"]) for r in written["records"]] == [
        ("outer", None, 0, {"phase": 1}), ("inner", 0, 0, {})]


def test_view_processed_report_equals_jax(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["view_processed_dataset.py", str(ROOT / "dataset/synthetic")])
    want, _ = printed(load_script("view_processed_dataset").main)
    got, _ = printed(view.main, ["processed", str(ROOT / "dataset/synthetic")])
    assert got == want and "== SeqData (eval) ==" in got


@pytest.mark.parametrize("command", ["train-hrqvae", "train-rqvae"])
def test_view_train_runs_on_the_jax_corpus(command, tmp_path):
    """Two iterations on the CPU: the written corpus is JAX's build_synthetic
    bitwise, the remapped counts JAX's remap, the table's width 16 codes as
    the plain sweep gives them."""
    text, rec = printed(view.main, [command, "--iterations", "2", "--root", str(tmp_path / "ds"),
                                    "--out", str(tmp_path / "out"), "--device", "cpu"])
    want = j_build_synthetic(n_items=500, n_users=100, feature_dim=64, tag_dim=32, max_seq_len=10)
    with np.load(tmp_path / "ds/processed/synthetic.npz") as z:
        assert set(z.files) == {k for k, v in vars(want).items() if v is not None}
        for k in z.files:
            np.testing.assert_array_equal(z[k], getattr(want, k), err_msg=k)
    model = rec["result"]["model"]
    assert model.embed_dim == 16 and rec["corpus"].shape[0] == 500
    feats = torch.as_tensor(rec["items"].item_features)
    with torch.no_grad():
        ids, _ = rq.rq_assign_reference(model.encode(feats), model.stacked_codebooks())
    np.testing.assert_array_equal(rec["corpus"][:, :3].numpy(), ids.numpy())
    assert "== Final metrics ==" in text and "corpus IDs" in text
    if command == "train-hrqvae":
        train = want.tags_indices[want.item_is_train]
        counts, _, _ = j_remap(train, [int(train[:, i].max()) + 1 for i in range(3)], 3)
        assert rec["result"]["tag_class_counts"] == list(counts)
        assert f"remapped tag_class_counts: {list(counts)}" in text
        assert "tag predictions vs ground truth" in text and rec["truth"].shape == (5, 3)
    else:
        assert "(last col = dedup rank)" in text and rec["corpus"].shape == (500, 4)


def jax_eval_ids(feats, widths, chunk):
    """The JAX script's eval-mode IDs (scripts/diag_mining.py:45-52)."""
    from hidvae_tpu.train.transformer import _build_tokenizer

    tok = _build_tokenizer(use_h_tokenizer=True, pretrained_rqvae_path=str(STAGE1),
                           tag_alignment_weight=0.15, tag_prediction_weight=0.55,
                           use_dedup_dim=False, use_concatenated_ids=True,
                           use_interleaved_ids=False, commitment_weight=0.4,
                           rng=jax.random.key(0), **widths)
    model, variables = tok.hrq_vae, tok.variables

    @jax.jit
    def eval_ids(x):
        enc = model.apply(variables, x, method=lambda m, v: m.encode(v))
        return model.apply(variables, enc, method=lambda m, e: m.get_semantic_ids(e)).sem_ids

    x = jnp.asarray(feats).reshape(-1, chunk, feats.shape[1])
    return np.asarray(jax.lax.map(eval_ids, x).reshape(len(feats), -1))


def test_diag_mining_eval_ids_and_pairs_equal_jax(tmp_path):
    """On the tracked synthetic HiD-VAE checkpoint (L 3; its recorded n_layers
    wins over the script's 4 in both packages) and the tracked corpus."""
    diag = load_script("torch_diag_mining")
    load_script("export_flax_checkpoint").export_checkpoint(str(STAGE1), str(tmp_path / "s1"))
    widths = dict(diag.WIDTHS, tag_class_counts=[9, 33, 127])  # the run's remapped counts
    n, chunk = 1900, 100
    got = diag.diag(str(tmp_path / "s1"), str(ROOT / "dataset/synthetic"), n, "cpu", chunk,
                    widths=widths)
    feats = np.load(ROOT / "dataset/synthetic/processed/synthetic.npz")
    feats = feats["item_features"][feats["item_is_train"]][:n]
    want = jax_eval_ids(feats, widths, chunk)
    assert want.shape == (n, 3)
    np.testing.assert_array_equal(got["ids_eval"], want)
    # The script's harvest (diag_mining.py:56-65) on JAX's IDs.
    _, inverse = np.unique(want, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    same = inverse[order[:-1]] == inverse[order[1:]]
    pa, pb = order[:-1][same], order[1:][same]
    sel = np.random.RandomState(0).choice(len(pa), min(128, len(pa)), replace=False)
    assert got["found"] == len(pa) > 0
    np.testing.assert_array_equal(got["pairs"][0], pa[sel])
    np.testing.assert_array_equal(got["pairs"][1], pb[sel])
    rates = got["rates"]
    assert rates["pairs equal under eval-mode ids"] == 1.0
    assert all(0.0 <= v <= 1.0 for v in rates.values()), rates


def test_attrib_at_smoke_size(tmp_path):
    """Three programs and the beam step; the forward's counted FLOPs are the
    products of the widths: 8 x 30-token histories, 2 layers of 512, MLP 1024."""
    prof = load_script("torch_train_profile")
    rep = prof.attrib("cpu", smoke=True, iters=1, warmup=1, beam_iters=1,
                      trace_dir=str(tmp_path))
    assert {"fwd", "fwd+bwd", "full_step", "beam", "attribution_ms"} <= set(rep)
    assert Path(rep["trace"]).exists() and rep["beam"][8]["flops"] > 0
    B, E, A, H, K = 8, 128, 512, 1024, 32
    tc, td = 31, 7  # user token + 30 history tokens; BOS + 6 digits
    enc = tc * E * A + tc * 4 * A * A + 2 * tc * tc * A + 2 * tc * A * H
    dec = (td * E * A + td * 6 * A * A + tc * 2 * A * A + 2 * (td * td + td * tc) * A
           + 2 * td * A * H + td * A * K)
    assert rep["fwd"]["flops"] == pytest.approx(2 * B * (enc + dec), rel=0.01)
    assert rep["fwd+bwd"]["flops"] > 2 * rep["fwd"]["flops"]
    assert rep["fwd"]["share_of_peak"] is None  # no share of the card's peak from a CPU run


def test_rq_assign_plain_at_d16_matches_jax_reference():
    """The view tools' launch shape: 500 rows, L 3, K 64, D 16."""
    rng = np.random.RandomState(16)
    x = rng.randn(500, 16).astype(np.float32)
    cbs = rng.randn(3, 64, 16).astype(np.float32)
    ids, qsum = rq.rq_assign_auto(torch.from_numpy(x), torch.from_numpy(cbs))
    ids_j, qsum_j = jrq.rq_assign_reference(jnp.asarray(x), jnp.asarray(cbs))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(qsum.numpy(), np.asarray(qsum_j), rtol=0, atol=1e-5)
    rq.check_dim(16, "cuda")
