"""The port's seeded corpora against the JAX package and the tracked
file, bitwise: `build_synthetic`, the presets against the JAX scripts'
arguments, files across packages, `load_or_build`."""

from pathlib import Path

import numpy as np
import pytest

from hidvae_tpu.data import processed as jprocessed
from hidvae_tpu.data.synthetic import build_synthetic as j_build_synthetic
from hidvae_tpu_torch.data import processed
from hidvae_tpu_torch.data.synthetic import build_synthetic
from tests._torch_common import load_script

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("item_features", "item_is_train", "seq_users", "seq_items", "seq_fut", "seq_is_train",
        "seq_split", "tags_emb", "tags_indices")


PRESETS = load_script("torch_make_synthetic").PRESETS


def assert_same(got, want):
    """Every array of two ProcessedArrays (or .npz mappings), bitwise."""
    for k in KEYS:
        a, b = (getattr(x, k) if hasattr(x, k) else x[k] for x in (got, want))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_default_corpus_equals_the_tracked_file():
    with np.load(ROOT / "dataset/synthetic/processed/synthetic.npz") as z:
        assert sorted(z.files) == sorted(KEYS)
        assert_same(build_synthetic(), z)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_equals_jax_at_the_preset_shapes(preset):
    kw = dict(PRESETS[preset], n_items=3_000, n_users=300)
    assert_same(build_synthetic(**kw), j_build_synthetic(**kw))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_are_the_jax_scripts_arguments(preset, tmp_path):
    script = load_script(f"make_synthetic_{preset}")
    calls = []

    def record(**kw):
        calls.append(kw)
        return j_build_synthetic(n_items=40, n_users=4)

    script.build_synthetic = record
    script.main(str(tmp_path))
    assert calls == [PRESETS[preset]]


def test_files_load_across_packages(tmp_path):
    """The port script's file read by JAX, a JAX file read by the port."""
    kw = dict(n_items=300, n_users=30)
    path = load_script("torch_make_synthetic").main("ml32m", str(tmp_path / "port"), **kw)
    want = j_build_synthetic(**{**PRESETS["ml32m"], **kw})
    assert_same(jprocessed.ProcessedArrays.load(path), want)
    jpath = str(tmp_path / "jax.npz")
    want.save(jpath)
    assert_same(processed.ProcessedArrays.load(jpath), want)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(KEYS)


def test_load_or_build_synthetic_as_jax(tmp_path):
    """Missing file: built at the defaults and saved (the split dropped);
    present: read as it is; forced: rebuilt over it."""
    got, want = (str(tmp_path / name) for name in ("port", "jax"))
    arrays = processed.load_or_build(got, processed.RecDataset.SYNTHETIC, "beauty")
    j_arrays = jprocessed.load_or_build(want, jprocessed.RecDataset.SYNTHETIC, "beauty")
    assert_same(arrays, j_arrays)
    path = processed.processed_path(got, processed.RecDataset.SYNTHETIC)
    assert path == jprocessed.processed_path(got, jprocessed.RecDataset.SYNTHETIC)
    with np.load(path) as z:
        assert_same(z, j_arrays)
    small = build_synthetic(n_items=50, n_users=5)
    small.save(path)
    assert_same(processed.load_or_build(got, processed.RecDataset.SYNTHETIC), small)
    assert_same(jprocessed.load_or_build(got, jprocessed.RecDataset.SYNTHETIC), small)
    # Forced, JAX builds as above (hidvae_tpu/data/processed.py:131-135).
    forced = processed.load_or_build(got, processed.RecDataset.SYNTHETIC, force_process=True)
    assert_same(forced, j_arrays)
    with np.load(path) as z:
        assert_same(z, j_arrays)


@pytest.mark.parametrize("dataset", ["AMAZON", "ML_1M", "ML_32M", "KUAIRAND"])
def test_raw_datasets_are_refused(dataset, tmp_path):
    """Read when present; missing or forced without raw files, refused, each
    builder naming the raw files it lacks."""
    ds = processed.RecDataset[dataset]
    path = processed.processed_path(str(tmp_path), ds, "beauty")
    lacks = {"AMAZON": r"P5 data drop", "ML_1M": r"ML-1M raw data not found",
             "ML_32M": r"ML-32M raw data not found",
             "KUAIRAND": r"KuaiRand raw data not found"}[dataset]
    with pytest.raises(FileNotFoundError, match=lacks):
        processed.load_or_build(str(tmp_path), ds, "beauty")
    build_synthetic(n_items=50, n_users=5).save(path)
    assert_same(processed.load_or_build(str(tmp_path), ds, "beauty"),
                processed.ProcessedArrays.load(path))
    with pytest.raises(FileNotFoundError, match=lacks):
        processed.load_or_build(str(tmp_path), ds, "beauty", force_process=True)
