"""The port's raw-file builders against the JAX package's, bitwise: the
hash text encoder, build_amazon, amazon-raw, build_movielens, load_or_build,
the stage-1 entry's remap on a built drop; sentence_transformers refused."""

import filecmp
import gzip
import os
import sys

import numpy as np
import pytest

import chip_smoke
from hidvae_tpu.data import amazon as jamazon
from hidvae_tpu.data import processed as jprocessed
from hidvae_tpu.data import text_embedding as jtext
from hidvae_tpu.data.movielens import build_movielens as j_build_movielens
from hidvae_tpu.train.tags import compute_rare_tag_remap, reconcile_tag_layers
from hidvae_tpu_torch.data import amazon, processed, text_embedding
from hidvae_tpu_torch.data.movielens import build_movielens
from tests._torch_common import ROOT, load_script, write_gin
from tests.test_data_builders import amazon_raw  # noqa: F401  (the P5 fixture)

KEYS = ("item_features", "item_is_train", "seq_users", "seq_items", "seq_fut", "seq_is_train",
        "seq_split", "tags_emb", "tags_indices", "user_features", "user_feature_ids")
DROP = dict(n_items=300, n_users=80, seed=42)


@pytest.fixture(autouse=True)
def no_text_model(monkeypatch):
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.delenv("HIDVAE_REQUIRE_TEXT_MODEL", raising=False)


def assert_same(got, want):
    """Every array of two ProcessedArrays, equal with equal dtypes; None
    where the other is None."""
    for k in KEYS:
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def drops(tmp_path_factory):
    """The P5 Sports drop at 300 items x 80 users, seed 42, written by the
    JAX script and by the port's preset."""
    root = tmp_path_factory.mktemp("drops")
    load_script("make_synthetic_amazon").main(str(root / "jax"), "sports", **DROP)
    load_script("torch_make_synthetic").main("amazon-raw", str(root / "port"), **DROP)
    return root


TEXTS = ["Title: Red Shampoo; Brand: Acme; ", "", "   ", "ünïcödé words words", "a b c d e f",
         "GenericTag2", "Café \"42\": A Story"]


def test_hash_embedding_and_cache_as_jax(tmp_path, monkeypatch):
    for dim in (8, 768):
        got, want = text_embedding._hash_embedding(TEXTS, dim), jtext._hash_embedding(TEXTS, dim)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    got = text_embedding.encode_text_feature(TEXTS, cache_dir=str(tmp_path / "port"))
    want = jtext.encode_text_feature(TEXTS, cache_dir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(got, want)
    assert text_embedding.encode_text_feature.encoder == "hash"
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax")
    name = os.listdir(tmp_path / "port")[0]
    assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name, shallow=False)
    # A cache either package wrote is read by the other (a planted one here).
    planted = np.full((len(TEXTS), 768), 0.5, np.float32)
    np.save(tmp_path / "jax" / name, planted)
    np.testing.assert_array_equal(
        text_embedding.encode_text_feature(TEXTS, cache_dir=str(tmp_path / "jax")), planted)
    assert text_embedding.encode_text_feature.encoder == "cache"
    monkeypatch.setenv("HIDVAE_REQUIRE_TEXT_MODEL", "1")
    for module in (text_embedding, jtext):
        with pytest.raises(ImportError):
            module.encode_text_feature(TEXTS)


def test_amazon_raw_preset_writes_the_jax_drop(drops):
    jax_raw, port_raw = drops / "jax/raw/sports", drops / "port/raw/sports"
    for name in ("sequential_data.txt", "datamaps.json"):
        assert filecmp.cmp(jax_raw / name, port_raw / name, shallow=False), name
    with gzip.open(jax_raw / "meta.json.gz") as a, gzip.open(port_raw / "meta.json.gz") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("with_tags", [True, False])
@pytest.mark.parametrize("layout", ["p5_fixture", "jax_drop"])
def test_build_amazon_as_jax(layout, with_tags, amazon_raw, drops, tmp_path):  # noqa: F811
    root, split = (amazon_raw, "beauty") if layout == "p5_fixture" else (str(drops / "jax"),
                                                                         "sports")
    vocab = os.path.join(root, "processed", f"tag_index_{split}.json")
    want = jamazon.build_amazon(root, split, with_tags=with_tags, cache_dir=str(tmp_path / "j"))
    want_vocab = open(vocab).read() if with_tags else None  # both packages write this path
    got = amazon.build_amazon(root, split, with_tags=with_tags, cache_dir=str(tmp_path / "p"))
    assert_same(got, want)
    if with_tags:
        assert open(vocab).read() == want_vocab
        assert got.tags_indices.shape[1] == 5 and got.tags_emb.shape[1:] == (5, 768)
    np.testing.assert_array_equal(amazon.item_split_95_5(12101), jamazon.item_split_95_5(12101))


def movielens_drop(root, fmt, genders="FM"):
    """chip_smoke's seeded drop at 60 movies and 2,000 ratings, checked for
    the cases it must hold."""
    chip_smoke.write_movielens_drop(str(root), fmt, 60, 2000, seed=3, genders=genders)
    raw = root / "raw"
    if fmt == "1m":
        movies = (raw / "movies.dat").read_text(encoding="ISO-8859-1")
        rows = np.array([r.split("::") for r in (raw / "ratings.dat").read_text().split()],
                        np.int64)
        occupations = {int(r.split("::")[3]) for r in (raw / "users.dat").read_text().split()}
        assert max(occupations) > 9
    else:
        movies = (raw / "movies.csv").read_text(encoding="utf-8")
        rows = np.loadtxt(raw / "ratings.csv", delimiter=",", skiprows=1).astype(np.int64)
    assert "(no genres listed)" in movies and ", The (Part" in movies and "é" in movies
    _, user_counts = np.unique(rows[:, 0], return_counts=True)
    _, movie_counts = np.unique(rows[:, 1], return_counts=True)
    _, ts_counts = np.unique(rows[:, 3], return_counts=True)
    assert user_counts.min() < 5 and movie_counts.min() < 5 and ts_counts.max() > 1
    return str(root)


@pytest.mark.parametrize("fmt,genders", [("1m", "FM"), ("1m", "M"), ("32m", "FM")])
def test_build_movielens_as_jax(fmt, genders, tmp_path):
    root = movielens_drop(tmp_path, fmt, genders)
    jds, ds = (jprocessed.RecDataset.ML_1M, processed.RecDataset.ML_1M) if fmt == "1m" else \
        (jprocessed.RecDataset.ML_32M, processed.RecDataset.ML_32M)
    want = j_build_movielens(root, jds, max_seq_len=8, cache_dir=str(tmp_path / "j"))
    got = build_movielens(root, ds, max_seq_len=8, cache_dir=str(tmp_path / "p"))
    assert_same(got, want)
    assert got.seq_is_train.any() and not got.seq_is_train.all()
    if fmt == "1m":
        assert got.user_features.shape[1] == 3
        assert set(got.user_features[:, 1]) == ({1.0} if genders == "M" else {0.0, 1.0})
    with pytest.raises(FileNotFoundError, match=f"ML-{fmt.upper()}"):
        build_movielens(str(tmp_path / "empty"), ds)


@pytest.mark.parametrize("dataset", ["AMAZON", "ML_1M", "ML_32M"])
def test_load_or_build_builds_as_jax(dataset, drops, tmp_path):
    """Missing or forced, each raw dataset is built and saved where JAX
    saves it, equal to JAX's; present, it is read."""
    ds, jds = processed.RecDataset[dataset], jprocessed.RecDataset[dataset]
    if dataset == "AMAZON":
        roots, split = [str(drops / "jax"), str(drops / "port")], "sports"
    else:
        roots = [movielens_drop(tmp_path / n, "1m" if dataset == "ML_1M" else "32m")
                 for n in ("jax", "port")]
        split = ""
    want = jprocessed.load_or_build(roots[0], jds, split, force_process=True)
    got = processed.load_or_build(roots[1], ds, split, force_process=True)
    assert_same(got, want)
    path = processed.processed_path(roots[1], ds, split)
    assert os.path.relpath(path, roots[1]) == os.path.relpath(
        jprocessed.processed_path(roots[0], jds, split), roots[0])
    assert_same(processed.ProcessedArrays.load(path), want)
    assert_same(processed.load_or_build(roots[1], ds, split), want)


def test_stage1_entry_on_a_built_drop_remaps_as_jax(drops, tmp_path):
    """h_rqvae_amazon.gin tiny, force_dataset_process, on the port's drop:
    the trainer builds the arrays; its rare-tag remap (3 levels) is JAX's."""
    import shutil

    root = tmp_path / "amazon"
    shutil.copytree(drops / "port" / "raw", root / "raw")
    gin = write_gin(tmp_path / "h.gin", (ROOT / "configs/h_rqvae_amazon.gin").read_text(),
                    iterations=1, eval_every=2, save_model_every=2, batch_size=16,
                    vae_hidden_dims=[32, 16], vae_embed_dim=8, vae_codebook_size=16,
                    force_dataset_process=True, dataset_folder=f'"{root}"',
                    save_dir_root=f'"{tmp_path / "runs"}"', eval_batches=1)
    result = load_script("torch_train_hidvae").main([gin, "--device", "cpu"])
    arrays = processed.ProcessedArrays.load(
        processed.processed_path(str(root), processed.RecDataset.AMAZON, "sports"))
    assert arrays.tags_indices.shape == (300, 5)
    train = arrays.tags_indices[arrays.item_is_train]
    _, tags = reconcile_tag_layers(arrays.tags_emb[arrays.item_is_train], train, 3)
    counts, _, rare = compute_rare_tag_remap(tags, [38, 168, 348], 30)
    assert list(result["tag_class_counts"]) == counts
    with np.load(tmp_path / "runs" / "special_tags_files" / "rare_tags.npz") as z:
        assert sorted(z.files) == sorted(str(k) for k in rare)
        for k, v in rare.items():
            assert z[str(k)].dtype == v.dtype
            np.testing.assert_array_equal(z[str(k)], v)
