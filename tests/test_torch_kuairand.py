"""The port's KuaiRand builder against the JAX package's, bitwise (arrays,
tag-index JSON), on drops that hit the pandas behaviours it reproduces;
kuairand-raw against scripts/make_synthetic_kuairand.py; load_or_build."""

import filecmp
import os

import numpy as np
import pytest

from hidvae_tpu.data import kuairand as jkuairand
from hidvae_tpu.data import processed as jprocessed
from hidvae_tpu_torch.data import kuairand, processed
from tests._torch_common import load_script
from tests.test_torch_raw_builders import assert_same, no_text_model  # noqa: F401

NA = ("NA", "null", "None", "n/a", "nan", "#N/A", "<NA>")
N_VIDEOS, N_USERS = 60, 30


write_csv = load_script("torch_make_synthetic").write_csv


def write_drop(root, layout="gaps", logs=(0, 1, 2), seed=0):
    """A small KuaiRand drop under root/raw/ with `logs`; `layout` makes
    the third level float by "gaps" or "blanks", or keeps "ints"."""
    rng = np.random.RandomState(seed)
    raw = root / "raw"
    raw.mkdir(parents=True)
    captions = []
    for v in range(N_VIDEOS):
        cap = f"视频{v} 类别{v % 5} 美妆 tok{v % 3}"
        cap = {3: "", 4: "  \t", 5: NA[v % len(NA)], 6: f'说 "好", {cap}', 7: "　"}.get(
            v % 13, cap)
        captions.append((v, cap))
    captions.insert(12, (10, "重复 caption 10"))  # a second caption row of video 10
    write_csv(raw / "kuairand_video_captions.csv", ("final_video_id", "caption"), captions)
    cats = []
    for v in range(N_VIDEOS):
        if layout == "gaps" and v % 11 == 6:
            continue  # no category row: the join leaves its levels missing
        l2 = ("UNKNOWN" if v % 9 == 2 else NA[v % len(NA)] if v % 9 == 5 else f"二级_{v % 7}")
        l3 = "" if layout == "blanks" and v % 5 == 0 else str(10 + v % 6)
        cats.append((v, f"一级{v % 4}", l2, l3))
        if v == 21:  # a duplicate category row, another level 1
            cats.append((v, "一级9", "二级_x", "7"))
    write_csv(raw / "kuairand_video_categories.csv",
              ("final_video_id", *kuairand.LEVEL_COLS), cats)
    rows = []  # (user, video, time_ms, is_click)
    clicks = [25, 25, 25, 22, 22, 30, 21, 21, 10, 10] * 3
    for u, n in enumerate(clicks):
        uid, t = 1000 + 7 * ((u * 13) % N_USERS), 1_649_000_000_000 + u
        for k in range(n):
            t += 0 if rng.rand() < 0.15 else int(rng.randint(1, 5000))  # ties
            # user 26: active, but with only 2 clicks of catalog videos
            v = int(rng.randint(60, 65)) if u == 26 and k > 1 else int(rng.randint(N_VIDEOS))
            rows.append((uid, v, t, 1))
            if rng.rand() < 0.3:
                rows.append((uid, int(rng.randint(N_VIDEOS)), t, 0))
    file_of = rng.randint(0, 3, len(rows))
    for i, name in enumerate(kuairand.LOG_FILES):
        if i in logs:
            part = [r for r, f in zip(rows, file_of) if f == i]
            write_csv(raw / name, ("user_id", "video_id", "date", "time_ms", "is_click", "tab"),
                      [(u, v, 20220408, t, c, 1) for u, v, t, c in part])
    return str(root)


def build_both(root, tmp_path, **options):
    want = jkuairand.build_kuairand(root, cache_dir=str(tmp_path / "j"), **options)
    vocab = os.path.join(root, "processed", "kuairand_tag_index.json")
    want_vocab = open(vocab, "rb").read()
    os.remove(vocab)
    got = kuairand.build_kuairand(root, cache_dir=str(tmp_path / "p"), **options)
    assert open(vocab, "rb").read() == want_vocab
    assert_same(got, want)
    return got


OPTIONS = {
    "defaults": dict(),
    "max_users": dict(max_users=8),
    "max_videos": dict(max_videos=15),
    "all": dict(max_users=9, max_videos=12, max_seq_len=6, min_user_interactions=22,
                random_seed=7),
}


@pytest.mark.parametrize("options", list(OPTIONS))
@pytest.mark.parametrize("layout", ["gaps", "blanks", "ints"])
def test_build_kuairand_as_jax(layout, options, tmp_path):
    got = build_both(write_drop(tmp_path / "drop", layout), tmp_path, **OPTIONS[options])
    n = len(got.item_features)
    assert got.tags_emb.shape == (n, 3, 768) and (got.seq_split == 2).sum() > 0
    if options == "max_videos":
        assert n <= 17


@pytest.mark.parametrize("logs", [(0, 2), (0, 1), (0,)])
def test_build_kuairand_with_missing_logs_as_jax(logs, tmp_path):
    build_both(write_drop(tmp_path / "drop", "blanks", logs, seed=1), tmp_path,
               min_user_interactions=8)
    with pytest.raises(FileNotFoundError, match="KuaiRand raw data not found"):
        kuairand.build_kuairand(str(tmp_path / "none"))


def test_csv_typing_as_pandas():
    """Fields typed as pd.read_csv types them on this host, and the category
    strings fillna("").astype(str) makes of them."""
    import pandas as pd

    cases = [["12", " 3", "+4", "-0"], ["12", ""], ["1e5", ".5", "5.", "inf", "-Infinity"],
             ["True", "false", "TRUE"], ["True", "NA"], ["1_000", "2"], ["0x10", "1"],
             ["1", "x"], ["  ", "1"], ["１２", "1"], ["NAN", "1"], ["1.5E+03", "null"],
             ["12345678901234567890123", "1"], ["1", "2.5", "None"]]
    for fields in cases:
        text = "a\n" + "".join(f'"{f}"\n' for f in fields)
        want = pd.read_csv(__import__("io").StringIO(text))["a"].fillna("").astype(str)
        assert kuairand.Column(fields).texts() == want.tolist(), fields


def test_kuairand_raw_preset_writes_the_jax_drop(tmp_path):
    size = dict(n_videos=400, n_users=60, seed=0)
    load_script("make_synthetic_kuairand").main(str(tmp_path / "jax"), **size)
    load_script("torch_make_synthetic").main("kuairand-raw", str(tmp_path / "port"), **size)
    names = sorted(os.listdir(tmp_path / "jax" / "raw"))
    assert names == sorted(os.listdir(tmp_path / "port" / "raw")) and len(names) == 6
    for name in names:
        assert filecmp.cmp(tmp_path / "jax/raw" / name, tmp_path / "port/raw" / name,
                           shallow=False), name
    got = build_both(str(tmp_path / "port"), tmp_path)
    assert got.seq_items.shape[1] == 40 and got.tags_indices[:, 2].max() < 353


def test_load_or_build_builds_kuairand_as_jax(tmp_path):
    """Missing or forced, KUAIRAND is built from <root>/raw/ whatever the
    split and saved where JAX saves it; present, it is read."""
    roots = [write_drop(tmp_path / n, "gaps", seed=2) for n in ("jax", "port")]
    for split in ("beauty", "kuairand"):
        want = jprocessed.load_or_build(roots[0], jprocessed.RecDataset.KUAIRAND, split)
        got = processed.load_or_build(roots[1], processed.RecDataset.KUAIRAND, split)
        assert_same(got, want)
        path = processed.processed_path(roots[1], processed.RecDataset.KUAIRAND, split)
        assert path.endswith(f"processed/kuairand_{split}.npz")
        assert_same(processed.ProcessedArrays.load(path), want)
    assert_same(processed.load_or_build(roots[1], processed.RecDataset.KUAIRAND, "kuairand",
                                        force_process=True), want)
