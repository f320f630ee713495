"""`from_artifacts` on exports against the JAX engine on Orbax checkpoints:
converter leaves, the synthetic and a tiny plain pair, stale and legacy
metas, the audit, the bridge, the gin reader."""

import enum
import json
import logging
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from hidvae_tpu.data.processed import ProcessedArrays as JArrays
from hidvae_tpu.data.processed import SeqData as JSeqData
from hidvae_tpu.data.processed import RecDataset as JRecDataset
from hidvae_tpu.models.retrieval import EncoderDecoderRetrievalModel as JModel
from hidvae_tpu.models.rqvae import RqVae as JRqVae
from hidvae_tpu.serve import RetrievalEngine as JEngine
from hidvae_tpu.tokenizer import SemanticIdTokenizer as JTokenizer
from hidvae_tpu.train import common as jcommon
from hidvae_tpu.utils.ginlite import parse_gin_file as jparse
from hidvae_tpu_torch.bridge import flax_to_state_dict, load_export, state_dict_to_flax
from hidvae_tpu_torch.models.rqvae import RqVae
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from hidvae_tpu_torch.train import common as tcommon
from hidvae_tpu_torch.utils.ginlite import parse_gin_file as tparse
from tests._torch_common import (
    flat,
    japply,
    jax_example_batch,
    load_script,
    random_variables,
    retrieval_pair,
    unflat,
    write_gin,
)

ROOT = Path(__file__).resolve().parent.parent
STAGE1 = ROOT / "out/hrqvae/synthetic/hrqvae_SYNTHETIC_20260816_065118/latest"
# Its train.log restores STAGE1; checkpoint_99's run left no log naming its
# stage-1 checkpoint, so it is not paired with STAGE1 here.
STAGE2 = ROOT / "out/decoder/synthetic/decoder_SYNTHETIC_20260816_072308/checkpoint_39"
SYNTHETIC_TAG_COUNTS = [9, 33, 127]  # the stage-1 run's remapped counts (its train.log)
SCORE_ATOL = 1e-4
N_HIST = 8


export_checkpoint = load_script("export_flax_checkpoint").export_checkpoint


def _assert_same_serving(j_engine, t_engine, hist, users):
    np.testing.assert_array_equal(t_engine.corpus_ids.numpy(), np.asarray(j_engine.corpus_ids))
    want = j_engine.recommend(hist, user_ids=users)
    got = t_engine.recommend(hist, user_ids=users)
    np.testing.assert_array_equal(got["items"], want["items"])
    np.testing.assert_array_equal(got["sem_ids"], want["sem_ids"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=SCORE_ATOL)
    assert (got["items"] >= 0).any()


# ---- the tracked synthetic pair (H route) ---------------------------------

@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    d = tmp_path_factory.mktemp("synthetic")
    base = (ROOT / "configs/decoder_synthetic.gin").read_text()
    gin = write_gin(d / "serve.gin", base, tag_class_counts=SYNTHETIC_TAG_COUNTS,
               dataset_folder=f'"{ROOT / "dataset/synthetic"}"')
    s1 = export_checkpoint(str(STAGE1), str(d / "s1"))
    s2 = export_checkpoint(str(STAGE2), str(d / "s2"))
    j_engine = JEngine.from_artifacts(gin, str(STAGE1), str(STAGE2), batch_buckets=(N_HIST,))
    t_engine = RetrievalEngine.from_artifacts(gin, str(d / "s1"), str(d / "s2"), device="cpu",
                                              batch_buckets=(N_HIST,))
    test = JSeqData(str(ROOT / "dataset/synthetic"), JRecDataset.SYNTHETIC, seq_split="test")
    return dict(dir=d, base=base, gin=gin, written={"stage1": s1, "stage2": s2},
                j=j_engine, t=t_engine, hist=test.items[:N_HIST], users=test.users[:N_HIST])


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_converter_writes_what_jax_restores(synthetic, stage):
    """Every leaf JAX's from_artifacts restores equals the converter's,
    bitwise; no optimizer state; meta.json copied byte for byte."""
    j = synthetic["j"]
    src, d = (STAGE1, "s1") if stage == "stage1" else (STAGE2, "s2")
    target = ({"params": j.tokenizer.variables["params"],
               "batch_stats": j.tokenizer.variables["batch_stats"]}
              if stage == "stage1" else {"params": j.params})
    with np.load(synthetic["dir"] / d / "arrays.npz") as z:
        written = {k: z[k] for k in z.files}
    assert set(written) == set(synthetic["written"][stage])
    assert "step" in written and not any(k.startswith("opt_state") for k in written)
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(target, sep="/").items()}
    assert set(want) == {k for k in written if k != "step"}
    for key, value in want.items():
        assert written[key].dtype == value.dtype, key
        np.testing.assert_array_equal(written[key], value, err_msg=key)
    assert (synthetic["dir"] / d / "meta.json").read_bytes() == (src / "meta.json").read_bytes()


def test_synthetic_pair_serves_as_jax(synthetic):
    assert synthetic["t"].corpus_ids.shape == (2000, 3)
    _assert_same_serving(synthetic["j"], synthetic["t"], synthetic["hist"], synthetic["users"])


def test_wrong_stage1_tag_counts_only_warn(synthetic, caplog):
    """Pre-remap tag counts mismatch 6 tag-head leaves (under tolerance):
    warnings; the semantic columns are JAX's."""
    gin = write_gin(synthetic["dir"] / "wrong_tags.gin", synthetic["base"],
               dataset_folder=f'"{ROOT / "dataset/synthetic"}"')
    with caplog.at_level(logging.WARNING):
        engine = RetrievalEngine.from_artifacts(gin, str(synthetic["dir"] / "s1"),
                                                str(synthetic["dir"] / "s2"), device="cpu",
                                                batch_buckets=(N_HIST,))
    mismatched = [r.getMessage() for r in caplog.records if "shape mismatch" in r.getMessage()]
    assert len(mismatched) == 6 and all("tag_predictor" in m for m in mismatched), mismatched
    np.testing.assert_array_equal(engine.corpus_ids.numpy(),
                                  np.asarray(synthetic["j"].corpus_ids))


# ---- the plain RQ-VAE route at tiny widths --------------------------------

PLAIN = dict(input_dim=32, hidden_dims=[16], embed_dim=8, codebook_size=32, n_layers=3,
             decoder_embed_dim=16, attn_embed_dim=32, attn_heads=4, attn_layers=2)
N_ITEMS, MAX_SEQ, N_SEQ = 120, 5, 24


def _seed_codebooks(params, feats):
    """Each level's codebook set to K items' residuals (k-means seeding),
    spreading the tiny corpus. Returns its IDs (numpy's argmin cascade)."""
    jm = JRqVae(input_dim=PLAIN["input_dim"], embed_dim=PLAIN["embed_dim"],
                hidden_dims=tuple(PLAIN["hidden_dims"]),
                codebook_size=PLAIN["codebook_size"], n_layers=PLAIN["n_layers"])
    res = np.asarray(japply(jm, {"params": unflat(params)}, JRqVae.encode, jnp.asarray(feats)),
                     np.float64)
    rng = np.random.RandomState(3)
    ids = []
    for level in range(PLAIN["n_layers"]):
        cb = res[rng.choice(len(res), PLAIN["codebook_size"], replace=False)]
        params[f"quantize_{level}/embedding"] = cb.astype(np.float32)
        pick = np.argmin(((res[:, None] - cb[None]) ** 2).sum(-1), axis=1)
        ids.append(pick)
        res = res - cb[pick]
    return np.stack(ids, 1)


def _plain_artifacts(root: Path, dedup: bool):
    """JAX RqVae + decoder checkpoints (save_checkpoint, with full meta), a
    tiny processed dataset, and a gin; returns their paths."""
    rng = np.random.RandomState(11)
    feats = rng.randn(N_ITEMS, PLAIN["input_dim"]).astype(np.float32)
    items = rng.randint(0, N_ITEMS, (N_SEQ, MAX_SEQ)).astype(np.int32)
    items[::3, 3:] = -1
    data_dir = root / "data"
    JArrays(item_features=feats, item_is_train=np.ones(N_ITEMS, bool),
            seq_users=np.arange(N_SEQ, dtype=np.int32), seq_items=items,
            seq_fut=rng.randint(0, N_ITEMS, N_SEQ).astype(np.int32),
            seq_is_train=np.ones(N_SEQ, bool),
            seq_split=np.repeat(np.int8([0, 1, 2]), N_SEQ // 3),
            ).save(str(data_dir / "processed" / "synthetic.npz"))

    vae = JRqVae(input_dim=PLAIN["input_dim"], embed_dim=PLAIN["embed_dim"],
                 hidden_dims=tuple(PLAIN["hidden_dims"]),
                 codebook_size=PLAIN["codebook_size"], n_layers=PLAIN["n_layers"],
                 n_cat_features=0)
    vae_params = random_variables(vae, (jnp.zeros((2, PLAIN["input_dim"])), 0.2, False),
                                  seed=4)["params"]
    ids = _seed_codebooks(vae_params, feats)
    rep = jcommon.repetition_rate(ids)[0]
    assert rep < 0.1  # the audit's guard is live
    s1 = jcommon.save_checkpoint(str(root), "stage1", {
        "params": unflat(vae_params), "step": jnp.zeros((), jnp.int32),
        "model_config": jcommon.structural_model_config(vae),
        "metrics": {"repetition_rate": rep},
    })

    d = PLAIN["n_layers"] + dedup
    dec = JModel(embedding_dim=PLAIN["decoder_embed_dim"], attn_dim=PLAIN["attn_embed_dim"],
                 dropout=0.1, num_heads=PLAIN["attn_heads"], n_layers=PLAIN["attn_layers"],
                 num_embeddings=PLAIN["codebook_size"], sem_id_dim=d, max_pos=MAX_SEQ * d,
                 n_sem_layers=PLAIN["n_layers"])
    example = jax_example_batch(d)
    dec_params = random_variables(dec, (example, False), seed=5)["params"]
    s2 = jcommon.save_checkpoint(str(root), "stage2", {
        "params": unflat(dec_params), "step": jnp.zeros((), jnp.int32),
        "model_config": {
            "attn_dim": PLAIN["attn_embed_dim"], "attn_embed_dim": PLAIN["attn_embed_dim"],
            "attn_heads": PLAIN["attn_heads"], "attn_layers": PLAIN["attn_layers"],
            "decoder_embed_dim": PLAIN["decoder_embed_dim"], "sem_id_dim": d,
            "num_embeddings": PLAIN["codebook_size"], "n_sem_layers": PLAIN["n_layers"],
            "use_interleaved_ids": False, "max_pos": MAX_SEQ * d,
        },
        "metrics": {},
    })
    base = "\n".join([
        "import data.processed",
        f'train.dataset_folder = "{data_dir}"',
        "train.dataset = %data.processed.RecDataset.SYNTHETIC",
        f"train.vae_input_dim = {PLAIN['input_dim']}",
        f"train.vae_hidden_dims = {PLAIN['hidden_dims']}",
        f"train.vae_embed_dim = {PLAIN['embed_dim']}",
        f"train.vae_codebook_size = {PLAIN['codebook_size']}",
        "train.vae_n_cat_feats = 0",
        "train.use_h_tokenizer = False",
        f"train.use_dedup_dim = {dedup}",
        f"train.decoder_embed_dim = {PLAIN['decoder_embed_dim']}",
        f"train.attn_embed_dim = {PLAIN['attn_embed_dim']}",
        f"train.attn_heads = {PLAIN['attn_heads']}",
        f"train.attn_layers = {PLAIN['attn_layers']}",
    ])
    return dict(s1=s1, s2=s2, base=base, data=data_dir, items=items, feats=feats,
                vae=vae, vae_params=vae_params)


PLAIN_CASES = {  # use_interleaved_ids is ignored on the plain route (PARITY.md #12)
    "semantic": dict(dedup=False, interleaved=False),
    "dedup": dict(dedup=True, interleaved=False),
    "interleaved_ignored": dict(dedup=False, interleaved=True),
}


@pytest.fixture(scope="module")
def plain_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("plain")
    arts = {dedup: _plain_artifacts(root / f"dedup_{dedup}", dedup) for dedup in (False, True)}
    for a in arts.values():
        for s in ("s1", "s2"):
            export_checkpoint(a[s], a[s] + "_export")
    return root, arts


def _both_engines(art, gin):
    j = JEngine.from_artifacts(gin, art["s1"], art["s2"], batch_buckets=(N_HIST,))
    t = RetrievalEngine.from_artifacts(gin, art["s1"] + "_export", art["s2"] + "_export",
                                       device="cpu", batch_buckets=(N_HIST,))
    return j, t


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_route_serves_as_jax(plain_root, case):
    root, arts = plain_root
    dedup, interleaved = PLAIN_CASES[case]["dedup"], PLAIN_CASES[case]["interleaved"]
    art = arts[dedup]
    gin = write_gin(root / f"{case}.gin", art["base"], use_interleaved_ids=interleaved)
    j, t = _both_engines(art, gin)
    assert isinstance(t.tokenizer, SemanticIdTokenizer)
    assert t.sem_id_dim == 3 + dedup and not t.model.sem_id_embedder.use_interleaved_ids
    hist = art["items"][:N_HIST]
    _assert_same_serving(j, t, hist, np.arange(N_HIST))


def test_stale_decoder_gin_heals_from_meta(plain_root):
    """Wrong decoder geometry in the gin, full meta in the checkpoint: the
    engine adopts the checkpoint's values and serves as the right gin does."""
    root, arts = plain_root
    art = arts[False]
    good = write_gin(root / "good.gin", art["base"])
    bad = write_gin(root / "bad.gin", art["base"], attn_heads=8, attn_layers=4, attn_embed_dim=64)
    t = RetrievalEngine.from_artifacts(bad, art["s1"] + "_export", art["s2"] + "_export",
                                       device="cpu", batch_buckets=(N_HIST,))
    m = t.model
    assert (m.num_heads, m.n_layers, m.attn_dim) == (
        PLAIN["attn_heads"], PLAIN["attn_layers"], PLAIN["attn_embed_dim"])
    j = JEngine.from_artifacts(good, art["s1"], art["s2"], batch_buckets=(N_HIST,))
    _assert_same_serving(j, t, art["items"][:N_HIST], np.arange(N_HIST))


@pytest.mark.parametrize("geometry", [
    dict(attn_layers=4, attn_embed_dim=64),  # leaves of other shapes, and missing ones
    dict(attn_layers=4),                     # only missing leaves: the extra blocks
])
def test_legacy_meta_with_wrong_geometry_is_refused(plain_root, tmp_path, geometry):
    """A legacy {attn_dim, sem_id_dim} meta cannot heal a wrong gin: both
    packages refuse the structurally incompatible restore."""
    root, arts = plain_root
    art = arts[False]
    bad = write_gin(tmp_path / "bad.gin", art["base"], **geometry)
    legacy = {"model_config": {"attn_dim": PLAIN["attn_embed_dim"], "sem_id_dim": 3},
              "metrics": {}}
    dirs = {}
    for name, src in (("orbax", art["s2"]), ("export", art["s2"] + "_export")):
        dst = tmp_path / name
        shutil.copytree(src, dst)
        (dst / "meta.json").write_text(json.dumps(legacy))
        dirs[name] = str(dst)
    with pytest.raises(ValueError, match="structurally incompatible"):
        JEngine.from_artifacts(bad, art["s1"], dirs["orbax"], batch_buckets=(N_HIST,))
    with pytest.raises(ValueError, match="structurally incompatible"):
        RetrievalEngine.from_artifacts(bad, art["s1"] + "_export", dirs["export"],
                                       device="cpu", batch_buckets=(N_HIST,))


def test_from_artifacts_defaults_to_cuda(plain_root):
    root, arts = plain_root
    gin = write_gin(root / "default_device.gin", arts[False]["base"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalEngine.from_artifacts(gin, arts[False]["s1"] + "_export",
                                       arts[False]["s2"] + "_export")


def test_missing_dataset_names_its_path(tmp_path):
    from hidvae_tpu_torch.data.processed import ItemData, RecDataset

    # No processed file and no raw files: the builder names the raw file it lacks.
    with pytest.raises(FileNotFoundError, match=rf"{tmp_path}/raw/movies\.csv"):
        ItemData(str(tmp_path), RecDataset.ML_32M, split="beauty")


# ---- the corpus audit -----------------------------------------------------

def _seeded_table(seed, n=200, k=16, levels=3, dup_share=0.0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, k, (n, levels)).astype(np.int32)
    n_dup = int(dup_share * n)
    ids[:n_dup] = ids[0]
    return ids


@pytest.mark.parametrize("seed,dup_share,sem_cols", [
    (0, 0.0, None), (1, 0.3, None), (2, 0.7, [0, 2]), (3, 0.95, [0, 1]),
])
def test_diversity_and_collapse_match_jax(seed, dup_share, sem_cols):
    ids = _seeded_table(seed, dup_share=dup_share)
    want = jcommon.id_diversity_metrics(ids, 16, 3, sem_cols=sem_cols)
    got = tcommon.id_diversity_metrics(ids, 16, 3, sem_cols=sem_cols)
    assert got == want
    assert tcommon.repetition_rate(ids) == jcommon.repetition_rate(ids)
    for recorded in (None, 0.05, 0.09, 0.1, 0.4):
        assert (tcommon.corpus_collapse_error(recorded, got)
                == jcommon.corpus_collapse_error(recorded, want))


def test_collapsed_table_is_refused_by_both_engines(plain_root, tmp_path):
    """Every codebook row the same: every item gets one ID tuple. Against a
    stage-1 meta that recorded a repetition rate of 0.05, both engines raise."""
    _, arts = plain_root
    art = arts[False]
    params = dict(art["vae_params"])
    for level in range(PLAIN["n_layers"]):
        cb = params[f"quantize_{level}/embedding"]
        params[f"quantize_{level}/embedding"] = np.repeat(cb[:1], len(cb), axis=0)
    meta_dir = tmp_path / "stage1"
    meta_dir.mkdir()
    (meta_dir / "meta.json").write_text(json.dumps({"metrics": {"repetition_rate": 0.05}}))
    jdec, dec_params, tdec = _tiny_decoder()
    kw = dict(n_layers=PLAIN["n_layers"], codebook_size=PLAIN["codebook_size"])
    jtok = JTokenizer(art["vae"], {"params": unflat(params)}, **kw)
    tvae = RqVae(PLAIN["input_dim"], PLAIN["embed_dim"], PLAIN["hidden_dims"],
                 PLAIN["codebook_size"], n_layers=PLAIN["n_layers"])
    tvae.load_state_dict(flax_to_state_dict(params))
    ttok = SemanticIdTokenizer(tvae, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="Corpus ID table collapsed"):
        JEngine(jdec, dec_params, jtok, jnp.asarray(art["feats"]), max_seq_len=MAX_SEQ,
                stage1_checkpoint=str(meta_dir))
    with pytest.raises(RuntimeError, match="Corpus ID table collapsed"):
        RetrievalEngine(tdec, ttok, art["feats"], max_seq_len=MAX_SEQ,
                        stage1_checkpoint=str(meta_dir), device="cpu")


def _tiny_decoder():
    return retrieval_pair(embedding_dim=PLAIN["decoder_embed_dim"],
                          attn_dim=PLAIN["attn_embed_dim"], num_heads=PLAIN["attn_heads"],
                          n_layers=PLAIN["attn_layers"], num_embeddings=PLAIN["codebook_size"],
                          sem_id_dim=3, max_pos=MAX_SEQ * 3)


# ---- weight bridge and gin reader -----------------------------------------

def _jax_init(name):
    """(flax variables from the JAX package's own init, jit-compiled, and
    the port module of the same structure)."""
    from hidvae_tpu.models.hrqvae import HRqVae as JHRqVae

    from hidvae_tpu_torch.models.hrqvae import HRqVae
    from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel

    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "gumbel", "dropout", "mixup"))}
    if name == "hrqvae":
        jm = JHRqVae(input_dim=32, embed_dim=8, hidden_dims=(16,), codebook_size=16,
                     n_cat_features=0, tag_class_counts=(4, 6, 8), tag_embed_dim=12,
                     codebook_normalize=True)
        args = (jnp.zeros((4, 32)), jnp.zeros((4, 3, 12)), jnp.zeros((4, 3), jnp.int32), 0.2)
        variables = jax.jit(lambda r: jm.init(r, *args, train=False))(rngs)
        tm = HRqVae(32, 8, (16,), 16, codebook_normalize=True, tag_class_counts=(4, 6, 8),
                    tag_embed_dim=12)
    elif name == "rqvae":
        jm = JRqVae(input_dim=32, embed_dim=8, hidden_dims=(16,), codebook_size=16,
                    codebook_sim_vq=True, n_cat_features=0)
        variables = jax.jit(lambda r: jm.init(r, jnp.zeros((2, 32)), 0.2, False))(rngs)
        tm = RqVae(32, 8, (16,), 16, codebook_sim_vq=True)
    else:
        jm, _, tm = _tiny_decoder()
        example = jax_example_batch(3)
        variables = jax.jit(lambda r: jm.init(r, example, False))(rngs)
    return variables, tm


@pytest.mark.parametrize("name", ["hrqvae", "rqvae", "retrieval"])
def test_state_dict_to_flax_inverts_the_bridge(name, tmp_path):
    variables, module = _jax_init(name)
    params = flat(variables["params"])
    stats = flat(variables.get("batch_stats", {}))
    module.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    got_params, got_stats = state_dict_to_flax(module)
    for got, want in ((got_params, params), (got_stats, stats)):
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # save_export / load_export carry the same leaves and the meta.
    from hidvae_tpu_torch.bridge import save_export

    meta = {"model_config": {"embed_dim": 8}, "metrics": {"repetition_rate": 0.01}}
    p, s, m = load_export(save_export(str(tmp_path / name), module, meta))
    assert m == meta and set(p) == set(params) and set(s) == set(stats)
    for key in params:
        np.testing.assert_array_equal(p[key], params[key], err_msg=key)


def _by_name(value, modules):
    """The parsed config with every enum member as (class name, member
    name); the module of each enum class goes into `modules`."""
    if isinstance(value, dict):
        return {k: _by_name(v, modules) for k, v in value.items()}
    if isinstance(value, list):
        return [_by_name(v, modules) for v in value]
    if isinstance(value, enum.Enum):
        modules.add(type(value).__module__.split(".")[0])
        return (type(value).__name__, value.name)
    return value


@pytest.mark.parametrize("gin", sorted(p.name for p in (ROOT / "configs").glob("*.gin")))
def test_gin_files_parse_as_in_jax(gin):
    path = str(ROOT / "configs" / gin)
    got_modules, want_modules = set(), set()
    assert _by_name(tparse(path), got_modules) == _by_name(jparse(path), want_modules)
    assert got_modules == {"hidvae_tpu_torch"} and want_modules == {"hidvae_tpu"}
