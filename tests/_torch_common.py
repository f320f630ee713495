"""Shared helpers of the port's parity tests: flax variables flattened to
numpy, as the bridge takes them, and the JAX/torch model pairs built from
the same weights at small widths."""

import enum
import functools
import importlib.util
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from hidvae_tpu_torch.bridge import load_flax_weights

ROOT = Path(__file__).resolve().parent.parent

# One intra-op thread per test process: a thread pool in every xdist worker
# oversubscribes the cores and slows small ops several times.
torch.set_num_threads(1)


def load_script(name):
    """scripts/<name>.py of this checkout as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_batch_indices(seed, steps, batch, n):
    """The batch indices of the JAX stage-1 trainers' steps (hidvae.py:645,
    :654-655; rqvae.py:244-248)."""
    root = jax.random.fold_in(jax.random.key(seed), 0x5EED)
    out = {}
    for s in steps:
        r_sample, _ = jax.random.split(jax.random.fold_in(root, s))
        out[s] = torch.from_numpy(np.array(jax.random.randint(r_sample, (batch,), 0, n)))
    return out


def write_gin(path, base, **overrides):
    """Write `base` (gin text) with `train.<key> = <value>` lines replaced or
    appended for each override. Returns the path."""
    lines = [ln for ln in base.splitlines()
             if ln.split("=")[0].strip().removeprefix("train.") not in overrides]
    lines += [f"train.{k} = {v}" for k, v in overrides.items()]
    Path(path).write_text("\n".join(lines) + "\n")
    return str(path)


def spy(fn):
    """A stand-in for `fn` that returns the keywords it is called with."""
    @functools.wraps(fn)
    def bound(**kwargs):
        return kwargs
    return bound


def norm(v):
    """An enum as (its type's name, its name), a tuple as a list."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    return list(v) if isinstance(v, tuple) else v


def assert_keywords_as_jax(jfn, fn):
    """Every keyword of the JAX `jfn`, with its default, is a keyword of `fn`.
    Returns fn's parameters."""
    jsig, sig = inspect.signature(jfn), inspect.signature(fn)
    for name, p in jsig.parameters.items():
        assert name in sig.parameters, name
        assert norm(sig.parameters[name].default) == norm(p.default), name
    return sig.parameters


def stage2_served(s1, dataset_root, out_root, *bindings):
    """The stage-2 entry, 2 tiny steps on `s1` (+ `bindings`), then
    from_artifacts on 8 histories. Returns (result, recommendations)."""
    from hidvae_tpu_torch.data.processed import RecDataset, processed_path
    from hidvae_tpu_torch.serve.engine import RetrievalEngine

    lines = ["import data.processed", "train.dataset = %data.processed.RecDataset.SYNTHETIC",
             f'train.dataset_folder = "{dataset_root}"',
             f'train.save_dir_root = "{out_root / "decoder"}"', "train.iterations = 2",
             "train.batch_size = 8", "train.vae_input_dim = 32", "train.vae_n_cat_feats = 0",
             "train.vae_hidden_dims = [32, 16]", "train.vae_embed_dim = 8",
             "train.decoder_embed_dim = 16", "train.attn_embed_dim = 32", "train.attn_heads = 2",
             "train.attn_layers = 2", "train.warmup_steps = 2", "train.save_model_every = 2",
             "train.partial_eval_every = 2", "train.full_eval_every = 2", "train.eval_batches = 1",
             'train.mixed_precision_type = "fp32"', "train.make_plots = False", *bindings]
    gin = out_root / "decoder.gin"
    gin.write_text("\n".join(lines) + "\n")
    out = load_script("torch_train_transformer").main([str(gin), "--stage1", s1,
                                                        "--device", "cpu"])
    assert out["step"] == 2 and basenames(out["saved_paths"]) == ["checkpoint_2"]
    served = RetrievalEngine.from_artifacts(str(gin), s1, out["saved_paths"][-1], device="cpu",
                                            batch_buckets=(8,))
    np.testing.assert_array_equal(served.corpus_ids.numpy(), out["tokenizer"].cached_ids.numpy())
    data = np.load(processed_path(dataset_root, RecDataset.SYNTHETIC))
    rec = served.recommend(data["seq_items"][:8])
    ok = rec["items"] >= 0
    assert ok.any()
    np.testing.assert_array_equal(served.corpus_ids.numpy()[rec["items"][ok]], rec["sem_ids"][ok])
    return out, data["item_features"]


def basenames(paths):
    return [os.path.basename(p) for p in paths]


def flat(tree):
    """A flax variable tree -> {"a/b/kernel": np.ndarray}."""
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def torchrun(script, gin, lines, *args):
    """scripts/`script` on `gin` (`lines` written to it) under torchrun on 2
    CPU ranks: its output."""
    gin.write_text("\n".join(lines) + "\n")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(ROOT / "scripts" / script), str(gin), *args, "--device", "cpu"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def part(result, prefix):
    """`result`'s entries under "prefix:", the prefix cut."""
    return {k[len(prefix) + 1:]: v for k, v in result.items() if k.startswith(prefix + ":")}


def assert_rel(got, want, tol, err_msg=""):
    """max |got - want| <= tol * max |want| (floor 1e-12: zeros stay zeros)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    scale = max(float(np.max(np.abs(want))), 1e-12) if want.size else 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=err_msg)


def unflat(d):
    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in d.items()}, sep="/")


def japply(module, variables, method, *args):
    """module.apply(variables, *args, method=method) under one jax.jit: one
    compile of the whole graph instead of one per eager op."""
    return jax.jit(lambda v, *a: module.apply(v, *a, method=method))(variables, *args)


def random_variables(module, init_args, init_kwargs=None, seed=0):
    """Flat numpy variables {collection: {path: array}} of a flax module's
    init shapes, drawn from `seed` by leaf kind (kernels N(0, 1/fan_in),
    variances in [0.5, 2))."""
    rngs = {name: jax.random.key(i) for i, name in
            enumerate(("params", "gumbel", "dropout", "mixup"))}
    shapes = jax.eval_shape(
        lambda r: module.init(r, *init_args, **(init_kwargs or {})), rngs)
    rng = np.random.RandomState(seed)
    out = {}
    for coll, tree in shapes.items():
        leaves = traverse_util.flatten_dict(tree, sep="/")
        arrays = {}
        for path, leaf in sorted(leaves.items()):
            shape, name = leaf.shape, path.split("/")[-1]
            if name == "kernel":
                v = rng.randn(*shape) / np.sqrt(shape[0])
            elif name in ("bias", "mean"):
                v = 0.3 * rng.randn(*shape)
            elif name in ("scale", "weight"):
                v = 1.0 + 0.1 * rng.randn(*shape)
            elif name == "var":
                v = rng.uniform(0.5, 2.0, shape)
            else:  # embedding tables, codebooks, bos_emb
                v = 0.5 * rng.randn(*shape)
            arrays[path] = v.astype(np.float32)
        out[coll] = arrays
    return out


def hrqvae_pair(*, input_dim=32, embed_dim=8, hidden_dims=(16,), codebook_size=16,
                n_layers=3, tag_class_counts=(4, 6, 8), tag_embed_dim=12,
                codebook_normalize=True, sim_vq=False, seed=0):
    """(JAX HRqVae, its variables, torch HRqVae with the same weights)."""
    from hidvae_tpu.models.hrqvae import HRqVae as JHRqVae
    from hidvae_tpu.models.quantize import QuantizeForwardMode

    from hidvae_tpu_torch.models.hrqvae import HRqVae

    kw = dict(input_dim=input_dim, embed_dim=embed_dim, hidden_dims=hidden_dims,
              codebook_size=codebook_size, n_layers=n_layers, n_cat_features=0,
              tag_class_counts=tag_class_counts, tag_embed_dim=tag_embed_dim,
              codebook_normalize=codebook_normalize, codebook_sim_vq=sim_vq)
    jm = JHRqVae(**kw, codebook_mode=QuantizeForwardMode.STE)
    flat_vars = random_variables(
        jm, (jnp.zeros((4, input_dim)), jnp.zeros((4, n_layers, tag_embed_dim)),
             jnp.zeros((4, n_layers), jnp.int32), 0.2), {"train": False}, seed)
    params, stats = flat_vars["params"], flat_vars["batch_stats"]
    jvars = {"params": unflat(params), "batch_stats": unflat(stats)}
    tm = HRqVae(input_dim, embed_dim, hidden_dims, codebook_size,
                codebook_normalize=codebook_normalize, codebook_sim_vq=sim_vq,
                n_layers=n_layers, tag_class_counts=tag_class_counts,
                tag_embed_dim=tag_embed_dim)
    load_flax_weights(tm, params, stats)
    return jm, jvars, tm.eval()


def batch_pair(b, n, d, seed, k, ragged):
    """The same tokenized batch for both packages, row r padded from item
    ragged[r] on."""
    from hidvae_tpu.data.schemas import TokenizedSeqBatch as JBatch
    from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch

    rng = np.random.RandomState(seed)
    mask = np.ones((b, n * d), bool)
    for r, i in ragged.items():
        mask[r, i * d:] = False
    sem = np.where(mask, rng.randint(0, k, (b, n * d)), -1).astype(np.int32)
    fut = rng.randint(0, k, (b, d)).astype(np.int32)
    tt, ttf = (np.tile(np.arange(d, dtype=np.int32), (b, m)) for m in (n, 1))
    arrays = (np.arange(b, dtype=np.int32) * 977, sem, fut, mask, tt, ttf)
    return (JBatch(*(jnp.asarray(a) for a in arrays)),
            TokenizedSeqBatch(*(torch.from_numpy(a) for a in arrays)))


def jax_example_batch(d):
    """A JAX batch of 2 rows of 2 items of `d` digits, all zeros: the shapes
    a retrieval model's init takes."""
    from hidvae_tpu.data.schemas import TokenizedSeqBatch as JBatch

    tt = jnp.arange(d, dtype=jnp.int32)
    return JBatch(user_ids=jnp.zeros((2,), jnp.int32), sem_ids=jnp.zeros((2, 2 * d), jnp.int32),
                  sem_ids_fut=jnp.zeros((2, d), jnp.int32), seq_mask=jnp.ones((2, 2 * d), bool),
                  token_type_ids=jnp.tile(tt, (2, 2)), token_type_ids_fut=jnp.tile(tt, (2, 1)))


def retrieval_pair(*, embedding_dim=16, attn_dim=32, num_heads=4, n_layers=2,
                   num_embeddings=16, sem_id_dim=3, max_pos=64, n_sem_layers=3,
                   use_interleaved_ids=False, seed=0):
    """(JAX EncoderDecoderRetrievalModel, its params, torch model with the
    same weights)."""
    from hidvae_tpu.models.retrieval import EncoderDecoderRetrievalModel as JModel

    from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel

    jm = JModel(embedding_dim=embedding_dim, attn_dim=attn_dim, dropout=0.1,
                num_heads=num_heads, n_layers=n_layers, num_embeddings=num_embeddings,
                sem_id_dim=sem_id_dim, max_pos=max_pos, n_sem_layers=n_sem_layers,
                use_interleaved_ids=use_interleaved_ids)
    example = jax_example_batch(sem_id_dim)
    params = random_variables(jm, (example, False), seed=seed)["params"]
    tm = EncoderDecoderRetrievalModel(
        embedding_dim, attn_dim, num_heads, n_layers, num_embeddings, sem_id_dim,
        max_pos=max_pos, n_sem_layers=n_sem_layers, use_interleaved_ids=use_interleaved_ids)
    load_flax_weights(tm, params)
    return jm, unflat(params), tm.eval()
