"""The port stands alone: with JAX, flax, orbax, optax and the JAX package
refused, every module imports, an engine serves, chip_smoke.py's early
phases run tiny (the later: test_torch_port_phases.py); sources are small."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "hidvae_tpu_torch"
SKIP_DIRS = {"__pycache__", "_build"}  # interpreter caches and kernel builds

# Both subprocesses refuse JAX at import, import every module of the port,
# serve a small engine and print "modules N resolved R" last.
PRELUDE = textwrap.dedent('''

    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "orbax", "optax", "hidvae_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import hidvae_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(hidvae_tpu_torch.__path__, "hidvae_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "hidvae_tpu_torch.parallel.mesh" in names and "hidvae_tpu_torch.parallel.dryrun" in names
    import os, tempfile
    import torch
    import chip_smoke
    import tests._torch_parallel_worker  # the multi-rank tests' ranks import no JAX either

    tiny = dict(input_dim=48, hidden_dims=(32, 16), embed_dim=8, codebook_size=16,
                n_layers=3, codebook_normalize=True, tag_class_counts=(4, 6, 20),
                tag_embed_dim=12, decoder_embed_dim=16, attn_embed_dim=32, attn_heads=4,
                attn_layers=2, max_seq_len=6, n_items=300)
    engine, items = chip_smoke.build_engine(tiny, "cpu", batch_buckets=(8,))
    hist = chip_smoke.seeded_histories(tiny["n_items"], 8, tiny["max_seq_len"])
    out = engine.recommend(hist, top_k=5)
    resolved = chip_smoke.check_recommendations(engine, out, tiny["n_items"])

    tiny_plain = dict(tiny, tag_class_counts=None, codebook_normalize=False)
''')
EPILOGUE = textwrap.dedent('''
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("modules", len(names), "resolved", resolved)
''')
HYGIENE_SCRIPT = textwrap.dedent('''
    # The artifacts phase on both routes (no launch on the CPU).
    launches = chip_smoke.artifacts_phase(torch.device("cpu"), engine, items, hist,
                                          amazon=tiny, ml32m=tiny_plain)
    assert launches == {"amazon": 0, "ml32m": 0}, launches
    # The serve phase's tokenize_features check (no launch on the CPU).
    assert chip_smoke.check_tokenize_features(engine.tokenizer, items, hist) == 0

    # The training path, dense and at 2,101 tokens (flash's plain version).
    tiny.update(precision="fp32")
    vae, feats = chip_smoke.build_vae(tiny, torch.Generator().manual_seed(0))
    for max_seq_len in (6, 350):
        result, launches, data = chip_smoke.train_run(
            tiny, vae, feats, torch.device("cpu"), max_seq_len, 4, 2, log=lambda line: None)
        chip_smoke.check_train_run("tiny", result, {**launches, "rq_assign": 1}, 2,
                                   n_encoder_layers=1, flash=False)
        before, after = chip_smoke.fixed_batch_descent(result, data, 4, 2)
        assert after < before, (before, after)

    # The stage-1 phase, then the trainer phase on its checkpoint.
    with tempfile.TemporaryDirectory() as work:
        s1, rec1 = chip_smoke.stage1_phase(
            torch.device("cpu"), feats, os.path.join(work, "stage1"), cfg=tiny, n=2,
            settings=(("gin", 16, 2), ("batch32", 32, 1)), timed=(1, 1), batch_size=16,
            rare_tag_threshold=8)
        assert rec1["resume_gaps"] == {"params": 0.0, "batch_stats": 0.0, "mu": 0.0,
                                       "nu": 0.0}, rec1
        rec = chip_smoke.trainer_phase(torch.device("cpu"), vae, feats, cfg=tiny, n=2,
                                       splits=(64, 20, 20), remat_run=(350, 2, 2), batch_size=8,
                                       mixed_precision_type='"fp32"', stage1=s1)
        # The multi phase: one Gloo rank (NCCL on the card), then two: DP and
        # TP from the gin, TP resumed, long DP, engines at 2 x 1 and 1 x 2.
        multi = chip_smoke.multi_phase(torch.device("cpu"), vae, feats, s1, cfg=tiny, n=2,
                                       splits=(64, 20, 20), short_run=(6, 8),
                                       long_run=(350, 4, 2), batch_size=8,
                                       mixed_precision_type='"fp32"')
    assert rec["resume"]["gaps"] == {"params": 0.0, "mu": 0.0, "nu": 0.0}, rec["resume"]
    assert rec["remat"]["param_gap"] == 0.0, rec["remat"]
    assert multi["nccl_1"]["bitwise"] and multi["tp"]["bytes_per_step"] > 0, multi

''')


def run_without_jax(script, prefix=""):
    """`prefix` + PRELUDE + `script` + EPILOGUE in a subprocess; it must exit
    0 and print its module and resolved counts last."""
    # One intra-op thread, as tests/_torch_common.py sets it for the workers.
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    code = textwrap.dedent(prefix) + PRELUDE + textwrap.dedent(script) + EPILOGUE
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    last = res.stdout.splitlines()[-1].split()  # the phases print before it
    assert int(last[1]) >= 20
    assert int(last[3]) > 0


def test_port_imports_and_serves_without_jax():
    run_without_jax(HYGIENE_SCRIPT)


# Without pandas, matplotlib and sentence_transformers (as on the card's
# machine) the port imports and the raw and tools phases run, tiny.
NO_PANDAS = """
    import sys
    sys.modules["pandas"] = sys.modules["sentence_transformers"] = sys.modules["matplotlib"] = None
"""
RAW_SCRIPT = """
    tiny_raw = dict(tiny, input_dim=768, tag_embed_dim=768)  # the built widths
    with tempfile.TemporaryDirectory() as work:
        rec = chip_smoke.raw_phase(torch.device("cpu"), work, cfg=tiny_raw,
                                   drop=dict(n_items=300, n_users=80), n=2, steps=2,
                                   movielens=(60, 2000), batch_size=16, stage2=dict(
                                       batch_size=8, mixed_precision_type='"fp32"'),
                                   kuairand_drop=dict(n_videos=400, n_users=60),
                                   kuairand=dict(
                                       vae_hidden_dims=[32, 16], vae_embed_dim=8,
                                       vae_codebook_size=16, batch_size=16, eval_batches=1,
                                       h_rqvae=dict(rare_tag_threshold=8), decoder=dict(
                                           batch_size=8, attn_embed_dim=32, attn_heads=4,
                                           attn_layers=2, decoder_embed_dim=16,
                                           mixed_precision_type='"fp32"')))
        # The tools phase: tag completion on the KuaiRand corpus just built,
        # the view tools (diag on the view run's checkpoint), attribution.
        tools = chip_smoke.tools_phase(torch.device("cpu"), work, diag_n=500,
                                       view_args=["--iterations", "2", "--device", "cpu"],
                                       attrib=dict(smoke=True, iters=1, warmup=1, beam_iters=1))
    assert tools["launches"] == {"train-hrqvae": 0, "train-rqvae": 0, "diag": 0}, tools
    assert tools["tags"]["rows_missing_l1"] > 0 and tools["tags"]["llm_resumed_requests"] > 0
    zeros = {"stage1": 0, "table": 0, "stage2": 0, "from_artifacts": 0}
    assert rec == dict(zeros, kuairand=dict(rqvae=0, rqvae_table=0, h_rqvae=0, h_rqvae_table=0,
                                            stage2=0, from_artifacts=0)), rec
    assert sys.modules["pandas"] is None and sys.modules["matplotlib"] is None
"""


def test_raw_builders_run_without_pandas():
    run_without_jax(RAW_SCRIPT, prefix=NO_PANDAS)


def _port_sources():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "tests").glob("test_torch_*.py")),
             *sorted((ROOT / "tests").glob("_torch_*.py")),
             *sorted((ROOT / "scripts").glob("torch_*.py"))]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
        files += [Path(dirpath) / f for f in filenames]
    return files


def test_port_sources_are_small_text():
    files = _port_sources()
    assert len(files) > 25
    total = 0
    for path in files:
        data = path.read_bytes()
        assert b"\0" not in data, f"{path} is not text"
        data.decode("utf-8")
        assert len(data) < 200 * 1024, f"{path} is {len(data)} bytes"
        total += len(data)
    assert total < 1024 * 1024, f"the port's sources come to {total} bytes"
