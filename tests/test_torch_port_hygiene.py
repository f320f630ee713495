"""The port stands alone: with JAX, flax, orbax, optax and the JAX package
refused at import, every module of hidvae_tpu_torch and chip_smoke.py still
import, a small engine serves on the CPU, the smoke's artifacts phase writes
small exported checkpoints and serves them through `from_artifacts` on both
tokenizer routes, the smoke's training path trains a small model there, and
its stage-1 phase drives scripts/torch_train_hidvae.py (train, resume,
audit, throughput) and its trainer phase scripts/torch_train_transformer.py
on that checkpoint (train, resume, serve the checkpoint, remat), its multi
phase the trainer and the engine on a process group (Gloo here), its mining
phase the stage-1 entry with duplicate-pair mining and its rqvae phase
scripts/torch_train_rqvae.py (train, resume, audit, serve the checkpoint).
And the port's sources are small text files."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "hidvae_tpu_torch"
SKIP_DIRS = {"__pycache__", "_build"}  # interpreter caches and kernel builds

HYGIENE_SCRIPT = textwrap.dedent('''
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

    # The smoke's artifacts phase at tiny widths: exported checkpoints, a
    # processed dataset and a gin in a temporary directory, served through
    # from_artifacts(device="cpu") on the H route (held equal to the
    # in-process engine) and the plain route (held to a plain sweep). The
    # plain version of rq_assign runs here, so no launch is counted.
    import torch
    tiny_plain = dict(tiny, tag_class_counts=None, codebook_normalize=False)
    launches = chip_smoke.artifacts_phase(torch.device("cpu"), engine, items, hist,
                                          amazon=tiny, ml32m=tiny_plain)
    assert launches == {"amazon": 0, "ml32m": 0}, launches
    # The serve phase's tokenize_features check (no launch on the CPU).
    assert chip_smoke.check_tokenize_features(engine.tokenizer, items, hist) == 0

    # The smoke's training path on the CPU: a short run (dense attention) and
    # one over 1 + 350 * 6 = 2,101 tokens (the flash route, whose plain
    # version runs here). No kernel launches on the CPU, so the checks are
    # held to zero launches, with the sweep's count stood in for.
    tiny.update(precision="fp32")
    vae, feats = chip_smoke.build_vae(tiny, torch.Generator().manual_seed(0))
    for max_seq_len in (6, 350):
        result, launches, data = chip_smoke.train_run(
            tiny, vae, feats, torch.device("cpu"), max_seq_len, 4, 2, log=lambda line: None)
        chip_smoke.check_train_run("tiny", result, {**launches, "rq_assign": 1}, 2,
                                   n_encoder_layers=1, flash=False)
        before, after = chip_smoke.fixed_batch_descent(result, data, 4, 2)
        assert after < before, (before, after)

    # The smoke's stage-1 phase at tiny widths: the gin entry script trains
    # 2N mini-steps with evals, audits and saves, N + a resume for N (bitwise
    # here), the audit's table equals a plain sweep, and the throughput
    # loop runs. Then its trainer phase on the stage-1 phase's checkpoint:
    # 2N steps, N + a resume for N (bitwise here), the checkpoint serves
    # through from_artifacts, and remat agrees with the plain run.
    import os, tempfile
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
        # The smoke's multi phase: one rank over Gloo here (NCCL on the
        # card), then two Gloo ranks: DP and TP runs from the gin, the TP
        # checkpoint resumed on one process, the long-history DP run and the
        # engine at 2 x 1 and 1 x 2 with shard_params.
        multi = chip_smoke.multi_phase(torch.device("cpu"), vae, feats, s1, cfg=tiny, n=2,
                                       splits=(64, 20, 20), short_run=(6, 8),
                                       long_run=(350, 4, 2), batch_size=8,
                                       mixed_precision_type='"fp32"')
    assert rec["resume"]["gaps"] == {"params": 0.0, "mu": 0.0, "nu": 0.0}, rec["resume"]
    assert rec["remat"]["param_gap"] == 0.0, rec["remat"]
    assert multi["nccl_1"]["bitwise"] and multi["tp"]["bytes_per_step"] > 0, multi

    # The smoke's mining phase at tiny widths (L 4, the xxl_m gin's other
    # keys as the repo holds them, bf16 included): planted near-copies
    # collide, the pool refreshes at each audit and survives the resume.
    with tempfile.TemporaryDirectory() as work:
        tiny_xxl = dict(input_dim=48, hidden_dims=(32, 16), embed_dim=8, codebook_size=16,
                        n_layers=4, tag_embed_dim=12, tag_tree=(4, 3, 3), n_items=600)
        rec = chip_smoke.mining_phase(torch.device("cpu"), work, cfg=tiny_xxl, n=2,
                                      settings=(("mining", 32, 1),), timed=(1, 1),
                                      batch_size=32, sem_id_mining_pool=64, rare_tag_threshold=3)
    assert rec["resume_gaps"] == {"params": 0.0, "batch_stats": 0.0, "mu": 0.0, "nu": 0.0}, rec
    assert rec["collision_rate"][-1] > 0 and rec["pool_colliding"] == 1.0, rec

    # The smoke's rqvae phase at tiny widths: the gin entry script, resume,
    # the audit's table against a plain sweep, and the served checkpoint.
    with tempfile.TemporaryDirectory() as work:
        rec = chip_smoke.rqvae_phase(torch.device("cpu"), work, cfg=dict(tiny_plain, n_items=400),
                                     n=2, timed=(1, 1), batch_size=16)
    assert rec["resume_gaps"] == {"params": 0.0, "mu": 0.0, "nu": 0.0}, rec
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("modules", len(names), "resolved", resolved)
''')


def test_port_imports_and_serves_without_jax():
    # One intra-op thread: the script's ops are tiny, and beside other test
    # workers on the same cores a thread pool per op makes it several times
    # slower, not faster.
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", HYGIENE_SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    last = res.stdout.splitlines()[-1].split()  # the phases print before it
    n_modules = int(last[1])
    assert n_modules >= 20
    assert int(last[3]) > 0


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
