"""The no-JAX guard compares whole top-level names, and nothing the
benchmark runs loads JAX or the JAX package; the reference imports nothing
of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from perfbench.harness.guard import forbidden_modules

PERFBENCH = Path(__file__).resolve().parent.parent


def test_whole_top_level_names():
    assert forbidden_modules(["hidvae_tpu_torch", "hidvae_tpu_torch.serve", "jaxtyping",
                              "flaxen", "torch"]) == []
    assert forbidden_modules(["hidvae_tpu.models", "jax.numpy", "optax", "orbax.checkpoint",
                              "flax", "jaxlib"]) == ["flax", "hidvae_tpu", "jax", "jaxlib",
                                                     "optax", "orbax"]


def test_nothing_run_loads_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.run, perfbench.control\n"
            "from perfbench.harness import runner, faults, build\n"
            "for c in [w['name'] for w in runner.benchmark()['workloads']]:\n"
            "    runner.load_cell(c)\n"
            "from perfbench.harness.guard import forbidden_modules\n"
            "print(forbidden_modules())\n") % str(PERFBENCH.parent)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_port():
    for path in (PERFBENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("hidvae_tpu_torch", "hidvae_tpu", "jax",
                                                  "flax"), (path.name, name)
