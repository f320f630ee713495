"""A CUDA source with a plain C interface built by `nvcc` at first use
into hidvae_tpu_torch/_build/ (named by a hash of source, headers and
flags; renamed into place) and loaded with ctypes."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 300

_loaded = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME or /usr/local/cuda")


class BuiltLibrary:
    """A loaded shared library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_s: float, log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s  # 0.0 when an existing build was loaded
        self.log = log          # nvcc's output (-Xptxas -v register report)


def load_library(source_name: str) -> BuiltLibrary:
    """Compile csrc/<source_name> (once per process and per content hash)
    and return the loaded library. Raises on a failed or timed-out build."""
    if source_name in _loaded:
        return _loaded[source_name]
    src = CSRC_DIR / source_name
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    stem = f"{src.stem}_{digest.hexdigest()[:16]}"
    out = BUILD_DIR / f"lib{stem}.so"
    log, build_s = "", 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"lib{stem}.tmp{os.getpid()}.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=NVCC_TIMEOUT_S, check=True)
        except subprocess.CalledProcessError as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {e.returncode}):\n{e.stderr}"
            ) from e
        except subprocess.TimeoutExpired:
            tmp.unlink(missing_ok=True)
            raise
        build_s = time.perf_counter() - t0
        log = res.stdout + res.stderr
        os.replace(tmp, out)
    built = BuiltLibrary(ctypes.CDLL(str(out)), out, build_s, log)
    _loaded[source_name] = built
    return built

