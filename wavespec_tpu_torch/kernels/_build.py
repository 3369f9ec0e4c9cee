"""Build the CUDA sources under `wavespec_tpu_torch/csrc/` with nvcc and
load them with ctypes.

Each source is compiled on first use into a shared library with a plain C
interface, under `wavespec_tpu_torch/_build/` (git-ignored), named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@lru_cache(maxsize=8)
def load_library(name: str, extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` (if not built yet) and load it."""
    src = CSRC / f"{name}.cu"
    flags = BASE_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *flags, "-o", tmp, str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(str(out))


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
