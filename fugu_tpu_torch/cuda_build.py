"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, which ``ctypes`` loads.  The
library's file name carries a hash of the source and flags, so an edited
source is rebuilt and a stale library is never loaded; the build writes
to a private file and renames it into place, so concurrent processes
never load a half-written library.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc/ptxas output of each build in this process (registers, spills)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str) -> Path:
    """Path of the built library for ``csrc/<name>.cu``, compiling it
    if no library of this source and these flags exists yet."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
            capture_output=True,
            text=True,
        )
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name}:\n{build_logs[name][-4000:]}"
            )
        os.replace(out, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
