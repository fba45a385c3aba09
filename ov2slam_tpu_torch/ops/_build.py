"""Build the package's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``ov2slam_tpu_torch/build/`` under a name keyed on the hash
of its source and flags, so an edited source rebuilds and an unchanged one
loads at once. Only sources in the repository are used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}      # nvcc/ptxas output (registers, smem)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str) -> Tuple[Path, Path]:
    """(source, library) paths for csrc/<name>.cu."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, then load it."""
    if name in _LIBS:
        return _LIBS[name]
    src, lib = library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = (proc.stdout + proc.stderr).strip()
    _LIBS[name] = ctypes.CDLL(str(lib))
    return _LIBS[name]
