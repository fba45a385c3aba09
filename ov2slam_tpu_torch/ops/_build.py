"""Build the package's native sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``ov2slam_tpu_torch/build/`` under a name keyed on the hash
of its source, the ``csrc`` headers it includes, and the flags, so an edited
source or header rebuilds and an unchanged one loads at once. ``build``
starts one ``nvcc`` per source, all at once. The host libraries
(``csrc/<name>.cpp``: the place index, the PNG unfilter) are compiled the
same way by ``g++`` (``build_cxx``), on any machine. A failed build raises.
Only sources in the repository are used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}
# nvcc/ptxas output (registers, smem), kept beside each library
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src: Path) -> list:
    """src and every csrc header it includes, directly or through another."""
    seen, todo = [], [src]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo += [CSRC / h for h in _INCLUDE.findall(f.read_text())
                 if (CSRC / h).exists()]
    return seen


def library_path(name: str) -> Tuple[Path, Path]:
    """(source, library) paths for csrc/<name>.cu."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources(src):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every missing csrc/<name>.cu library, one nvcc each, all
    started together."""
    jobs = []
    for name in names:
        src, lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            if log.exists():
                BUILD_LOG.setdefault(name, log.read_text())
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, src, lib, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, lib, tmp, proc, t0 in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} (exit "
                          f"{proc.returncode}):\n{out}")
            continue
        lib.with_suffix(".log").write_text(out.strip())
        os.replace(tmp, lib)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out.strip()
    if failed:
        raise RuntimeError("\n".join(failed))


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_summary(log: str) -> Dict[str, Dict[str, int]]:
    """Per function of an nvcc ``-Xptxas=-v`` log (its mangled name):
    ``stack`` frame bytes, ``spill_stores`` and ``spill_loads`` bytes, and
    for a kernel entry its ``registers``. A device function that ptxas did
    not inline has an entry of its own."""
    out: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
        m = _FRAME.search(line)
        if m and props is not None:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, then load it."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)[1]))
    return _LIBS[name]


def cxx_library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cpp, at its current source and
    flags, lives."""
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_cxx(name: str) -> Path:
    """Compile csrc/<name>.cpp with g++ (``$CXX``) unless its library
    exists; returns the library's path. Raises when the compiler fails."""
    lib = cxx_library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cpp")],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {name}.cpp (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib
