"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>.so``, a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). All stale
sources are compiled at once, one ``nvcc`` process per source. A library is
rebuilt only when its source, any header in ``csrc/`` or the flags change (a
hash kept beside it). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNELS", "build", "load", "build_log", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
KERNELS = ("flash_fwd", "flash_bwd", "folded_fwd", "folded_bwd",
           "flash_single_kv", "masked_flash", "rasterize", "short_fwd",
           "short_bwd")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    # every header under csrc/ enters each library's hash, so that a new or
    # changed header rebuilds all of them
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def _paths(name: str) -> tuple[Path, Path]:
    return BUILD_DIR / f"lib{name}.so", BUILD_DIR / f"lib{name}.sha256"


def _fresh(name: str) -> bool:
    so, stamp = _paths(name)
    return so.exists() and stamp.exists() and stamp.read_text() == _digest(name)


def build(names=KERNELS) -> float:
    """Compile every stale library among ``names`` in parallel; returns the
    wall seconds spent. Raises with nvcc's output if any build fails."""
    stale = [n for n in names if not _fresh(n)]
    if not stale:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in stale:
        so, _ = _paths(n)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        build_log[n] = out
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        so, stamp = _paths(n)
        os.replace(tmp, so)
        stamp.write_text(_digest(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if stale."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_paths(name)[0]))
        _libs[name] = lib
    return lib
