"""Build the port's CUDA kernels from ``kernels/csrc`` and bind them with
ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
at first use, into ``kernels/_build/`` beside this file (listed in
``.gitignore``).  The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale library is
never loaded.

Nothing here runs at import: the CPU tests import every module, and this
host may have no ``nvcc`` at all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = {"stencil2d": "stencil2d.cu"}
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from the CUDA toolkit PyTorch found, else from ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built at first use "
            "and need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile the library ``name`` if it is missing; returns the
    compiler's output (ptxas register and shared-memory lines), empty when
    the library was already built."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / SOURCES[name])],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)   # atomic: concurrent builders never see half
    return proc.stdout


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
