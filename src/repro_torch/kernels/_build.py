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
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = {"stencil2d": "stencil2d.cu", "stencil3d": "stencil3d.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_mma": "flash_attention_mma.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "flash_attention_bwd_mma": "flash_attention_bwd_mma.cu"}
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


def build(name: str) -> None:
    """Compile the library ``name`` if it is missing.  The compiler's
    output (ptxas register and spill lines) is kept beside the library
    (:func:`build_log`); a library without it is built again."""
    out = library_path(name)
    if out.exists() and out.with_suffix(".log").exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / SOURCES[name])],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    log_tmp = out.with_suffix(f".{os.getpid()}.log.tmp")
    log_tmp.write_text(proc.stdout)
    os.replace(log_tmp, out.with_suffix(".log"))
    os.replace(tmp, out)   # atomic: concurrent builders never see half


def build_log(name: str) -> str:
    """The compiler's output of the library ``name`` as it was built
    (builds it first if missing)."""
    library(name)
    return library_path(name).with_suffix(".log").read_text()


def ptxas_usage(log: str) -> dict[str, tuple[int, int]]:
    """``{kernel: (registers, spill-store bytes)}`` for each entry function
    in an ``nvcc -Xptxas -v`` output (mangled names)."""
    usage, fn, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)), spill)
            fn = None
    return usage


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
