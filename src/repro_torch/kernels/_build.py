"""Build the port's CUDA kernels from ``kernels/csrc`` and bind them with
ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
at first use, into ``kernels/_build/`` beside this file (listed in
``.gitignore``).  The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale library is
never loaded.

A template source (``TEMPLATES``: the 2-D and the 3-D stencil kernels,
``stencil2d.cu`` and ``stencil3d.cu``) includes a header generated per
tap set (``kernels/stencil2d_gen.py``, ``kernels/stencil3d_gen.py``).
Its libraries are built from the template and a header's text: the
header is written beside the library, and the hash covers the template,
the header and the flags, so each tap set has its own library and a
changed header never loads a stale one.  Different libraries build in
parallel; one library is built once.

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
SOURCES = {"flash_attention_mma": "flash_attention_mma.cu",
           "flash_attention_tf32": "flash_attention_tf32.cu",
           "flash_attention_bwd_mma": "flash_attention_bwd_mma.cu",
           "flash_attention_bwd_tf32": "flash_attention_bwd_tf32.cu"}
TEMPLATES = {"stencil2d": ("stencil2d.cu", "stencil2d_taps.cuh"),
             "stencil3d": ("stencil3d.cu", "stencil3d_taps.cuh")}
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_build_locks: dict[Path, threading.Lock] = {}
_libs: dict[tuple[str, str | None], ctypes.CDLL] = {}
_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: the stencil service
    launches from worker threads, and a bare ``+= 1`` could lose a count
    when two of them launch at once."""
    with _count_lock:
        wrapper.launches += 1


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


def _source(name: str) -> Path:
    return CSRC / (TEMPLATES[name][0] if name in TEMPLATES
                   else SOURCES[name])


def library_path(name: str, header: str | None = None) -> Path:
    """Where the library ``name`` (a template's: for ``header``) lives."""
    if (name in TEMPLATES) != (header is not None):
        raise ValueError(f"{name}: a template library takes a generated "
                         "header, a plain source none")
    blob = _source(name).read_bytes() + " ".join(NVCC_FLAGS).encode()
    if header is not None:
        blob += b"\0" + header.encode()
    digest = hashlib.sha256(blob).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, header: str | None = None) -> None:
    """Compile the library ``name`` (for ``header``) if it is missing.  The
    compiler's output (ptxas register, spill and stack lines) is kept
    beside the library (:func:`build_log`); a library without it is built
    again."""
    out = library_path(name, header)
    with _lock:
        lock = _build_locks.setdefault(out, threading.Lock())
    with lock:
        if out.exists() and out.with_suffix(".log").exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pid = os.getpid()
        args = [nvcc_path(), *NVCC_FLAGS]
        if header is not None:
            inc = out.with_suffix(f".{pid}.inc")
            inc.mkdir(exist_ok=True)
            (inc / TEMPLATES[name][1]).write_text(header)
            args += ["-I", str(inc)]
        tmp = out.with_suffix(f".{pid}.tmp")
        proc = subprocess.run([*args, "-o", str(tmp), str(_source(name))],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_source(name).name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        if header is not None:
            os.replace(inc / TEMPLATES[name][1], out.with_suffix(".cuh"))
            inc.rmdir()
        log_tmp = out.with_suffix(f".{pid}.log.tmp")
        log_tmp.write_text(proc.stdout)
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(tmp, out)   # atomic: concurrent builders never see half


def build_log(name: str, header: str | None = None) -> str:
    """The compiler's output of the library ``name`` (for ``header``) as
    it was built (builds it first if missing)."""
    library(name, header)
    return library_path(name, header).with_suffix(".log").read_text()


def ptxas_usage(log: str) -> dict[str, tuple[int, int]]:
    """``{kernel: (registers, spill-store bytes)}`` for each entry function
    in an ``nvcc -Xptxas -v`` output (mangled names)."""
    return {fn: (regs, spill)
            for fn, (regs, spill, _) in ptxas_frames(log).items()}


def ptxas_frames(log: str) -> dict[str, tuple[int, int, int]]:
    """``{kernel: (registers, spill-store bytes, stack-frame bytes)}`` for
    each entry function in an ``nvcc -Xptxas -v`` output."""
    usage, fn, spill, stack = {}, None, 0, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill, stack = m.group(1), 0, 0
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and fn:
            stack = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)), spill, stack)
            fn = None
    return usage


def library(name: str, header: str | None = None) -> ctypes.CDLL:
    """The loaded library for ``name`` (for ``header``), built first if
    missing.  Loaded libraries are kept by name and header, so a launch
    reads no file and hashes nothing."""
    lib = _libs.get((name, header))
    if lib is None:
        build(name, header)
        with _lock:
            lib = _libs.get((name, header))
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name, header)))
                _libs[(name, header)] = lib
    return lib
