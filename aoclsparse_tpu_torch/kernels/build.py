"""Build the package's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), all started together, and the
objects are linked into one shared library with plain C entry points, which
kernel wrappers load with ``ctypes``. The library
lands in ``aoclsparse_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name carrying a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing file. Nothing is fetched
from outside the repository; ``nvcc`` comes from ``PATH``, ``CUDA_HOME`` or
``/usr/local/cuda``. The compiler's ``-Xptxas -v`` report (registers, shared
memory, spills per kernel) is kept beside the library as a ``.log`` file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["BUILD_DIR", "CSRC_DIR", "MAX_SMEM", "build_library", "load_library"]

#: dynamic shared memory one thread block may use on the sm_90a target (an
#: H100: 227 KB of the SM's 256 KB); the wrappers size their tiles by it
MAX_SMEM = 232448

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
#: one source to one object
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
#: the objects to the library
LINK_FLAGS = (*GENCODE, "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def build_library() -> Path:
    """Compile the sources unless a library of the same hash exists; return
    its path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libaoclsparse_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.tmp.so")
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(o), str(p)], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for p, o in zip(srcs, objs)
    ]
    logs, failed = [], []
    for p, proc in zip(srcs, procs):
        stdout, stderr = proc.communicate()
        logs.append(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{p.name} (exit {proc.returncode}):\n{stdout}\n{stderr}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}\n{link.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build_library()))
    return _lib
