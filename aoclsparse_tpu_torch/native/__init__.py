"""Host C++ kernels of the planner: ILU(0) factorization and the blocked
triangular-solve form fill, bound with ctypes.

PyTorch-side counterpart of ``aoclsparse_tpu/native/__init__.py:45-247,
697-773``. The C++ source, ``native/src/host_kernels.cpp``, is this
package's own byte-equal copy of the JAX package's
``aoclsparse_tpu/native/src/host_kernels.cpp`` (a CPU test holds the two
equal, so both packages factor with the same code). At first use ``g++``
(the host compiler nvcc itself needs) compiles it, with the JAX package's
flags, into ``aoclsparse_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name carrying a hash of the source and flags, so an edited source
rebuilds and an unchanged one loads the existing file. Nothing under
``aoclsparse_tpu/`` is read or written.

`ilu0_factor` falls back to `_ilu0_numpy` (the same IKJ sweep in numpy)
when the library cannot be built; `trsv_win_build` returns None then, and
its callers build the form in numpy. `available()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..kernels.build import BUILD_DIR

__all__ = ["available", "ilu0_factor", "trsv_win_build", "HOST_SOURCE"]

#: the package's copy of the JAX package's host kernels
HOST_SOURCE = Path(__file__).resolve().parent / "src" / "host_kernels.cpp"
#: the JAX package's own g++ flags (aoclsparse_tpu/native/__init__.py:47-59),
#: so both packages factor with the same machine code
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_VALP = {
    np.dtype(np.float32): ("s", ctypes.POINTER(ctypes.c_float)),
    np.dtype(np.float64): ("d", ctypes.POINTER(ctypes.c_double)),
    np.dtype(np.complex64): ("c", ctypes.c_void_p),
    np.dtype(np.complex128): ("z", ctypes.c_void_p),
}


def _build() -> Optional[Path]:
    """Compile the source unless a library of the same hash exists."""
    if not HOST_SOURCE.exists():
        return None
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    out = BUILD_DIR / f"libaoclsparse_host-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, str(HOST_SOURCE), "-o", str(tmp)],
            check=True, capture_output=True, timeout=300,
        )
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _bind(lib: ctypes.CDLL) -> None:
    for dt, (suf, vp) in _VALP.items():
        fn = getattr(lib, f"ilu0_{suf}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int64, _I64P, _I64P, vp, _I64P, _I64P]
    lib.trsv_win_analyze.restype = None
    lib.trsv_win_analyze.argtypes = [
        ctypes.c_int64, _I64P, _I64P, _I32P, ctypes.c_int64, ctypes.c_int, _I64P, _I64P, _I64P,
    ]
    for dt in (np.dtype(np.float32), np.dtype(np.float64)):
        suf, vp = _VALP[dt]
        fn = getattr(lib, f"trsv_win_fill_{suf}")
        fn.restype = None
        fn.argtypes = [
            ctypes.c_int64, _I64P, _I64P, _I32P, vp, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, _I64P, _I64P, vp, vp, _I64P, _I64P, _I64P, _I64P,
        ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            path = _build()
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                    _bind(lib)
                    _lib = lib
                except OSError:
                    _lib = None
    return _lib


def available() -> bool:
    """True when the C++ library built and loaded."""
    return _load() is not None


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int64)


def _ptr(a: np.ndarray, vp):
    return a.ctypes.data_as(vp)


def ilu0_factor(m: int, ptr, ind, val) -> Tuple[np.ndarray, np.ndarray]:
    """IKJ ILU(0) over a sorted CSR pattern; returns (lu, diag_ptr). Raises
    ValueError("missing_diag:<row>") or ValueError("zero_pivot:<row>"),
    which the caller maps to a Status."""
    lib = _load()
    val = np.asarray(val)
    if lib is None or val.dtype not in _VALP:
        return _ilu0_numpy(m, ptr, ind, val)
    suf, vp = _VALP[val.dtype]
    ptr64, ind64 = _i64(ptr), _i64(ind)
    lu = np.ascontiguousarray(val).copy()
    diag = np.empty(m, dtype=np.int64)
    err = np.zeros(1, dtype=np.int64)
    lu_p = ctypes.c_void_p(lu.ctypes.data) if vp is ctypes.c_void_p else _ptr(lu, vp)
    rc = getattr(lib, f"ilu0_{suf}")(
        ctypes.c_int64(m), _ptr(ptr64, _I64P), _ptr(ind64, _I64P), lu_p,
        _ptr(diag, _I64P), _ptr(err, _I64P),
    )
    if rc == 1:
        raise ValueError(f"missing_diag:{int(err[0])}")
    if rc == 2:
        raise ValueError(f"zero_pivot:{int(err[0])}")
    return lu, diag


def _ilu0_numpy(m, ptr, ind, val):
    """The same IKJ sweep in numpy: the factorization's plain version."""
    ptr = _i64(ptr)
    ind = _i64(ind)
    lu = np.array(val, copy=True)
    diag = np.full(m, -1, dtype=np.int64)
    for i in range(m):
        lo, hi = ptr[i], ptr[i + 1]
        seg = ind[lo:hi]
        p = np.searchsorted(seg, i)
        if p < hi - lo and seg[p] == i:
            diag[i] = lo + p
        else:
            raise ValueError(f"missing_diag:{i}")
    pos = np.full(m, -1, dtype=np.int64)
    for i in range(m):
        lo, hi = int(ptr[i]), int(ptr[i + 1])
        pos[ind[lo:hi]] = np.arange(lo, hi)
        for k in range(lo, hi):
            j = int(ind[k])
            if j >= i:
                break
            piv = lu[diag[j]]
            if piv == 0:
                raise ValueError(f"zero_pivot:{j}")
            lik = lu[k] / piv
            lu[k] = lik
            t0, t1 = int(diag[j]) + 1, int(ptr[j + 1])
            if t0 < t1:
                tgt = pos[ind[t0:t1]]
                ok = tgt >= 0
                lu[tgt[ok]] -= lik * lu[t0:t1][ok]
        pos[ind[lo:hi]] = -1
    return lu, diag


def trsv_win_build(m, lo, hi, ind, vals, nb, reversed_):
    """Operands of a ``win`` blocked-solve form in C++: the triangle given
    as per-row [lo, hi) slices of the clean structure is split into dense
    diagonal blocks D (nblk*nb*nb,) and the left window Lw (nblk*nb*WL,),
    plus the refresh scatter maps (destinations, clean-position sources).
    reversed_=True builds on reversed indices (upper -> lower). Returns a
    dict, or None when the library is missing, the dtype is not f32/f64, or
    the window would pass the numpy builder's memory cap."""
    lib = _load()
    vals = np.ascontiguousarray(np.asarray(vals))
    if lib is None or vals.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    m = int(m)
    lo64, hi64 = _i64(lo), _i64(hi)
    ind32 = np.ascontiguousarray(np.asarray(ind), dtype=np.int32)
    wl = np.zeros(1, np.int64)
    prefL = np.zeros(m + 1, np.int64)
    prefD = np.zeros(m + 1, np.int64)
    rev = ctypes.c_int(1 if reversed_ else 0)
    lib.trsv_win_analyze(
        ctypes.c_int64(m), _ptr(lo64, _I64P), _ptr(hi64, _I64P), _ptr(ind32, _I32P),
        ctypes.c_int64(int(nb)), rev, _ptr(prefL, _I64P), _ptr(prefD, _I64P), _ptr(wl, _I64P),
    )
    WL = max(8, -(-int(wl[0]) // 8) * 8)
    nblk = -(-m // nb) if m else 1
    nL, nD = int(prefL[-1]), int(prefD[-1])
    # the numpy builder's win cap (planner/triangular.py build_trsv_form)
    if not (nblk * nb * WL <= max(8 * max(nL + nD, 1), 64 * nb * nb) and WL <= 8192):
        return None
    D = np.zeros(nblk * nb * nb, dtype=vals.dtype)
    Lw = np.zeros(nblk * nb * WL, dtype=vals.dtype)
    D_dest, D_srcpos = np.empty(nD, np.int64), np.empty(nD, np.int64)
    L_dest, L_srcpos = np.empty(nL, np.int64), np.empty(nL, np.int64)
    suf, vp = _VALP[vals.dtype]
    getattr(lib, f"trsv_win_fill_{suf}")(
        ctypes.c_int64(m), _ptr(lo64, _I64P), _ptr(hi64, _I64P), _ptr(ind32, _I32P),
        _ptr(vals, vp), ctypes.c_int64(int(nb)), rev, ctypes.c_int64(WL),
        _ptr(prefL, _I64P), _ptr(prefD, _I64P), _ptr(D, vp), _ptr(Lw, vp),
        _ptr(D_dest, _I64P), _ptr(D_srcpos, _I64P), _ptr(L_dest, _I64P), _ptr(L_srcpos, _I64P),
    )
    return {
        "WL": WL, "nblk": nblk, "D": D, "Lw": Lw,
        "D_dest": D_dest, "D_srcpos": D_srcpos, "L_dest": L_dest, "L_srcpos": L_srcpos,
    }
