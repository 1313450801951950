"""Host C++ kernels of the planner: ILU(0) factorization, the blocked
triangular-solve form fill, the level schedule of a triangle, the host
sequential triangular solves, reverse Cuthill-McKee ordering, the Benes
routing plan, the SpGEMM symbolic and host numeric stages and the masked
block scan of csr2blkcsr, bound with ctypes.

PyTorch-side counterpart of ``aoclsparse_tpu/native/__init__.py:45-455,
558-848``. The C++ source, ``native/src/host_kernels.cpp``, is this
package's own byte-equal copy of the JAX package's
``aoclsparse_tpu/native/src/host_kernels.cpp`` (a CPU test holds the two
equal, so both packages factor with the same code). At first use ``g++``
(the host compiler nvcc itself needs) compiles it, with the JAX package's
flags, into ``aoclsparse_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name carrying a hash of the source and flags, so an edited source
rebuilds and an unchanged one loads the existing file. Nothing under
``aoclsparse_tpu/`` is read or written.

`ilu0_factor`, `level_schedule`, `trsv_seq`, `trsm_seq`,
`rcm_permutation`, `benes_plan`, `spgemm_nnz`, `blkcsr_count` and
`blkcsr_build` fall back to their numpy versions (`_ilu0_numpy`, a row
loop, `_trsv_seq_numpy`, `_rcm_numpy`, `_benes_numpy`, a marker scan,
`_blkcsr_numpy`) when the library cannot be built; `trsv_win_build`,
`spgemm_expand`, `spgemm_pattern` and `spgemm_numeric_host` return None
then, and their callers take their numpy or torch paths, as in the JAX
package. `available()` says which one runs.
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

__all__ = [
    "available",
    "benes_plan",
    "blkcsr_build",
    "blkcsr_count",
    "ilu0_factor",
    "level_schedule",
    "rcm_permutation",
    "spgemm_expand",
    "spgemm_nnz",
    "spgemm_numeric_host",
    "spgemm_pattern",
    "trsm_seq",
    "trsv_seq",
    "trsv_win_build",
    "HOST_SOURCE",
]

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
_U8P = ctypes.POINTER(ctypes.c_uint8)
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
    lib.level_schedule.restype = ctypes.c_int64
    lib.level_schedule.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P]
    for suf, vp in _VALP.values():
        fn = getattr(lib, f"trsv_seq_{suf}")
        fn.restype = None
        fn.argtypes = [ctypes.c_int64, _I64P, _I64P, vp, vp, vp, ctypes.c_int]
        fn = getattr(lib, f"trsm_seq_{suf}")
        fn.restype = None
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, vp, vp, vp, ctypes.c_int]
    lib.rcm.restype = ctypes.c_int64
    lib.rcm.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P]
    lib.benes_plan.restype = None
    lib.benes_plan.argtypes = [ctypes.c_int64, _I64P, _U8P]
    lib.blkcsr_count.restype = ctypes.c_int64
    lib.blkcsr_count.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, ctypes.c_int64]
    lib.blkcsr_build.restype = ctypes.c_int64
    lib.blkcsr_build.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, ctypes.c_int64,
                                 _I64P, _I64P, _U8P, _I64P]
    lib.spgemm_nnz.restype = ctypes.c_int64
    lib.spgemm_nnz.argtypes = [ctypes.c_int64, ctypes.c_int64] + [_I64P] * 5
    lib.spgemm_expand.restype = ctypes.c_int64
    lib.spgemm_expand.argtypes = [ctypes.c_int64] + [_I64P] * 4 + [_I32P] * 3 + [_I64P, _I32P, ctypes.c_uint8, _I64P]
    lib.spgemm_pattern_count.restype = ctypes.c_int64
    lib.spgemm_pattern_count.argtypes = [ctypes.c_int64] + [_I64P] * 6
    lib.spgemm_pattern_fill.restype = None
    lib.spgemm_pattern_fill.argtypes = [ctypes.c_int64] + [_I64P] * 6 + [_I32P]
    for suf, vp in _VALP.values():
        fn = getattr(lib, f"spgemm_numeric_{suf}")
        fn.restype = None
        fn.argtypes = [ctypes.c_int64, _I32P, _I32P, _I32P, vp, vp, vp, ctypes.c_int64]


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


def level_schedule(m: int, ptr, ind) -> Tuple[np.ndarray, int]:
    """Wavefront levels of a lower triangle's strictly-lower dependency DAG:
    (level of each row, number of levels)."""
    lib = _load()
    ptr64, ind64 = _i64(ptr), _i64(ind)
    levels = np.zeros(m, dtype=np.int64)
    if lib is not None:
        nlev = lib.level_schedule(ctypes.c_int64(m), _ptr(ptr64, _I64P), _ptr(ind64, _I64P), _ptr(levels, _I64P))
        return levels, int(nlev)
    nlev = 0
    for i in range(m):
        lv = 0
        for k in range(int(ptr64[i]), int(ptr64[i + 1])):
            j = int(ind64[k])
            if j >= i:
                break
            lv = max(lv, int(levels[j]) + 1)
        levels[i] = lv
        nlev = max(nlev, lv + 1)
    return levels, nlev


def trsv_seq(m: int, ptr, ind, val, b, lower: bool) -> np.ndarray:
    """Sequential substitution over a host CSR triangle that carries its
    diagonal (the host engine, sv KID 2; the reference's scalar
    substitution, level2/aoclsparse_trsv_kr.hpp). A zero or missing pivot
    divides through to Inf/NaN, as the device forms do."""
    ptr64, ind64 = _i64(ptr), _i64(ind)
    v = np.ascontiguousarray(np.asarray(val))
    dt = np.result_type(v.dtype, np.asarray(b).dtype)
    v = v.astype(dt, copy=False)
    bh = np.ascontiguousarray(np.asarray(b), dtype=dt)
    lib = _load()
    if lib is None or dt not in _VALP:
        return _trsv_seq_numpy(m, ptr64, ind64, v, bh, lower)
    suf, vp = _VALP[dt]
    x = np.zeros(m, dtype=dt)
    getattr(lib, f"trsv_seq_{suf}")(
        ctypes.c_int64(m), _ptr(ptr64, _I64P), _ptr(ind64, _I64P), _ptr(v, vp), _ptr(bh, vp), _ptr(x, vp),
        ctypes.c_int(1 if lower else 0),
    )
    return x


def trsm_seq(m: int, ptr, ind, val, B, lower: bool) -> np.ndarray:
    """Multi-RHS sequential substitution (the host engine of trsm, KID 2):
    B (m, k), columns solved independently, threaded across columns in
    C++ like the reference's OpenMP split (level3/aoclsparse_trsm.hpp:149)."""
    ptr64, ind64 = _i64(ptr), _i64(ind)
    v = np.ascontiguousarray(np.asarray(val))
    Bh = np.asarray(B)
    k = Bh.shape[1]
    dt = np.result_type(v.dtype, Bh.dtype)
    v = v.astype(dt, copy=False)
    bt = np.ascontiguousarray(Bh.T, dtype=dt)  # (k, m): each solve sweeps a contiguous vector
    lib = _load()
    if lib is None or dt not in _VALP:
        return np.stack([_trsv_seq_numpy(m, ptr64, ind64, v, bt[j], lower) for j in range(k)], axis=1)
    suf, vp = _VALP[dt]
    x = np.zeros((k, m), dtype=dt)
    getattr(lib, f"trsm_seq_{suf}")(
        ctypes.c_int64(m), ctypes.c_int64(k), _ptr(ptr64, _I64P), _ptr(ind64, _I64P), _ptr(v, vp),
        _ptr(bt, vp), _ptr(x, vp), ctypes.c_int(1 if lower else 0),
    )
    return x.T


def _trsv_seq_numpy(m, ptr, ind, val, b, lower):
    """Row-loop substitution, vectorised within each row."""
    dt = np.result_type(val.dtype, b.dtype)
    x = np.zeros(m, dtype=dt)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(m) if lower else range(m - 1, -1, -1):
            k0, k1 = int(ptr[i]), int(ptr[i + 1])
            cols, vals = ind[k0:k1], val[k0:k1]
            off = (cols < i) if lower else (cols > i)
            s = vals[off] @ x[cols[off]] if off.any() else dt.type(0)
            dmask = cols == i
            x[i] = (b[i] - s) / (vals[dmask][0] if dmask.any() else dt.type(0))
    return x


def rcm_permutation(m: int, ptr, ind) -> Tuple[np.ndarray, int]:
    """Reverse Cuthill-McKee ordering on the symmetrized pattern: returns
    (perm, half bandwidth after), perm[k] = original row placed at position
    k. The gen form's planner orders the block quotient graph with it."""
    lib = _load()
    ptr64, ind64 = _i64(ptr), _i64(ind)
    if lib is None:
        return _rcm_numpy(m, ptr64, ind64)
    perm = np.empty(m, dtype=np.int64)
    bw = lib.rcm(ctypes.c_int64(m), _ptr(ptr64, _I64P), _ptr(ind64, _I64P), _ptr(perm, _I64P))
    return perm, int(bw)


def _rcm_numpy(m, ptr, ind):
    """The ordering in numpy, one BFS level at a time: its plain version."""
    ptr, ind = _i64(ptr), _i64(ind)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    keep = (ind < m) & (ind != rows)
    src = np.concatenate([rows[keep], ind[keep]])
    dst = np.concatenate([ind[keep], rows[keep]])
    order2 = np.lexsort((dst, src))
    src, dst = src[order2], dst[order2]
    if src.size:  # drop duplicate edges
        uniq = np.concatenate([[True], (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])])
        src, dst = src[uniq], dst[uniq]
    aptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(aptr, src + 1, 1)
    aptr = np.cumsum(aptr)
    deg = np.diff(aptr)
    visited = np.zeros(m, dtype=bool)
    order = []
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        frontier = np.array([seed], dtype=np.int64)
        visited[seed] = True
        while frontier.size:
            order.append(frontier)
            starts, stops = aptr[frontier], aptr[frontier + 1]
            if stops.sum() - starts.sum() == 0:
                nxt = np.zeros(0, dtype=np.int64)
            else:
                nxt = np.unique(np.concatenate([dst[a:b] for a, b in zip(starts, stops)]))
                nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            # degree-ascending within the level (the Cuthill-McKee tie-break)
            frontier = nxt[np.argsort(deg[nxt], kind="stable")] if nxt.size else nxt
    perm = np.concatenate(order)[::-1].copy() if order else np.zeros(0, np.int64)
    ip = np.empty(m, dtype=np.int64)
    ip[perm] = np.arange(m)
    bw = int(np.abs(ip[rows[keep]] - ip[ind[keep]]).max()) if keep.any() else 0
    return perm, bw


def benes_plan(k: int, src) -> np.ndarray:
    """Per-stage cross masks of a Benes network realizing the permutation
    out[j] = in[src[j]] on n = 2**k slots: (2k-1, n) uint8, stage strides
    2^(k-1), ..., 2, 1, 2, ..., 2^(k-1) (kernels/route.py applies them). The
    C++ looping solver is O(n log n) and releases the GIL; the numpy
    version walks the same cycles."""
    src = _i64(src)
    n = 1 << int(k)
    if src.size != n:
        raise ValueError(f"src must have {n} entries, got {src.size}")
    if k == 0:
        return np.zeros((0, 1), dtype=np.uint8)
    masks = np.empty((2 * int(k) - 1, n), dtype=np.uint8)
    lib = _load()
    if lib is None:
        return _benes_numpy(int(k), src, masks)
    lib.benes_plan(ctypes.c_int64(int(k)), _ptr(src, _I64P), _ptr(masks, _U8P))
    return masks


def _benes_numpy(k: int, src: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """The routing plan in numpy: its plain version, for tests."""
    n = 1 << k
    q_of = src.copy()
    a = np.empty(n, dtype=np.int64)
    a[src] = np.arange(n)
    out_of = np.arange(n)
    o_at = np.arange(n)
    color = np.zeros(n, dtype=np.uint8)
    for d in range(k - 1):
        s = 1 << (k - 1 - d)
        t1, t2 = d, 2 * k - 2 - d
        done = np.zeros(n, dtype=bool)
        for j0 in range(n):
            e = int(o_at[j0])
            if done[e]:
                continue
            c = 0
            while True:
                color[e] = c
                done[e] = True
                e2 = int(a[int(q_of[e]) ^ s])
                color[e2] = 1 - c
                done[e2] = True
                e3 = int(o_at[int(out_of[e2]) ^ s])
                if done[e3]:
                    break
                e = e3
        lo = (np.arange(n) & s) == 0
        ci = color[a[lo.nonzero()[0]]]
        masks[t1][lo] = ci
        masks[t1][~lo] = ci  # partner slots share the switch
        co = color[o_at[lo.nonzero()[0]]]
        masks[t2][lo] = co
        masks[t2][~lo] = co
        q_of = (q_of & ~s) | np.where(color == 1, s, 0)
        out_of = (out_of & ~s) | np.where(color == 1, s, 0)
        a[q_of] = np.arange(n)
        o_at[out_of] = np.arange(n)
    # the middle stage, stride 1
    tm = k - 1
    ev = np.arange(0, n, 2)
    cr = (q_of[o_at[ev]] != ev).astype(np.uint8)
    masks[tm][ev] = cr
    masks[tm][ev + 1] = cr
    return masks


_I32_MAX = np.iinfo(np.int32).max


def spgemm_expand(mA: int, Aptr, Aind, Bptr, Bind, upper_only: bool = False):
    """Full symbolic stage: (pa, pb, pc, Cptr, Cind) with the products
    ordered by (row, col), or None when the library is missing or the
    product triples would pass int32 (the caller takes its numpy sort
    path)."""
    lib = _load()
    if lib is None:
        return None
    Aptr64, Aind64, Bptr64, Bind64 = _i64(Aptr), _i64(Aind), _i64(Bptr), _i64(Bind)
    P = int(np.diff(Bptr64)[Aind64].sum()) if Aind64.size else 0  # upper bound on products
    if P >= _I32_MAX or Aind64.size >= _I32_MAX or Bind64.size >= _I32_MAX or (
        Bind64.size and int(Bind64.max()) >= _I32_MAX
    ):
        return None
    pa, pb, pc = (np.empty(P, dtype=np.int32) for _ in range(3))
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    Cind = np.empty(max(P, 1), dtype=np.int32)
    kept = np.zeros(1, dtype=np.int64)
    nnzC = lib.spgemm_expand(
        ctypes.c_int64(mA), _ptr(Aptr64, _I64P), _ptr(Aind64, _I64P), _ptr(Bptr64, _I64P),
        _ptr(Bind64, _I64P), _ptr(pa, _I32P), _ptr(pb, _I32P), _ptr(pc, _I32P), _ptr(Cptr, _I64P),
        _ptr(Cind, _I32P), ctypes.c_uint8(1 if upper_only else 0), _ptr(kept, _I64P),
    )
    kp = int(kept[0])
    return pa[:kp], pb[:kp], pc[:kp], Cptr, Cind[:nnzC]


def spgemm_pattern(mA: int, Aptr, Aind, Bptr, Bind):
    """Pattern-only symbolic stage: (Cptr, Cind, P) without the O(P)
    product triples (the band numeric engine needs only C's pattern). None
    when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    Aptr64, Aind64, Bptr64, Bind64 = _i64(Aptr), _i64(Aind), _i64(Bptr), _i64(Bind)
    if Bind64.size and int(Bind64.max()) >= _I32_MAX:
        return None
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    Pptr = np.zeros(mA + 1, dtype=np.int64)
    args = (ctypes.c_int64(mA), _ptr(Aptr64, _I64P), _ptr(Aind64, _I64P), _ptr(Bptr64, _I64P),
            _ptr(Bind64, _I64P), _ptr(Cptr, _I64P), _ptr(Pptr, _I64P))
    nnzC = int(lib.spgemm_pattern_count(*args))
    Cind = np.empty(max(nnzC, 1), dtype=np.int32)
    lib.spgemm_pattern_fill(*args, _ptr(Cind, _I32P))
    return Cptr, Cind[:nnzC], int(Pptr[mA])


def spgemm_nnz(mA: int, nB: int, Aptr, Aind, Bptr, Bind) -> Tuple[np.ndarray, int]:
    """Symbolic C row pointer (the Gustavson marker scan) and nnz(C)."""
    lib = _load()
    Aptr64, Aind64, Bptr64, Bind64 = _i64(Aptr), _i64(Aind), _i64(Bptr), _i64(Bind)
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    if lib is not None:
        total = lib.spgemm_nnz(
            ctypes.c_int64(mA), ctypes.c_int64(nB), _ptr(Aptr64, _I64P), _ptr(Aind64, _I64P),
            _ptr(Bptr64, _I64P), _ptr(Bind64, _I64P), _ptr(Cptr, _I64P),
        )
        return Cptr, int(total)
    marker = np.full(nB, -1, dtype=np.int64)
    total = 0
    for i in range(mA):
        for k in range(int(Aptr64[i]), int(Aptr64[i + 1])):
            kk = int(Aind64[k])
            cols = Bind64[int(Bptr64[kk]) : int(Bptr64[kk + 1])]
            fresh = cols[marker[cols] != i]
            marker[fresh] = i
            total += int(fresh.size)
        Cptr[i + 1] = total
    return Cptr, total


def spgemm_numeric_host(pa, pb, pc, aval, bval, nnzC: int):
    """Threaded host numeric pass over the expansion plan (the reference's
    numeric Gustavson, level3/aoclsparse_csr2m.cpp:405-545): threads own
    disjoint output ranges of the sorted pc, so the accumulation is
    race-free. Returns the (nnzC,) values, or None when the library is
    missing or the dtype has no instance (the caller takes the device
    engine)."""
    lib = _load()
    if lib is None:
        return None
    pa32, pb32, pc32 = (np.ascontiguousarray(np.asarray(a), dtype=np.int32) for a in (pa, pb, pc))
    av = np.ascontiguousarray(np.asarray(aval))
    bv = np.ascontiguousarray(np.asarray(bval))
    dt = np.result_type(av.dtype, bv.dtype)
    if dt not in _VALP:
        return None
    av = av.astype(dt, copy=False)
    bv = bv.astype(dt, copy=False)
    suf, vp = _VALP[dt]
    cv = np.zeros(max(int(nnzC), 1), dtype=dt)

    def vptr(a):
        return ctypes.c_void_p(a.ctypes.data) if vp is ctypes.c_void_p else _ptr(a, vp)

    getattr(lib, f"spgemm_numeric_{suf}")(
        ctypes.c_int64(pa32.size), _ptr(pa32, _I32P), _ptr(pb32, _I32P), _ptr(pc32, _I32P),
        vptr(av), vptr(bv), vptr(cv), ctypes.c_int64(int(nnzC)),
    )
    return cv[: int(nnzC)]


def _blkcsr_numpy(m, n, ptr, ind, nrowsblk, build):
    """The greedy masked-block scan in numpy (the library's plain version):
    Python loops over row groups, a searchsorted per subrow for the consume
    step (columns are sorted)."""
    W = 8
    total = 0
    brow_ptr = np.zeros(m + 1, dtype=np.int64) if build else None
    bcols, masks, perm = [], [], []
    for r0 in range(0, m, nrowsblk):
        nr = min(nrowsblk, m - r0)
        cur = ptr[r0 : r0 + nr].astype(np.int64).copy()
        end = ptr[r0 + 1 : r0 + nr + 1].astype(np.int64)
        blk0 = total
        while True:
            live = [ind[cur[s]] for s in range(nr) if cur[s] < end[s]]
            if not live:
                break
            c0 = int(min(live))
            cstart = n - W if c0 + W > n else c0
            for s in range(nr):
                stop = cur[s] + np.searchsorted(ind[cur[s] : end[s]], c0 + W)
                if build:
                    cols = ind[cur[s] : stop]
                    masks.append(np.bitwise_or.reduce((1 << (cols - cstart)).astype(np.uint8), initial=np.uint8(0)))
                    perm.append(np.arange(cur[s], stop, dtype=np.int64))
                cur[s] = stop
            if build:
                bcols.append(cstart)
                masks.extend([np.uint8(0)] * (nrowsblk - nr))
            total += 1
        if build:
            brow_ptr[r0] = blk0
            brow_ptr[r0 + 1 : r0 + nr + 1] = total
    if not build:
        return total
    prm = np.concatenate(perm) if perm else np.zeros(0, np.int64)
    return brow_ptr, np.asarray(bcols, dtype=np.int64), np.asarray(masks, dtype=np.uint8), prm


def blkcsr_count(m: int, n: int, ptr, ind, nrowsblk: int) -> int:
    """Number of nrowsblk x 8 blocks of the greedy scan (the reference's
    opt_blksize counting pass, conversion/aoclsparse_convert.cpp:69-110)."""
    lib = _load()
    ptr64, ind64 = _i64(ptr), _i64(ind)
    if lib is None:
        return _blkcsr_numpy(m, n, ptr64, ind64, nrowsblk, build=False)
    return int(lib.blkcsr_count(ctypes.c_int64(m), ctypes.c_int64(n), _ptr(ptr64, _I64P), _ptr(ind64, _I64P),
                                ctypes.c_int64(nrowsblk)))


def blkcsr_build(m: int, n: int, ptr, ind, nrowsblk: int):
    """The blkcsr structure (the reference's csr2blkcsr,
    conversion/aoclsparse_convert.cpp:145-290): (blk_row_ptr, blk_col_ind,
    masks, perm), perm mapping each output value slot to its CSR source."""
    lib = _load()
    ptr64, ind64 = _i64(ptr), _i64(ind)
    if lib is None:
        return _blkcsr_numpy(m, n, ptr64, ind64, nrowsblk, build=True)
    nblk = blkcsr_count(m, n, ptr64, ind64, nrowsblk)
    brow_ptr = np.zeros(m + 1, dtype=np.int64)
    bcol = np.empty(max(nblk, 1), dtype=np.int64)
    masks = np.zeros(max(nblk * nrowsblk, 1), dtype=np.uint8)
    perm = np.empty(max(int(ind64.shape[0]), 1), dtype=np.int64)
    nval = lib.blkcsr_build(ctypes.c_int64(m), ctypes.c_int64(n), _ptr(ptr64, _I64P), _ptr(ind64, _I64P),
                            ctypes.c_int64(nrowsblk), _ptr(brow_ptr, _I64P), _ptr(bcol, _I64P),
                            _ptr(masks, _U8P), _ptr(perm, _I64P))
    return brow_ptr, bcol[:nblk], masks[: nblk * nrowsblk], perm[: int(nval)]
