"""Level-scheduled (wavefront) triangular solve, sv KID 1.

PyTorch counterpart of ``aoclsparse_tpu/kernels/xla/trsv_level.py``, whose
XLA level loops (`_solve_levels_jit` :138, `_solve_runs_jit` :157) have a
hand-written Hopper kernel here, ``csrc/trsv_level.cu``. The form wins where
the dependency DAG is shallow against the blocked chain: all rows of a
level solve at once, so a solve takes `nlev` dependent rounds instead of
m / nb chain steps (planner/triangular.py `sv_engine_for` picks it on the
card by that count).

Reference role: the sequential sweep of level2/aoclsparse_trsv_kt.cpp:65.
The level analysis runs in the host C++ library (native/ level_schedule);
the packing is vectorised numpy. A form holds two layouts of the same
triangle, both built once per structure:

- the padded runs of the plain version: levels grouped into contiguous runs
  of similar width (`_level_runs`), each padded to its own (R, W), as in the
  JAX package; `trsv_level_plain` loops over the levels of each run, nine
  tensor operations a level (`level_step`);
- the compact level-ordered CSR of the kernel (`lrow`, `lptr`, `lcol`,
  `lval`, `dinv`, `lvl_ptr`, rows and columns in the caller's index space),
  with the kernel's readiness words and flags and its epoch counter.

`trsv_level` has the rule of every port kernel: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (one launch a solve; its
grid from `grid_for`) or raises. The kernel has f32, f64, complex64 and
complex128 instances; a bf16 form solves on the CPU only.
`trsv_level.launches` counts launches per instance. The form keeps source
positions into the effective values, so `refresh()` regathers both layouts'
values on the device.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import AoclSparseError, Status
from .build import load_library

__all__ = [
    "DTYPES",
    "LevelForm",
    "build_level_form",
    "level_form_stats",
    "grid_for",
    "hop_probe",
    "level_step",
    "trsv_level",
    "trsv_level_plain",
]

#: dtype -> (instance name, C entry point, kind code of trsv_level_occupancy)
_INSTANCES = {
    torch.float32: ("f32", "trsv_level_f32", 0),
    torch.float64: ("f64", "trsv_level_f64", 1),
    torch.complex64: ("c64", "trsv_level_c64", 2),
    torch.complex128: ("c128", "trsv_level_c128", 3),
}
#: operand dtypes the kernel has instances for
DTYPES = tuple(_INSTANCES)
#: the largest epoch before the readiness words and flags are zeroed again
EPOCH_MAX = 2**31 - 1
#: warps of a CTA (csrc/trsv_level.cu kThreads / 32), one row a warp
CTA_WARPS = 16
#: the grid's warps for each row of the triangle's mean level (m / nlev),
#: at least a CTA an SM and at most what the card holds (`grid_for`; swept
#: by scripts/level_bench.py)
LEVEL_SLACK = 2.5

_fns = {}
_occupancy = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        if symbol == "trsv_level_occupancy":
            fn.argtypes = [ctypes.c_int64] * 2 + [ctypes.c_void_p]
        elif symbol == "trsv_level_hop_probe":
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def grid_for(m: int, nlev: int, sms: int, per_sm: int) -> int:
    """CTAs of a launch over m rows in nlev levels, on a card of `sms` SMs
    holding `per_sm` CTAs each: LEVEL_SLACK warps a row of the mean level,
    so that a warp has a few levels' time for its loads and no more warps
    poll than that, within [sms, sms * per_sm]."""
    want = -(-int(LEVEL_SLACK * m / max(nlev, 1)) // CTA_WARPS)
    return max(sms, min(sms * per_sm, want))


def _resident(kind: int, K: int, dev: torch.device):
    """(SMs, resident CTAs an SM) of the instance on `dev`, cached."""
    key = (kind, K == 1, dev.index)
    got = _occupancy.get(key)
    if got is None:
        out = (ctypes.c_int64 * 2)()
        with torch.cuda.device(dev):
            rc = _entry("trsv_level_occupancy")(kind, K, ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"level solve occupancy query failed: CUDA error {rc}")
        got = _occupancy[key] = (int(out[0]), int(out[1]))
    return got


def hop_probe(word: torch.Tensor, smids: torch.Tensor, rounds: int, mode: int) -> None:
    """One launch of the hop probe (csrc/trsv_level.cu): two CTAs on two
    SMs pass a counter `rounds` times through the int64 `word` (zeroed by
    the caller), relaxed (mode 0) or release / acquire (mode 1) at GPU
    scope, or two warps of one CTA through shared memory (mode 2); a round
    is two hops. `smids` (2,) int32 receives the CTAs' SMs. Not
    synchronised."""
    if word.device.type != "cuda" or word.dtype != torch.int64 or smids.dtype != torch.int32 or smids.numel() < 2:
        raise AoclSparseError(Status.invalid_value, "hop_probe needs an int64 word and two int32 slots on the card")
    with torch.cuda.device(word.device):
        rc = _entry("trsv_level_hop_probe")(word.data_ptr(), smids.data_ptr(), rounds, mode,
                                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hop probe launch failed: CUDA error {rc}")


@dataclasses.dataclass
class LevelForm:
    """Wavefront execution form of one lower-oriented triangle: per run of
    levels lo..hi, rows (nl, R) (padding rows point at the scratch row m),
    their validity, the strict entries' columns (nl, R, W) and validity,
    all on the device, and host source maps of their values; beside them
    the kernel's compact level-ordered CSR."""

    m: int
    nlev: int
    R_max: int  # widest level
    W_max: int  # most strict entries in a row
    reversed_: bool
    unit_diag: bool
    runs: Tuple = ()  # ((lo, hi, R, W), ...)
    _run_struct: Tuple = ()  # ((rows, row_valid, cols, col_valid), ...) tensors
    _run_srcL: Tuple = ()  # ((nl, R, W) int64 source positions, -1 = none)
    _run_srcD: Tuple = ()  # ((nl, R) int64 diagonal source positions)
    _run_vals: Tuple = ()  # ((Lval, Dinv), ...) tensors
    #: the compact level-ordered CSR (int32, the caller's index space):
    #: position p holds row lrow[p], its strict entries lptr[p]..lptr[p+1]
    lrow: Optional[torch.Tensor] = None
    lptr: Optional[torch.Tensor] = None
    lcol: Optional[torch.Tensor] = None
    lvl_ptr: Optional[torch.Tensor] = None  # (nlev + 1,) positions
    lval: Optional[torch.Tensor] = None  # strict values in position order
    dinv: Optional[torch.Tensor] = None  # (m,) inverted diagonal by position
    _srcL: Optional[np.ndarray] = None  # source positions of lval
    _srcD: Optional[np.ndarray] = None  # of dinv's diagonal, by position
    #: the kernel's ready flags (K > 1) and readiness words (K = 1) on the
    #: card and the epoch of its last launch
    _ready: Optional[torch.Tensor] = None
    _words: Optional[torch.Tensor] = None
    _epoch: int = 0
    #: bumped by refresh: copies of the values kept elsewhere
    #: (parallel/trsv.py) are valid for one epoch
    values_epoch: int = 0

    def _vals_for(self, v: torch.Tensor, Ls: np.ndarray, Ds: np.ndarray):
        dev = v.device
        Lt = torch.from_numpy(Ls).to(dev)
        lv = torch.where(Lt >= 0, v[Lt.clamp(min=0)], torch.zeros((), dtype=v.dtype, device=dev))
        if self.unit_diag:
            di = torch.ones(Ds.shape, dtype=v.dtype, device=dev)
        else:
            Dt = torch.from_numpy(Ds).to(dev)
            di = 1.0 / torch.where(Dt >= 0, v[Dt.clamp(min=0)], torch.ones((), dtype=v.dtype, device=dev))
        return lv, di

    def refresh(self, eff_val: torch.Tensor) -> None:
        """Regather the run values and the compact values from new
        effective values."""
        self._run_vals = tuple(self._vals_for(eff_val, Ls, Ds) for Ls, Ds in zip(self._run_srcL, self._run_srcD))
        self.lval, self.dinv = self._vals_for(eff_val, self._srcL, self._srcD)
        self.values_epoch += 1

    def next_epoch(self, dev: torch.device, nwords: int = 0) -> int:
        """The epoch of the next launch on `dev`: the flags are made (zero)
        at the first launch, the readiness words (`nwords` 64-bit words a
        row) at the first launch that asks for them, and both are zeroed
        again when the counter passes EPOCH_MAX."""
        if self._ready is None or self._ready.device != dev:
            self._ready = torch.zeros(self.m, dtype=torch.int32, device=dev)
            self._words = None
            self._epoch = 0
        if nwords and self._words is None:
            self._words = torch.zeros(self.m * nwords, dtype=torch.int64, device=dev)
        self._epoch += 1
        if self._epoch > EPOCH_MAX:
            self._ready.zero_()
            if self._words is not None:
                self._words.zero_()
            self._epoch = 1
        return self._epoch

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = T^{-1} b for b (m,) or (m, k) on the form's device."""
        return trsv_level(self, b.to(self.lval.dtype))


def level_step(x, bp, r, rv, c, cv, lv, di):
    """Solve one level against the partial solution x: its rows' new
    entries (R, k), zero on padding rows (kernels/xla/trsv_level.py:125)."""
    g = x[c]  # (R, W, k) already-solved entries
    contrib = torch.where(cv[..., None], lv[..., None] * g, torch.zeros((), dtype=x.dtype, device=x.device))
    xi = (bp[r] - contrib.sum(1)) * di[..., None]
    return torch.where(rv[..., None], xi, torch.zeros((), dtype=x.dtype, device=x.device))


def trsv_level_plain(form: LevelForm, b: torch.Tensor) -> torch.Tensor:
    """The solve in plain PyTorch over the padded runs: a Python loop over
    the levels, one `level_step` each (kernels/xla/trsv_level.py:157)."""
    squeeze = b.dim() == 1
    b2 = b[:, None] if squeeze else b
    if form.reversed_:
        b2 = b2.flip(0)
    k = b2.shape[1]
    x = torch.zeros(form.m + 1, k, dtype=b2.dtype, device=b2.device)
    bp = torch.cat([b2, torch.zeros(1, k, dtype=b2.dtype, device=b2.device)])
    for (lo, hi, _R, _W), (rows, rv, cols, cv), (lv, di) in zip(form.runs, form._run_struct, form._run_vals):
        for lvl in range(hi - lo):
            x[rows[lvl]] = level_step(x, bp, rows[lvl], rv[lvl], cols[lvl], cv[lvl], lv[lvl], di[lvl])
    x = x[: form.m]
    if form.reversed_:
        x = x.flip(0)
    return x[:, 0] if squeeze else x


def trsv_level(form: LevelForm, b: torch.Tensor) -> torch.Tensor:
    """x = T^{-1} b over `form`, b (m,) or (m, K) of the form's dtype. The
    plain version on a CPU tensor; one launch of csrc/trsv_level.cu on a
    CUDA tensor, on the current stream, not synchronised."""
    if form.lval.dtype != b.dtype:
        raise AoclSparseError(Status.wrong_type, f"a level form of {form.lval.dtype} with b of {b.dtype}")
    if b.dim() not in (1, 2) or b.shape[0] != form.m:
        raise AoclSparseError(Status.invalid_size, f"b must be ({form.m},) or ({form.m}, K), got {tuple(b.shape)}")
    if b.device != form.lval.device:
        raise AoclSparseError(Status.invalid_value, "operands on different devices")
    if b.device.type == "cpu":
        return trsv_level_plain(form, b)
    if b.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no level-solve kernel for {b.device}")
    inst = _INSTANCES.get(b.dtype)
    if inst is None:
        raise AoclSparseError(Status.wrong_type, f"level solve has no instance for {b.dtype}")
    name, symbol, kind = inst
    B = (b[:, None] if b.dim() == 1 else b).contiguous()
    X = torch.empty_like(B)
    if form.m == 0 or B.shape[1] == 0:
        return X if b.dim() == 2 else X[:, 0]
    K = B.shape[1]
    dev = b.device
    grid = grid_for(form.m, form.nlev, *_resident(kind, K, dev))
    epoch = form.next_epoch(dev, B.element_size() // 4 if K == 1 else 0)
    sync = form._words if K == 1 else form._ready
    n = ctypes.c_int64(0)
    with torch.cuda.device(dev):
        rc = _entry(symbol)(
            form.lrow.data_ptr(),
            form.lptr.data_ptr(),
            form.lcol.data_ptr(),
            form.lval.data_ptr(),
            form.dinv.data_ptr(),
            B.data_ptr(),
            X.data_ptr(),
            sync.data_ptr(),
            form.m,
            K,
            grid,
            epoch,
            torch.cuda.current_stream().cuda_stream,
            ctypes.addressof(n),
        )
    if rc != 0:
        raise RuntimeError(f"level solve ({name}) launch failed: CUDA error {rc}")
    trsv_level.launches[name] += 1
    return X if b.dim() == 2 else X[:, 0]


trsv_level.launches = {name: 0 for name, _sym, _kind in _INSTANCES.values()}


def _level_runs(counts, wlev, slack: float = 1.6, max_runs: int = 16):
    """Greedy contiguous grouping of levels into runs (lo, hi, R, W): extend
    a run while its padded cost stays within `slack` of the exact per-level
    cost; past max_runs, widen the slack, then merge the adjacent pair whose
    merge costs least (kernels/xla/trsv_level.py:184-226)."""
    nlev = counts.shape[0]
    runs = []
    while True:
        runs.clear()
        lo = 0
        Rr = Wr = exact = 0
        for lvl in range(nlev):
            R_l, W_l = int(counts[lvl]), max(int(wlev[lvl]), 1)
            c_l = R_l * (W_l + 1)
            nR, nW = max(Rr, R_l), max(Wr, W_l)
            padded = (lvl - lo + 1) * nR * (nW + 1)
            if lvl > lo and padded > slack * (exact + c_l):
                runs.append((lo, lvl, Rr, Wr))
                lo, Rr, Wr, exact = lvl, R_l, W_l, c_l
            else:
                Rr, Wr, exact = nR, nW, exact + c_l
        runs.append((lo, nlev, Rr, Wr))
        if len(runs) <= max_runs or slack > 64:
            break
        slack *= 1.8

    def _cost(run):
        lo_, hi_, R_, W_ = run
        return (hi_ - lo_) * R_ * (W_ + 1)

    while len(runs) > max_runs:
        best_i, best_c = 0, None
        for i in range(len(runs) - 1):
            a, b = runs[i], runs[i + 1]
            merged = (a[0], b[1], max(a[2], b[2]), max(a[3], b[3]))
            dc = _cost(merged) - _cost(a) - _cost(b)
            if best_c is None or dc < best_c:
                best_i, best_c = i, dc
        a, b = runs[best_i], runs[best_i + 1]
        runs[best_i : best_i + 2] = [(a[0], b[1], max(a[2], b[2]), max(a[3], b[3]))]
    return tuple(runs)


def _levels(ptr: np.ndarray, ind: np.ndarray, m: int):
    """(levels, nlev, per-level row counts, per-level widest strict row)."""
    from .. import native

    levels, nlev = native.level_schedule(m, ptr, ind)
    nlev = max(int(nlev), 1)
    counts = np.bincount(levels, minlength=nlev).astype(np.int64) if m else np.zeros(1, np.int64)
    rows_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    strict = ind < rows_of
    wlev = np.zeros(nlev, dtype=np.int64)
    if strict.any():
        np.maximum.at(wlev, levels, np.bincount(rows_of[strict], minlength=m))
    return levels, nlev, counts, wlev, rows_of, strict


def level_form_stats(eff_ptr, eff_ind, m: int):
    """(nlev, padded run entries) of the form without building it: the
    dispatcher's routing check (kernels/xla/trsv_level.py:233-253)."""
    ptr = np.asarray(eff_ptr, dtype=np.int64)
    ind = np.asarray(eff_ind, dtype=np.int64)
    _lv, nlev, counts, wlev, _r, _s = _levels(ptr, ind, m)
    runs = _level_runs(counts, wlev) if m else ()
    return nlev, int(sum((hi - lo) * R * (W + 1) for lo, hi, R, W in runs))


def _compact(ptr, ind, src, m, levels, counts, order, rows_of, strict, dmask, reversed_):
    """The kernel's compact level-ordered CSR of a lower-oriented triangle:
    (lrow, lptr, lcol, lvl_ptr) int32, in the caller's index space (an upper
    source's reversal undone: index i -> m - 1 - i), and the source
    positions of the strict values (position order, each row's entries in
    ascending oriented column) and of the diagonal (by position; -1 none)."""
    if ind.size >= 2**31 or m >= 2**31:
        raise AoclSparseError(Status.invalid_size, "the level form's compact CSR needs int32 indices")
    pos_of = np.empty(m, dtype=np.int64)
    pos_of[order] = np.arange(m, dtype=np.int64)
    se = np.nonzero(strict)[0]
    se = se[np.argsort(pos_of[rows_of[se]], kind="stable")]  # rows in position order, columns kept in order
    lptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(pos_of[rows_of[se]], minlength=m), out=lptr[1:])
    srcD = np.full(m, -1, dtype=np.int64)
    srcD[pos_of[rows_of[dmask]]] = src[dmask]
    lvl_ptr = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=lvl_ptr[1:])

    def caller(i):
        return (m - 1 - i) if reversed_ else i

    return (caller(order).astype(np.int32), lptr.astype(np.int32), caller(ind[se]).astype(np.int32),
            lvl_ptr.astype(np.int32), src[se].astype(np.int64), srcD)


def build_level_form(eff_ptr, eff_ind, eff_src, m: int, reversed_: bool, unit_diag: bool,
                     eff_val: torch.Tensor) -> LevelForm:
    """The form of a lower-oriented triangle (sorted CSR ptr/ind, src mapping
    each entry to its position in eff_val), run by run, so a deep or skewed
    DAG allocates about its exact level sizes (kernels/xla/trsv_level.py:256)."""
    ptr = np.asarray(eff_ptr, dtype=np.int64)
    ind = np.asarray(eff_ind, dtype=np.int64)
    src = np.asarray(eff_src, dtype=np.int64)
    levels, nlev, counts, wlev, rows_of, strict = _levels(ptr, ind, m)
    R_max = max(int(counts.max()) if counts.size else 1, 1)
    lvl_first = np.zeros(nlev, dtype=np.int64)
    np.cumsum(counts[:-1], out=lvl_first[1:])
    order = np.lexsort((np.arange(m), levels))  # rows grouped by level
    slot_of = np.empty(m, dtype=np.int64)
    slot_of[order] = np.arange(m, dtype=np.int64) - lvl_first[levels[order]]
    pos_in_row = np.arange(ind.size, dtype=np.int64) - np.repeat(ptr[:-1], np.diff(ptr))
    W_max = max(1, int(wlev.max())) if m else 1
    dmask = ind == rows_of
    if not unit_diag:
        has_d = np.zeros(m, dtype=bool)
        has_d[rows_of[dmask]] = True
        if not has_d.all():
            raise AoclSparseError(Status.invalid_value, f"missing diagonal entry in row {int(np.nonzero(~has_d)[0][0])}")
    runs = _level_runs(counts, wlev) if m else ()
    dev = eff_val.device
    e_lv = levels[rows_of] if m else rows_of
    run_struct, run_srcL, run_srcD = [], [], []
    for lo, hi, R, W in runs:
        nl = hi - lo
        rids = np.nonzero((levels >= lo) & (levels < hi))[0]
        li, si = levels[rids] - lo, slot_of[rids]
        rows_r = np.full((nl, R), m, dtype=np.int64)
        rv_r = np.zeros((nl, R), dtype=bool)
        rows_r[li, si] = rids
        rv_r[li, si] = True
        cols_r = np.zeros((nl, R, W), dtype=np.int64)
        cv_r = np.zeros((nl, R, W), dtype=bool)
        Ls_r = np.full((nl, R, W), -1, dtype=np.int64)
        emask = strict & (e_lv >= lo) & (e_lv < hi)
        if emask.any():
            er, pe = rows_of[emask], pos_in_row[emask]
            at = (levels[er] - lo, slot_of[er], pe)
            cols_r[at] = ind[emask]
            cv_r[at] = True
            Ls_r[at] = src[emask]
        Ds_r = np.full((nl, R), -1, dtype=np.int64)
        dm = dmask & (e_lv >= lo) & (e_lv < hi)
        if dm.any():
            dr = rows_of[dm]
            Ds_r[levels[dr] - lo, slot_of[dr]] = src[dm]
        run_struct.append(tuple(torch.from_numpy(a).to(dev) for a in (rows_r, rv_r, cols_r, cv_r)))
        run_srcL.append(Ls_r)
        run_srcD.append(Ds_r)
    lrow, lptr, lcol, lvl_ptr, srcL, srcD = _compact(ptr, ind, src, m, levels, counts, order, rows_of, strict,
                                                     dmask, reversed_)
    form = LevelForm(
        m=m,
        nlev=nlev,
        R_max=R_max,
        W_max=W_max,
        reversed_=reversed_,
        unit_diag=unit_diag,
        runs=runs,
        _run_struct=tuple(run_struct),
        _run_srcL=tuple(run_srcL),
        _run_srcD=tuple(run_srcD),
        lrow=torch.from_numpy(lrow).to(dev),
        lptr=torch.from_numpy(lptr).to(dev),
        lcol=torch.from_numpy(lcol).to(dev),
        lvl_ptr=torch.from_numpy(lvl_ptr).to(dev),
        _srcL=srcL,
        _srcD=srcD,
    )
    form.refresh(eff_val)
    return form
