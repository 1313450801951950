"""Planner for mv and mm: clean CSR -> effective CSR -> execution form.

PyTorch counterpart of ``aoclsparse_tpu/planner/plan.py`` for the forms this
package runs: ``bandt``, ``bwd`` (the G = 8 group windows of mv KID 5),
``gen`` (the general-structure composite), ``route`` (the whole-matrix
spill-route engine), ``bwdg`` (a SpGEMM product's seeded band, or mv KID
9), ``diag`` (mv KID 6), ``sell`` (sliced ELL, KID 10), ``host`` (the host
engine, KID 11), ``ell``, ``ellhyb`` and ``segsum`` for mv; ``bandtm``,
``diag``, ``bwdg``, ``ell``, ``ellhyb`` and ``segsum`` for mm. Reference
analogs:

- clean-CSR construction `aoclsparse_csr_csc_optimize`
  (analysis/aoclsparse_csr_util.hpp:764-945): validate, sort, split triangles.
- DOID copies `aoclsparse_matrix_transform` (csr_util.hpp:516-759): general
  form / transposed / conjugated copies cached per (descriptor, operation).
- SpMV format selection `aoclsparse_optimize_mv`
  (analysis/aoclsparse_analysis.cpp:35-385), re-derived for Hopper in
  `choose_mv_format`; the SpMM counterpart in `choose_mm_format`.

Structure work (sorting, triangle splits, scatter maps) is host numpy, once
per structure, exactly as in the JAX package. Values stay tensors on the
matrix's device, and every value-derived operand is rebuilt by a device
gather/scatter in `refresh`, so `update_values` never re-plans.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.descr import MatrixDescriptor
from ..core.formats import CSR
from ..core.matrix import SparseMatrix
from ..core.types import (
    AoclSparseError,
    DiagType,
    FillMode,
    MatrixType,
    MemoryPolicy,
    Operation,
    Status,
)
from ..core.validate import host_array

__all__ = [
    "BANDT_MAX_W",
    "BWD_CAP",
    "GEN_B",
    "ROUTE_MAX_NNZ",
    "ROUTE_MIN_NNZ",
    "CleanCSR",
    "EffectiveCSR",
    "ExecForm",
    "Plan",
    "build_clean_csr",
    "build_effective_csr",
    "build_exec_form",
    "CARD_MV_CSR_DTYPES",
    "choose_mm_format",
    "choose_mv_format",
    "DIAG_CSR_SLOTS",
    "diag_beats_csr",
    "gather_fallback_kind",
    "gen_beats_csr_mm",
    "GEN_CSR_SLOTS",
    "MM_CSR_DEVICES",
    "mm_gather_kind",
    "pick_mv_format",
    "structure_mv_format",
    "gen_mm_ok",
    "get_plan",
    "mm_kind",
    "optimize",
]


def _dev_index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host index map -> int64 device tensor (torch's native index type)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _csr_index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host CSR index array -> device tensor in its own int32 or int64
    dtype (other integer types widen to int64): what the CSR kernel reads."""
    a = np.asarray(a)
    if a.dtype not in (np.int32, np.int64):
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def attach_csr_plan(form: "ExecForm", ptr: np.ndarray) -> None:
    """Put a segsum form's row pointers and the CSR kernels' block schedule
    (kernels/spmv_csr.py `csr_blocks`) on its device, where the form lacks
    them (at build, and on loading a plan snapshot written before segsum
    forms carried them or with an earlier schedule). The row of each entry
    is kept only on the CPU, where the plain gathers run the form's mv and
    mm; on the card both kernels (csrc/spmv_csr.cu, csrc/spmm_csr.cu) read
    ptr and the schedule."""
    from ..kernels.spmv_csr import csr_blocks, row_ids_from_ptr, tile_of

    dev = form.val.device
    if form.ptr is None:
        form.ptr = _csr_index(ptr, dev)
    if form.csr_blocks is None:
        form.csr_blocks = _dev_index(csr_blocks(ptr, *tile_of(form.val.dtype)), dev)
    if dev.type != "cpu":
        form.row_ids = None
    elif form.row_ids is None:
        form.row_ids = row_ids_from_ptr(form.ptr, form.ind.shape[0])


# ---------------------------------------------------------------------------
# clean CSR (validated, sorted, zero-based, triangle-split)
# ---------------------------------------------------------------------------


def host_values(t: torch.Tensor) -> np.ndarray:
    """A value tensor on the host as numpy; bf16 widens to float32 (numpy
    has no bfloat16), so host work on bf16 values runs in f32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@dataclasses.dataclass
class CleanCSR:
    """Sorted zero-based CSR + triangle split pointers.

    idiag[i] = offset of the diagonal entry of row i (or the position where it
    would be, if missing); iurow[i] = offset of the first strictly-upper entry.
    Mirrors aoclsparse_csr_csc_indices (csr_util.cpp:389).
    """

    ptr: np.ndarray  # (m+1,) int32 host copy (the planner reads structure)
    ind: np.ndarray  # (nnz,) int32 host copy
    val: torch.Tensor  # (nnz,) device values (sorted order)
    perm: np.ndarray  # (nnz_in,) int64: sorted-order source positions
    idiag: np.ndarray  # (m,)
    iurow: np.ndarray  # (m,)
    has_diag: np.ndarray  # (m,) bool: row i stores its diagonal entry
    fulldiag: bool
    shape: Tuple[int, int]
    #: set when the input had duplicate (row, col) entries: maps each sorted
    #: input entry to its merged slot (values accumulate, matching the dense
    #: oracle's duplicate-summing semantics)
    merge_seg: Optional[np.ndarray] = None
    #: host copy of `val`, fetched once by host_val() for the host builders
    val_host: Optional[np.ndarray] = None

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.ind.size)

    def host_val(self) -> np.ndarray:
        """Host copy of the sorted values, cached: the native ILU0 and the
        triangular form builders read values on the host (`host_values`)."""
        if self.val_host is None:
            self.val_host = host_values(self.val)
        return self.val_host

    def refresh(self, new_val: torch.Tensor) -> None:
        self.val_host = None
        dev = new_val.device
        v = new_val.reshape(-1)[_dev_index(self.perm, dev)]
        if self.merge_seg is not None:
            v = torch.zeros(self.nnz, dtype=v.dtype, device=dev).index_add_(
                0, _dev_index(self.merge_seg, dev), v
            )
        self.val = v


def _triangle_split(m, ptr, ind_s, rows):
    """Vectorized idiag/iurow/has_diag over a sorted CSR
    (aoclsparse_csr_csc_indices analog, csr_util.cpp:389)."""
    ptr64 = np.asarray(ptr, dtype=np.int64)
    idiag = np.empty(m, dtype=np.int64)
    iurow = np.empty(m, dtype=np.int64)
    has_diag = np.zeros(m, dtype=bool)
    if ind_s.size == 0 or m == 0:
        idiag[:] = ptr64[:-1]
        iurow[:] = ptr64[:-1]
        return idiag, iurow, has_diag
    below = (ind_s < rows).astype(np.int64)  # strictly-lower entries
    on = ind_s == rows
    csum_below = np.concatenate([[0], np.cumsum(below)])
    csum_on = np.concatenate([[0], np.cumsum(on.astype(np.int64))])
    nbelow = csum_below[ptr64[1:]] - csum_below[ptr64[:-1]]
    non = csum_on[ptr64[1:]] - csum_on[ptr64[:-1]]
    idiag[:] = ptr64[:-1] + nbelow
    has_diag[:] = non > 0
    iurow[:] = idiag + non
    return idiag, iurow, has_diag


def _ranges_concat(starts, stops):
    """Vectorized concatenate([arange(s, e) for s, e in zip(starts, stops)])."""
    starts = np.asarray(starts, dtype=np.int64)
    stops = np.asarray(stops, dtype=np.int64)
    lens = stops - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64), lens
    firsts = np.zeros(lens.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=firsts[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(firsts, lens)
    return np.repeat(starts, lens) + within, lens


def build_clean_csr(A: CSR) -> CleanCSR:
    """Validate + sort + split (aoclsparse_csr_csc_optimize analog). Missing
    diagonal entries are NOT injected into the general matrix; triangle views
    inject unit diagonals in build_effective_csr."""
    ptr = host_array(A.ptr)
    ind = host_array(A.ind)
    m, n = A.shape
    dev = A.val.device
    lens = np.diff(ptr)
    if np.any(lens < 0) or (ind.size and (ind.min() < 0 or ind.max() >= n)):
        raise AoclSparseError(Status.invalid_index_value, "corrupt CSR structure")
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    # within rows, NON-decreasing suffices: equal (row, col) keys are summed
    # by the duplicate merge below in any order
    if ind.size > 1:
        nondec = ind[1:] >= ind[:-1]
        row_start = rows[1:] != rows[:-1]
        sorted_already = bool(np.all(nondec | row_start))
    else:
        sorted_already = True
    perm = (
        np.arange(ind.size, dtype=np.int64) if sorted_already else np.lexsort((ind, rows))
    )
    ind_s = ind[perm].astype(np.int32)
    val = A.val if sorted_already else A.val[_dev_index(perm, dev)]
    # merge duplicate (row, col) entries by summation (dense-oracle semantics;
    # the scatter-based execution forms require unique slots)
    merge_seg = None
    if ind_s.size > 1:
        same = (ind_s[1:] == ind_s[:-1]) & (rows[perm][1:] == rows[perm][:-1])
        if same.any():
            first = np.concatenate([[True], ~same])
            merge_seg = (np.cumsum(first) - 1).astype(np.int64)
            nuniq = int(merge_seg[-1]) + 1
            val = torch.zeros(nuniq, dtype=val.dtype, device=dev).index_add_(
                0, _dev_index(merge_seg, dev), val
            )
            rows_u = rows[perm][first]
            ind_s = ind_s[first]
            lens_u = np.bincount(rows_u, minlength=m).astype(np.int64)
            ptr = np.concatenate([[0], np.cumsum(lens_u)])
            rows = rows_u
    idiag, iurow, has_diag = _triangle_split(m, ptr, ind_s, rows)
    return CleanCSR(
        ptr=ptr.astype(np.int32),
        ind=ind_s,
        val=val,
        perm=perm.astype(np.int64),
        idiag=idiag,
        iurow=iurow,
        has_diag=has_diag,
        fulldiag=bool(has_diag[: min(m, n)].all()) if m and n else True,
        shape=(m, n),
        merge_seg=merge_seg,
    )


# ---------------------------------------------------------------------------
# effective CSR for (descriptor, operation) — the DOID copy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EffectiveCSR:
    """CSR of the matrix the (descr, op) pair denotes, expressed as a
    structure + a value map over the clean CSR's values:

        val_out = conj? conj(v) : v,  v = src>=0 ? clean.val[src] : const_val

    so a refresh after update_values is one device gather
    (aoclsparse_matrix_transform analog, csr_util.hpp:516-759)."""

    ptr: np.ndarray
    ind: np.ndarray
    src: np.ndarray  # (nnz,) int64, -1 => const_val
    conj: bool
    const_val: float
    shape: Tuple[int, int]
    val: Optional[torch.Tensor] = None  # materialized values
    # symmetric/hermitian merges: which entries are mirrored, how to
    # conjugate ("none" | "all" | "mirror" | "nonmirror"), and the hermitian
    # diagonal (realified)
    mirror_mask: Optional[np.ndarray] = None
    conj_mode: Optional[str] = None
    herm_diag_mask: Optional[np.ndarray] = None

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.ind.size)

    def materialize(self, clean_val: torch.Tensor) -> None:
        self.val = _apply_conj_pattern(self, _gather_vals(clean_val, self.src, self.const_val))


def _gather_vals(val: torch.Tensor, src: np.ndarray, const) -> torch.Tensor:
    dev = val.device
    if src.size and not (src >= 0).all():
        fill = torch.full((src.size,), const, dtype=val.dtype, device=dev)
        keep = np.nonzero(src >= 0)[0]
        fill[_dev_index(keep, dev)] = val[_dev_index(src[keep], dev)]
        return fill
    return val[_dev_index(src, dev)]


def _transpose_structure(ptr, ind, src, m, n):
    """Transpose a (structure, src-map) pair host-side."""
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    order = np.lexsort((rows, ind))
    tptr = np.zeros(n + 1, dtype=np.int64)
    if ind.size:
        np.add.at(tptr, ind.astype(np.int64) + 1, 1)
    tptr = np.cumsum(tptr)
    return (
        tptr.astype(np.int32),
        rows[order].astype(np.int32),
        src[order],
    )


def build_effective_csr(
    clean: CleanCSR, descr: MatrixDescriptor, op: Operation, dtype=None
) -> EffectiveCSR:
    """Build the general-form CSR for (descr, op) over the clean structure.

    symmetric/hermitian -> mirrored general copy; triangular -> triangle
    extraction honoring diag_type; op -> structural transpose (+conj).
    Matches the descriptor semantics of aoclsparse_mv.cpp:52-176 and the
    copies of aoclsparse_matrix_transform."""
    descr.validate()
    op = Operation(op)
    m, n = clean.shape
    ptr, ind = clean.ptr, clean.ind
    mtype = MatrixType(descr.type)
    lower = FillMode(descr.fill_mode) == FillMode.lower
    dt = DiagType(descr.diag_type)
    src_all = np.arange(ind.size, dtype=np.int64)

    if mtype == MatrixType.general:
        eptr, eind, esrc = ptr, ind, src_all
        conj_whole = False
        if op != Operation.none:
            eptr, eind, esrc = _transpose_structure(eptr, eind, esrc, m, n)
            m, n = n, m
            conj_whole = op == Operation.conjugate_transpose
        out = EffectiveCSR(eptr, eind, esrc, conj_whole, 0.0, (m, n))
        out.materialize(clean.val)
        return out

    if m != n:
        raise AoclSparseError(Status.invalid_size, f"{mtype.name} requires square matrix")

    # triangle extraction over the split pointers
    lo_r = clean.ptr[:-1].astype(np.int64)
    hi_r = clean.ptr[1:].astype(np.int64)
    if lower:
        tri_lo, tri_hi = lo_r, clean.iurow  # L including diagonal
        strict_lo, strict_hi = lo_r, clean.idiag  # strictly-L
    else:
        tri_lo, tri_hi = clean.idiag, hi_r  # U including diagonal
        strict_lo, strict_hi = clean.iurow, hi_r  # strictly-U

    def _extract(starts, stops):
        src, lens = _ranges_concat(starts, stops)
        eptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        return eptr, ind[src].astype(np.int32), src

    if mtype == MatrixType.triangular:
        if dt == DiagType.non_unit:
            eptr, eind, esrc = _extract(tri_lo, tri_hi)
        else:
            # strict triangle; unit diag injects const 1.0 entries
            eptr, eind, esrc = _extract(strict_lo, strict_hi)
            if dt == DiagType.unit:
                eptr, eind, esrc = _inject_diag(eptr, eind, esrc, m)
        conj_whole = False
        if op != Operation.none:
            eptr, eind, esrc = _transpose_structure(eptr, eind, esrc, m, n)
            conj_whole = op == Operation.conjugate_transpose
        out = EffectiveCSR(eptr, eind, esrc, conj_whole, 1.0, (m, n))
        out.materialize(clean.val)
        return out

    # symmetric / hermitian: tri (with diag) + mirrored strict triangle.
    #   sym: none/transpose identical; conj-transpose = conj(A).
    #   herm: none/conj-transpose identical; transpose = conj(A).
    tptr, tind, tsrc = _extract(tri_lo, tri_hi)
    sptr, sind, ssrc = _extract(strict_lo, strict_hi)
    mptr, mind, msrc = _transpose_structure(sptr, sind, ssrc, m, n)
    # merge rows of (t) and (mirror), vectorized via global (row, col) lexsort
    trows = np.repeat(np.arange(m, dtype=np.int64), np.diff(tptr.astype(np.int64)))
    mrows = np.repeat(np.arange(m, dtype=np.int64), np.diff(mptr.astype(np.int64)))
    allrows = np.concatenate([trows, mrows])
    allind = np.concatenate([tind.astype(np.int64), mind.astype(np.int64)])
    allsrc = np.concatenate([tsrc, msrc])
    allmir = np.concatenate([np.zeros(trows.size, bool), np.ones(mrows.size, bool)])
    order = np.lexsort((allind, allrows))
    eind = allind[order].astype(np.int32)
    esrc = allsrc[order]
    lens = np.bincount(allrows, minlength=m).astype(np.int64)
    eptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    herm = mtype == MatrixType.hermitian
    conj_all = (mtype == MatrixType.symmetric and op == Operation.conjugate_transpose) or (
        herm and op == Operation.transpose
    )
    #   herm, op in {none, conj_transpose} -> conjugate MIRROR entries
    #   sym + conj_transpose              -> conjugate ALL
    #   herm + transpose (= conj(A))      -> conjugate NON-mirror entries
    if herm and not conj_all:
        conj_mode = "mirror"
    elif conj_all and not herm:
        conj_mode = "all"
    elif conj_all and herm:
        conj_mode = "nonmirror"
    else:
        conj_mode = "none"
    out = EffectiveCSR(
        eptr,
        eind,
        esrc,
        False,
        0.0,
        (m, n),
        mirror_mask=allmir[order],
        conj_mode=conj_mode,
        herm_diag_mask=(eind == np.arange(m).repeat(np.diff(eptr.astype(np.int64))))
        if herm
        else None,
    )
    out.materialize(clean.val)
    return out


def _apply_conj_pattern(eff: EffectiveCSR, v: torch.Tensor) -> torch.Tensor:
    """Apply the stored conjugation pattern + hermitian-diagonal realification
    (shared by build and refresh so update_values stays consistent)."""
    if not v.is_complex():
        return v
    mode = eff.conj_mode or ("all" if eff.conj else "none")
    dev = v.device
    if mode == "all":
        v = torch.conj_physical(v)
    elif mode in ("mirror", "nonmirror"):
        mm = torch.from_numpy(eff.mirror_mask).to(dev)
        if mode == "nonmirror":
            mm = ~mm
        v = torch.where(mm, torch.conj_physical(v), v)
    if eff.herm_diag_mask is not None:
        dm = torch.from_numpy(eff.herm_diag_mask).to(dev)
        v = torch.where(dm, v.real.to(v.dtype), v)
    return v


def _inject_diag(eptr, eind, esrc, m):
    """Insert a const-valued diagonal entry into every row (unit diag).
    Vectorized: concatenate the diagonal entries then (row, col)-lexsort."""
    lens0 = np.diff(eptr.astype(np.int64))
    rows0 = np.repeat(np.arange(m, dtype=np.int64), lens0)
    allrows = np.concatenate([rows0, np.arange(m, dtype=np.int64)])
    allind = np.concatenate([eind.astype(np.int64), np.arange(m, dtype=np.int64)])
    allsrc = np.concatenate([esrc, np.full(m, -1, dtype=np.int64)])
    order = np.lexsort((allind, allrows))
    nptr = np.concatenate([[0], np.cumsum(lens0 + 1)]).astype(np.int32)
    return nptr, allind[order].astype(np.int32), allsrc[order]


# ---------------------------------------------------------------------------
# execution forms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExecForm:
    """Device-ready SpMV/SpMM operand in the chosen format. Device arrays
    are tensors on the matrix's device; `*_dest`/`*_src` are host scatter
    and gather maps kept for the value refresh."""

    kind: str  # "segsum" | "bandt" | "bwd" | "gen" | "route" | "bandtm" | "bwdg" | "diag" | "sell" | "host" | ...
    m: int
    n: int
    # segsum; sell: the flattened slices (padding: column 0, value 0)
    ind: Optional[torch.Tensor] = None
    val: Optional[torch.Tensor] = None
    row_ids: Optional[torch.Tensor] = None
    # segsum: the row pointers (int32 or int64, as the effective CSR holds
    # them; ind keeps its index dtype too) and the CSR kernels' schedule
    # (kernels/spmv_csr.py `csr_blocks` at `tile_of` the values' dtype): the
    # (blocks + 1, 2) int64 table of each row block's first row and first
    # entry. Its row_ids are kept only on the CPU, where the plain gathers
    # run its mv and mm (`attach_csr_plan`)
    ptr: Optional[torch.Tensor] = None
    csr_blocks: Optional[torch.Tensor] = None
    sell_dest: Optional[np.ndarray] = None  # (nnz,) flat slice positions of the entries
    sell_total: int = 0
    # host: numpy CSR of the host engine (kernels/host.py); the values are
    # fetched from the device at the first call after a refresh
    host_ptr: Optional[np.ndarray] = None
    host_ind: Optional[np.ndarray] = None
    host_val: Optional[np.ndarray] = None
    _host_pending: Optional[torch.Tensor] = None
    # ell / ellhyb: (m, w) padded rows, -1 marks padding
    ell_ind: Optional[torch.Tensor] = None
    ell_val: Optional[torch.Tensor] = None
    ell_src: Optional[np.ndarray] = None  # (m, w) positions into eff val, -1 pad
    # spill: the band forms' peel outliers and ellhyb's row tails, COO
    # triplets summed after the main product
    sp_ind: Optional[torch.Tensor] = None
    sp_val: Optional[torch.Tensor] = None
    sp_rows: Optional[torch.Tensor] = None
    sp_src: Optional[np.ndarray] = None
    #: bwd: (nblk + 1,) first spill entry of each 8-row group, for the kernel
    sp_gptr: Optional[torch.Tensor] = None
    # band forms. bandt: bwd_val[j, i] = A[i, i + lo + j] as a (W, m)
    # tensor for the band SpMV kernel (kernels/band_spmv.py); bandtm: the
    # row-aligned (m, W) layout v[i, j] = A[i, i + lo + j] for the band SpMM
    # kernels (kernels/spmm_band.py); bwd (G = 8, kernels/spmv_bwd.py) and
    # bwdg: (ngrp, G, W) group windows, the window of group g starting at
    # padded x (B) row G * (g + bwd_base8).
    # bwd_padL is the left padding (= max(0, -lo)), bandt_start the window
    # start (= max(lo, 0))
    bwd_val: Optional[torch.Tensor] = None
    bwd_dest: Optional[np.ndarray] = None  # (kept,) flat positions into bwd_val
    bwd_srcpos: Optional[np.ndarray] = None  # (kept,) positions into eff val (None = all)
    bwd_W: int = 0
    bwd_padL: int = 0
    bandt_start: int = 0
    bwd_G: int = 8
    bwd_base8: int = 0
    bwd_n_pad: int = 0
    bwd_rel: int = 0
    # diag: dia_val[d, i] = A[i, i + offs[d]] as a (ndiag, m) tensor
    dia_val: Optional[torch.Tensor] = None
    dia_offs: Optional[torch.Tensor] = None  # (ndiag,) int64, sorted
    dia_dest: Optional[np.ndarray] = None  # (nnz,) flat positions into dia_val
    dia_offs_static: Optional[Tuple[int, ...]] = None
    dia_L: int = 0
    dia_n_pad: int = 0
    # gen (block-RCM-permuted band + hub slabs + spill; kernels/spmv_gen.py):
    # the band and spill fields above are in PERMUTED coordinates, over
    # gen_m_pad = nblk * gen_B rows; gen_bandt picks the band's layout, the
    # (W, m_pad) band of the band kernel or the (m_pad/8, 8, W) group windows
    gen_perm: Optional[torch.Tensor] = None  # (nblk,) block perm: xp blocks = x blocks[gen_perm]
    gen_out: Optional[torch.Tensor] = None  # (nblk,) inverse block perm
    gen_flip: Optional[torch.Tensor] = None  # (nblk,) bool: reverse the block's elements
    gen_B: int = 128
    gen_m_pad: int = 0
    gen_bandt: bool = False
    hub_cols: Optional[torch.Tensor] = None  # (k,) ORIGINAL column ids
    hub_slab: Optional[torch.Tensor] = None  # (m_pad, k) dense, permuted rows
    hub_dest: Optional[np.ndarray] = None
    hub_src: Optional[np.ndarray] = None
    hubr_rows: Optional[torch.Tensor] = None  # (kr,) PERMUTED row positions
    hubr_slab: Optional[torch.Tensor] = None  # (kr, m_pad) dense, permuted columns
    hubr_dest: Optional[np.ndarray] = None
    hubr_src: Optional[np.ndarray] = None
    #: the spill-route engine over the spill (gen, built on first use) or
    #: over every entry (route): planner/spill_route.py
    _spill_route: object = None
    #: the handle's precision policy, copied on by ops/level2/mv.py
    precision_mode: str = "full"
    _bwd_val_bf16: Optional[torch.Tensor] = None
    #: lazily derived operands (the block-window and tile-major bands, bf16
    #: diagonals), dropped by refresh()
    _derived: Optional[Dict[object, torch.Tensor]] = None
    #: gen_perm_maps' cache (structure only, kept by refresh())
    _perm_maps: Optional[Tuple] = None

    @property
    def has_spill(self) -> bool:
        return self.sp_ind is not None and int(self.sp_ind.shape[0]) > 0

    def host_values(self) -> np.ndarray:
        """Host copy of a host form's values, fetched at the first call
        after a refresh (a refresh that is never followed by a host call
        moves nothing)."""
        if self.host_val is None:
            self.host_val = self._host_pending.detach().cpu().numpy()
            self._host_pending = None
        return self.host_val

    def band_bf16(self) -> torch.Tensor:
        """Cached bfloat16 copy of the band for the mixed-precision path
        (mv KID 12 and mm KID 3 under set_precision_mode(A, "mixed")).
        Casting per call would stream the f32 band and defeat the point;
        refresh() drops it so update_values flows through."""
        if self._bwd_val_bf16 is None:
            self._bwd_val_bf16 = self.bwd_val.to(torch.bfloat16)
        return self._bwd_val_bf16

    def _derive(self, key, build) -> torch.Tensor:
        if self._derived is None:
            self._derived = {}
        if key not in self._derived:
            self._derived[key] = build()
        return self._derived[key]

    def band_mxu_dt(self, bf16: bool = False) -> torch.Tensor:
        """(nblk, 256, 128) block windows of the band for mm KID 5 and the
        block-window SpMV (kernels/spmm_band.py `band_mxu_blocks`), built
        once on the form's device and cached per dtype. A bandtm form's band
        is row-aligned (m, W) already; a bandt form's (W, m) band is
        transposed first, as the JAX package does. Needs W <= 129: one
        256-row window covers a 128-row block plus its band."""
        from ..kernels.spmm_band import MXU_MAX_W, band_mxu_blocks

        if self.kind not in ("bandt", "bandtm") or self.bwd_W > MXU_MAX_W:
            raise AoclSparseError(
                Status.invalid_kid,
                f"the block-window band needs a bandt or bandtm form with W <= {MXU_MAX_W}, "
                f"got {self.kind} W={self.bwd_W}",
            )
        if bf16:
            return self._derive("mxu_bf16", lambda: self.band_mxu_dt().to(torch.bfloat16))
        rows = self.bwd_val.t() if self.kind == "bandt" else self.bwd_val
        return self._derive("mxu", lambda: band_mxu_blocks(rows, self.bwd_W))

    def bandt_rows(self, bf16: bool = False) -> torch.Tensor:
        """Row-aligned (m_pad, W) band of a gen form in the band kernel's
        layout, v[i, j] = A_p[i, i + lo + j]: the transpose of its (W, m_pad)
        band, for mm KID 6's band leg on the band SpMM kernel
        (kernels/spmm_gen.py), the counterpart of the JAX package's
        `ExecForm.bandt_rows` (planner/plan.py:630-650 there). Built once on
        the form's device, cached per dtype (bf16: the mixed mode's band),
        dropped by refresh()."""
        if self.kind != "gen" or not self.gen_bandt:
            raise AoclSparseError(
                Status.invalid_kid, f"the row-aligned band needs a gen form in the band layout, got {self.kind}"
            )
        if bf16:
            return self._derive("rows_bf16", lambda: self.bwd_val.t().to(torch.bfloat16).contiguous())
        return self._derive("rows", lambda: self.bwd_val.t().contiguous())

    def bandt_tiles(self, TM: int, bf16: bool = False) -> torch.Tensor:
        """(ntile, W, TM) tile-major band of a bandt form for the tile-major
        band SpMV kernels (kernels/band_tiles.py `band_tiles`): each TM-row
        tile's slab is contiguous. The counterpart of the JAX package's
        `bandt_vertical` (its sublane layout stays behind). Built once on
        the form's device, cached per (TM, dtype), dropped by refresh()."""
        from ..kernels.band_tiles import band_tiles

        if self.kind != "bandt":
            raise AoclSparseError(Status.invalid_kid, f"the tile-major band needs a bandt form, got {self.kind}")
        if bf16:
            return self._derive(("tiles_bf16", TM), lambda: band_tiles(self.band_bf16(), TM))
        return self._derive(("tiles", TM), lambda: band_tiles(self.bwd_val, TM))

    def dia_bf16(self) -> torch.Tensor:
        """Cached bfloat16 diagonals for mm KID 7 in the mixed mode."""
        return self._derive("dia_bf16", lambda: self.dia_val.to(torch.bfloat16))

    def spill_route(self):
        """The spill-route engine over the gen form's PERMUTED spill
        triplets, built on first use and kept across value refreshes."""
        if self._spill_route is None:
            from .spill_route import build_spill_route

            self._spill_route = build_spill_route(
                self.sp_rows.cpu().numpy(), self.sp_ind.cpu().numpy(), self.sp_val, self.gen_m_pad
            )
        return self._spill_route

    def gen_perm_maps(self):
        """(src, inv, hub_cols_p) int64 element maps of a gen form, for
        iteration in permuted space (kernels/spmv_gen.py spmv_gen_p):

            xp = pad(x, m_pad)[src];  y = yp[inv][:m];  xp[hub_cols_p] == x[hub_cols]

        Pure structure: cached, kept across value refreshes."""
        if self._perm_maps is None:
            B, nblk = self.gen_B, self.gen_m_pad // self.gen_B
            bperm = self.gen_perm.cpu().numpy()
            offs = np.arange(B, dtype=np.int64)
            if self.gen_flip is not None:
                o2 = np.where(self.gen_flip.cpu().numpy()[:, None], B - 1 - offs[None, :], offs[None, :])
            else:
                o2 = np.broadcast_to(offs[None, :], (nblk, B))
            src = (bperm[:, None] * B + o2).reshape(-1)
            inv = np.empty_like(src)
            inv[src] = np.arange(src.size, dtype=np.int64)
            dev = self.gen_perm.device
            hub_p = None
            if self.hub_cols is not None and self.hub_cols.shape[0]:
                hub_p = _dev_index(inv[self.hub_cols.cpu().numpy()], dev)
            self._perm_maps = (_dev_index(src, dev), _dev_index(inv, dev), hub_p)
        return self._perm_maps

    def segsum_rows(self) -> torch.Tensor:
        """A segsum form's row of each entry (int64), built from ptr at
        first use where the form does not keep them (a form on the card):
        the plain gathers read them, the CSR kernels do not."""
        if self.row_ids is None:
            from ..kernels.spmv_csr import row_ids_from_ptr

            self.row_ids = row_ids_from_ptr(self.ptr, self.ind.shape[0])
        return self.row_ids

    def nbytes(self) -> int:
        """Device bytes of the form's operands (the route's included)."""
        ts = (self.ind, self.val, self.row_ids, self.ptr, self.csr_blocks, self.ell_ind, self.ell_val, self.sp_ind,
              self.sp_val, self.sp_rows, self.sp_gptr, self.bwd_val, self.dia_val, self.dia_offs, self.gen_perm,
              self.gen_out, self.gen_flip, self.hub_cols, self.hub_slab, self.hubr_rows, self.hubr_slab)
        own = sum(t.numel() * t.element_size() for t in ts if t is not None)
        return own + (self._spill_route.nbytes() if self._spill_route is not None else 0)

    def refresh(self, eff_val: torch.Tensor) -> None:
        self._bwd_val_bf16 = None
        self._derived = None
        dev = eff_val.device

        def scatter(size, dest, srcpos):
            buf = torch.zeros(size, dtype=eff_val.dtype, device=dev)
            kept = eff_val if srcpos is None else eff_val[_dev_index(srcpos, dev)]
            buf[_dev_index(dest, dev)] = kept
            return buf

        if self.kind == "segsum":
            self.val = eff_val
        elif self.kind == "host":
            self.host_val, self._host_pending = None, eff_val
        elif self.kind == "sell":
            self.val = scatter(self.sell_total, self.sell_dest, None)
        elif self.kind == "route":
            # every entry rides the engine: values rescatter through its
            # stored select-slot map
            self._spill_route.refresh(eff_val)
        elif self.kind == "gen":
            mp = self.gen_m_pad
            shape = (self.bwd_W, mp) if self.gen_bandt else (-(-mp // 8), 8, self.bwd_W)
            self.bwd_val = scatter(int(np.prod(shape)), self.bwd_dest, self.bwd_srcpos).reshape(shape)
            if self.hub_src is not None:
                k = int(self.hub_cols.shape[0])
                self.hub_slab = scatter(mp * k, self.hub_dest, self.hub_src).reshape(mp, k)
            if self.hubr_src is not None:
                kr = int(self.hubr_rows.shape[0])
                self.hubr_slab = scatter(kr * mp, self.hubr_dest, self.hubr_src).reshape(kr, mp)
            if self.sp_src is not None and self.sp_src.size and self._spill_route is not None:
                self._spill_route.refresh(eff_val[_dev_index(self.sp_src, dev)])
        elif self.kind in ("bandt", "bandtm", "bwd", "bwdg"):
            if self.kind in ("bwd", "bwdg"):
                ngrp = -(-self.m // self.bwd_G)
                shape = (ngrp, self.bwd_G, self.bwd_W)
            else:
                shape = (self.bwd_W, self.m) if self.kind == "bandt" else (self.m, self.bwd_W)
            self.bwd_val = scatter(int(np.prod(shape)), self.bwd_dest, self.bwd_srcpos).reshape(shape)
        elif self.kind == "diag":
            ndiag = len(self.dia_offs_static)
            self.dia_val = scatter(ndiag * self.m, self.dia_dest, None).reshape(ndiag, self.m)
        elif self.kind in ("ell", "ellhyb"):
            src = self.ell_src
            valid = src >= 0
            buf = scatter(src.size, np.nonzero(valid.reshape(-1))[0], src[valid])
            self.ell_val = buf.reshape(src.shape)
        else:
            raise AoclSparseError(Status.internal_error, f"bad exec form {self.kind}")
        if self.sp_src is not None and self.sp_src.size:
            self.sp_val = eff_val[_dev_index(self.sp_src, dev)]


#: density cap of the band form: its dense (W, m) band may stream at most
#: BWD_CAP x the nnz's bytes
BWD_CAP = 16.0
#: widest row window served by the band form. The kernel itself would take
#: more (its shared-memory x window is (256 + W - 1) elements), but beyond
#: this width the band's padding, not the kernel, decides the cost
BANDT_MAX_W = 1024

#: dtypes the band kernel has instances for (f32, bf16 band / f32 x, f64);
#: complex stays off the band form, as in the JAX package
_BAND_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _bandt_window(rows: np.ndarray, rel: np.ndarray):
    """(lo, W, spill_mask) of the row-aligned band over relative column
    offsets rel = col - row: the full [min, max] window, or — above 4096
    entries — the [0.25, 99.75] percentile core when that saves >= 16 of
    width and spills at most max(1024, 1%) of the entries. W rounds up to 8."""
    lo = int(rel.min())
    W = int(rel.max()) - lo + 1
    spill_mask = np.zeros(rel.size, dtype=bool)
    if rel.size > 4096:
        lo_c = int(np.percentile(rel, 0.25))
        hi_c = int(np.percentile(rel, 99.75))
        W_core = hi_c - lo_c + 1
        outside = (rel < lo_c) | (rel > hi_c)
        n_out = int(outside.sum())
        if W_core <= W - 16 and n_out <= max(1024, rel.size // 100):
            spill_mask = outside
            lo, W = lo_c, W_core
    return lo, -(-W // 8) * 8, spill_mask


def _rows_rel(eff: EffectiveCSR):
    rows = np.repeat(np.arange(eff.m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
    return rows, eff.ind.astype(np.int64) - rows


#: the value dtypes for which the card's mv rule sends general structure to
#: `segsum` (`pick_mv_format`) and weighs `diag` against the CSR kernel
#: (`diag_beats_csr`). The CSR kernel also has a bfloat16 instance, which
#: the restricted memory policy and a kid=0 pin reach; bfloat16 keeps the
#: `gen` band's bf16 instance by default (the two not timed against each
#: other)
CARD_MV_CSR_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def pick_mv_format(kind: str, device, dtype) -> str:
    """The device's part of the mv rule: `kind`, the structure's form
    (`structure_mv_format`), on `device` for values of `dtype`.

    On a CUDA device, `gen` gives way to `segsum` for
    CARD_MV_CSR_DTYPES (csrc/spmv_csr.cu: float32 and float64 among the
    band dtypes; complex is `segsum` already): general structure runs
    the row-gather kernel, never the composite nor the whole-matrix `route`
    it falls back to. The reason is bytes. The CSR kernel reads
    nnz * (index + value) + (m + 1) * 4 + m * value, its x gathers mostly
    L2 hits; the `gen` band reads W * m_pad values for nnz entries plus two
    permutes of 2 * m * (4 + value), in three launches or more. On the
    webbase stand-in the band alone is 2.912 GB against the CSR kernel's
    36.7 MB (79x): `gen` took 1.2778 ms a call against cuSPARSE's 0.0380,
    the `route` form on the scatter operand 1.0563 against a 0.0066 ms
    bound (an H100, PERF.md section 5). bfloat16 keeps `gen` (the
    band kernel's bf16 instance). Elsewhere the
    structure's form stands. Pins are untouched: kid=7 or kind="gen" still
    build `gen`, kind="route" `route`, and an autotune_mv pin replaces the
    default."""
    if kind == "gen" and torch.device(device).type == "cuda" and dtype in CARD_MV_CSR_DTYPES:
        return "segsum"
    return kind


def choose_mv_format(eff: EffectiveCSR, device=None) -> str:
    """The default mv form of `eff` on `device` (the values' device where
    None): `structure_mv_format`'s form, turned by `pick_mv_format` (on the
    card, general structure takes `segsum`). On the card, for the dtypes
    the CSR kernel has, the diag branch also weighs the two kernels' bytes
    (`diag_beats_csr`)."""
    device = eff.val.device if device is None else device
    card_csr = torch.device(device).type == "cuda" and eff.val.dtype in CARD_MV_CSR_DTYPES
    return pick_mv_format(structure_mv_format(eff, card_csr=card_csr), device, eff.val.dtype)


#: stored slots a nonzero up to which the diagonal SpMV kernel is no slower
#: than the CSR kernel on the card, by value dtype: the measured crossovers
#: (`scripts/diag_bench.py --cross` on an H100, kernel ms diag / CSR: f32
#: 0.0532 / 0.0542 at 2.01 slots, 0.0537 / 0.0504 at 2.21; f64 0.0950 /
#: 0.0982 at 1.71, 0.0948 / 0.0920 at 1.81)
DIAG_CSR_SLOTS = {torch.float32: 2.05, torch.float64: 1.75}


def diag_beats_csr(eff: EffectiveCSR, ndiag: int) -> bool:
    """Is the diagonal kernel no slower than the CSR kernel on `eff`'s
    diag form of `ndiag` diagonals (float32 or float64 values)? The
    diagonal kernel reads every stored slot of its (ndiag, m) values, so
    its time stays flat as the slots empty, while the CSR kernel's falls
    with nnz; on the 27 offsets of a 104^3 stencil at m = 1,124,864 they
    tie at DIAG_CSR_SLOTS slots a nonzero. So diag while
    ndiag * m <= DIAG_CSR_SLOTS[dtype] * nnz."""
    return ndiag * eff.m <= DIAG_CSR_SLOTS[eff.val.dtype] * eff.nnz


def structure_mv_format(eff: EffectiveCSR, card_csr: bool = False) -> str:
    """Execution-format selection by structure, re-derived for Hopper.

    The JAX package's rule (plan.py:815-879) rests on a TPU fact: gathers run
    far below the stream rate, so it weighs several gather-free forms. On
    Hopper the band kernel streams the (W, m) band once and reads x from a
    shared-memory window, while the gather form (segsum) pays an index and a
    random x read per nonzero. So:

    - `bandt` when the peeled row window fits (W <= BANDT_MAX_W, the JAX
      package's test) and the band's padding stays bounded
      (m * W <= BWD_CAP * nnz);
    - `diag` where the diagonals pass the JAX package's diag test
      (`_diag_ok`) and either the band does not fit or it is more than
      twice as wide as there are diagonals (2 * ndiag < W), tested before
      `bandt` and `gen` as in the JAX rule (plan.py:838-851 there): HPCG's
      27-point stencil (27 diagonals, W about 2 nx^2) runs mv KID 6 and not
      the whole-matrix `route`, while a full band (the bench operand: 129
      diagonals in W = 136) stays on `bandt`. The factor 2 holds on the
      card (an H100: 32 diagonals in W = 128 run 1.9x faster on the diagonal
      kernel than on the band kernel, 80 of 128 1.3x slower). A divergence (ROADMAP item
      22): W and the fit are the port's peeled row window (`_bandt_window`,
      BANDT_MAX_W), not the JAX rule's unpeeled group window (`_bwd_window`,
      BWD_MAX_W), which is never narrower. So a band with a few far
      outliers stays on `bandt` (the band kernel, outliers spilled) where
      the JAX rule takes `diag` (here the diagonal kernel), and the port picks
      `diag` less often; the stencil and the bench band get the same form
      under both windows;
      On the card (`card_csr`: a CUDA device and a dtype of the CSR
      kernel, float32 or float64), `diag` also needs `diag_beats_csr`: it
      is kept to operands whose diagonals store at most DIAG_CSR_SLOTS
      slots a nonzero (2.05 float32, 1.75 float64), where the JAX test allows 16 (or 8 for
      more than DIA_MAX diagonals); past that the rule goes on as below,
      and general structure ends at `segsum`. A divergence from the JAX
      rule (ROADMAP, deliberate divergences); bfloat16 and the CPU keep it;
    - otherwise, for a square matrix with m >= 2 * GEN_B, `gen`: general
      structure is made band-compressible (hub slabs, block RCM, a peeled
      band on the same kernel) and its spill rides the spill-route kernels,
      as the JAX package does on its TPU with Pallas (plan.py:866-869; here
      the card stands in for both). When `_build_gen` rejects the matrix,
      `build_exec_form` goes on to the whole-matrix `route` form or the
      gather fallback, as in the JAX package;
    - otherwise `segsum`.

    `choose_mv_format` turns `gen` into `segsum` on the card
    (`pick_mv_format`); mm's rule reads this one, and on the card turns its
    `gen` (mm KID 6) into `segsum` past the measured crossover
    (`gen_beats_csr_mm`). Complex and float16 operands have no band kernel
    instance and take `segsum`. AOCLSPARSE_TPU_FORCE_GENERIC
    (enable_instructions("generic")) sends every operand to the gather forms, as in the JAX package
    (plan.py:831-879 there)."""
    if eff.m == 0 or eff.nnz == 0:
        return "segsum"
    if os.environ.get("AOCLSPARSE_TPU_FORCE_GENERIC", "0") in ("1", "true"):
        return gather_fallback_kind(eff)
    if eff.val.dtype not in _BAND_DTYPES:
        return "segsum"
    rows, rel = _rows_rel(eff)
    _lo, W, _spill = _bandt_window(rows, rel)
    bandt_ok = W <= BANDT_MAX_W and eff.m * W <= BWD_CAP * eff.nnz
    ndiag = int(_diag_stats(eff)[0].size)
    if _diag_ok(eff, ndiag) and (not bandt_ok or 2 * ndiag < W) and (not card_csr or diag_beats_csr(eff, ndiag)):
        return "diag"
    if bandt_ok:
        return "bandt"
    if eff.shape[0] == eff.shape[1] and eff.m >= 2 * GEN_B:
        return "gen"
    return "segsum"


def _build_bandt(eff: EffectiveCSR) -> Optional[ExecForm]:
    """Row-aligned transposed band for the band kernel:
    vt[j, i] = A[i, i + lo + j]. Each row gets its own window start, and the
    kernel streams the band from device memory exactly once. Peel outliers
    spill to COO triplets summed after the kernel."""
    m, n = eff.shape
    if eff.nnz == 0:
        return None
    rows, rel = _rows_rel(eff)
    lo, W, spill_mask = _bandt_window(rows, rel)
    if W > BANDT_MAX_W:
        return None
    cols = eff.ind.astype(np.int64)
    keep = ~spill_mask
    dest = (rel - lo)[keep] * m + rows[keep]
    spilled = bool(spill_mask.any())
    dev = eff.val.device
    form = ExecForm(
        kind="bandt",
        m=m,
        n=n,
        bwd_dest=dest,
        bwd_srcpos=np.nonzero(keep)[0] if spilled else None,
        bwd_W=int(W),
        bwd_padL=int(max(0, -lo)),
        bandt_start=int(max(lo, 0)),
        sp_src=np.nonzero(spill_mask)[0] if spilled else None,
        sp_ind=_dev_index(cols[spill_mask], dev) if spilled else None,
        sp_rows=_dev_index(rows[spill_mask], dev) if spilled else None,
    )
    form.refresh(eff.val)
    return form


def _build_bandtm(eff: EffectiveCSR) -> Optional[ExecForm]:
    """Row-aligned (m, W) band for the band SpMM kernels
    (plan.py:1424-1465 of the JAX package): v[i, j] = A[i, i + lo + j], the
    same peeled window as `_build_bandt`. None when the window is wider
    than the kernel's shared-memory plan takes for this dtype."""
    from ..kernels.spmm_band import band_max_w

    m, n = eff.shape
    if eff.nnz == 0:
        return None
    rows, rel = _rows_rel(eff)
    lo, W, spill_mask = _bandt_window(rows, rel)
    if W > band_max_w(eff.val.dtype):
        return None
    cols = eff.ind.astype(np.int64)
    keep = ~spill_mask
    spilled = bool(spill_mask.any())
    dev = eff.val.device
    form = ExecForm(
        kind="bandtm",
        m=m,
        n=n,
        bwd_dest=rows[keep] * W + (rel - lo)[keep],
        bwd_srcpos=np.nonzero(keep)[0] if spilled else None,
        bwd_W=int(W),
        bwd_padL=int(max(0, -lo)),
        bandt_start=int(max(lo, 0)),
        sp_src=np.nonzero(spill_mask)[0] if spilled else None,
        sp_ind=_dev_index(cols[spill_mask], dev) if spilled else None,
        sp_rows=_dev_index(rows[spill_mask], dev) if spilled else None,
    )
    form.refresh(eff.val)
    return form


#: row-group size of the bwdg form (the JAX package's G = 512 for SpMM)
BWDG_G = 512


def _build_bwdg(eff: EffectiveCSR, G: int = BWDG_G) -> ExecForm:
    """Group-banded form of mm KID 3 (plan.py:895-989 of the JAX package,
    kind "bwdg", which peels nothing): rows in groups of G, each group's
    window of W columns starting at G * group + rel_lo stored densely as
    (ngrp, G, W). B is padded to n_pad rows with bwd_padL rows in front."""
    m, n = eff.shape
    rows, rel_row = _rows_rel(eff)
    ngrp = -(-m // G)
    rel = rel_row + rows % G  # column relative to the group's first row
    if rel.size == 0:
        W, rel_lo = G, 0
    else:
        rel_lo = (int(rel.min()) // G) * G
        W = -(-(int(rel.max()) - rel_lo + 1) // 8) * 8
    L = max(0, -rel_lo)
    base = (rel_lo + L) // G
    need = G * (base + (-(-W // G)) - 1 + ngrp)
    form = ExecForm(
        kind="bwdg",
        m=m,
        n=n,
        bwd_dest=rows * W + (rel - rel_lo),
        bwd_W=int(W),
        bwd_G=G,
        bwd_base8=int(base),
        bwd_padL=int(L),
        bwd_n_pad=int(max(-(-(L + n) // G) * G, need)),
        bwd_rel=int(rel_lo),
    )
    form.refresh(eff.val)
    return form


#: the diag form's caps (plan.py:1479-1482 of the JAX package): at most
#: DIA_MAX diagonals with padding within BWD_CAP x nnz, or DIA_MAX_WIDE with
#: padding within 8 x nnz
DIA_MAX = 96
DIA_MAX_WIDE = 192


def _diag_stats(eff: EffectiveCSR):
    """Distinct generalized diagonals (j - i) of the effective matrix, and
    each entry's diagonal."""
    if eff.nnz == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    _rows, d = _rows_rel(eff)
    return np.unique(d), d


def _diag_ok(eff: EffectiveCSR, ndiag: Optional[int] = None) -> bool:
    if ndiag is None:
        ndiag = int(_diag_stats(eff)[0].size)
    nnz = max(eff.nnz, 1)
    return 0 < ndiag and (
        (ndiag <= DIA_MAX and ndiag * eff.m <= BWD_CAP * nnz)
        or (ndiag <= DIA_MAX_WIDE and ndiag * eff.m <= 8 * nnz)
    )


def _build_diag(eff: EffectiveCSR) -> ExecForm:
    """Diagonal form of mm KID 7 (plan.py:1485-1506 of the JAX package):
    dia_val[d, i] = A[i, i + offs[d]] over the sorted distinct offsets."""
    m, n = eff.shape
    offs, d = _diag_stats(eff)
    rows, _rel = _rows_rel(eff)
    L = int(max(0, -(offs.min() if offs.size else 0)))
    max_off = int(offs.max()) if offs.size else 0
    form = ExecForm(
        kind="diag",
        m=m,
        n=n,
        dia_offs=_dev_index(offs, eff.val.device),
        dia_dest=np.searchsorted(offs, d) * m + rows,
        dia_offs_static=tuple(int(o) for o in offs),
        dia_L=L,
        dia_n_pad=int(max(L + n, L + max_off + m)),
    )
    form.refresh(eff.val)
    return form


def _build_ell_map(eff: EffectiveCSR, width: int):
    """(m, width) gather map into effective values and column indices; -1
    marks padding (plan.py:882-892 of the JAX package)."""
    ptr = eff.ptr.astype(np.int64)
    lens = np.diff(ptr)
    cols = np.arange(width)[None, :]
    valid = cols < np.minimum(lens, width)[:, None]
    src = np.where(valid, ptr[:-1, None] + cols, -1)
    ind = np.where(valid, eff.ind[np.clip(src, 0, max(eff.nnz - 1, 0))], -1)
    return src, ind


#: ellhyb's row width rounds up to a multiple of this (the JAX package's
#: SUBLANE)
ELL_ROUND = 8


def _build_ell(eff: EffectiveCSR, hybrid: bool) -> ExecForm:
    """Padded-row forms of mm KIDs 1 and 2 (plan.py:1686-1717 of the JAX
    package): ell pads every row to the longest; ellhyb to about the 75th
    percentile row length, the row tails spilling to COO triplets."""
    m, n = eff.shape
    lens = np.diff(eff.ptr.astype(np.int64))
    w_max = int(lens.max()) if lens.size else 0
    width = max(1, w_max)
    sp = {}
    if hybrid:
        p75 = int(np.percentile(lens, 75)) if lens.size else 1
        width = min(max(ELL_ROUND, -(-p75 // ELL_ROUND) * ELL_ROUND), max(1, w_max))
        ptr64 = eff.ptr.astype(np.int64)
        sp_src, _ = _ranges_concat(np.minimum(ptr64[:-1] + width, ptr64[1:]), ptr64[1:])
        dev = eff.val.device
        sp = dict(
            sp_src=sp_src,
            sp_ind=_dev_index(eff.ind[sp_src], dev),
            sp_rows=_dev_index(np.repeat(np.arange(m), np.maximum(lens - width, 0)), dev),
        )
    src, ind = _build_ell_map(eff, width)
    form = ExecForm(
        kind="ellhyb" if hybrid else "ell",
        m=m,
        n=n,
        ell_ind=_dev_index(ind, eff.val.device),
        ell_src=src,
        **sp,
    )
    form.refresh(eff.val)
    return form


# ---------------------------------------------------------------------------
# gen: the general-structure composite (plan.py:992-1350 of the JAX package)
# ---------------------------------------------------------------------------

#: gen-form tuning, the JAX package's constants kept as they are, so both
#: packages build the same forms (re-tuning them from the card's numbers is
#: later work, ROADMAP.md queue 1 item 14)
GEN_B = 128  # block-permutation granularity
GEN_MAX_HUB = 512  # dense hub-slab width cap
GEN_HUB_MIN = 32  # min entries for a column to be hub-eligible
GEN_MEM_CAP = 6e9  # band operand byte cap
GEN_SPILL_FRAC = 0.30  # max fraction of nnz in the spill at one ladder rung
GEN_STREAM_BPS = 250e9  # dense-stream rate of the cost model
GEN_GATHER_NS = 13e-9  # per-element irregular gather cost
GEN_PANEL_NS = 0.33e-9  # per-element 128-wide panel-gather cost
GEN_MARGIN = 0.6  # accept gen only when its estimate <= margin * the gather form's
#: widest group window of the G = 8 layout (the JAX package's BWD_MAX_W)
BWD_MAX_W = 4096


def _gen_cost_model(m_pad, W, B, k_hub, n_spill, itemsize):
    """Estimated per-call time of the gen composite (seconds)."""
    band = m_pad * W * itemsize / GEN_STREAM_BPS
    hub = k_hub * m_pad * itemsize / GEN_STREAM_BPS
    perm = 2 * m_pad * (GEN_PANEL_NS if B >= 8 else GEN_GATHER_NS)
    return band + hub + perm + n_spill * GEN_GATHER_NS


def _block_flips(pb_r, pb_c, pos_r, pos_c, nblk: int, B: int):
    """Per-block orientation (reverse a block's B elements or not) that
    minimises the |rel| mass of entries crossing CONSECUTIVE permuted
    blocks; (nblk,) bool by permuted position, or None. Block RCM keeps
    each block's inner order, so a chain running against the index
    direction puts the entries that couple one block's end to the next
    block's start at offset ~2B; a flip brings them back to the diagonal.
    An O(nblk) two-state chain DP over boundary crossing costs."""
    d = pb_c - pb_r
    fwd = d == 1  # row in block p, column in block p+1 (boundary p)
    bwd = d == -1  # column in block p, row in block p+1 (boundary p)
    if not (fwd.any() or bwd.any()) or nblk < 2:
        return None
    # cost[p, fp, fq]: |rel| mass crossing boundary p under orientations
    # (fp, fq) of blocks (p, p+1), saturating at 4B
    cost = np.zeros((nblk - 1, 2, 2), dtype=np.float64)
    cap = 4.0 * B
    for fp in (0, 1):
        for fq in (0, 1):
            if fwd.any():
                pr = (B - 1 - pos_r[fwd]) if fp else pos_r[fwd]
                pc = (B - 1 - pos_c[fwd]) if fq else pos_c[fwd]
                np.add.at(cost[:, fp, fq], pb_r[fwd], np.minimum(np.abs(B + pc - pr), cap))
            if bwd.any():
                pc2 = (B - 1 - pos_c[bwd]) if fp else pos_c[bwd]
                pr2 = (B - 1 - pos_r[bwd]) if fq else pos_r[bwd]
                np.add.at(cost[:, fp, fq], pb_c[bwd], np.minimum(np.abs(pc2 - pr2 - B), cap))
    back = np.zeros((nblk, 2), dtype=np.int8)
    prev = np.zeros(2)
    for p in range(nblk - 1):
        cand = prev[:, None] + cost[p]
        back[p + 1] = np.argmin(cand, axis=0)  # ties -> 0 (no flip)
        prev = cand.min(axis=0)
    fP = np.zeros(nblk, dtype=bool)
    f = int(np.argmin(prev))
    for p in range(nblk - 1, 0, -1):
        fP[p] = bool(f)
        f = int(back[p][f])
    fP[0] = bool(f)
    return fP if fP.any() else None


#: edge peel of the bwd form (plan.py:903-904 of the JAX package): the
#: window keeps the [0.25, 99.75] percentile core of the group-relative
#: column offsets when that saves >= 16 of width and spills at most
#: max(1024, 1 %) of the entries
BWD_PEEL_PCTS = (0.25, 99.75)
BWD_SPILL_FRAC = 0.01


def _bwd_peel_window(rel: np.ndarray, G: int, peel: bool) -> Tuple[int, int, np.ndarray]:
    """(rel_lo, W, spill_mask) of the group windows over group-relative
    offsets `rel` (plan.py:922-943 of the JAX package): the full window,
    start aligned to G and width to 8, or with `peel` past 4096 entries the
    percentile core."""
    if rel.size == 0:
        return 0, G, np.zeros(0, dtype=bool)
    rel_lo = (int(rel.min()) // G) * G
    W = -(-(int(rel.max()) - rel_lo + 1) // 8) * 8
    if peel and rel.size > 4096:
        lo_c = (int(np.percentile(rel, BWD_PEEL_PCTS[0])) // G) * G
        hi_c = int(np.percentile(rel, BWD_PEEL_PCTS[1]))
        W_core = -(-(hi_c - lo_c + 1) // 8) * 8
        outside = (rel < lo_c) | (rel >= lo_c + W_core)
        if W_core <= W - 16 and int(outside.sum()) <= max(1024, int(rel.size * BWD_SPILL_FRAC)):
            return lo_c, W_core, outside
    return rel_lo, W, np.zeros(rel.size, dtype=bool)


def _build_bwd_coo(rows, cols, src, m: int, n: int, window: Optional[Tuple[int, int]], device,
                   G: int = 8, kind: str = "gen") -> ExecForm:
    """Group-window geometry (plan.py:895-978 of the JAX package) of a
    (row, col)-sorted COO triple: rows in groups of G, the window of group
    g starting at column G * g + rel_lo; entries outside it spill. The
    (rel_lo, W) window is the caller's (the gen ladder), or with None the
    peeled one of `_bwd_peel_window`. `src` maps each entry to the
    effective value vector (None: the identity, as the SpGEMM band operands
    take it, kernels/spgemm_band.py). Returns the form WITHOUT values."""
    ngrp = -(-m // G)
    blk = rows // G
    rel = cols - G * blk
    if window is None:
        rel_lo, W, spill_mask = _bwd_peel_window(rel, G, peel=kind in ("bwd", "gen"))
    else:
        rel_lo, W = window
        spill_mask = (rel < rel_lo) | (rel >= rel_lo + W)
    keep = ~spill_mask
    L = max(0, -rel_lo)
    base = (rel_lo + L) // G
    need = G * (base + (-(-W // G)) - 1 + ngrp)
    spilled = bool(spill_mask.any())
    if src is None:
        src = np.arange(rows.size, dtype=np.int64)
        kept_src = np.nonzero(keep)[0] if spilled else None
    else:
        kept_src = src[keep]
    return ExecForm(
        kind=kind,
        m=m,
        n=n,
        bwd_dest=((blk * G + rows % G)[keep]) * W + (rel - rel_lo)[keep],
        bwd_srcpos=kept_src,
        bwd_W=int(W),
        bwd_base8=int(base),
        bwd_padL=int(L),
        bwd_n_pad=int(max(-(-(L + n) // G) * G, need)),
        bwd_G=G,
        bwd_rel=int(rel_lo),
        sp_src=src[spill_mask] if spilled else None,
        sp_ind=_dev_index(cols[spill_mask], device) if spilled else None,
        sp_rows=_dev_index(rows[spill_mask], device) if spilled else None,
    )


def _build_bwd(eff: EffectiveCSR) -> ExecForm:
    """The G = 8 group-window form of mv KID 5 (plan.py:981-989 of the JAX
    package), with its spill's group pointer for the kernel
    (kernels/spmv_bwd.py)."""
    from ..kernels.spmv_bwd import G, spill_group_ptr

    m, n = eff.shape
    rows, _rel = _rows_rel(eff)
    form = _build_bwd_coo(rows, eff.ind.astype(np.int64), None, m, n, None, eff.val.device, G=G, kind="bwd")
    if form.has_spill:
        form.sp_gptr = _dev_index(spill_group_ptr(rows[form.sp_src], -(-m // G)), eff.val.device)
    form.refresh(eff.val)
    return form


#: the sell form's slices: SELL_ROWS rows, each slice padded to a multiple
#: of SELL_LANE columns (the JAX package's SUBLANE and LANE)
SELL_ROWS = 8
SELL_LANE = 128


def _build_sell(eff: EffectiveCSR) -> ExecForm:
    """Sliced-ELL form of mv KID 10 (plan.py:1509-1558 of the JAX package):
    SELL_ROWS-row slices, each padded to its own SELL_LANE-multiple width,
    flattened; padding entries get column 0 and value 0, so the product
    needs no mask."""
    from ..convert.conversions import sell_layout

    m, n = eff.shape
    dev = eff.val.device
    if m == 0 or eff.nnz == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return ExecForm(kind="sell", m=m, n=n, ind=empty, val=torch.zeros(0, dtype=eff.val.dtype, device=dev),
                        row_ids=empty, sell_dest=np.zeros(0, np.int64), sell_total=0)
    widths, base, dest = sell_layout(eff.ptr, SELL_ROWS, SELL_LANE)
    total = int(base[-1])
    ind_buf = np.zeros(total, dtype=np.int64)
    ind_buf[dest] = eff.ind
    pos = np.arange(total, dtype=np.int64)
    sl = np.searchsorted(base, pos, side="right") - 1
    row_ids = np.minimum(sl * SELL_ROWS + (pos - base[sl]) // widths[sl], m - 1)
    form = ExecForm(kind="sell", m=m, n=n, ind=_dev_index(ind_buf, dev), row_ids=_dev_index(row_ids, dev),
                    sell_dest=dest, sell_total=total)
    form.refresh(eff.val)
    return form


def _hub_candidates(cnt: np.ndarray, m: int, nnz: int) -> np.ndarray:
    """Sorted ids of the densest columns (or rows) worth a dense slab lane:
    at least max(GEN_HUB_MIN, m / 1024) entries, within a slab budget of
    max(8 nnz, 4 m) entries and GEN_MAX_HUB lanes."""
    cand = np.nonzero(cnt >= max(GEN_HUB_MIN, m // 1024))[0]
    if not cand.size:
        return cand
    cand = cand[np.argsort(cnt[cand])[::-1]]
    take = np.cumsum(np.full(cand.size, float(m))) <= max(8.0 * nnz, 4.0 * m)
    return np.sort(cand[take][:GEN_MAX_HUB])


def _build_gen(eff: EffectiveCSR) -> Optional[ExecForm]:
    """The general-structure composite (plan.py:1072-1349 of the JAX
    package): dense hub columns and hub rows leave for dense slabs, the rest
    is reordered by reverse Cuthill-McKee at B = 128 block granularity (then
    B = 1), a cost-model ladder picks the peeled window, and what falls
    outside it spills (past a break-even, spill columns and rows are
    promoted into the slabs). The band takes the band kernel's (W, m_pad)
    layout when its row window is at most BANDT_MAX_W and the kernel has
    the dtype, else the G = 8 group windows. None when even the best window
    costs more than GEN_MARGIN of the gather form (the caller falls back)."""
    from .. import native

    m, n = eff.shape
    if m != n or eff.nnz == 0 or m < 2 * GEN_B:
        return None
    dev = eff.val.device
    rows, _rel = _rows_rel(eff)
    cols = eff.ind.astype(np.int64)
    idx = np.arange(cols.size, dtype=np.int64)
    # hub columns: dense columns ruin any bandwidth ordering
    hub = _hub_candidates(np.bincount(cols, minlength=n), m, eff.nnz)
    has_hub = hub.size > 0
    is_hub = np.zeros(cols.size, dtype=bool)
    if has_hub:
        hub_mark = np.zeros(n, dtype=bool)
        hub_mark[hub] = True
        is_hub = hub_mark[cols]
    r2, c2, s2 = rows[~is_hub], cols[~is_hub], idx[~is_hub]
    # hub rows: a (kr, m_pad) slab against the permuted x
    hubr = _hub_candidates(np.bincount(r2, minlength=m), m, eff.nnz)
    has_hubr = hubr.size > 0
    if has_hubr:
        hubr_mark = np.zeros(m, dtype=bool)
        hubr_mark[hubr] = True
        is_hubr = hubr_mark[r2]
        hr_r, hr_c, hr_s = r2[is_hubr], c2[is_hubr], s2[is_hubr]
        r2, c2, s2 = r2[~is_hubr], c2[~is_hubr], s2[~is_hubr]
    nnz_r = r2.size
    itemsize = eff.val.element_size()
    k_hub_total = hub.size + (hubr.size if has_hubr else 0)
    fallback_t = eff.nnz * GEN_GATHER_NS  # the gather form's estimate to beat

    def _try_granularity(B: int):
        """RCM on the quotient graph of B-element blocks, then the peel
        ladder evaluated on the offset distribution; the cheapest window
        under the cost model, or None."""
        nblk = -(-m // B)
        m_pad = nblk * B
        if nnz_r:
            qkey, qcnt = np.unique((r2 // B) * nblk + (c2 // B), return_counts=True)
            if B > 1:
                # prune weak block couplings: a few random entries per block
                # pair would make the quotient graph an expander; they spill
                strong = qcnt >= 4
                if strong.any():
                    qkey = qkey[strong]
            q_r, q_c = qkey // nblk, qkey % nblk
            qptr = np.zeros(nblk + 1, dtype=np.int64)
            np.add.at(qptr, q_r + 1, 1)
            bperm, _bw = native.rcm_permutation(nblk, np.cumsum(qptr), q_c)
        else:
            bperm = np.arange(nblk, dtype=np.int64)
        bpos = np.empty(nblk, dtype=np.int64)
        bpos[bperm] = np.arange(nblk)
        fP = None
        if B > 1 and nnz_r:
            fP = _block_flips(bpos[r2 // B], bpos[c2 // B], r2 % B, c2 % B, nblk, B)

        def ppos(i):
            """Original index -> permuted position (flip-aware)."""
            pb, off = bpos[i // B], i % B
            if fP is None:
                return pb * B + off
            return pb * B + np.where(fP[pb], B - 1 - off, off)

        prows, pcols = ppos(r2), ppos(c2)
        rel = pcols - 8 * (prows // 8)
        if rel.size == 0:
            return None
        rel_s = np.sort(rel)
        nmax = rel.size - 1
        best = None  # (cost, rel_lo, W, n_out)
        for plo, phi in ((0.0, 100.0), (0.25, 99.75), (1.0, 99.0), (2.5, 97.5), (5.0, 95.0),
                         (7.5, 92.5), (12.5, 87.5)):
            lo_c = (int(rel_s[int(plo / 100 * nmax)]) // 8) * 8
            hi_c = int(rel_s[int(phi / 100 * nmax)])
            W = -(-(hi_c - lo_c + 1) // 8) * 8
            if W > BWD_MAX_W or m_pad * W * itemsize > GEN_MEM_CAP:
                continue
            n_out = int(np.searchsorted(rel_s, lo_c)) + int(rel.size - np.searchsorted(rel_s, lo_c + W))
            if n_out > max(4096, int(rel.size * GEN_SPILL_FRAC)):
                continue
            cost = _gen_cost_model(m_pad, W, B, k_hub_total, n_out, itemsize)
            if best is None or cost < best[0]:
                best = (cost, lo_c, W, n_out)
        if best is None or best[0] > GEN_MARGIN * fallback_t:
            return None
        order = np.lexsort((pcols, prows))
        pr_s, pc_s, src_s = prows[order], pcols[order], s2[order]
        rel_lo8, W8 = best[1], best[2]
        rel8 = pc_s - 8 * (pr_s // 8)
        spill = (rel8 < rel_lo8) | (rel8 >= rel_lo8 + W8)
        keep_m = ~spill
        row_rel = pc_s - pr_s
        lo_r = int(row_rel[keep_m].min()) if keep_m.any() else 0
        W_r = -(-(int(row_rel[keep_m].max()) - lo_r + 1) // 8) * 8 if keep_m.any() else 8
        if eff.val.dtype in _BAND_DTYPES and W_r <= BANDT_MAX_W:
            # the band kernel's transposed (W, m_pad) layout
            spilled = bool(spill.any())
            cand = ExecForm(
                kind="gen",
                m=m_pad,
                n=m_pad,
                bwd_dest=(row_rel - lo_r)[keep_m] * m_pad + pr_s[keep_m],
                bwd_srcpos=src_s[keep_m],
                bwd_W=int(W_r),
                bwd_padL=int(max(0, -lo_r)),
                bandt_start=int(max(lo_r, 0)),
                gen_bandt=True,
                sp_src=src_s[spill] if spilled else None,
                sp_ind=_dev_index(pc_s[spill], dev) if spilled else None,
                sp_rows=_dev_index(pr_s[spill], dev) if spilled else None,
            )
        else:
            cand = _build_bwd_coo(pr_s, pc_s, src_s, m_pad, m_pad, (rel_lo8, W8), dev)
        return cand, bperm, bpos, m_pad, fP, ppos

    B = GEN_B
    got = _try_granularity(B)
    if got is None:
        B = 1
        got = _try_granularity(B)
    if got is None:
        return None
    core, bperm, bpos, m_pad, fP, ppos = got
    core.m, core.n = m, n  # logical size; the band lives in m_pad space
    core.gen_m_pad = m_pad
    core.gen_B = B
    core.gen_perm = _dev_index(bperm, dev)
    core.gen_out = _dev_index(bpos, dev)
    core.gen_flip = torch.from_numpy(fP).to(dev) if fP is not None else None
    # hub entries as (permuted row, ORIGINAL column, src); hub-row entries
    # as (permuted row, permuted column, src)
    ei = np.zeros(0, dtype=np.int64)
    h_pr, h_oc, h_src = (ppos(rows[is_hub]), cols[is_hub], idx[is_hub]) if has_hub else (ei, ei, ei)
    r_pr, r_pc, r_src = (ppos(hr_r), ppos(hr_c), hr_s) if has_hubr else (ei, ei, ei)
    # spill -> slab promotion: past thresh entries a spill column (row)
    # costs more as gathers than as one dense slab lane
    thresh = max(GEN_HUB_MIN, int((m_pad * itemsize / GEN_STREAM_BPS) / GEN_GATHER_NS) + 1)
    if core.sp_src is not None and core.sp_src.size:
        sp_src = core.sp_src
        sp_pr = core.sp_rows.cpu().numpy()
        sp_pc = core.sp_ind.cpu().numpy()
        sp_oc = cols[sp_src]  # original column of each spill entry
        hist = np.bincount(sp_oc, minlength=n)
        room = max(0, GEN_MAX_HUB - hub.size)
        cand_p = np.nonzero(hist >= thresh)[0]
        if cand_p.size > room:
            cand_p = cand_p[np.argsort(hist[cand_p])[::-1][:room]]
        if cand_p.size:
            pmark = np.zeros(n, dtype=bool)
            pmark[cand_p] = True
            mvq = pmark[sp_oc]
            h_pr = np.concatenate([h_pr, sp_pr[mvq]])
            h_oc = np.concatenate([h_oc, sp_oc[mvq]])
            h_src = np.concatenate([h_src, sp_src[mvq]])
            hub = np.union1d(hub, cand_p)
            has_hub = True
            sp_src, sp_pr, sp_pc = sp_src[~mvq], sp_pr[~mvq], sp_pc[~mvq]
        if sp_src.size:
            rhist = np.bincount(sp_pr, minlength=m_pad)
            roomr = max(0, GEN_MAX_HUB - (np.unique(r_pr).size if r_pr.size else 0))
            cand_r = np.nonzero(rhist >= thresh)[0]
            if cand_r.size > roomr:
                cand_r = cand_r[np.argsort(rhist[cand_r])[::-1][:roomr]]
            if cand_r.size:
                rmark = np.zeros(m_pad, dtype=bool)
                rmark[cand_r] = True
                mvr = rmark[sp_pr]
                r_pr = np.concatenate([r_pr, sp_pr[mvr]])
                r_pc = np.concatenate([r_pc, sp_pc[mvr]])
                r_src = np.concatenate([r_src, sp_src[mvr]])
                has_hubr = True
                sp_src, sp_pr, sp_pc = sp_src[~mvr], sp_pr[~mvr], sp_pc[~mvr]
        if sp_src.size:
            order_sp = np.argsort(sp_pr, kind="stable")
            core.sp_src = sp_src[order_sp]
            core.sp_ind = _dev_index(sp_pc[order_sp], dev)
            core.sp_rows = _dev_index(sp_pr[order_sp], dev)
        else:
            core.sp_src = core.sp_ind = core.sp_rows = None
    if has_hub:
        k = hub.size
        core.hub_cols = _dev_index(hub, dev)
        core.hub_dest = h_pr * k + np.searchsorted(hub, h_oc)
        core.hub_src = h_src
    if has_hubr:
        slabrows = np.unique(r_pr)
        core.hubr_rows = _dev_index(slabrows, dev)
        core.hubr_dest = np.searchsorted(slabrows, r_pr) * m_pad + r_pc
        core.hubr_src = r_src
    core.refresh(eff.val)
    return core


#: whole-matrix route gates (plan.py:1561-1579 of the JAX package): worth
#: the plan-time Benes build past ROUTE_MIN_NNZ, bounded by the router's
#: slot budget
ROUTE_MIN_NNZ = 2e6
ROUTE_MAX_NNZ = 1.5e8


def _route_ok(eff: EffectiveCSR) -> bool:
    """The whole-matrix route serves float32 operands in the nnz window,
    the JAX package's test with the card (or the kernels' plain versions)
    in place of its TPU and Pallas."""
    return eff.val.dtype == torch.float32 and ROUTE_MIN_NNZ <= eff.nnz <= ROUTE_MAX_NNZ


def _build_route(eff: EffectiveCSR) -> ExecForm:
    """Whole-matrix spill-route SpMV (mv KID 14): select, Benes route and
    accumulate over EVERY entry; row stripes of about 2^19 slots past
    2^18 entries (plan.py:1582-1611 of the JAX package)."""
    from .spill_route import build_spill_route, build_striped_route

    m, n = eff.shape
    rows, _rel = _rows_rel(eff)
    m_pad = -(-m // 1024) * 1024
    n_pad_x = -(-n // 1024) * 1024
    build = build_striped_route if eff.nnz > (1 << 18) else build_spill_route
    form = ExecForm(kind="route", m=m, n=n)
    form._spill_route = build(rows, eff.ind.astype(np.int64), eff.val, m_pad=m_pad, n_pad_x=n_pad_x)
    return form


def gather_fallback_kind(eff: EffectiveCSR) -> str:
    """Pick among the gather forms (segsum / ell / ellhyb) by fill
    (plan.py:1614-1622 of the JAX package)."""
    lens = np.diff(eff.ptr.astype(np.int64))
    w0 = int(lens.max()) if lens.size else 0
    if w0 == 0:
        return "segsum"
    fill = eff.nnz / float(max(eff.m, 1) * w0)
    return "ell" if fill >= 0.5 or w0 <= 2 * max(float(lens.mean()), 1.0) else "ellhyb"


#: band slots a nonzero (the gen form's m_pad * W over nnz) up to which
#: mm's `gen` composite (mm KID 6) is no slower than the CSR SpMM kernel
#: (mm KID 0) on the card, by value dtype, at K = 64: the measured
#: crossovers (scripts/csr_mm_bench.py --cross on an H100: the bench band
#: under a random symmetric permutation, W = 144, thinned; mm call ms gen /
#: kid=0: f32 0.6102 / 0.6465 at 3.38 slots, 0.6132 / 0.5469 at 4.0; f64
#: 0.9042 / 0.9715 at 4.95, 0.9069 / 0.8609 at 5.63; bf16 0.7424 / 0.8001 at
#: 3.0, 0.7411 / 0.7212 at 3.38; ties by log interpolation)
GEN_CSR_SLOTS = {torch.float32: 3.6, torch.float64: 5.3, torch.bfloat16: 3.3}
#: the devices whose mm rule weighs the CSR SpMM kernel (tests add "cpu" to
#: drive the card's rule on the plain versions)
MM_CSR_DEVICES = ("cuda",)


def _card_csr_mm(eff: EffectiveCSR, device=None) -> bool:
    """Does `eff`'s mm run on the card in a dtype the CSR SpMM kernel has
    (csrc/spmm_csr.cu: float32, float64, complex64, complex128, bf16)?"""
    from ..kernels.spmm_csr import KERNEL_DTYPES

    device = eff.val.device if device is None else device
    return torch.device(device).type in MM_CSR_DEVICES and eff.val.dtype in KERNEL_DTYPES


def mm_gather_kind(eff: EffectiveCSR, device=None) -> str:
    """mm's form for general structure where `gen` is not taken: on the
    card (`device`, the values' device where None), for the CSR SpMM
    kernel's dtypes, `segsum` (mm KID 0, the kernel); elsewhere the gather
    form `gather_fallback_kind` picks, as the JAX package does."""
    return "segsum" if _card_csr_mm(eff, device) else gather_fallback_kind(eff)


def gen_beats_csr_mm(form: ExecForm, eff: EffectiveCSR, device=None) -> bool:
    """Does mm's default keep a gen form that passes KID 6's gate? Off
    the card, always (the JAX rule). On the card, for the CSR SpMM kernel's
    dtypes, only where its band stores at most GEN_CSR_SLOTS slots a
    nonzero (m_pad * W <= GEN_CSR_SLOTS * nnz): a recovered band, whose B
    rows the band kernel (#8) reads once for W rows, beats the kernel's
    gather of a B row an entry; a sparse band of a scattered matrix
    (scircuit: W = 56 over 5.6 entries a row) does not. Complex values have
    no gen band."""
    if not _card_csr_mm(eff, device) or eff.val.dtype not in GEN_CSR_SLOTS:
        return True
    return form.gen_m_pad * form.bwd_W <= GEN_CSR_SLOTS[eff.val.dtype] * eff.nnz


def choose_mm_format(eff: EffectiveCSR, device=None) -> str:
    """SpMM form selection, re-derived for Hopper.

    The JAX package decides by TPU facts (ops/level3/csrmm.py:146-184):
    whether Pallas runs, VMEM-driven caps on K and W, Mosaic's dtypes. On
    Hopper both SpMM kernels stream their operand once and read B rows
    coalesced along K for any K, so the rule rests on the operand alone:

    - `bandtm` (KID 4) when the peeled row window fits the band kernel's
      shared-memory plan for the dtype and the band's padding stays
      bounded (m * W <= BWD_CAP * nnz);
    - otherwise `diag` (KID 7) when the diagonals pass the JAX package's
      own diag test (plan.py:845-848): <= DIA_MAX diagonals with padding
      within BWD_CAP x nnz, or <= DIA_MAX_WIDE within 8 x nnz;
    - otherwise `gen` (KID 6, the general-structure composite) where
      `structure_mv_format` takes `gen` for the operand: the JAX package's
      TPU default, whose kind=None slot holds the mv form and sends it to
      KID 6 (on the card the mv default takes `segsum` there, and `gen` is
      mm's candidate). `mm_kind` keeps it only where the built form's band passes
      KID 6's gate (`gen_mm_ok`: the band kernel's layout, W <= band_max_w)
      and, on the card, beats the CSR SpMM kernel (`gen_beats_csr_mm`);
    - otherwise `mm_gather_kind(eff, device)`: on the card (`device`, the
      values' device where None), for the CSR SpMM kernel's dtypes,
      `segsum` (mm KID 0, csrc/spmm_csr.cu), which reads the CSR once and
      a B row an entry where the gather forms build an (nnz, K) product
      tile in plain torch and `gen` permutes B and C around a band far
      wider than the rows (scircuit at K = 64: 5.8x cuSPARSE's time on
      `gen`; PERF.md, PR 17); on the CPU the gather form
      `gather_fallback_kind` picks, as the JAX package does.

    The band kernels have f32, f64 and bf16 instances (a bf16 band or bf16
    diagonals with f32 B and C, the instances the mixed mode also uses), so
    a bf16 handle takes `bandtm`, `diag` or `gen` by the same rule; complex
    takes `mm_gather_kind`. On the card this diverges from the JAX package,
    which takes `gen` on its TPU (ops/level3/csrmm.py:186-208 there):
    ROADMAP, deliberate divergences."""
    from ..kernels.spmm_band import band_max_w

    if eff.m == 0 or eff.nnz == 0 or eff.val.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        return mm_gather_kind(eff, device)
    rows, rel = _rows_rel(eff)
    _lo, W, _spill = _bandt_window(rows, rel)
    if W <= band_max_w(eff.val.dtype) and eff.m * W <= BWD_CAP * eff.nnz:
        return "bandtm"
    if _diag_ok(eff):
        return "diag"
    if structure_mv_format(eff) == "gen":
        return "gen"
    return mm_gather_kind(eff, device)


def gen_mm_ok(form: Optional[ExecForm]) -> bool:
    """mm KID 6's gate, re-derived from the band SpMM kernel (#8): a gen
    form whose band has the kernel's (W, m_pad) layout, hence a dtype the
    kernel has (f32, f64, bf16), and a width within its plan for the dtype
    (`band_max_w`: 400 f32 and bf16, 184 f64), for any K. The JAX gate is a
    TPU's (ops/level3/csrmm.py:186-208 there: Mosaic dtypes, K padded to
    128, W <= 256)."""
    from ..kernels.spmm_band import band_max_w

    return (
        form is not None
        and form.kind == "gen"
        and form.gen_bandt
        and form.bwd_W <= band_max_w(form.bwd_val.dtype)
    )


def _gen_fallback_kind(eff: EffectiveCSR) -> str:
    """Where the composite rejects the structure: the whole-matrix route
    when it qualifies, else a gather form (plan.py:1629-1640 of the JAX
    package, without its catch-all: a failed route build raises)."""
    return "route" if _route_ok(eff) else gather_fallback_kind(eff)


def _is_allocation_failure(e: BaseException) -> bool:
    """numpy's MemoryError, the card's OutOfMemoryError, or the RuntimeError
    torch's CPU allocator raises when the host refuses an allocation."""
    return isinstance(e, (MemoryError, torch.OutOfMemoryError)) or (
        isinstance(e, RuntimeError) and "DefaultCPUAllocator" in str(e)
    )


def build_exec_form(eff: EffectiveCSR, kind: Optional[str] = None) -> ExecForm:
    """The execution form of `kind` (the cost model's where None). A layout
    the host or the card cannot allocate (a padded window of a structure
    far from the form's class) raises ``memory_error``, the reference's
    status for a failed allocation, so a caller that tries forms (the
    tuners, kernels/autotune.py) can tell it from a fault."""
    try:
        return _build_exec_form(eff, kind)
    except (MemoryError, RuntimeError) as e:
        if not _is_allocation_failure(e):
            raise
        raise AoclSparseError(Status.memory_error, f"the {kind} form does not fit: {e}") from e


def _build_exec_form(eff: EffectiveCSR, kind: Optional[str]) -> ExecForm:
    if kind is None:
        kind = choose_mv_format(eff)
    m, n = eff.shape
    if kind == "gen":
        form = _build_gen(eff)
        if form is not None:
            return form
        kind = _gen_fallback_kind(eff)
    if kind == "route":
        return _build_route(eff)
    if kind == "bandt":
        form = _build_bandt(eff)
        if form is not None:
            return form
        kind = "bwd"  # row window too wide after all: the group windows, as in the JAX package
    if kind == "bwd":
        return _build_bwd(eff)
    if kind == "sell":
        return _build_sell(eff)
    if kind == "host":
        form = ExecForm(kind="host", m=m, n=n, host_ptr=eff.ptr.astype(np.int64), host_ind=np.asarray(eff.ind))
        form.refresh(eff.val)
        return form
    if kind == "bandtm":
        form = _build_bandtm(eff)
        if form is not None:
            return form
        kind = "bwdg"  # row window too wide: the group form, as in the JAX package
    if kind == "bwdg":
        return _build_bwdg(eff)
    if kind == "diag":
        return _build_diag(eff)
    if kind in ("ell", "ellhyb"):
        return _build_ell(eff, hybrid=kind == "ellhyb")
    if kind == "segsum":
        form = ExecForm(kind="segsum", m=m, n=n, ind=_csr_index(eff.ind, eff.val.device), val=eff.val)
        attach_csr_plan(form, eff.ptr)
        return form
    raise AoclSparseError(Status.not_implemented, f"no execution form '{kind}'")


# ---------------------------------------------------------------------------
# Plan: the handle's cached optimized state (the `A->mats` + optim_data analog)
# ---------------------------------------------------------------------------


class Plan:
    def __init__(self, clean: CleanCSR):
        self.clean = clean
        self.effective: Dict[Tuple, EffectiveCSR] = {}
        self.exec_forms: Dict[Tuple, ExecForm] = {}
        #: choose_mm_format's answer per (descriptor, op): structure only
        self.mm_kinds: Dict[Tuple, str] = {}
        #: triangular solve forms (planner/triangular.py trsv_form_for)
        self.levels: Optional[Dict[Tuple, object]] = None
        #: (fill, diag, op) keys whose blocked solve form was refused, and
        #: their level statistics (ops/level2/trsv.py): structure only
        self.trsv_refused: set = set()
        self.trsv_level_stats: Dict[Tuple, Tuple[int, int]] = {}
        #: (descriptor, op) keys whose structure `_build_gen` rejected
        self.gen_rejected: set = set()
        # the pins of kernels/autotune.py, as in the JAX package: mv's host
        # engine by (type, fill, diag, op); mm's form by (type, fill, diag,
        # op, K); the triangular solve's nb and engine by (fill, diag, op)
        self._mv_engine: Dict[Tuple, str] = {}
        self._mm_tuned: Dict[Tuple, str] = {}
        self._trsv_tuned: Dict[Tuple, int] = {}
        self._trsv_engine: Dict[Tuple, str] = {}
        #: bumped by refresh_values: caches of value copies outside the
        #: plan (parallel/sweeps.py) are valid for one epoch
        self.values_epoch = 0

    def effective_for(
        self, descr: MatrixDescriptor, op: Operation, dtype=None
    ) -> EffectiveCSR:
        key = (descr.type, descr.fill_mode, descr.diag_type, Operation(op))
        eff = self.effective.get(key)
        if eff is None:
            eff = self.effective[key] = build_effective_csr(self.clean, descr, op, dtype)
        return eff

    def exec_form_for(
        self, descr: MatrixDescriptor, op: Operation, kind: Optional[str] = None, dtype=None
    ) -> ExecForm:
        eff = self.effective_for(descr, op, dtype)
        key = (descr.type, descr.fill_mode, descr.diag_type, Operation(op), kind)
        form = self.exec_forms.get(key)
        if form is None and kind is not None and kind != "bwdg":
            # an explicit kind the default form already has (mv kid=7 on a
            # matrix planned as gen): one form, not a second copy. A default
            # bwdg is a seeded SpGEMM product band (seed_bwdg), whose window
            # is not the G-aligned one mm KID 3 reads: never shared
            default = self.exec_forms.get(key[:4] + (None,))
            if default is not None and default.kind == kind:
                form = default
        if form is None:
            if kind is None:
                kind = choose_mv_format(eff)
                if kind == "gen":  # one gen form for mv and mm KID 6
                    form = self.gen_form_for(descr, op)
                    if form is None:
                        kind = _gen_fallback_kind(eff)
            if form is None:
                form = build_exec_form(eff, kind)
            self.exec_forms[key] = form
        return form

    def gen_form_for(self, descr: MatrixDescriptor, op: Operation) -> Optional[ExecForm]:
        """The gen form of (descr, op), or None where `_build_gen` rejects
        the structure. It is kept under kind "gen", the one form the mv
        default, mv kid=7 and mm KID 6 share, so a pin that replaces the
        default (kernels/autotune.py) leaves it to KID 6; a snapshot's
        default may hold it alone. Never the route or gather form
        `build_exec_form` falls back to, which mm KID 6 cannot use."""
        key = (descr.type, descr.fill_mode, descr.diag_type, Operation(op))
        for slot in (None, "gen"):
            form = self.exec_forms.get(key + (slot,))
            if form is not None and form.kind == "gen":
                return form
        if key + ("gen",) in self.exec_forms or key in self.gen_rejected:
            return None
        form = _build_gen(self.effective_for(descr, op))
        if form is None:
            self.gen_rejected.add(key)
            return None
        self.exec_forms[key + ("gen",)] = form
        return form

    def mm_form_for(self, descr: MatrixDescriptor, op: Operation, kind: str, default: bool = False) -> ExecForm:
        """The form `mm` runs for `kind`. For ``gen``: the gen form where it
        passes KID 6's gate (`gen_mm_ok`) and, for the `default` rule
        (`mm_kind`), beats the CSR SpMM kernel on the card
        (`gen_beats_csr_mm`), else `mm_gather_kind`'s form: the JAX
        package's gather rebuild (ops/level3/csrmm.py:225-241 there) off the
        card, `segsum` on it. A pin (kid=6, an autotune pin) reads the gate
        alone."""
        if kind == "gen":
            form = self.gen_form_for(descr, op)
            eff = self.effective_for(descr, op)
            if gen_mm_ok(form) and (not default or gen_beats_csr_mm(form, eff)):
                return form
            kind = mm_gather_kind(eff)
        return self.exec_form_for(descr, op, kind=kind)

    def seed_bwdg(self, form: ExecForm) -> None:
        """Seat a ready group-band form as the (general, none) mv form: the
        SpGEMM band engine's C band (kernels/spgemm_band.py
        `cband_exec_form`), so `mv` on a product reuses the band the numeric
        stage computed on the device, without a host relayout or the CSR
        extraction gather (plan.py:1759-1777 of the JAX package). Its
        scatter list is the extraction map, so a value refresh follows the
        normal path."""
        from ..core.descr import GENERAL

        self.effective_for(GENERAL, Operation.none)
        self.exec_forms[(GENERAL.type, GENERAL.fill_mode, GENERAL.diag_type, Operation.none, None)] = form

    def refresh_values(self, data: CSR) -> None:
        """After update_values: re-run every value gather (structure reused)."""
        self.clean.refresh(data.val)
        for eff in self.effective.values():
            eff.materialize(self.clean.val)
        for key, form in self.exec_forms.items():
            form.refresh(self.effective[key[:4]].val)
        self.levels = None  # solve forms rebuild from the new values
        self.values_epoch += 1


# ---------------------------------------------------------------------------
# public optimize() entry (aoclsparse_optimize, analysis.cpp:426-593)
# ---------------------------------------------------------------------------


def optimize(A: SparseMatrix) -> Plan:
    """Walk the hint list and prebuild what the hints ask for.

    With AOCLSPARSE_TPU_AUTOTUNE=1, mv hints of at least
    AOCLSPARSE_TPU_AUTOTUNE_NOP calls (default 1000) are measured: every
    buildable execution form is timed through the live dispatch and the
    winner pinned (kernels/autotune.py `autotune_mv`), as the JAX package
    does (planner/plan.py:1816-1850 there). A failed measurement warns and
    keeps the cost model's form."""
    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    plan = get_plan(A)
    tune = os.environ.get("AOCLSPARSE_TPU_AUTOTUNE", "0") in ("1", "true")
    try:
        tune_nop = int(os.environ.get("AOCLSPARSE_TPU_AUTOTUNE_NOP", "1000"))
    except ValueError:
        tune_nop = 1000
    for h in A.hints:
        if h.done:
            continue
        if tune and h.action == "mv" and h.nop >= tune_nop:
            from ..kernels.autotune import autotune_mv

            try:
                autotune_mv(A, h.descr, h.trans)
            except Exception as e:  # the cost model's form serves instead
                import warnings

                warnings.warn(
                    f"AOCLSPARSE_TPU_AUTOTUNE requested but measurement failed "
                    f"({type(e).__name__}: {e}); using the cost model",
                    RuntimeWarning,
                )
                plan.exec_form_for(h.descr, h.trans)
        elif h.action in ("mv", "dotmv"):
            plan.exec_form_for(h.descr, h.trans)
        elif h.action == "mm":
            plan.exec_form_for(h.descr, h.trans, kind=mm_kind(A, plan, h.descr, h.trans))
        else:
            plan.effective_for(h.descr, h.trans)
        h.done = True
    return plan


def mm_kind(A: SparseMatrix, plan: Plan, descr: MatrixDescriptor, op: Operation) -> str:
    """The form `mm` runs without a kid: `segsum` under the restricted
    memory policy (no format copies), else `choose_mm_format`'s answer,
    kept on the plan (it reads the structure only)."""
    if A.mem_policy == MemoryPolicy.restricted:
        return "segsum"
    key = (descr.type, descr.fill_mode, descr.diag_type, Operation(op))
    if key not in plan.mm_kinds:
        eff = plan.effective_for(descr, op)
        kind = choose_mm_format(eff)
        if kind == "gen":
            kind = plan.mm_form_for(descr, op, kind, default=True).kind
        plan.mm_kinds[key] = kind
    return plan.mm_kinds[key]


def get_plan(A: SparseMatrix) -> Plan:
    """Return (building if needed) the matrix's plan — the on-the-fly
    optimize path every op falls back to (aoclsparse_mv.cpp:149-163)."""
    if A.plan is None:
        from ..convert.conversions import to_csr

        A.plan = Plan(build_clean_csr(to_csr(A.data)))
        # a SpGEMM product's band, unless its values were swapped since
        seed = getattr(A, "_seed_bwdg", None)
        if seed is not None and getattr(A, "_seed_bwdg_val", None) is A.data.val:
            A.plan.seed_bwdg(seed)
    return A.plan
