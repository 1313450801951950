"""Planner for mv and mm: clean CSR -> effective CSR -> execution form.

PyTorch counterpart of ``aoclsparse_tpu/planner/plan.py`` for the forms this
package runs: ``bandt``, ``gen`` (the general-structure composite),
``route`` (the whole-matrix spill-route engine), ``ell``, ``ellhyb`` and
``segsum`` for mv; ``bandtm``, ``diag``, ``bwdg``, ``ell``, ``ellhyb`` and
``segsum`` for mm. Reference analogs:

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
    "choose_mm_format",
    "choose_mv_format",
    "gather_fallback_kind",
    "get_plan",
    "mm_kind",
    "optimize",
]


def _dev_index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host index map -> int64 device tensor (torch's native index type)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


# ---------------------------------------------------------------------------
# clean CSR (validated, sorted, zero-based, triangle-split)
# ---------------------------------------------------------------------------


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
        triangular form builders read values on the host."""
        if self.val_host is None:
            self.val_host = self.val.detach().cpu().numpy()
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

    kind: str  # "segsum" | "bandt" | "gen" | "route" | "bandtm" | "bwdg" | "diag" | "ell" | "ellhyb"
    m: int
    n: int
    # segsum
    ind: Optional[torch.Tensor] = None
    val: Optional[torch.Tensor] = None
    row_ids: Optional[torch.Tensor] = None
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
    # band forms. bandt: bwd_val[j, i] = A[i, i + lo + j] as a (W, m)
    # tensor for the band SpMV kernel (kernels/band_spmv.py); bandtm: the
    # row-aligned (m, W) layout v[i, j] = A[i, i + lo + j] for the band SpMM
    # kernels (kernels/spmm_band.py); bwdg: (ngrp, G, W) group windows, the
    # window of group g starting at padded B row G * (g + bwd_base8).
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
    #: lazily derived operands (the block-window band, bf16 diagonals),
    #: dropped by refresh()
    _derived: Optional[Dict[str, torch.Tensor]] = None
    #: gen_perm_maps' cache (structure only, kept by refresh())
    _perm_maps: Optional[Tuple] = None

    @property
    def has_spill(self) -> bool:
        return self.sp_ind is not None and int(self.sp_ind.shape[0]) > 0

    def band_bf16(self) -> torch.Tensor:
        """Cached bfloat16 copy of the band for the mixed-precision path
        (mv KID 12 and mm KID 3 under set_precision_mode(A, "mixed")).
        Casting per call would stream the f32 band and defeat the point;
        refresh() drops it so update_values flows through."""
        if self._bwd_val_bf16 is None:
            self._bwd_val_bf16 = self.bwd_val.to(torch.bfloat16)
        return self._bwd_val_bf16

    def _derive(self, key: str, build) -> torch.Tensor:
        if self._derived is None:
            self._derived = {}
        if key not in self._derived:
            self._derived[key] = build()
        return self._derived[key]

    def band_mxu_dt(self, bf16: bool = False) -> torch.Tensor:
        """(nblk, 256, 128) block windows of the bandtm band for mm KID 5
        (kernels/spmm_band.py `band_mxu_blocks`), built once on the form's
        device and cached per dtype. Needs W <= 129: one 256-row window
        covers a 128-row block plus its band."""
        from ..kernels.spmm_band import MXU_MAX_W, band_mxu_blocks

        if self.kind != "bandtm" or self.bwd_W > MXU_MAX_W:
            raise AoclSparseError(
                Status.invalid_kid,
                f"the block-window band needs a bandtm form with W <= {MXU_MAX_W}, "
                f"got {self.kind} W={self.bwd_W}",
            )
        if bf16:
            return self._derive("mxu_bf16", lambda: self.band_mxu_dt().to(torch.bfloat16))
        return self._derive("mxu", lambda: band_mxu_blocks(self.bwd_val, self.bwd_W))

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

    def nbytes(self) -> int:
        """Device bytes of the form's operands (the route's included)."""
        ts = (self.ind, self.val, self.row_ids, self.ell_ind, self.ell_val, self.sp_ind, self.sp_val,
              self.sp_rows, self.bwd_val, self.dia_val, self.dia_offs, self.gen_perm, self.gen_out,
              self.gen_flip, self.hub_cols, self.hub_slab, self.hubr_rows, self.hubr_slab)
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
        elif self.kind in ("bandt", "bandtm", "bwdg"):
            if self.kind == "bwdg":
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


def choose_mv_format(eff: EffectiveCSR) -> str:
    """Execution-format selection, re-derived for Hopper.

    The JAX package's rule (plan.py:815-879) rests on a TPU fact: gathers run
    far below the stream rate, so it weighs several gather-free forms. On
    Hopper the band kernel streams the (W, m) band once and reads x from a
    shared-memory window, while the gather form (segsum) pays an index and a
    random x read per nonzero. So:

    - `bandt` when the peeled row window fits (W <= BANDT_MAX_W, the JAX
      package's test) and the band's padding stays bounded
      (m * W <= BWD_CAP * nnz);
    - otherwise, for a square matrix with m >= 2 * GEN_B, `gen`: general
      structure is made band-compressible (hub slabs, block RCM, a peeled
      band on the same kernel) and its spill rides the spill-route kernels,
      as the JAX package does on its TPU with Pallas (plan.py:866-869; here
      the card stands in for both). When `_build_gen` rejects the matrix,
      `build_exec_form` goes on to the whole-matrix `route` form or the
      gather fallback, as in the JAX package;
    - otherwise `segsum`.

    Complex and float16 operands have no band kernel instance and take
    `segsum`."""
    if eff.m == 0 or eff.nnz == 0 or eff.val.dtype not in _BAND_DTYPES:
        return "segsum"
    rows, rel = _rows_rel(eff)
    _lo, W, _spill = _bandt_window(rows, rel)
    if W <= BANDT_MAX_W and eff.m * W <= BWD_CAP * eff.nnz:
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


def _diag_ok(eff: EffectiveCSR) -> bool:
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


def _build_bwd_coo(rows, cols, src, m: int, n: int, window: Tuple[int, int], device,
                   G: int = 8, kind: str = "gen") -> ExecForm:
    """Group-window geometry (plan.py:895-978 of the JAX package) of a
    (row, col)-sorted COO triple over a pre-selected (rel_lo, W) window:
    rows in groups of G, the window of group g starting at column
    G * g + rel_lo; entries outside it spill. `src` maps each entry to the
    effective value vector. Returns the form WITHOUT values."""
    ngrp = -(-m // G)
    blk = rows // G
    rel = cols - G * blk
    rel_lo, W = window
    spill_mask = (rel < rel_lo) | (rel >= rel_lo + W)
    keep = ~spill_mask
    L = max(0, -rel_lo)
    base = (rel_lo + L) // G
    need = G * (base + (-(-W // G)) - 1 + ngrp)
    spilled = bool(spill_mask.any())
    return ExecForm(
        kind=kind,
        m=m,
        n=n,
        bwd_dest=((blk * G + rows % G)[keep]) * W + (rel - rel_lo)[keep],
        bwd_srcpos=src[keep],
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


def choose_mm_format(eff: EffectiveCSR) -> str:
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
    - otherwise the gather form `gather_fallback_kind` picks.

    The kernels have f32 and f64 instances (and bf16 diagonals under the
    mixed mode); other dtypes take the gather forms."""
    from ..kernels.spmm_band import band_max_w

    if eff.m == 0 or eff.nnz == 0 or eff.val.dtype not in (torch.float32, torch.float64):
        return gather_fallback_kind(eff)
    rows, rel = _rows_rel(eff)
    _lo, W, _spill = _bandt_window(rows, rel)
    if W <= band_max_w(eff.val.dtype) and eff.m * W <= BWD_CAP * eff.nnz:
        return "bandtm"
    if _diag_ok(eff):
        return "diag"
    return gather_fallback_kind(eff)


def build_exec_form(eff: EffectiveCSR, kind: Optional[str] = None) -> ExecForm:
    if kind is None:
        kind = choose_mv_format(eff)
    m, n = eff.shape
    if kind == "gen":
        form = _build_gen(eff)
        if form is not None:
            return form
        # the composite rejected the structure: the whole-matrix route when
        # it qualifies, else a gather form (plan.py:1629-1640 of the JAX
        # package, without its catch-all: a failed route build raises)
        kind = "route" if _route_ok(eff) else gather_fallback_kind(eff)
    if kind == "route":
        return _build_route(eff)
    if kind == "bandt":
        form = _build_bandt(eff)
        if form is not None:
            return form
        kind = "segsum"  # row window too wide after all: the gather form
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
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
        dev = eff.val.device
        return ExecForm(
            kind="segsum",
            m=m,
            n=n,
            ind=_dev_index(eff.ind, dev),
            val=eff.val,
            row_ids=_dev_index(rows, dev),
        )
    raise AoclSparseError(
        Status.not_implemented,
        f"execution form '{kind}' is not ported yet (ROADMAP.md queue 1 item 10)",
    )


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
        if form is None and kind is not None:
            # an explicit kind the default form already has (mv kid=7 on a
            # matrix planned as gen): one form, not a second copy
            default = self.exec_forms.get(key[:4] + (None,))
            if default is not None and default.kind == kind:
                form = default
        if form is None:
            form = self.exec_forms[key] = build_exec_form(eff, kind)
        return form

    def refresh_values(self, data: CSR) -> None:
        """After update_values: re-run every value gather (structure reused)."""
        self.clean.refresh(data.val)
        for eff in self.effective.values():
            eff.materialize(self.clean.val)
        for key, form in self.exec_forms.items():
            form.refresh(self.effective[key[:4]].val)
        self.levels = None  # solve forms rebuild from the new values


# ---------------------------------------------------------------------------
# public optimize() entry (aoclsparse_optimize, analysis.cpp:426-593)
# ---------------------------------------------------------------------------


def optimize(A: SparseMatrix) -> Plan:
    """Walk the hint list and prebuild what the hints ask for."""
    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    plan = get_plan(A)
    for h in A.hints:
        if h.done:
            continue
        if h.action in ("mv", "dotmv"):
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
        plan.mm_kinds[key] = choose_mm_format(plan.effective_for(descr, op))
    return plan.mm_kinds[key]


def get_plan(A: SparseMatrix) -> Plan:
    """Return (building if needed) the matrix's plan — the on-the-fly
    optimize path every op falls back to (aoclsparse_mv.cpp:149-163)."""
    if A.plan is None:
        A.plan = Plan(build_clean_csr(A.data))
    return A.plan
