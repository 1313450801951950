"""Format conversions (reference: library/src/conversion/aoclsparse_convert.cpp).

PyTorch counterpart of ``aoclsparse_tpu/convert/conversions.py``. Structure
(pointers, index layouts, widths, permutations) is computed on the host
with vectorized numpy, as in the JAX package; values stay tensors on the
operand's device and move through one gather or scatter keyed by the host
permutation.

Covers csr2csc (:817), csr2ell/ellt/ellthyb (:307-505), csr2dia (:506),
csr2bsr (:592), the sliced-ELL layout, csr2dense (:933), the handle-level
convert_csr (:1004) through `to_csr` on every format, and the sizing
queries of the reference's two-phase API (include/aoclsparse_convert.h).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.context import resolve_device
from ..core.formats import BSR, COO, CSC, CSR, DIA, ELL, SELL, TCSR
from ..core.types import AoclSparseError, Operation, Status
from ..core.validate import host_array

__all__ = [
    "to_csr",
    "to_csc",
    "to_coo",
    "sort_csr",
    "csr_transpose",
    "csr_apply_operation",
    "tcsr_to_csr",
    "csr_to_ell",
    "csr_to_ellhyb",
    "csr_to_dia",
    "csr_to_bsr",
    "csr_to_sell",
    "bsr_to_csr",
    "csr_to_dense",
    "dense_to_csr",
    "coo_to_csr",
    "csr2ell_width",
    "csr2ellthyb_width",
    "csr2dia_ndiag",
    "csr2bsr_nnz",
    "opt_blksize",
    "csr2blkcsr",
    "sell_layout",
]


def _idx(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host int32 index array -> tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def _take(val: torch.Tensor, pos: np.ndarray) -> torch.Tensor:
    """val[pos] on val's device, pos a host index array."""
    return val[torch.from_numpy(np.ascontiguousarray(pos, dtype=np.int64)).to(val.device)]


def _csr_from_coo_sorted(r: np.ndarray, c: np.ndarray, val: torch.Tensor, shape) -> CSR:
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=shape[0]))]).astype(np.int32)
    return CSR(_idx(ptr, val.device), _idx(c, val.device), val, shape=tuple(shape))


# ---------------------------------------------------------------------------
# canonicalization
# ---------------------------------------------------------------------------


def coo_to_csr(A: COO, sum_duplicates: bool = False) -> CSR:
    """COO -> CSR sorted by (row, col); with sum_duplicates equal (row, col)
    entries merge by summation."""
    row = host_array(A.row).astype(np.int64)
    col = host_array(A.col).astype(np.int64)
    order = np.lexsort((col, row))
    row_s, col_s = row[order], col[order]
    val = _take(A.val, order)
    if sum_duplicates and row_s.size:
        keep = np.ones(row_s.size, dtype=bool)
        keep[1:] = (row_s[1:] != row_s[:-1]) | (col_s[1:] != col_s[:-1])
        seg = np.cumsum(keep) - 1
        val = torch.zeros(int(seg[-1]) + 1, dtype=val.dtype, device=val.device).index_add_(
            0, torch.from_numpy(seg).to(val.device), val
        )
        row_s, col_s = row_s[keep], col_s[keep]
    return _csr_from_coo_sorted(row_s, col_s, val, A.shape)


def sort_csr(A: CSR) -> CSR:
    """Sort column indices within each row (aoclsparse_sort_idx_val analog,
    csr_util.hpp:103); values permuted on their device."""
    ptr, ind = host_array(A.ptr), host_array(A.ind)
    rows = np.repeat(np.arange(A.m, dtype=np.int64), np.diff(ptr))
    order = np.lexsort((ind, rows))
    if np.array_equal(order, np.arange(order.size)):
        return A
    return CSR(A.ptr, _idx(ind[order], A.device), _take(A.val, order), shape=A.shape)


def csr_transpose(A: CSR, conj: bool = False) -> CSR:
    """CSR of A^T (the csr2csc engine), conjugated with conj."""
    ptr, ind = host_array(A.ptr), host_array(A.ind).astype(np.int64)
    m, n = A.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    order = np.lexsort((rows, ind))  # by (col, row)
    val = _take(A.val, order)
    if conj and val.is_complex():
        val = torch.conj_physical(val)
    return _csr_from_coo_sorted(ind[order], rows[order], val, (n, m))


def csr_apply_operation(A: CSR, op: Operation) -> CSR:
    op = Operation(op)
    if op == Operation.none:
        return A
    return csr_transpose(A, conj=op == Operation.conjugate_transpose)


def tcsr_to_csr(data: TCSR) -> CSR:
    """Merge the two TCSR triangles into sorted CSR, the diagonal taken from
    the L copy."""
    m, n = data.shape
    pL, pU = host_array(data.ptr_L).astype(np.int64), host_array(data.ptr_U).astype(np.int64)
    iL, iU = host_array(data.ind_L).astype(np.int64), host_array(data.ind_U).astype(np.int64)
    rows_L = np.repeat(np.arange(m, dtype=np.int64), np.diff(pL))
    rows_U = np.repeat(np.arange(m, dtype=np.int64), np.diff(pU))
    keep_U = np.nonzero(iU != rows_U)[0]  # strictly-upper only
    r = np.concatenate([rows_L, rows_U[keep_U]])
    c = np.concatenate([iL, iU[keep_U]])
    v = torch.cat([data.val_L, _take(data.val_U, keep_U)])
    order = np.lexsort((c, r))
    return _csr_from_coo_sorted(r[order], c[order], _take(v, order), (m, n))


def to_csr(data) -> CSR:
    if isinstance(data, CSR):
        return data
    if isinstance(data, TCSR):
        return tcsr_to_csr(data)
    if isinstance(data, CSC):
        # CSC(m, n) arrays are the CSR of the (n, m) transpose
        return csr_transpose(CSR(data.ptr, data.ind, data.val, shape=(data.n, data.m)))
    if isinstance(data, COO):
        return coo_to_csr(data)
    if isinstance(data, BSR):
        return bsr_to_csr(data)
    if isinstance(data, ELL):
        return _ell_to_csr(data)
    if isinstance(data, DIA):
        return _dia_to_csr(data)
    raise AoclSparseError(Status.wrong_type, f"to_csr: unsupported {type(data)}")


def to_csc(data) -> CSC:
    A = to_csr(data)
    T = csr_transpose(A)
    return CSC(T.ptr, T.ind, T.val, shape=A.shape)


def to_coo(data) -> COO:
    A = to_csr(data)
    rows = np.repeat(np.arange(A.m, dtype=np.int64), np.diff(host_array(A.ptr)))
    return COO(_idx(rows, A.device), A.ind, A.val, shape=A.shape)


# ---------------------------------------------------------------------------
# CSR -> padded and blocked formats
# ---------------------------------------------------------------------------


def _padded_rows(A: CSR, width: int, lens: np.ndarray):
    """(valid mask, source positions, column indices with -1 padding) of
    the (m, width) padded rows over the first `lens` entries of each row."""
    ptr, ind = host_array(A.ptr).astype(np.int64), host_array(A.ind)
    valid = np.arange(width)[None, :] < lens[:, None]
    src = np.where(valid, ptr[:-1, None] + np.arange(width)[None, :], 0)
    cols = np.where(valid, ind[np.minimum(src, max(ind.size - 1, 0))] if ind.size else 0, -1)
    return valid, src, cols


def _padded_vals(A: CSR, valid: np.ndarray, src: np.ndarray) -> torch.Tensor:
    m, w = valid.shape
    if A.nnz == 0 or w == 0:
        return torch.zeros((m, w), dtype=A.dtype, device=A.device)
    vals = _take(A.val, src.reshape(-1)).reshape(m, w)
    return torch.where(torch.from_numpy(valid).to(A.device), vals, torch.zeros((), dtype=A.dtype, device=A.device))


def csr_to_ell(A: CSR, width: Optional[int] = None) -> ELL:
    """Pad every row to `width` (default: the longest row) (csr2ell,
    convert.cpp:307)."""
    lens = np.diff(host_array(A.ptr))
    w = int(width if width is not None else (lens.max() if lens.size else 0))
    valid, src, cols = _padded_rows(A, w, lens)
    return ELL(_idx(cols, A.device), _padded_vals(A, valid, src), width=w, shape=A.shape)


def csr_to_ellhyb(A: CSR, width: Optional[int] = None) -> Tuple[ELL, CSR]:
    """Hybrid split (csr2ellthyb, convert.cpp:406): each row's first `width`
    entries in ELL, the rest in a CSR remainder. The default width is the
    mean row length rounded up to 8, clamped to [8, 64], as in the JAX
    package."""
    lens = np.diff(host_array(A.ptr))
    if width is None:
        mean = float(lens.mean()) if lens.size else 0.0
        width = int(min(max(8, int(np.ceil(mean / 8.0) * 8)), 64))
    w = int(width)
    head = np.minimum(lens, w)
    valid, src, cols = _padded_rows(A, w, head)
    ell = ELL(_idx(cols, A.device), _padded_vals(A, valid, src), width=w, shape=A.shape)
    tail = lens - head
    ptr = host_array(A.ptr).astype(np.int64)
    starts = ptr[:-1] + head
    firsts = np.concatenate([[0], np.cumsum(tail)])
    src2 = np.repeat(starts, tail) + (np.arange(int(firsts[-1])) - np.repeat(firsts[:-1], tail))
    ind = host_array(A.ind)
    spill = CSR(_idx(firsts, A.device), _idx(ind[src2] if src2.size else np.zeros(0, np.int32), A.device),
                _take(A.val, src2), shape=A.shape)
    return ell, spill


def csr_to_dia(A: CSR, max_diags: Optional[int] = None) -> DIA:
    """DIA over the distinct diagonals, val[k, i] = A[i, i + dist[k]]
    (csr2dia, convert.cpp:506); invalid_size past max_diags."""
    ptr, ind = host_array(A.ptr), host_array(A.ind).astype(np.int64)
    m, _n = A.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    diags = ind - rows
    dist = np.unique(diags)
    if max_diags is not None and dist.size > max_diags:
        raise AoclSparseError(Status.invalid_size, f"{dist.size} diagonals > cap {max_diags}")
    val = torch.zeros(dist.size * m, dtype=A.dtype, device=A.device)
    flat = np.searchsorted(dist, diags) * m + rows
    val[torch.from_numpy(flat).to(A.device)] = A.val
    return DIA(_idx(dist, A.device), val.reshape(dist.size, m), shape=A.shape)


def csr_to_bsr(A: CSR, block_dim: int) -> BSR:
    """BSR of (bs, bs) blocks, the element-level shape kept and the edge
    blocks zero-padded (csr2bsr, convert.cpp:592)."""
    bs = int(block_dim)
    m, n = A.shape
    mb, nb = -(-m // bs), -(-n // bs)
    ptr, ind = host_array(A.ptr), host_array(A.ind).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    keys = (rows // bs) * nb + ind // bs
    ukeys, inv = np.unique(keys, return_inverse=True)
    bptr = np.concatenate([[0], np.cumsum(np.bincount(ukeys // nb, minlength=mb))])
    bval = torch.zeros(ukeys.size * bs * bs, dtype=A.dtype, device=A.device)
    flat = (inv.reshape(-1) * bs + rows % bs) * bs + ind % bs
    bval[torch.from_numpy(flat).to(A.device)] = A.val
    return BSR(_idx(bptr, A.device), _idx(ukeys % nb, A.device), bval.reshape(ukeys.size, bs, bs),
               block_dim=bs, shape=(m, n))


def bsr_to_csr(A: BSR) -> CSR:
    """Expand the stored blocks to element CSR. Every in-range entry of a
    stored block is kept, zeros included: filtering on value would change
    the stored pattern."""
    bs = A.block_dim
    bptr, bind = host_array(A.ptr).astype(np.int64), host_array(A.ind).astype(np.int64)
    m, n = A.shape
    nnzb = bind.shape[0]
    brow = np.repeat(np.arange(A.mb, dtype=np.int64), np.diff(bptr))
    r = np.arange(bs, dtype=np.int64)
    i = np.broadcast_to(brow[:, None, None] * bs + r[None, :, None], (nnzb, bs, bs)).ravel()
    j = np.broadcast_to(bind[:, None, None] * bs + r[None, None, :], (nnzb, bs, bs)).ravel()
    keep = np.nonzero((i < m) & (j < n))[0]
    order = np.lexsort((j[keep], i[keep]))
    pos = keep[order]
    return _csr_from_coo_sorted(i[pos], j[pos], _take(A.val.reshape(-1), pos), (m, n))


def sell_layout(ptr: np.ndarray, slice_rows: int, lane: int):
    """The sliced-ELL layout of a CSR row pointer: per `slice_rows`-row
    slice, the width is the slice's longest row rounded up to a `lane`
    multiple (at least one lane). Returns (widths, slice offsets, dest), dest
    the flat position of each stored entry."""
    ptr = np.asarray(ptr, dtype=np.int64)
    m = ptr.size - 1
    lens = np.diff(ptr)
    nsl = -(-m // slice_rows) if m else 0
    lens_pad = np.zeros(nsl * slice_rows, dtype=np.int64)
    lens_pad[:m] = lens
    wmax = lens_pad.reshape(nsl, slice_rows).max(axis=1) if nsl else np.zeros(0, np.int64)
    widths = np.maximum(lane, -(-wmax // lane) * lane)
    sp = np.concatenate([[0], np.cumsum(widths * slice_rows)])
    r = np.arange(m)
    row_off = sp[r // slice_rows] + (r % slice_rows) * widths[r // slice_rows]
    dest = np.repeat(row_off, lens) + (np.arange(int(ptr[-1])) - np.repeat(ptr[:-1], lens))
    return widths, sp, dest


def csr_to_sell(A: CSR, slice_rows: int = 8, lane: int = 128) -> SELL:
    """Sliced ELL (`sell_layout`); -1 and 0 pad."""
    widths, sp, dest = sell_layout(host_array(A.ptr), slice_rows, lane)
    ind = host_array(A.ind)
    tot = int(sp[-1])
    out_ind = np.full(tot, -1, dtype=np.int32)
    out_ind[dest] = ind
    vals = torch.zeros(tot, dtype=A.dtype, device=A.device)
    vals[torch.from_numpy(dest).to(A.device)] = A.val
    return SELL(_idx(sp, A.device), _idx(widths, A.device), _idx(out_ind, A.device), vals,
                slice_rows=slice_rows, shape=A.shape)


# ---------------------------------------------------------------------------
# dense interop
# ---------------------------------------------------------------------------


def csr_to_dense(A, order: str = "row") -> torch.Tensor:
    """csr2dense (convert.cpp:933): duplicates add. Takes the CSR or a
    CSR-format handle; order="column" returns the transpose's layout."""
    if not isinstance(A, CSR) and isinstance(getattr(A, "data", None), CSR):
        A = A.data
    m, n = A.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(host_array(A.ptr)))
    out = torch.zeros((m, n), dtype=A.dtype, device=A.device)
    out.index_put_((torch.from_numpy(rows).to(A.device), A.ind.long()), A.val, accumulate=True)
    return out.T if order == "column" else out


def _ell_to_csr(E: ELL) -> CSR:
    ind = host_array(E.ind)
    mask = ind >= 0
    pos = np.flatnonzero(mask)
    rows = pos // max(ind.shape[1], 1)
    return _csr_from_coo_sorted(rows, ind.reshape(-1)[pos], _take(E.val.reshape(-1), pos), E.shape)


def _dia_to_csr(D: DIA) -> CSR:
    """The stored nonzero entries of the diagonals, sorted by (row, col)."""
    dist = host_array(D.dist).astype(np.int64)
    m, n = D.shape
    cols = np.arange(m, dtype=np.int64)[None, :] + dist[:, None]
    nz = host_array(D.val != 0) if D.val.numel() else np.zeros((dist.size, m), bool)
    pos = np.flatnonzero(((cols >= 0) & (cols < n)) & nz)
    rows = pos % max(m, 1)
    c = cols.reshape(-1)[pos]
    order = np.lexsort((c, rows))
    return _csr_from_coo_sorted(rows[order], c[order], _take(D.val.reshape(-1), pos[order]), D.shape)


def dense_to_csr(dense, tol: float = 0.0, device=None) -> CSR:
    """CSR of the entries with |value| > tol, on the tensor's device (an
    array-like goes to `device`, default cuda:0)."""
    d = dense if isinstance(dense, torch.Tensor) else torch.as_tensor(np.asarray(dense), device=resolve_device(device))
    m, n = d.shape
    mask = d.abs() > tol
    lens = host_array(mask.sum(dim=1))
    rc = torch.nonzero(mask)
    ptr = np.concatenate([[0], np.cumsum(lens)])
    return CSR(_idx(ptr, d.device), rc[:, 1].to(torch.int32), d[mask], shape=(m, n))


# ---------------------------------------------------------------------------
# Sizing queries of the reference's two-phase conversion API
# (aoclsparse_csr2ell_width, csr2ellthyb_width, csr2dia_ndiag, csr2bsr_nnz,
# opt_blksize; include/aoclsparse_convert.h:39-634). The converters above
# return ready objects; these answer the planning numbers alone.
# ---------------------------------------------------------------------------


def csr2ell_width(m: int, nnz: int, csr_row_ptr) -> int:
    """Longest row, the ELL width (aoclsparse_csr2ell_width, convert.cpp:
    300-335). The null check comes before any m == 0 exit."""
    if m < 0 or nnz < 0:
        raise AoclSparseError(Status.invalid_size, "negative size")
    if csr_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null row_ptr")
    lens = np.diff(host_array(csr_row_ptr))
    return int(lens.max()) if lens.size else 0


def csr2ellthyb_width(m: int, nnz: int, csr_row_ptr) -> Tuple[int, int]:
    """(ell_m, ell_width) of the hybrid split (aoclsparse_csr2ellthyb_width,
    convert.cpp:340-404): the reference's majority-side pivot around the
    mean row length; ell_m counts the rows that fit."""
    if m < 0 or nnz < 0:
        raise AoclSparseError(Status.invalid_size, "negative size")
    if m == 0:
        return 0, 0
    if csr_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null row_ptr")
    lens = np.diff(host_array(csr_row_ptr)).astype(np.int64)
    nnza = nnz // m
    le, gt = lens[lens <= nnza], lens[lens > nnza]
    mx_le = int(le.max()) if le.size else 0
    mn_gt = int(gt.min()) if gt.size else nnz
    width = mx_le if le.size >= gt.size else mn_gt
    return int((lens <= width).sum()), width


def csr2dia_ndiag(m: int, n: int, nnz: int, csr_row_ptr, csr_col_ind) -> int:
    """Number of distinct diagonals (aoclsparse_csr2dia_ndiag, convert.h:215)."""
    if m < 0 or n < 0 or nnz < 0:
        raise AoclSparseError(Status.invalid_size, "negative size")
    if csr_row_ptr is None or csr_col_ind is None:
        raise AoclSparseError(Status.invalid_pointer, "null CSR array")
    ptr, ind = host_array(csr_row_ptr), host_array(csr_col_ind).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    return int(np.unique(ind - rows).size)


def csr2bsr_nnz(m: int, n: int, csr_row_ptr, csr_col_ind, block_dim: int) -> Tuple[np.ndarray, int]:
    """(bsr_row_ptr, bsr_nnz): the nonzero blocks per block row and in all
    (aoclsparse_csr2bsr_nnz, convert.h:324)."""
    if m < 0 or n < 0 or block_dim <= 0:
        raise AoclSparseError(Status.invalid_size, "bad dimension/block_dim")
    if csr_row_ptr is None or csr_col_ind is None:
        raise AoclSparseError(Status.invalid_pointer, "null CSR array")
    bs = int(block_dim)
    mb, nb = -(-m // bs), -(-n // bs)
    ptr, ind = host_array(csr_row_ptr), host_array(csr_col_ind).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    keys = np.unique((rows // bs) * nb + ind // bs)
    counts = np.bincount((keys // nb).astype(np.int64), minlength=mb)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64), int(keys.size)


def opt_blksize(m: int, nnz: int, csr_row_ptr, csr_col_ind) -> Tuple[int, int]:
    """The blkcsr row-group size (aoclsparse_opt_blksize,
    conversion/aoclsparse_convert.cpp:36-143): (nRowsblk, total_blks), with
    nRowsblk == 0 when block compression does not pay, by the reference's
    utilization cutoffs."""
    if m <= 0 or nnz <= 0 or csr_row_ptr is None or csr_col_ind is None:
        return 0, 0
    from .. import native

    ptr, ind = host_array(csr_row_ptr).astype(np.int64), host_array(csr_col_ind).astype(np.int64)
    n_cols = int(ind.max()) + 1 if ind.size else 0
    factors = (1, 2, 4)
    # the first counting pass gates the rest (the reference returns inside
    # the first iteration); nnz per row is an integer division there
    t1 = native.blkcsr_count(m, n_cols, ptr, ind, 1)
    util1 = (nnz / t1 if t1 else 0.0) / 8 * 100
    nnzpr = nnz // m
    if (nnzpr < 30 and util1 < 40) or (nnzpr > 30 and util1 < 50):
        return 0, 0
    total = [t1] + [native.blkcsr_count(m, n_cols, ptr, ind, f) for f in factors[1:]]
    per_blk = [nnz / t if t else 0.0 for t in total]
    blk_util = [per_blk[i] / (factors[i] * 8) * 100 for i in range(3)]
    inc1 = (per_blk[1] - per_blk[0]) / per_blk[0] * 100 if per_blk[0] else 0.0
    inc2 = (per_blk[2] - per_blk[1]) / per_blk[1] * 100 if per_blk[1] else 0.0
    if blk_util[2] > 24 and (abs(inc1 - inc2) < 12.5 or abs(blk_util[1] - blk_util[2]) < 12.5) and inc2 > 51:
        return 4, total[2]
    if blk_util[1] > 28:
        return 2, total[1]
    return 0, 0


def csr2blkcsr(m: int, n: int, nnz: int, csr_row_ptr, csr_col_ind, csr_val, nRowsblk: int, device=None):
    """Greedy masked-block compression (aoclsparse_csr2blkcsr,
    conversion/aoclsparse_convert.cpp:145-290): (blk_row_ptr, blk_col_ind,
    blk_csr_val, masks), blocks of nRowsblk x 8 columns with per-subrow
    uint8 masks and the values in mask-bit order. Needs sorted,
    duplicate-free CSR; the scan runs in the host library. The values stay
    on csr_val's device (an array-like goes to `device`, default cuda:0)."""
    if m < 0 or n < 8 or nnz < 0:
        raise AoclSparseError(Status.invalid_size, "need m >= 0, n >= 8")
    if nRowsblk not in (1, 2, 4):
        raise AoclSparseError(Status.invalid_size, "nRowsblk must be 1, 2 or 4")
    if csr_row_ptr is None or csr_col_ind is None or csr_val is None:
        raise AoclSparseError(Status.invalid_pointer, "null CSR array")
    from .. import native
    from ..core.matrix import as_values

    ptr, ind = host_array(csr_row_ptr).astype(np.int64), host_array(csr_col_ind).astype(np.int64)
    brow_ptr, bcol, masks, perm = native.blkcsr_build(m, n, ptr, ind, int(nRowsblk))
    dev = csr_val.device if isinstance(csr_val, torch.Tensor) else resolve_device(device)
    return brow_ptr, bcol, _take(as_values(csr_val, dev), perm), masks
