"""Format-direct SpMV entry points on raw arrays (the reference's legacy API).

PyTorch counterpart of ``aoclsparse_tpu/ops/level2/format_mv.py``:

- ``csrmv``     aoclsparse_?csrmv     (level2/aoclsparse_csrmv.cpp:31-62)
- ``ellmv``     aoclsparse_?ellmv     (level2/aoclsparse_ellmv.hpp:35-89, row-major ELL)
- ``elltmv``    aoclsparse_?elltmv    (ellmv.hpp:318-361, slot-major ELL)
- ``ellthybmv`` aoclsparse_?ellthybmv (ellmv.hpp:555-700, ELLT head + CSR rows)
- ``diamv``     aoclsparse_?diamv     (level2/aoclsparse_diamv.hpp:72+)
- ``bsrmv``     aoclsparse_?bsrmv     (level2/aoclsparse_bsrmv.cpp)
- ``blkcsrmv``  aoclsparse_?blkcsrmv  (level2/aoclsparse_blkcsrmv.cpp:35+, masked 8-column blocks)

They run the plain formulations of kernels/plain_spmv.py with no planner
round trip, the reference's no-analysis path; the handle API (create_* +
hints + ``mv``) is the optimized one. Validation is the JAX package's
(:66-108 there): the legacy format routines take general matrices and
``Operation.none`` only (ellmv_t:237-247 returns not_implemented
otherwise), ``csrmv`` also symmetric matrices and the transposes
(csrmv_t:188-295). Array layouts are those of convert/conversions.py: ELL
(m, width) with -1 padding, ELLT (width, m), DIA (ndiag, m) plus offsets,
BSR (nnzb, bs, bs). The result lies on x's device when x is a tensor, else
on `device` (default cuda:0).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.context import resolve_device
from ...core.matrix import as_values
from ...core.types import AoclSparseError, DiagType, FillMode, IndexBase, MatrixType, Operation, Status
from ...core.validate import host_array
from ...kernels.plain_spmv import spmv_bsr, spmv_dia, spmv_ell, spmv_segsum

__all__ = ["csrmv", "ellmv", "elltmv", "ellthybmv", "diamv", "bsrmv", "blkcsrmv"]


def _common_checks(descr, op, m, n, x, general_only: bool):
    if descr is None:
        raise AoclSparseError(Status.invalid_pointer, "null descriptor")
    descr.validate()
    op = Operation(op)
    mt = MatrixType(descr.type)
    if general_only:
        if mt != MatrixType.general:
            raise AoclSparseError(Status.not_implemented, f"matrix type {mt.name} not supported here")
        if op != Operation.none:
            raise AoclSparseError(Status.not_implemented, "transposed op not supported here")
    if m < 0 or n < 0:
        raise AoclSparseError(Status.invalid_size, "negative dimension")
    if x is None:
        raise AoclSparseError(Status.invalid_pointer, "null x")
    return op, mt


def _device(x, device) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else resolve_device(device)


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return a.to(dev) if isinstance(a, torch.Tensor) else as_values(a, dev)


def _x(x, dev: torch.device, want: int) -> torch.Tensor:
    """x as a tensor of at least `want` entries: the arrays carry their
    length, so an undersized x is invalid_size here (the reference's raw
    pointers cannot tell)."""
    xs = _tensor(x, dev)
    if xs.shape[0] < want:
        raise AoclSparseError(Status.invalid_size, f"x needs {want} entries")
    return xs


def _idx(a, dev: torch.device, base=IndexBase.zero) -> torch.Tensor:
    a = host_array(a).astype(np.int64)
    if IndexBase(base) == IndexBase.one:
        a = a - 1
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _epilogue(ax, alpha, beta, y, ny: int, dtype, dev) -> torch.Tensor:
    if y is not None:
        yt = _tensor(y, dev)
        if yt.shape[0] < ny:
            raise AoclSparseError(Status.invalid_size, f"y needs {ny} entries")
        y0 = yt[:ny].to(dtype)
    else:
        y0 = torch.zeros(ny, dtype=dtype, device=dev)
    return alpha * ax.to(dtype) + beta * y0


def _segsum(vals, seg, m: int) -> torch.Tensor:
    """Scatter-add of `vals` into `m` rows by (unsorted) segment ids."""
    return torch.zeros(m, dtype=vals.dtype, device=vals.device).index_add_(0, seg, vals)


def csrmv(op, alpha, m, n, nnz, csr_val, csr_col_ind, csr_row_ptr, descr, x, beta, y=None, device=None):
    """Direct CSR SpMV on raw arrays (aoclsparse_?csrmv, csrmv.cpp:31-62):
    general (any op) and symmetric (the fill-mode triangle plus its mirror,
    the diagonal once, csrmv_t:188-295); other types not_implemented."""
    op, mt = _common_checks(descr, op, m, n, x, general_only=False)
    if mt not in (MatrixType.general, MatrixType.symmetric):
        raise AoclSparseError(Status.not_implemented, f"csrmv: type {mt.name}")
    if mt == MatrixType.symmetric and m != n:
        raise AoclSparseError(Status.invalid_size, "symmetric matrix must be square")
    if nnz < 0:
        raise AoclSparseError(Status.invalid_size, "negative nnz")
    if csr_val is None or csr_col_ind is None or csr_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null CSR array")
    ptr = host_array(csr_row_ptr)
    if ptr.shape[0] != m + 1:
        raise AoclSparseError(Status.invalid_size, "row_ptr must have m+1 entries")
    dev = _device(x, device)
    ind_h = host_array(csr_col_ind).astype(np.int64) - (1 if IndexBase(descr.base) == IndexBase.one else 0)
    val = _tensor(csr_val, dev)
    xs = _x(x, dev, n if op == Operation.none or mt == MatrixType.symmetric else m)
    dtype = torch.promote_types(val.dtype, xs.dtype)
    rows_h = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    if ind_h.shape[0] and (ind_h.min() < 0 or ind_h.max() >= n):
        raise AoclSparseError(Status.invalid_index_value, "column index out of range")
    conj = op == Operation.conjugate_transpose and val.is_complex()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if mt == MatrixType.symmetric:
        lower = FillMode(descr.fill_mode) == FillMode.lower
        keep = np.flatnonzero((ind_h <= rows_h) if lower else (ind_h >= rows_h))
        strict = np.flatnonzero((ind_h < rows_h) if lower else (ind_h > rows_h))
        tri_val, s_val = val[t(keep)], val[t(strict)]
        if conj:
            tri_val, s_val = torch.conj_physical(tri_val), torch.conj_physical(s_val)
        ax = spmv_segsum(t(ind_h[keep]), tri_val, t(rows_h[keep]), xs, m)
        ax = ax + _segsum(s_val * xs[t(rows_h[strict])], t(ind_h[strict]), m)
        dt = DiagType(descr.diag_type)
        if dt in (DiagType.unit, DiagType.zero):
            on = np.flatnonzero(ind_h[keep] == rows_h[keep])
            ax = ax - _segsum(tri_val[t(on)] * xs[t(ind_h[keep][on])], t(rows_h[keep][on]), m)
            if dt == DiagType.unit:
                ax = ax + xs[:m]
        return _epilogue(ax, alpha, beta, y, m, dtype, dev)
    if op == Operation.none:
        ax = spmv_segsum(t(ind_h), val, t(rows_h), xs, m)
        ny = m
    else:
        v = torch.conj_physical(val) if conj else val
        ax = _segsum(v * xs[t(rows_h)], t(ind_h), n)
        ny = n
    return _epilogue(ax, alpha, beta, y, ny, dtype, dev)


def ellmv(op, alpha, m, n, nnz, ell_val, ell_col_ind, ell_width, descr, x, beta, y=None, device=None):
    """Row-major ELL SpMV (aoclsparse_?ellmv, ellmv.hpp:35-89): ell_val and
    ell_col_ind are (m, ell_width), column -1 padding. General, none only."""
    _common_checks(descr, op, m, n, x, general_only=True)
    if ell_val is None or ell_col_ind is None:
        raise AoclSparseError(Status.invalid_pointer, "null ELL array")
    dev = _device(x, device)
    ind = _idx(ell_col_ind, dev, descr.base).reshape(m, ell_width)
    ind = torch.where(ind < 0, torch.full_like(ind, -1), ind)  # the one-based sentinel -2 is -1 again
    val = _tensor(ell_val, dev).reshape(m, ell_width)
    xs = _x(x, dev, n)
    return _epilogue(spmv_ell(ind, val, xs), alpha, beta, y, m, torch.promote_types(val.dtype, xs.dtype), dev)


def elltmv(op, alpha, m, n, nnz, ell_val, ell_col_ind, ell_width, descr, x, beta, y=None, device=None):
    """Slot-major ("transposed") ELL SpMV (aoclsparse_?elltmv,
    ellmv.hpp:318-361): entry (slot p, row i) at p*m + i. Padding carries
    value 0 with a valid column, as the reference's csr2ellt writes it; a
    negative column reads as column 0."""
    _common_checks(descr, op, m, n, x, general_only=True)
    if ell_val is None or ell_col_ind is None:
        raise AoclSparseError(Status.invalid_pointer, "null ELL array")
    dev = _device(x, device)
    ind = _idx(ell_col_ind, dev, descr.base).reshape(ell_width, m).clamp(min=0)
    val = _tensor(ell_val, dev).reshape(ell_width, m)
    xs = _x(x, dev, n)
    ax = spmv_ell(ind.T.contiguous(), val.T.contiguous(), xs)
    return _epilogue(ax, alpha, beta, y, m, torch.promote_types(val.dtype, xs.dtype), dev)


def ellthybmv(op, alpha, m, n, nnz, ell_val, ell_col_ind, ell_width, ell_m, csr_val, csr_row_ind,
              csr_col_ind, row_idx_map, csr_row_idx_map, descr, x, beta, y=None, device=None):
    """Hybrid ELLT + CSR SpMV (aoclsparse_?ellthybmv, ellmv.hpp:555-700):
    the ELLT part over all m rows, then the rows of `csr_row_idx_map`
    recomputed from the full CSR arrays replace theirs, as the reference
    saves and restores y around its CSR pass."""
    op, _mt = _common_checks(descr, op, m, n, x, general_only=True)
    if ell_m == m:
        return elltmv(op, alpha, m, n, nnz, ell_val, ell_col_ind, ell_width, descr, x, beta, y, device)
    if csr_val is None or csr_row_ind is None or csr_col_ind is None or csr_row_idx_map is None:
        raise AoclSparseError(Status.invalid_pointer, "null hybrid CSR array")
    dev = _device(x, device)
    xs = _x(x, dev, n)
    dtype = torch.promote_types(_tensor(ell_val, dev).dtype, xs.dtype)
    ax = elltmv(op, 1.0, m, n, nnz, ell_val, ell_col_ind, ell_width, descr, xs, 0.0, device=dev)
    heavy = host_array(csr_row_idx_map).astype(np.int64)
    ptr = host_array(csr_row_ind).astype(np.int64)
    one = 1 if IndexBase(descr.base) == IndexBase.one else 0
    cind = host_array(csr_col_ind).astype(np.int64) - one
    cval = _tensor(csr_val, dev)
    starts, ends = ptr[heavy] - one, ptr[heavy + 1] - one
    counts = ends - starts
    firsts = np.concatenate([[0], np.cumsum(counts)])
    take = np.repeat(starts, counts) + (np.arange(int(firsts[-1])) - np.repeat(firsts[:-1], counts))
    seg = np.repeat(np.arange(heavy.size, dtype=np.int64), counts)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    hvals = _segsum(cval[t(take)] * xs[t(cind[take])], t(seg), heavy.size)
    ax = ax.clone()
    ax[t(heavy)] = hvals.to(ax.dtype)
    return _epilogue(ax, alpha, beta, y, m, dtype, dev)


def diamv(op, alpha, m, n, nnz, dia_val, dia_offset, dia_num_diag, descr, x, beta, y=None, device=None):
    """DIA SpMV (aoclsparse_?diamv, diamv.hpp:72+): dia_val (ndiag, m), the
    offsets in dia_offset (negative below the main diagonal). General, none
    only."""
    _common_checks(descr, op, m, n, x, general_only=True)
    if dia_val is None or dia_offset is None:
        raise AoclSparseError(Status.invalid_pointer, "null DIA array")
    offs = host_array(dia_offset).reshape(-1)
    if offs.shape[0] != dia_num_diag:
        raise AoclSparseError(Status.invalid_size, "dia_offset length != dia_num_diag")
    dev = _device(x, device)
    val = _tensor(dia_val, dev).reshape(dia_num_diag, m)
    xs = _x(x, dev, n)
    ax = spmv_dia(offs, val, xs, m, n)
    return _epilogue(ax, alpha, beta, y, m, torch.promote_types(val.dtype, xs.dtype), dev)


def bsrmv(op, alpha, mb, nb, bsr_dim, bsr_val, bsr_col_ind, bsr_row_ptr, descr, x, beta, y=None, device=None):
    """BSR SpMV (aoclsparse_?bsrmv, bsrmv.cpp): bsr_val (nnzb, bs, bs)
    blocks; y has mb * bsr_dim rows. An x of n entries with n not a block
    multiple is zero-padded. General, none only."""
    _common_checks(descr, op, mb, nb, x, general_only=True)
    if bsr_val is None or bsr_col_ind is None or bsr_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null BSR array")
    if bsr_dim <= 0:
        raise AoclSparseError(Status.invalid_size, "bsr_dim must be positive")
    ptr = host_array(bsr_row_ptr).astype(np.int64)
    if ptr.shape[0] != mb + 1:
        raise AoclSparseError(Status.invalid_size, "bsr_row_ptr must have mb+1 entries")
    dev = _device(x, device)
    ind = _idx(bsr_col_ind, dev, descr.base)
    val = _tensor(bsr_val, dev).reshape(-1, bsr_dim, bsr_dim)
    xs = _x(x, dev, nb * bsr_dim - (bsr_dim - 1))
    brow = torch.from_numpy(np.repeat(np.arange(mb, dtype=np.int64), np.diff(ptr))).to(dev)
    ax = spmv_bsr(brow, ind, val, xs[: nb * bsr_dim], mb, bsr_dim)
    return _epilogue(ax, alpha, beta, y, mb * bsr_dim, torch.promote_types(val.dtype, xs.dtype), dev)


def blkcsrmv(op, alpha, m, n, nnz, masks, blk_csr_val, blk_col_ind, blk_row_ptr, descr, x, beta, y=None,
             nRowsblk: int = 4, device=None):
    """Masked-block CSR SpMV (aoclsparse_?blkcsrmv, blkcsrmv.cpp:35+) over
    csr2blkcsr's layout: nRowsblk x 8 blocks, per-subrow uint8 column
    masks, values subrow after subrow in mask-bit order. The masks are
    decoded on the host back to (row, column) pairs and the product is the
    gather form's."""
    _common_checks(descr, op, m, n, x, general_only=True)
    if masks is None or blk_csr_val is None or blk_col_ind is None or blk_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null blkcsr array")
    if nRowsblk not in (1, 2, 4):
        raise AoclSparseError(Status.invalid_size, "nRowsblk must be 1, 2 or 4")
    masks = host_array(masks).astype(np.uint8)
    bptr = host_array(blk_row_ptr).astype(np.int64)
    bcol = host_array(blk_col_ind).astype(np.int64) - (1 if IndexBase(descr.base) == IndexBase.one else 0)
    total_blks = int(bptr[-1]) - int(bptr[0])
    if masks.shape[0] != total_blks * nRowsblk:
        raise AoclSparseError(Status.invalid_size, "masks length != total_blks * nRowsblk")
    bits = np.unpackbits(masks[:, None], axis=1, bitorder="little")  # bit k = column offset k
    nvals = int(bits.sum())
    dev = _device(x, device)
    val = _tensor(blk_csr_val, dev)
    if val.shape[0] < nvals:
        raise AoclSparseError(Status.invalid_size, "blk_csr_val shorter than mask population")
    sub, coloff = np.nonzero(bits)  # (block, subrow)-major, bit order: the value order
    blk_of, sub_of = sub // nRowsblk, sub % nRowsblk
    # every subrow of a row group shares the group's running block offset
    grp = np.searchsorted(bptr[::nRowsblk] - bptr[0], blk_of, side="right") - 1
    rows = grp * nRowsblk + sub_of
    cols = bcol[blk_of] + coloff
    order = np.argsort(rows, kind="stable")
    xs = _x(x, dev, n)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ax = spmv_segsum(t(cols[order]), val[:nvals][t(order)], t(rows[order]), xs, m)
    return _epilogue(ax, alpha, beta, y, m, torch.promote_types(val.dtype, xs.dtype), dev)
