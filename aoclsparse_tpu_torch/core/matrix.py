"""SparseMatrix handle: creation, export, copy, value updates, hints.

PyTorch counterpart of ``aoclsparse_tpu/core/matrix.py`` (the analog of
`_aoclsparse_matrix`, aoclsparse_mat_structures.hpp:747-783, and the
create/auxiliary API, src/extra/aoclsparse_auxiliary.cpp:366-1014).

- The data is a format dataclass of tensors on one device (core/formats.py:
  CSR, CSC, COO, BSR, TCSR, ELL, DIA); the handle is a thin mutable object
  that owns the hint list and the cached Plan. Every create_* takes the
  `device=` of create_csr (default cuda:0).
- Index-base conversion to zero-base happens at creation; `export_*`
  restores the requested base.
- Values may be lazy (core/matrix.py:97-127 of the JAX package): a SpGEMM
  product computed on the band engine keeps its CSR values as a pending
  extraction (`set_lazy_values`), since chained `mv` runs straight on the
  seeded device band. Reading ``.data`` materializes them first, so every
  consumer stays correct; shape, nnz, dtype and device answer from the
  pending structure without the extraction gather.
- `destroy` drops the handle's references; provided for API parity.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .context import resolve_device
from .descr import GENERAL, MatrixDescriptor
from .formats import BSR, COO, CSC, CSR, DIA, ELL, TCSR, nnz_of
from .types import (
    AoclSparseError,
    FormatType,
    IndexBase,
    MatrixSort,
    MemoryPolicy,
    Operation,
    Status,
    check_value_dtype,
    to_torch_dtype,
)
from .validate import check_csr_arrays, check_sizes, host_array, require

__all__ = [
    "Hint",
    "SparseMatrix",
    "as_values",
    "create_bsr",
    "create_coo",
    "create_csc",
    "create_csr",
    "create_dia",
    "create_ell",
    "create_tcsr",
    "copy",
    "destroy",
    "export_coo",
    "export_csc",
    "export_csr",
    "order_mat",
    "set_value",
    "update_values",
]


@dataclasses.dataclass
class Hint:
    """One registered optimization hint (analog of aoclsparse_optimize_data,
    aoclsparse_mat_structures.hpp:54-81)."""

    action: str  # "mv" | "sv" | "mm" | "2m" | "dotmv" | ...
    trans: Operation = Operation.none
    descr: MatrixDescriptor = GENERAL
    kid: Optional[int] = None
    nop: int = 1
    done: bool = False


class SparseMatrix:
    """Mutable handle around an immutable CSR of tensors."""

    def __init__(self, data, input_format: FormatType, base: IndexBase = IndexBase.zero):
        self._lazy = None  # (ptr, ind, shape, dtype, thunk) | None
        self.data = data  # zero-based
        self.input_format = FormatType(input_format)
        self.base = IndexBase(base)
        self.hints: List[Hint] = []
        self.sort = MatrixSort.unknown
        self.fulldiag: Optional[bool] = None
        self.plan = None  # planner.Plan once optimize() ran
        self.ilu_state = None  # solvers.ilu0 factorization cache
        #: precision policy opt-in ("full" | "mixed"); see docs/precision.md
        #: and set_precision_mode (ops consult it via _mixed_enabled)
        self.precision_mode = "full"
        #: set_memory_hint: "restricted" keeps mm on the gather form
        self.mem_policy = MemoryPolicy.unrestricted

    # -- lazy-values protocol --------------------------------------------
    @property
    def data(self) -> CSR:
        if self._lazy is not None:
            ptr, ind, shape, _dtype, thunk = self._lazy
            self._lazy = None
            self._data = CSR(ptr, ind, thunk(), shape=shape)
            # the seeded band form was made together with the thunk: seat
            # its staleness key now that a concrete value tensor exists
            if getattr(self, "_seed_bwdg", None) is not None and getattr(self, "_seed_bwdg_val", None) is None:
                self._seed_bwdg_val = self._data.val
        return self._data

    @data.setter
    def data(self, v: Optional[CSR]) -> None:
        self._lazy = None
        self._data = v

    def set_lazy_values(self, ptr: torch.Tensor, ind: torch.Tensor, shape, dtype, thunk) -> None:
        """Install a pending value extraction: the structure (device ptr and
        ind tensors) is final, the values materialize on the first read of
        ``.data`` (kernels/spgemm_band.py)."""
        self._data = None
        self._lazy = (ptr, ind, tuple(shape), dtype, thunk)

    @property
    def values_pending(self) -> bool:
        return self._lazy is not None

    def invalidate(self) -> None:
        """Drop the cached plan and factorization after a structural change."""
        self.plan = None
        self.ilu_state = None

    # -- passthroughs, answered from the pending structure when lazy ------
    @property
    def shape(self) -> Tuple[int, int]:
        if self._lazy is not None:
            return self._lazy[2]
        return self._data.shape

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        if self._lazy is not None:
            return int(self._lazy[1].shape[0])
        return nnz_of(self._data)

    @property
    def dtype(self) -> torch.dtype:
        if self._lazy is not None:
            return self._lazy[3]
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        if self._lazy is not None:
            return self._lazy[1].device
        return self._data.device

    def add_hint(self, hint: Hint) -> None:
        self.hints.insert(0, hint)  # reference prepends (csr_util.cpp:47)

    def __repr__(self):
        return (
            f"SparseMatrix({self.input_format.name}, shape={self.shape}, "
            f"nnz={self.nnz}, dtype={self.dtype}, device={self.device}, "
            f"plan={'yes' if self.plan else 'no'})"
        )


def as_values(values, device: torch.device) -> torch.Tensor:
    """A value array as a tensor on `device`. A tensor already there is
    used as it is (torch's no-hidden-copy idiom: change a handle's values
    through update_values); host arrays are copied. Dtypes outside the
    supported set raise wrong_type."""
    if isinstance(values, torch.Tensor):
        check_value_dtype(values.dtype)
        return values.to(device)
    arr = np.asarray(values)
    dt = check_value_dtype(arr.dtype)
    if dt == torch.bfloat16:  # numpy has no bf16 buffer torch can read
        return torch.tensor(arr.astype(np.float32), device=device).to(dt)
    return torch.tensor(np.ascontiguousarray(arr), device=device)


def _index_tensor(arr, base: IndexBase, device: torch.device) -> torch.Tensor:
    a = host_array(arr)
    if not np.issubdtype(a.dtype, np.integer):
        raise AoclSparseError(Status.wrong_type, f"index array has dtype {a.dtype}")
    if int(base) != 0:
        a = a - int(base)
    if a.dtype not in (np.int32, np.int64):
        a = a.astype(np.int32)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def create_csr(
    m, n, ptr, ind, val, base: IndexBase = IndexBase.zero, device=None
) -> SparseMatrix:
    """CSR handle on `device` (default cuda:0; CPU only when named)."""
    dev = resolve_device(device)
    for v in (ptr, ind, val):
        require(v is not None, Status.invalid_pointer, "null csr array")
    vals = as_values(val, dev)
    srt, full = check_csr_arrays(m, n, ptr, ind, vals, base)
    A = CSR(
        _index_tensor(ptr, base, dev),
        _index_tensor(ind, base, dev),
        vals,
        shape=(int(m), int(n)),
    )
    h = SparseMatrix(A, FormatType.csr, base)
    h.sort = MatrixSort.fully_sorted if srt else MatrixSort.unsorted
    h.fulldiag = full
    return h


def create_csc(m, n, ptr, ind, val, base: IndexBase = IndexBase.zero, device=None) -> SparseMatrix:
    """CSC handle: the column-compressed arrays, checked as the CSR of the
    (n, m) transpose (aoclsparse_create_?csc)."""
    dev = resolve_device(device)
    for v in (ptr, ind, val):
        require(v is not None, Status.invalid_pointer, "null csc array")
    vals = as_values(val, dev)
    srt, _full = check_csr_arrays(n, m, ptr, ind, vals, base)
    A = CSC(_index_tensor(ptr, base, dev), _index_tensor(ind, base, dev), vals, shape=(int(m), int(n)))
    h = SparseMatrix(A, FormatType.csc, base)
    h.sort = MatrixSort.fully_sorted if srt else MatrixSort.unsorted
    return h


def create_coo(m, n, row, col, val, base: IndexBase = IndexBase.zero, device=None) -> SparseMatrix:
    """COO handle (aoclsparse_create_?coo): rows and columns in range of
    the base."""
    dev = resolve_device(device)
    for v in (row, col, val):
        require(v is not None, Status.invalid_pointer, "null coo array")
    vals = as_values(val, dev)
    r, c = host_array(row), host_array(col)
    check_sizes(m, n, int(vals.shape[0]))
    require(r.shape == c.shape == tuple(vals.shape[:1]), Status.invalid_size, "coo array mismatch")
    b = int(base)
    if r.size:
        require(bool(r.min() >= b and r.max() < m + b), Status.invalid_index_value, "row range")
        require(bool(c.min() >= b and c.max() < n + b), Status.invalid_index_value, "col range")
    A = COO(_index_tensor(r, base, dev), _index_tensor(c, base, dev), vals, shape=(int(m), int(n)))
    return SparseMatrix(A, FormatType.coo, base)


def create_bsr(mb, nb, block_dim, ptr, ind, val, base: IndexBase = IndexBase.zero, device=None) -> SparseMatrix:
    """BSR handle of (block_dim, block_dim) row-major blocks
    (aoclsparse_create_?bsr); the element shape is (mb, nb) * block_dim."""
    dev = resolve_device(device)
    vals = as_values(val, dev)
    require(block_dim > 0, Status.invalid_size, "block_dim must be > 0")
    p = host_array(ptr) - int(base)
    nnzb = int(p[-1])
    require(vals.numel() == nnzb * block_dim * block_dim, Status.invalid_size, "bsr val size")
    A = BSR(
        _index_tensor(ptr, base, dev),
        _index_tensor(ind, base, dev),
        vals.reshape(nnzb, block_dim, block_dim),
        block_dim=int(block_dim),
        shape=(int(mb * block_dim), int(nb * block_dim)),
    )
    return SparseMatrix(A, FormatType.bsr, base)


def create_tcsr(m, n, nnz, ptr_L, ptr_U, ind_L, ind_U, val_L, val_U, base: IndexBase = IndexBase.zero,
                device=None) -> SparseMatrix:
    """Triangular-CSR handle (aoclsparse_create_?tcsr,
    include/aoclsparse_auxiliary.h:516-598). Per row, the L part holds the
    strictly-lower entries then the diagonal LAST, the U part the diagonal
    FIRST then the strictly-upper entries. Square with a full diagonal;
    entries in the wrong part give unsorted_input, a missing or duplicated
    diagonal invalid_value, as the reference's status table says."""
    for v in (ptr_L, ptr_U, ind_L, ind_U, val_L, val_U):
        require(v is not None, Status.invalid_pointer, "null tcsr array")
    dev = resolve_device(device)
    vL, vU = as_values(val_L, dev), as_values(val_U, dev)
    require(vL.dtype == vU.dtype, Status.wrong_type, "val_L/val_U dtype mismatch")
    m, n = int(m), int(n)
    require(m == n, Status.invalid_size, "TCSR supports square matrices only")
    check_sizes(m, n, int(nnz))
    b = int(base)
    pL, pU = host_array(ptr_L).astype(np.int64) - b, host_array(ptr_U).astype(np.int64) - b
    iL, iU = host_array(ind_L).astype(np.int64) - b, host_array(ind_U).astype(np.int64) - b
    for p, i, v, nm in ((pL, iL, vL, "L"), (pU, iU, vU, "U")):
        require(p.shape == (m + 1,), Status.invalid_size, f"ptr_{nm} must be (m+1,)")
        require(p[0] == 0, Status.invalid_value, f"ptr_{nm}[0] must equal base")
        require(bool(np.all(np.diff(p) >= 0)), Status.invalid_value, f"ptr_{nm} non-decreasing")
        require(int(p[-1]) == i.shape[0], Status.invalid_size, f"ptr_{nm}[-1] != len(ind_{nm})")
        require(i.shape[0] == v.shape[0], Status.invalid_size, f"ind_{nm}/val_{nm} mismatch")
        if i.size:
            require(bool(i.min() >= 0 and i.max() < n), Status.invalid_index_value, f"ind_{nm} out of range")
    require(int(pL[-1]) + int(pU[-1]) - m == int(nnz), Status.invalid_size, "nnz != nnz(L+D) + nnz(D+U) - m")
    rows_L = np.repeat(np.arange(m, dtype=np.int64), np.diff(pL))
    rows_U = np.repeat(np.arange(m, dtype=np.int64), np.diff(pU))
    require(bool(np.all(iL <= rows_L)), Status.unsorted_input, "U element in the L part")
    require(bool(np.all(iU >= rows_U)), Status.unsorted_input, "L element in the U part")
    require(bool(np.all(np.diff(pL) >= 1)), Status.invalid_value, "missing diagonal in L")
    require(bool(np.all(np.diff(pU) >= 1)), Status.invalid_value, "missing diagonal in U")
    require(bool(np.all(iL[pL[1:] - 1] == np.arange(m))), Status.unsorted_input,
            "diagonal must be the last entry of each L row segment")
    require(bool(np.all(iU[pU[:-1]] == np.arange(m))), Status.unsorted_input,
            "diagonal must be the first entry of each U row segment")
    ndiag_L = np.bincount(rows_L[iL == rows_L], minlength=m)
    ndiag_U = np.bincount(rows_U[iU == rows_U], minlength=m)
    require(bool(np.all(ndiag_L == 1) and np.all(ndiag_U == 1)), Status.invalid_value, "duplicate diagonal entries")

    def idx(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    A = TCSR(idx(pL), idx(iL), vL, idx(pU), idx(iU), vU, shape=(m, n))
    h = SparseMatrix(A, FormatType.tcsr, base)
    h.fulldiag = True
    return h


def create_ell(m, n, width, ind, val, base: IndexBase = IndexBase.zero, device=None) -> SparseMatrix:
    """ELL handle (m, width) with -1 padding (aoclsparse_create_?ell)."""
    dev = resolve_device(device)
    vals = as_values(val, dev).reshape(m, width)
    i = host_array(ind).reshape(m, width)
    if int(base) != 0:
        i = np.where(i >= 0, i - int(base), -1)
    A = ELL(torch.from_numpy(np.ascontiguousarray(i, dtype=np.int32)).to(dev), vals, width=int(width),
            shape=(int(m), int(n)))
    return SparseMatrix(A, FormatType.ell, base)


def create_dia(m, n, dist, val, base: IndexBase = IndexBase.zero, device=None) -> SparseMatrix:
    """DIA handle: offsets `dist` (ndiag,) and values (ndiag, m)
    (aoclsparse_create_?dia)."""
    dev = resolve_device(device)
    d = host_array(dist).reshape(-1)
    vals = as_values(val, dev).reshape(d.shape[0], m)
    A = DIA(torch.from_numpy(np.ascontiguousarray(d, dtype=np.int32)).to(dev), vals, shape=(int(m), int(n)))
    return SparseMatrix(A, FormatType.dia, base)


def _require_handle(h) -> None:
    """Reference contract: every handle-taking entry point returns
    invalid_pointer on a null matrix (e.g. auxiliary.cpp:840)."""
    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")


def _to_csr_data(h: SparseMatrix) -> CSR:
    """The handle's data as CSR, converted from its format when needed."""
    _require_handle(h)
    from ..convert import conversions as cv

    return cv.to_csr(h.data)


def _host_values(val: torch.Tensor) -> np.ndarray:
    if val.dtype == torch.bfloat16:
        raise AoclSparseError(Status.wrong_type, "numpy has no bfloat16: export the tensor")
    return host_array(val)


def export_csr(h: SparseMatrix, base: Optional[IndexBase] = None):
    """Return (m, n, nnz, ptr, ind, val) host numpy arrays in the requested
    base (aoclsparse_export_?csr, auxiliary.cpp:552-651)."""
    A = _to_csr_data(h)
    b = int(base if base is not None else h.base)
    ptr = host_array(A.ptr) + b
    ind = host_array(A.ind) + b
    return A.m, A.n, A.nnz, ptr, ind, _host_values(A.val)


def export_csc(h: SparseMatrix, base: Optional[IndexBase] = None):
    """(m, n, nnz, col_ptr, row_ind, val) host arrays in the requested base
    (aoclsparse_export_?csc)."""
    _require_handle(h)
    from ..convert import conversions as cv

    A = cv.to_csc(h.data)
    b = int(base if base is not None else h.base)
    return A.m, A.n, A.nnz, host_array(A.ptr) + b, host_array(A.ind) + b, _host_values(A.val)


def export_coo(h: SparseMatrix, base: Optional[IndexBase] = None):
    """(m, n, nnz, row, col, val) host arrays, row-sorted, in the requested
    base (aoclsparse_export_?coo)."""
    _require_handle(h)
    from ..convert import conversions as cv

    A = cv.to_coo(h.data)
    b = int(base if base is not None else h.base)
    return A.m, A.n, A.nnz, host_array(A.row) + b, host_array(A.col) + b, _host_values(A.val)


def copy(h: SparseMatrix) -> SparseMatrix:
    """An independent handle over the same data (aoclsparse_copy): the data
    is never changed in place, so a later update_values on either handle
    leaves the other as it was."""
    _require_handle(h)
    out = SparseMatrix(h.data, h.input_format, h.base)
    out.sort = h.sort
    out.fulldiag = h.fulldiag
    out.mem_policy = h.mem_policy
    return out


def order_mat(h: SparseMatrix) -> SparseMatrix:
    """Sort the column indices of each row in place (auxiliary.cpp:837).
    Only CSR input is ordered (auxiliary.cpp:846-848): other formats give
    not_implemented."""
    from ..convert import conversions as cv

    _require_handle(h)
    if h.input_format != FormatType.csr:
        raise AoclSparseError(Status.not_implemented, "order_mat supports CSR input only (reference parity)")
    h.data = cv.sort_csr(_to_csr_data(h))
    h.sort = MatrixSort.fully_sorted
    h.invalidate()
    return h


def set_value(h: SparseMatrix, row: int, col: int, value) -> SparseMatrix:
    """Set one stored entry (zero-based row and column); invalid_index_value
    when (row, col) is not in the pattern (auxiliary.cpp:529-548). The
    handle becomes CSR; a cached plan keeps its structure and refreshes its
    values."""
    A = _to_csr_data(h)
    ptr, ind = host_array(A.ptr), host_array(A.ind)
    require(0 <= row < A.m, Status.invalid_index_value, f"row {row} out of range")
    lo, hi = int(ptr[row]), int(ptr[row + 1])
    pos = np.nonzero(ind[lo:hi] == col)[0]
    require(pos.size > 0, Status.invalid_index_value, f"({row},{col}) not in sparsity pattern")
    val = A.val.clone()
    val[lo + int(pos[0])] = value
    h.data = dataclasses.replace(A, val=val)
    h.input_format = FormatType.csr
    h.ilu_state = None
    if h.plan is not None:
        h.plan.refresh_values(h.data)
    return h


def update_values(h: SparseMatrix, values) -> SparseMatrix:
    """Replace all values keeping the pattern (auxiliary.cpp:674-706). The
    cached plan keeps its structure and refreshes every value-derived
    operand (ExecForm.refresh); the ILU0 factors and the triangular solve
    forms are dropped and rebuilt at their next use. On a handle whose
    values are pending (a band-engine SpGEMM product) the old values are
    replaced without being materialized."""
    _require_handle(h)
    if values is None:
        raise AoclSparseError(Status.invalid_pointer, "null values")
    vals = as_values(values, h.device).reshape(-1)
    A = None if h.values_pending else h.data
    if isinstance(A, TCSR):
        # the reference's update_values handles csr and coo only
        # (auxiliary.hpp:217-241, default -> not_implemented)
        raise AoclSparseError(Status.not_implemented, "update_values on TCSR")
    want = h.nnz if A is None or isinstance(A, CSR) else A.val.numel()
    require(vals.shape[0] == want, Status.invalid_size, "update_values length mismatch")
    require(
        to_torch_dtype(vals.dtype) == h.dtype,
        Status.wrong_type,
        f"update_values dtype {vals.dtype} != matrix dtype {h.dtype}",
    )
    if A is None:
        ptr, ind, shape, _dtype, _thunk = h._lazy
        h.data = CSR(ptr, ind, vals, shape=shape)
    else:
        h.data = dataclasses.replace(A, val=vals.reshape(A.val.shape))
    h.ilu_state = None
    if h.plan is not None:
        if isinstance(h.data, DIA):
            h.invalidate()  # a DIA handle's CSR pattern is its nonzero values
        else:
            h.plan.refresh_values(_to_csr_data(h))
    return h


def destroy(h: SparseMatrix) -> None:
    """API-parity release. A null handle is a success no-op, exactly the
    reference (auxiliary.cpp:654-658 `if(A && *A)`)."""
    if h is None:
        return
    h.data = None
    h.plan = None
    h.ilu_state = None
