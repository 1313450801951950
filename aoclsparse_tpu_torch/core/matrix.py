"""SparseMatrix handle: creation, export, value updates, hints.

PyTorch counterpart of ``aoclsparse_tpu/core/matrix.py`` for CSR handles
(the analog of `_aoclsparse_matrix`, aoclsparse_mat_structures.hpp:747-783,
and the create/auxiliary API, src/extra/aoclsparse_auxiliary.cpp:366-1014).

- The data is a CSR dataclass of tensors on one device; the handle is a
  thin mutable object that owns the hint list and the cached Plan.
- Index-base conversion to zero-base happens at creation; `export_csr`
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
from .formats import CSR
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
from .validate import check_csr_arrays, host_array, require

__all__ = [
    "Hint",
    "SparseMatrix",
    "as_values",
    "create_csr",
    "export_csr",
    "update_values",
    "destroy",
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

    def __init__(self, data: Optional[CSR], input_format: FormatType, base: IndexBase = IndexBase.zero):
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
        return self._data.nnz

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


def _require_handle(h) -> None:
    """Reference contract: every handle-taking entry point returns
    invalid_pointer on a null matrix (e.g. auxiliary.cpp:840)."""
    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")


def export_csr(h: SparseMatrix, base: Optional[IndexBase] = None):
    """Return (m, n, nnz, ptr, ind, val) host numpy arrays in the requested
    base (aoclsparse_export_?csr, auxiliary.cpp:552-651)."""
    _require_handle(h)
    A = h.data
    b = int(base if base is not None else h.base)
    ptr = host_array(A.ptr) + b
    ind = host_array(A.ind) + b
    if A.val.dtype == torch.bfloat16:
        raise AoclSparseError(Status.wrong_type, "numpy has no bfloat16: export the tensor")
    return A.m, A.n, A.nnz, ptr, ind, host_array(A.val)


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
    require(vals.shape[0] == h.nnz, Status.invalid_size, "update_values length mismatch")
    require(
        to_torch_dtype(vals.dtype) == h.dtype,
        Status.wrong_type,
        f"update_values dtype {vals.dtype} != matrix dtype {h.dtype}",
    )
    if h.values_pending:
        ptr, ind, shape, _dtype, _thunk = h._lazy
        h.data = CSR(ptr, ind, vals, shape=shape)
    else:
        h.data = dataclasses.replace(h.data, val=vals)
    h.ilu_state = None
    if h.plan is not None:
        h.plan.refresh_values(h.data)
    return h


def destroy(h: SparseMatrix) -> None:
    """API-parity release. A null handle is a success no-op, exactly the
    reference (auxiliary.cpp:654-658 `if(A && *A)`)."""
    if h is None:
        return
    h.data = None
    h.plan = None
    h.ilu_state = None
