"""Input validation, the analog of the reference's per-entry-point checks
(e.g. aoclsparse_mv.cpp:52-109) and of aoclsparse_mat_check_internal
(library/src/analysis/aoclsparse_csr_util.cpp:124).

PyTorch counterpart of ``aoclsparse_tpu/core/validate.py``. Structural
checks run on host numpy copies, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from .types import AoclSparseError, IndexBase, Status, to_torch_dtype

__all__ = [
    "check_base_match",
    "check_csr_arrays",
    "check_dtype_compat",
    "check_sizes",
    "host_array",
    "require",
]


def host_array(a) -> np.ndarray:
    """Host numpy view of an index or value array (tensor or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def check_base_match(A, descr):
    """The descriptor's index base must agree with the matrix handle's
    (reference: aoclsparse_mv.cpp:71-73 — invalid_value on mismatch)."""
    if int(descr.base) != int(A.base):
        raise AoclSparseError(
            Status.invalid_value, "descriptor/matrix index-base mismatch"
        )


def require(cond: bool, status: Status, msg: str = ""):
    if not cond:
        raise AoclSparseError(status, msg)


def check_dtype_compat(mat_dtype, operand_dtype, what: str = "operand"):
    """Reject operand dtypes the matrix compute dtype cannot represent.

    The reference API is typed (s/d/c/z entry points), so a complex operand
    against a real matrix or a double operand against a float matrix is
    impossible there; here it would silently narrow (wrong_type analog). A
    safe up-cast of the operand into mat_dtype remains allowed.
    """
    mat_dtype = to_torch_dtype(mat_dtype)
    operand_dtype = to_torch_dtype(operand_dtype)
    if torch.promote_types(mat_dtype, operand_dtype) != mat_dtype:
        raise AoclSparseError(
            Status.wrong_type,
            f"{what} dtype {operand_dtype} does not fit matrix "
            f"dtype {mat_dtype}: computation would narrow",
        )


def check_sizes(m: int, n: int, nnz: int):
    require(m >= 0 and n >= 0 and nnz >= 0, Status.invalid_size, f"m={m} n={n} nnz={nnz}")


def check_csr_arrays(m, n, ptr, ind, val, base: IndexBase = IndexBase.zero, strict: bool = True):
    """Host-side structural validation of a CSR triple.

    Mirrors aoclsparse_mat_check_internal: ptr monotonicity, bounds of indices,
    base consistency. Returns (sorted, full_diag) flags like check_sort_diag
    (csr_util.cpp:290).
    """
    ptr = host_array(ptr)
    ind = host_array(ind)
    nval = int(val.shape[0]) if val.ndim else 0
    check_sizes(m, n, int(ind.shape[0]))
    require(ptr.ndim == 1 and ptr.shape[0] == m + 1, Status.invalid_size, "ptr must be (m+1,)")
    require(ind.ndim == 1 and ind.shape[0] == nval, Status.invalid_size, "ind/val length mismatch")
    b = int(base)
    require(int(ptr[0]) == b, Status.invalid_value, f"ptr[0] must equal base ({b})")
    d = np.diff(ptr)
    require(bool(np.all(d >= 0)), Status.invalid_value, "ptr must be non-decreasing")
    require(int(ptr[-1]) - b == int(ind.shape[0]), Status.invalid_size, "ptr[-1]-base != nnz")
    if ind.size:
        require(
            bool((ind.min() >= b) and (ind.max() < n + b)),
            Status.invalid_index_value,
            "column index out of range",
        )
    srt = True
    full_diag = True
    if strict and m > 0:
        z = (ind - b).astype(np.int64)
        p = (ptr - b).astype(np.int64)
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(p))
        if z.size > 1:
            # sorted iff strictly increasing within each row
            srt = bool(np.all((z[1:] > z[:-1]) | (rows[1:] != rows[:-1])))
        if z.size:
            ndiag = np.bincount(rows[z == rows], minlength=m)
            full_diag = bool(np.all(ndiag[: min(m, n)] > 0))
        else:
            full_diag = min(m, n) == 0
    return srt, full_diag
