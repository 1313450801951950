"""Level-3 multi-RHS triangular solve: ``trsm``.

PyTorch counterpart of ``aoclsparse_tpu/ops/level3/trsm.py``. Reference:
aoclsparse_?trsm/_kid (level3/aoclsparse_trsm.{cpp,hpp}), which runs TRSV
column by column across the right-hand sides. Here the planner's blocked
``win`` form solves all columns at once: one launch of the multi-RHS
window-solve kernel (kernels/trsv_win.py `trsm_win`), through the same
`_solve` as trsv.

sv KIDs as for trsv: 0 is the blocked window solve; 1 (level wavefront)
and 2 (the host engine, the JAX package's column-threaded C++ sweep) are
not ported yet and raise ``not_implemented`` (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

from numbers import Number
from typing import Optional

import torch

from ...core.descr import MatrixDescriptor
from ...core.matrix import SparseMatrix
from ...core.types import AoclSparseError, Operation, Order, Status
from ...core.validate import check_dtype_compat
from ..level2.mv import _as_operand
from ..level2.trsv import _solve

__all__ = ["trsm"]


def trsm(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    B,
    order: Order = Order.row,
    kid: Optional[int] = None,
) -> torch.Tensor:
    """X = op(tri(A))^{-1} (alpha * B), B dense (m, k)  (aoclsparse_?trsm).
    With order=Order.column, B is passed as B^T and X returns as X^T."""
    if A is None or descr is None or B is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    B = _as_operand(B, A, "B")
    order = Order(order)
    if order == Order.column:
        B = B.T
    if B.dim() != 2 or B.shape[0] != A.shape[0]:
        raise AoclSparseError(Status.invalid_size, f"B must be ({A.shape[0]}, k), got {tuple(B.shape)}")
    check_dtype_compat(A.dtype, B.dtype, "B")
    dtype = torch.promote_types(A.dtype, B.dtype)
    if isinstance(alpha, Number) and alpha == 1.0:
        rhs = B.to(A.dtype)
    else:
        rhs = (alpha * B.to(dtype)).to(A.dtype)
    X = _solve(A, descr, op, rhs, kid).to(dtype)
    return X.T if order == Order.column else X
