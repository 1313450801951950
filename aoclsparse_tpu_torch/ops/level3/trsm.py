"""Level-3 multi-RHS triangular solve: ``trsm``.

PyTorch counterpart of ``aoclsparse_tpu/ops/level3/trsm.py``. Reference:
aoclsparse_?trsm/_kid (level3/aoclsparse_trsm.{cpp,hpp}), which runs TRSV
column by column across the right-hand sides. Here the planner's blocked
form solves all columns at once, through the same `_solve` as trsv: the
multi-RHS window solve of a ``win`` form (kernels/trsv_win.py `trsm_win`),
one launch of the chain kernel of a ``dwin`` or ``gather`` form
(kernels/trsv_blocked.py).

sv KIDs as for trsv: 0 the blocked solve, 1 the level wavefront (all
columns a level at once), 2 the host engine (the column-threaded C++
sweep, native/ trsm_seq), which returns a CPU tensor.
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
