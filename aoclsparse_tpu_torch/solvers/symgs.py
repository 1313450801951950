"""Symmetric Gauss-Seidel smoother (aoclsparse_?symgs / ?symgs_mv).

PyTorch counterpart of ``aoclsparse_tpu/solvers/symgs.py``. Reference:
symgs_ref (solvers/aoclsparse_symgs.hpp:88-...), two SpMV and two TRSV
steps over the L/D/U splitting:

    1. q = alpha*U_s*x0 ; r = b - q ; (L+D) x1 = r
    2. r = L_s*x1 ; q = b - r ; (U+D) x = q
    3. (fused) y = A x

Triangular descriptors quick-exit to a single TRSV (symgs.hpp:130-149).
With no kid the sweep runs over the planner's cached forms: the strict
triangles' mv forms and the default solves (`default_solver`: the blocked
form's kernel call, or on the card the level kernel where the DAG is
shallow against the chain), the JAX package's `_symgs_fused` without its
jit.
An explicit kid takes the composed mv/trsv calls, the kid passed to both
solves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.descr import MatrixDescriptor
from ..core.matrix import SparseMatrix, as_values
from ..core.types import AoclSparseError, DiagType, FillMode, MatrixType, Operation, Status
from ..core.validate import check_base_match
from ..ops.level2.mv import _run_exec_form, mv
from ..ops.level2.trsv import default_solver, trsv
from ..planner.plan import get_plan
from ..planner.triangular import check_solve_dtype

__all__ = ["lu_view_selection", "symgs", "symgs_mv"]


def _tri(fill, diag) -> MatrixDescriptor:
    return MatrixDescriptor(type=MatrixType.triangular, fill_mode=fill, diag_type=diag)


def lu_view_selection(mtype: MatrixType, descr: MatrixDescriptor, trans: Operation):
    """Which stored triangle feeds the L and U views of the splitting, and
    with which op (symgs.hpp:150-190): (l_fill, l_op, u_fill, u_op)."""
    lower, upper = FillMode.lower, FillMode.upper
    if mtype == MatrixType.general:
        if trans == Operation.none:
            return lower, Operation.none, upper, Operation.none
        return upper, Operation.transpose, lower, Operation.transpose
    if mtype == MatrixType.symmetric:
        if FillMode(descr.fill_mode) == FillMode.lower:
            return lower, Operation.none, lower, Operation.transpose
        return upper, Operation.transpose, upper, Operation.none
    # hermitian
    if FillMode(descr.fill_mode) == FillMode.lower:
        return lower, Operation.none, lower, Operation.conjugate_transpose
    return upper, Operation.conjugate_transpose, upper, Operation.none


def symgs(trans: Operation, A: SparseMatrix, descr: MatrixDescriptor, alpha, b, x0=None,
          kid: Optional[int] = None) -> torch.Tensor:
    """One symmetric GS sweep; returns x (aoclsparse_?symgs)."""
    x, _ = _symgs_core(trans, A, descr, alpha, b, x0, fuse_mv=False, kid=kid)
    return x


def symgs_mv(trans: Operation, A: SparseMatrix, descr: MatrixDescriptor, alpha, b, x0=None,
             kid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused sweep + y = A x (aoclsparse_?symgs_mv); returns (x, y)."""
    return _symgs_core(trans, A, descr, alpha, b, x0, fuse_mv=True, kid=kid)


def _symgs_core(trans, A, descr, alpha, b, x0, fuse_mv, kid):
    if A is None or descr is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to symgs")
    descr.validate()
    check_base_match(A, descr)
    trans = Operation(trans)
    m, n = A.shape
    if m != n:
        raise AoclSparseError(Status.invalid_size, "symgs requires square A")
    if DiagType(descr.diag_type) == DiagType.unit:
        raise AoclSparseError(Status.not_implemented, "unit diagonal unsupported (parity)")
    b = as_values(b, A.device).to(A.dtype)
    if tuple(b.shape) != (m,):
        raise AoclSparseError(Status.invalid_size, f"b must be ({m},)")
    mtype = MatrixType(descr.type)

    # triangular quick exit: a single TRSV (+ the final SpMV), symgs.hpp:130
    if mtype == MatrixType.triangular:
        x = trsv(1.0, A, descr, trans, b, kid=kid)
        return x, (mv(1.0, A, descr, trans, x, 0.0) if fuse_mv else None)
    if mtype == MatrixType.general and trans == Operation.conjugate_transpose:
        raise AoclSparseError(Status.not_implemented, "general + conjugate_transpose unsupported (parity)")
    check_solve_dtype(A.dtype)

    l_fm, l_op, u_fm, u_op = lu_view_selection(mtype, descr, trans)
    tri_l = _tri(l_fm, DiagType.non_unit)  # L + D view
    tri_ls = _tri(l_fm, DiagType.zero)  # strict L
    tri_u = _tri(u_fm, DiagType.non_unit)  # U + D view
    tri_us = _tri(u_fm, DiagType.zero)  # strict U
    x0 = torch.zeros(m, dtype=A.dtype, device=A.device) if x0 is None else as_values(x0, A.device).to(A.dtype)
    if kid is None:
        plan = get_plan(A)
        solve_l = default_solver(plan, tri_l, l_op, A.device)
        solve_u = default_solver(plan, tri_u, u_op, A.device)
        us_form = plan.exec_form_for(tri_us, u_op, dtype=A.dtype)
        ls_form = plan.exec_form_for(tri_ls, l_op, dtype=A.dtype)
        q = alpha * _run_exec_form(us_form, x0, None).to(A.dtype)
        x1 = solve_l(b - q)
        x = solve_u(b - _run_exec_form(ls_form, x1, None).to(A.dtype))
        y = None
        if fuse_mv:
            y = _run_exec_form(plan.exec_form_for(descr, trans, dtype=A.dtype), x, None).to(A.dtype)
        return x, y
    # the composed steps, each call with its own validation
    q = mv(alpha, A, tri_us, u_op, x0, 0.0)
    x1 = trsv(1.0, A, tri_l, l_op, b - q, kid=kid)
    r = mv(1.0, A, tri_ls, l_op, x1.to(A.device), 0.0)
    x = trsv(1.0, A, tri_u, u_op, b - r, kid=kid)
    return x, (mv(1.0, A, descr, trans, x.to(A.device), 0.0) if fuse_mv else None)
