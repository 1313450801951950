"""SOR preconditioner (aoclsparse_?sorv, solvers/aoclsparse_sorv.{cpp,hpp}).

PyTorch counterpart of ``aoclsparse_tpu/solvers/sorv.py``. One forward
sweep of successive over-relaxation:

    (D + omega*L) x1 = omega*b - (omega*U + (omega-1)*D) x0,
    x0 = alpha*x  (or 0 when alpha == 0)

The reference supports the forward sweep on general matrices and needs a
full nonzero diagonal (aoclsparse_csr_check_full_diag, sorv.hpp:36-79);
backward and symmetric sweeps return not_implemented, here too. The
(D + omega*L) solve runs over a copy of the lower triangle whose
off-diagonal values are scaled by omega, by the default solve's engine
(planner/triangular.py `sv_engine_for`, as in trsv and symgs): the blocked
form's kernel, or on the card the level kernel where the triangle's DAG is
shallow against the blocked form's chain (the scaled triangle has the lower
triangle's pattern, so its level count). Each form is cached per omega on
the plan (dropped by update_values). Complex handles take complex omega
and alpha, as in the JAX package (:12-14, :75-77 there): the reference
declares csorv/zsorv but stubs them, and both packages run the sweep.
"""

from __future__ import annotations

from numbers import Number

import numpy as np
import torch

from ..core.descr import MatrixDescriptor
from ..core.matrix import SparseMatrix, as_values
from ..core.types import AoclSparseError, DiagType, FillMode, MatrixType, Operation, SorType, Status
from ..core.validate import check_base_match
from ..ops.level2.mv import mv
from ..ops.level2.trsv import pad_solve
from ..planner.plan import Plan, _dev_index, build_effective_csr, get_plan
from ..planner.triangular import adaptive_nb, build_trsv_form, check_solve_dtype, sv_engine_for
from ..utils.debug import check_finite

__all__ = ["sorv"]


def sorv(sor_type: SorType, descr: MatrixDescriptor, A: SparseMatrix, omega, alpha, x, b) -> torch.Tensor:
    """One SOR iteration; returns the updated x (aoclsparse_?sorv)."""
    if A is None or descr is None or x is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to sorv")
    if SorType(sor_type) != SorType.forward:
        raise AoclSparseError(Status.not_implemented, "only forward SOR (parity)")
    if MatrixType(descr.type) != MatrixType.general:
        raise AoclSparseError(Status.not_implemented, "only general matrices (parity)")
    check_base_match(A, descr)
    m, n = A.shape
    if m != n:
        raise AoclSparseError(Status.invalid_size, "sorv requires square A")
    b = as_values(b, A.device).to(A.dtype)
    x = as_values(x, A.device).to(A.dtype)
    if tuple(b.shape) != (m,) or tuple(x.shape) != (m,):
        raise AoclSparseError(Status.invalid_size, "x/b size mismatch")
    plan = get_plan(A)
    if not plan.clean.fulldiag:
        raise AoclSparseError(Status.invalid_value, "sorv requires a full nonzero diagonal")
    check_solve_dtype(A.dtype)
    omega = complex(omega) if A.dtype.is_complex else float(omega)
    x0 = torch.zeros(m, dtype=A.dtype, device=A.device) if isinstance(alpha, Number) and alpha == 0 else alpha * x

    if plan.levels is None:
        plan.levels = {}
    key = ("sorv", omega)
    form = plan.levels.get(key)
    if form is None:
        form = build_trsv_form(_TRI_L, Operation.none, _scaled_lower(plan, omega), adaptive_nb(m, dtype=A.dtype))
        plan.levels[key] = form
    if sv_engine_for(plan, _TRI_L, Operation.none, A.device, form=form) == "level":
        lkey = ("sorv_level", omega)
        lform = plan.levels.get(lkey)
        if lform is None:
            from ..kernels.trsv_level import build_level_form

            eff = _scaled_lower(plan, omega)
            lform = build_level_form(eff.ptr, eff.ind, np.arange(eff.nnz, dtype=np.int64), m, False, False, eff.val)
            plan.levels[lkey] = lform
        solve = lform.solve
    else:
        def solve(r):
            return pad_solve(form, r)

    dkey = ("sorv", "diag")
    diag = plan.levels.get(dkey)
    if diag is None:
        diag = plan.clean.val[_dev_index(plan.clean.idiag, plan.clean.val.device)]
        plan.levels[dkey] = diag

    tri_us = MatrixDescriptor(
        type=MatrixType.triangular,
        fill_mode=FillMode.upper,
        diag_type=DiagType.zero,
        base=A.base,  # the internal mv carries the handle's base
    )
    u_x0 = mv(1.0, A, tri_us, Operation.none, x0, 0.0)
    return check_finite("sorv", solve(omega * b - (omega * u_x0 + (omega - 1.0) * diag * x0)))


_TRI_L = MatrixDescriptor(type=MatrixType.triangular, fill_mode=FillMode.lower)


def _scaled_lower(plan: Plan, omega: float):
    """The effective lower triangle with its off-diagonal values scaled by
    omega: the diagonal plus omega times the strict lower triangle."""
    eff = build_effective_csr(plan.clean, _TRI_L, Operation.none)
    rows = np.repeat(np.arange(eff.m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
    is_diag = torch.from_numpy(eff.ind.astype(np.int64) == rows).to(eff.val.device)
    eff.val = torch.where(is_diag, eff.val, omega * eff.val)
    return eff
