"""SOR preconditioner (aoclsparse_?sorv, solvers/aoclsparse_sorv.{cpp,hpp}).

PyTorch counterpart of ``aoclsparse_tpu/solvers/sorv.py``. One forward
sweep of successive over-relaxation:

    (D + omega*L) x1 = omega*b - (omega*U + (omega-1)*D) x0,
    x0 = alpha*x  (or 0 when alpha == 0)

The reference supports the forward sweep on general matrices and needs a
full nonzero diagonal (aoclsparse_csr_check_full_diag, sorv.hpp:36-79);
backward and symmetric sweeps return not_implemented, here too. The
(D + omega*L) solve is a blocked triangular solve over a copy of the lower
triangle whose off-diagonal values are scaled by omega, a form cached per
omega on the plan (dropped by update_values). The JAX package also runs
complex SOR through that solve; the port's triangular solves take real
f32/f64 only, so complex (and bf16) handles raise not_implemented
(ROADMAP.md queue 1 item 12).
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
from ..planner.plan import _dev_index, build_effective_csr, get_plan
from ..planner.triangular import adaptive_nb, build_trsv_form, check_solve_dtype

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
    omega = float(omega)
    x0 = torch.zeros(m, dtype=A.dtype, device=A.device) if isinstance(alpha, Number) and alpha == 0 else alpha * x

    if plan.levels is None:
        plan.levels = {}
    key = ("sorv", omega)
    form = plan.levels.get(key)
    tri_l = MatrixDescriptor(type=MatrixType.triangular, fill_mode=FillMode.lower)
    if form is None:
        # the diagonal plus omega times the strict lower triangle
        eff = build_effective_csr(plan.clean, tri_l, Operation.none)
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
        is_diag = torch.from_numpy(eff.ind.astype(np.int64) == rows).to(eff.val.device)
        eff.val = torch.where(is_diag, eff.val, omega * eff.val)
        form = build_trsv_form(tri_l, Operation.none, eff, adaptive_nb(m, dtype=A.dtype))
        plan.levels[key] = form
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
    return pad_solve(form, omega * b - (omega * u_x0 + (omega - 1.0) * diag * x0))
