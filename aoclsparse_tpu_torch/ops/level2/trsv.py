"""Level-2 triangular solve: ``trsv``, its strided variant and ``csrsv``.

PyTorch counterpart of ``aoclsparse_tpu/ops/level2/trsv.py``. Reference:
aoclsparse_?trsv/_kid/_strided (level2/aoclsparse_trsv.cpp:46, the DOID x
KID table at :198-290), a sequential substitution vectorized within each
row. Here the planner builds a blocked form (planner/triangular.py) and a
solve is one call of its kernel: the window solve of a ``win`` form, the
chain kernel of a ``dwin`` or ``gather`` form.

Semantics: solve op(tri(A)) x = alpha * b, where tri() takes
descr.fill_mode's triangle of A honoring diag_type; symmetric descriptors
are treated as triangular like the reference (trsv.cpp:141-151).

sv KIDs, as in the JAX package: 0 the blocked solve, 1 the level-scheduled
wavefront (kernels/trsv_level.py, its kernel csrc/trsv_level.cu on the
card), 2 the host sequential substitution (native/), which returns a CPU
tensor, as mv KID 11 does. With no kid, on the card, a triangle whose
blocked form would run the chain kernel (``dwin``, ``gather``) takes the
level kernel where its DAG is shallow against the chain
(planner/triangular.py `sv_engine_for`; `default_solver` gives the same
choice to the smoothers and preconditioners); the CPU's default stays the
blocked form. With no kid, a triangle whose blocked form is refused
(``memory_error``: a padded ELL past the cap) takes the level engine where
its DAG is shallow (nlev <= 4096 and its runs pad to at most 16 * nnz), as
in the JAX package (:110-154 there). Past that the JAX package escapes to
its host engine; the port raises ``memory_error`` and names kid=2 instead,
the policy of its mv, which runs the host engine only for an explicit kid
(ROADMAP.md queue 3).
"""

from __future__ import annotations

from numbers import Number
from typing import Callable, Optional

import torch

from ...core.descr import MatrixDescriptor
from ...core.matrix import SparseMatrix
from ...core.types import AoclSparseError, MatrixType, Operation, Status
from ...core.validate import check_base_match, check_dtype_compat
from ...kernels.registry import registry
from ...planner.plan import Plan, get_plan
from ...planner.triangular import (
    LEVEL_MAX_NLEV,
    sv_engine_for,
    trsv_form_for,
    trsv_host_form_for,
    trsv_level_form_for,
    trsv_level_stats_for,
)
from .mv import _as_operand

__all__ = ["trsv", "trsv_strided", "csrsv"]

#: the level engine's reach as the default's fallback: levels
#: (LEVEL_MAX_NLEV, from the planner), and padded run entries per stored
#: nonzero (ops/level2/trsv.py:152 there)
LEVEL_MAX_PAD = 16


def pad_solve(form, r: torch.Tensor) -> torch.Tensor:
    """Apply a TrsvForm to an (m,) or (m, k) rhs, m = form.m: reverse its
    rows for an upper source, pad them to the form's blocks, solve, slice to
    m and reverse back (solvers/fused.py:45-56, ops/level2/trsv.py:175-186)."""
    if form.reversed_:
        r = r.flip(0)
    if form.m_pad != form.m:
        pad = (0, form.m_pad - form.m)
        r = torch.nn.functional.pad(r, pad if r.dim() == 1 else (0, 0) + pad)
    x = form.solve(r)[: form.m]
    return x.flip(0) if form.reversed_ else x


def default_solver(plan: Plan, descr: MatrixDescriptor, op: Operation, device) -> Callable:
    """The default solve of a triangle of `plan` on `device` as a function
    of an (m,) or (m, k) rhs: the level form's where `sv_engine_for` picks
    the level kernel, else the blocked form's (`pad_solve`). The smoothers
    and preconditioners resolve it once and call it every sweep."""
    form = trsv_form_for(plan, descr, op)
    if sv_engine_for(plan, descr, op, device, form=form) == "level":
        return trsv_level_form_for(plan, descr, op).solve
    return lambda r: pad_solve(form, r)


def _solve(A: SparseMatrix, descr: MatrixDescriptor, op: Operation, rhs: torch.Tensor, kid):
    if A is None or descr is None or rhs is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to trsv")
    descr.validate()
    check_base_match(A, descr)
    op = Operation(op)
    m, n = A.shape
    if m != n:
        raise AoclSparseError(Status.invalid_size, "trsv requires square A")
    if MatrixType(descr.type) == MatrixType.general:
        raise AoclSparseError(
            Status.invalid_value, "trsv requires a triangular or symmetric/hermitian descriptor"
        )
    entry = registry.select("sv", kid=kid, device=rhs.device)  # KID validation + engine
    plan = get_plan(A)
    if entry.fmt == "host":
        return trsv_host_form_for(plan, descr, op).solve(rhs)
    if entry.fmt == "level":
        return trsv_level_form_for(plan, descr, op).solve(rhs)
    key = (descr.fill_mode, descr.diag_type, op)
    try:
        if kid is None and key in plan.trsv_refused:
            raise AoclSparseError(Status.memory_error, "blocked form refused (cached)")
        form = trsv_form_for(plan, descr, op)
    except AoclSparseError as e:
        if e.status != Status.memory_error or kid is not None:
            raise
        # a refused blocked form: remember it, and the level statistics,
        # read from the structure before any level form is built
        plan.trsv_refused.add(key)
        if key not in plan.trsv_level_stats:
            plan.trsv_level_stats[key] = trsv_level_stats_for(plan, descr, op)
        nlev, padded = plan.trsv_level_stats[key]
        if nlev <= LEVEL_MAX_NLEV and padded <= LEVEL_MAX_PAD * max(A.nnz, 1):
            return trsv_level_form_for(plan, descr, op).solve(rhs)
        raise AoclSparseError(
            Status.memory_error,
            f"triangle too wide for the blocked forms and too deep or padded for the level engine "
            f"({nlev} levels, {padded} padded entries); call kid=2 (the host engine, which returns a "
            f"CPU tensor) or kid=1",
        ) from None
    if kid is None:
        return default_solver(plan, descr, op, rhs.device)(rhs)
    return pad_solve(form, rhs)


def trsv(alpha, A: SparseMatrix, descr: MatrixDescriptor, op: Operation, b, kid: Optional[int] = None):
    """x = op(tri(A))^{-1} (alpha * b)  (aoclsparse_?trsv)."""
    if A is None or descr is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    b = _as_operand(b, A, "b")
    if b.dim() != 1 or b.shape[0] != A.shape[0]:
        raise AoclSparseError(
            Status.invalid_size, f"b must be ({A.shape[0]},), got {tuple(b.shape)}"
        )
    check_dtype_compat(A.dtype, b.dtype, "b")
    dtype = torch.promote_types(A.dtype, b.dtype)
    # alpha == 1 is the case of every solver inner loop: skip the scale
    if isinstance(alpha, Number) and alpha == 1.0:
        rhs = b.to(A.dtype)
    else:
        rhs = (alpha * b.to(dtype)).to(A.dtype)
    return _solve(A, descr, op, rhs, kid).to(dtype)


def csrsv(alpha, A, descr, op, b, kid=None):
    """Deprecated alias of trsv (the reference deprecates aoclsparse_?csrsv
    in favor of ?trsv, include/aoclsparse_functions.h:1203)."""
    return trsv(alpha, A, descr, op, b, kid=kid)


def trsv_strided(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    b,
    incb: int,
    incx: int = 1,
    x_out=None,
    kid: Optional[int] = None,
):
    """Strided-rhs variant (aoclsparse_?trsv_strided): reads b[i*incb] and
    returns x embedded at stride incx, in a copy of x_out when given."""
    if incb <= 0 or incx <= 0:
        raise AoclSparseError(Status.invalid_size, "strides must be positive")
    if A is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    b = _as_operand(b, A, "b")
    m = A.shape[0]
    if b.shape[0] < (m - 1) * incb + 1:
        raise AoclSparseError(Status.invalid_size, "b too small for stride")
    x = trsv(alpha, A, descr, op, b[: (m - 1) * incb + 1 : incb], kid=kid)
    if x_out is None:
        out = torch.zeros((m - 1) * incx + 1, dtype=x.dtype, device=x.device)
    else:
        out = _as_operand(x_out, A, "x_out").to(x.dtype).clone()
    out[: (m - 1) * incx + 1 : incx] = x
    return out
