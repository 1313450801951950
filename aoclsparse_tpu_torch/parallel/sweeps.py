"""Distributed preconditioner sweeps: the ILU0 apply and SymGS over a mesh
(the JAX package's parallel/sweeps.py).

Both compose pieces that already run distributed: the triangular solves
(parallel/trsv.py: the block-row ring pipeline, engine="pipeline", or the
sharded level sweep, engine="level") and the row-sharded padded-ELL SpMV
(parallel/spmv.py), whose row blocks are all-gathered for the next solve.
Real dtypes; general and symmetric descriptors, as the single-process
sweeps. The sharded operands are cached on the matrix's plan and dropped
by update_values (planner/plan.py `refresh_values`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.descr import MatrixDescriptor
from ..core.types import AoclSparseError, DiagType, MatrixType, Operation, Status
from ..utils import collectives as coll
from .placement import Mesh
from .spmv import shard_ell, spmv_ell_runner
from .trsv import _rhs, dist_trsv_levels, dist_trsv_pipeline

__all__ = ["dist_ilu_apply", "dist_symgs", "dist_symgs_chain"]

ENGINES = ("pipeline", "level")


def _tri(fill, diag):
    return MatrixDescriptor(type=MatrixType.triangular, fill_mode=fill, diag_type=diag)


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise AoclSparseError(Status.invalid_value, f"unknown engine '{engine}'")


def _solve(mesh: Mesh, form, rhs, engine: str, axis: str):
    if form is None:
        raise AoclSparseError(Status.invalid_value, "the blocked solve forms were refused: use engine='level'")
    if engine == "level":
        return dist_trsv_levels(mesh, form, rhs, axis=axis)
    return dist_trsv_pipeline(mesh, form, rhs, axis=axis)


def dist_ilu_apply(mesh: Mesh, A, b, axis: str = "x", engine: str = "pipeline"):
    """x = U^-1 L^-1 b over A's cached ILU0 factors. engine="pipeline"
    (default) runs both solves as block-row ring pipelines (banded
    operands); engine="level" as sharded level sweeps (one all_gather a
    level, the shallow-DAG schedule). Returns x replicated."""
    from ..solvers.ilu import _level_forms, ilu0_factorize

    if b is None:
        raise AoclSparseError(Status.invalid_pointer, "null b")
    st = A.ilu_state if getattr(A, "ilu_state", None) is not None else ilu0_factorize(A)
    b = _rhs(b, A.dtype, mesh.device)
    if engine == "level":
        lf, uf = _level_forms(st)
    else:
        _check_engine(engine)
        lf, uf = st.l_form, st.u_form
    m = A.shape[0]
    y = _solve(mesh, lf, b, engine, axis)[:m]
    return _solve(mesh, uf, y, engine, axis)[:m]


def _checks(A, descr: MatrixDescriptor, b, name: str) -> MatrixType:
    if b is None:
        raise AoclSparseError(Status.invalid_pointer, "null b")
    mtype = MatrixType(descr.type)
    if mtype not in (MatrixType.general, MatrixType.symmetric):
        raise AoclSparseError(Status.not_implemented, f"{name}: type {mtype.name}")
    m, n = A.shape
    if m != n:
        raise AoclSparseError(Status.invalid_size, "symgs requires a square matrix")
    if A.dtype.is_complex:
        raise AoclSparseError(Status.not_implemented, f"{name}: real dtypes")
    return mtype


def _sweep_ops(mesh: Mesh, A, descr: MatrixDescriptor, mtype, axis: str, engine: str):
    """(mv_us, mv_ls, form_l, form_u) of a sweep, cached on A's plan: the
    strict triangles' row-sharded ELL SpMVs (full result on every rank)
    and the two solve forms of `engine`."""
    from ..planner.plan import get_plan
    from ..planner.triangular import trsv_form_for, trsv_level_form_for
    from ..solvers.symgs import lu_view_selection

    l_fm, l_op, u_fm, u_op = lu_view_selection(mtype, descr, Operation.none)
    plan = get_plan(A)
    _check_engine(engine)
    key = ("dist_symgs", mtype, descr.fill_mode, axis, mesh.size, mesh.rank, str(mesh.device), engine)
    cache = plan.__dict__.setdefault("_dist_sweep_cache", {})
    epoch, ops = cache.get(key, (None, None))
    if epoch != plan.values_epoch:
        m = A.shape[0]
        run = spmv_ell_runner(mesh, axis)

        def sharded_mv(descr_s, op_s):
            form = plan.exec_form_for(descr_s, op_s, kind="ell", dtype=A.dtype)
            ind_s, val_s, m_pad = shard_ell(mesh, form.ell_ind, form.ell_val, axis=axis)

            def mv(x):
                xp = torch.nn.functional.pad(x, (0, max(0, m_pad - x.shape[0])))
                return coll.all_gather(run(ind_s, val_s, xp).local, mesh)[:m]

            return mv

        form_for = trsv_level_form_for if engine == "level" else trsv_form_for
        ops = (
            sharded_mv(_tri(u_fm, DiagType.zero), u_op),
            sharded_mv(_tri(l_fm, DiagType.zero), l_op),
            form_for(plan, _tri(l_fm, DiagType.non_unit), l_op),
            form_for(plan, _tri(u_fm, DiagType.non_unit), u_op),
        )
        cache[key] = (plan.values_epoch, ops)
    return ops


def _sweep(mesh, ops, b, x0, alpha, engine: str, axis: str, m: int):
    """One sweep (symgs.hpp:88+): (L+D) x1 = b - alpha U_s x0, then
    (U+D) x = b - L_s x1."""
    mv_us, mv_ls, form_l, form_u = ops
    x1 = _solve(mesh, form_l, b - alpha * mv_us(x0), engine, axis)[:m]
    return _solve(mesh, form_u, b - mv_ls(x1), engine, axis)[:m]


def _vectors(mesh, A, b, x0):
    m = A.shape[0]
    b = _rhs(b, A.dtype, mesh.device)
    x0 = torch.zeros(m, dtype=A.dtype, device=mesh.device) if x0 is None else _rhs(x0, A.dtype, mesh.device)
    return b, x0


def dist_symgs(mesh: Mesh, A, descr: MatrixDescriptor, alpha, b, x0=None, axis: str = "x",
               engine: str = "pipeline"):
    """One distributed symmetric Gauss-Seidel sweep (aoclsparse_?symgs,
    symgs.hpp:88+):

        1. q = alpha U_s x0 ; (L+D) x1 = b - q     [SpMV + solve]
        2. r = L_s x1 ;       (U+D) x  = b - r     [SpMV + solve]

    The strict-triangle SpMVs run row-sharded; the solves as block-row ring
    pipelines (engine="pipeline") or sharded level sweeps (engine="level").
    Returns x replicated."""
    mtype = _checks(A, descr, b, "dist_symgs")
    ops = _sweep_ops(mesh, A, descr, mtype, axis, engine)
    b, x0 = _vectors(mesh, A, b, x0)
    return _sweep(mesh, ops, b, x0, float(np.asarray(alpha)), engine, axis, A.shape[0])


def dist_symgs_chain(mesh: Mesh, A, descr: MatrixDescriptor, alpha, b, nsweeps: int, x0=None, axis: str = "x"):
    """nsweeps distributed SymGS sweeps (the pipeline engine) over operands
    sharded and cached once, the sweeps marked as one loop for the
    collective ledger. The JAX package compiles the chain into one program
    to spare host round trips between sweeps; here the sweeps are a Python
    loop over the cached operands, the result of nsweeps dist_symgs calls.
    Returns x replicated."""
    if b is None:
        raise AoclSparseError(Status.invalid_pointer, "null b")
    if not isinstance(nsweeps, int) or nsweeps < 1:
        raise AoclSparseError(Status.invalid_value, "nsweeps must be a positive int")
    mtype = _checks(A, descr, b, "dist_symgs_chain")
    ops = _sweep_ops(mesh, A, descr, mtype, axis, "pipeline")
    b, x = _vectors(mesh, A, b, x0)
    alpha = float(np.asarray(alpha))
    for k in range(nsweeps):
        with coll.loop_body(k):
            x = _sweep(mesh, ops, b, x, alpha, "pipeline", axis, A.shape[0])
    return x
