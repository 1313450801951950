"""Level-2 SpMV: ``mv`` (aoclsparse_?mv) and the fused ``dotmv``.

PyTorch counterpart of ``aoclsparse_tpu/ops/level2/mv.py``. Reference:
entry/validation at level2/aoclsparse_mv.cpp:39-382 (null/size/base checks,
empty-matrix beta-scale quick exit, DOID copy lookup, format switch) and
the fused dotmv template (level2/aoclsparse_dotmv.hpp:32).

The (descr, op) pair resolves through the planner to an EffectiveCSR copy
and an ExecForm; the registry Oracle picks the kernel row for the form, and
y = alpha*op(A)x + beta*y is applied in the epilogue. This package runs the
`bandt`, `gen` (general structure, its spill through the spill-route
kernels), `route` (the whole-matrix spill route), `ell`, `ellhyb` and
`segsum` forms; `mv_operator` keeps a gen operand's iterations in permuted
space. The JAX package's ELL/DIA/BSR native-format paths and its host
engine (mv KID 11) are not ported yet (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

from numbers import Number
from typing import Optional

import torch

from ...core.descr import MatrixDescriptor
from ...core.formats import CSR
from ...core.matrix import SparseMatrix, as_values
from ...core.types import (
    AoclSparseError,
    MatrixType,
    MemoryPolicy,
    Operation,
    Status,
)
from ...core.validate import check_base_match, check_dtype_compat
from ...kernels.registry import registry
from ...planner.plan import get_plan

__all__ = ["mv", "dotmv", "mv_operator", "MvOperator"]

#: KID of the JAX package's host mv engine (kernels/host.py), not ported yet
HOST_MV_KID = 11

#: a gen form's spill takes the spill-route engine (select -> Benes route ->
#: accumulate kernels) from this many float32 entries on, on the devices
#: listed: the JAX package's gate (mv.py:77-100), with the card in place of
#: its TPU. Below it, and off the card, the spill is one gather and an
#: index_add_.
SPILL_ROUTE_MIN = 49152
SPILL_ROUTE_DEVICES = ("cuda",)


def _as_operand(v, A: SparseMatrix, what: str) -> torch.Tensor:
    """x/y as a tensor on A's device. Array-likes are copied there; a tensor
    on another device is an error, never a silent copy."""
    if not isinstance(v, torch.Tensor):
        return as_values(v, A.device)
    if v.device != A.device:
        raise AoclSparseError(
            Status.invalid_value, f"{what} is on {v.device} but the matrix on {A.device}"
        )
    return v


def _validate(A: SparseMatrix, descr: MatrixDescriptor, op: Operation, x, y):
    if A is None or descr is None or x is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to mv")
    descr.validate()
    check_base_match(A, descr)
    op = Operation(op)
    m, n = A.shape
    nx, ny = (n, m) if op == Operation.none else (m, n)
    x = _as_operand(x, A, "x")
    if tuple(x.shape) != (nx,):
        raise AoclSparseError(
            Status.invalid_size, f"x must have shape ({nx},), got {tuple(x.shape)}"
        )
    if y is not None:
        y = _as_operand(y, A, "y")
        if tuple(y.shape) != (ny,):
            raise AoclSparseError(
                Status.invalid_size, f"y must have shape ({ny},), got {tuple(y.shape)}"
            )
    if MatrixType(descr.type) in (MatrixType.symmetric, MatrixType.hermitian, MatrixType.triangular):
        if m != n:
            raise AoclSparseError(Status.invalid_size, f"{descr.type.name} requires square A")
    return op, x, y, ny


def _mixed_enabled(form, dtype) -> bool:
    """Precision policy gate (docs/precision.md): bf16-multiply/f32-
    accumulate runs when the handle opted in (set_precision_mode(A,
    "mixed"), copied onto the form by _spmv_core). Only f32 operands
    qualify."""
    return dtype == torch.float32 and form.precision_mode == "mixed"


def _spill_route_on(form, device: torch.device) -> bool:
    """Does this gen form's spill ride the spill-route engine on `device`?"""
    return (
        device.type in SPILL_ROUTE_DEVICES
        and form.sp_ind is not None
        and int(form.sp_ind.shape[0]) >= SPILL_ROUTE_MIN
        and form.sp_val.dtype == torch.float32
    )


def _run_exec_form(form, x: torch.Tensor, kid: Optional[int]) -> torch.Tensor:
    e = registry.select("mv", fmt=form.kind, kid=kid, device=x.device)
    if form.kind == "segsum":
        return e.fn(form.ind, form.val, form.row_ids, x, form.m)
    if form.kind == "gen":
        route = form.spill_route() if _spill_route_on(form, x.device) else None
        return e.fn(form, x, mixed=_mixed_enabled(form, x.dtype), route=route)
    if form.kind == "route":
        return e.fn(form._spill_route, x, form.m)
    if form.kind == "ell":
        return e.fn(form.ell_ind, form.ell_val, x)
    if form.kind == "ellhyb":
        return e.fn(form.ell_ind, form.ell_val, form.sp_ind, form.sp_val, form.sp_rows, x, form.m)
    if form.kind == "bandt":
        if kid is None and x.dtype == torch.float64:
            # a float64 band runs the f64 instance (KID 13), as the JAX
            # package routes f64 band data to its double-float kernel
            e = registry.select("mv", fmt=form.kind, kid=13, device=x.device)
        if e.kid == 13 and x.dtype != torch.float64:
            raise AoclSparseError(
                Status.invalid_kid, f"kid 13 (f64 band) serves float64 operands, got {x.dtype}"
            )
        vt = form.bwd_val
        if e.kid == 12 and _mixed_enabled(form, x.dtype):
            vt = form.band_bf16()
        return e.fn(
            vt,
            x,
            form.sp_val,
            form.sp_ind,
            form.sp_rows,
            start=form.bandt_start,
            padL=form.bwd_padL,
        )
    raise AoclSparseError(Status.internal_error, f"bad exec form {form.kind}")


def _spmv_core(A: SparseMatrix, descr: MatrixDescriptor, op: Operation, x, kid=None):
    """op(descr(A)) @ x without the alpha/beta epilogue."""
    if kid == HOST_MV_KID:
        raise AoclSparseError(
            Status.not_implemented,
            "the host mv engine (kid 11) is not ported yet (ROADMAP.md queue 1 item 10)",
        )
    if not isinstance(A.data, CSR):
        raise AoclSparseError(
            Status.not_implemented,
            "ELL/DIA/BSR mv paths are not ported yet (ROADMAP.md queue 1 item 10)",
        )
    plan = get_plan(A)
    # the restricted memory policy forbids format copies: the gather form
    kind = "segsum" if A.mem_policy == MemoryPolicy.restricted else None
    if kid is not None:
        # an explicit KID pins the kernel, hence its execution format
        # (invalid_kid when unsupported, cntx_dispatcher.hpp:272-364)
        for e in registry.table("mv"):
            if e.kid == kid:
                if e.fmt == "route":
                    # not pinnable in the JAX package either (its mv.py:495-514):
                    # the whole-matrix route is reached through the planner only
                    raise AoclSparseError(Status.invalid_kid, f"kid {kid} serves format '{e.fmt}', not CSR")
                kind = e.fmt
                break
        else:
            raise AoclSparseError(Status.invalid_kid, f"kid {kid} not in table for 'mv'")
    form = plan.exec_form_for(descr, op, kind=kind, dtype=A.dtype)
    # the handle's precision policy travels on the form (read by
    # _mixed_enabled; the fused solvers see whatever the handle last asked)
    form.precision_mode = A.precision_mode
    return _run_exec_form(form, x.contiguous(), kid)


def _is_zero(s) -> bool:
    return isinstance(s, Number) and s == 0


def mv(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    x,
    beta,
    y=None,
    kid: Optional[int] = None,
) -> torch.Tensor:
    """y = alpha * op(descr(A)) @ x + beta * y  (aoclsparse_?mv)."""
    op, x, y, ny = _validate(A, descr, op, x, y)
    check_dtype_compat(A.dtype, x.dtype, "x")
    dtype = torch.promote_types(A.dtype, x.dtype)
    dev = A.device
    # beta == 0 means y is NOT read — the reference overwrites y even when
    # it holds NaN/Inf (csrmv_kr.hpp:54-56), so 0*NaN must not contaminate
    # the result. NaN/Inf beta compares unequal to 0 and takes the full
    # epilogue (IEEE propagation).
    beta_is_zero = _is_zero(beta)
    y0 = None
    if not beta_is_zero:
        y0 = torch.zeros(ny, dtype=dtype, device=dev) if y is None else y.to(dtype)
    # quick exits (mv.cpp:118-123); alpha*0 keeps IEEE propagation of a
    # NaN/Inf alpha
    if A.nnz == 0 or _is_zero(alpha):
        zeros = torch.zeros(ny, dtype=dtype, device=dev)
        if beta_is_zero:
            return zeros
        return (alpha * 0) * zeros + beta * y0
    ax = _spmv_core(A, descr, op, x.to(A.dtype), kid).to(dtype)
    if beta_is_zero:
        return ax if isinstance(alpha, Number) and alpha == 1 else alpha * ax
    return alpha * ax + beta * y0


class MvOperator:
    """Iteration-resident SpMV operator (see mv_operator)."""

    def __init__(self, apply, to_space, from_space, space: str):
        self.apply = apply  # v in the space -> (A v) in the space
        self.to_space = to_space  # original -> iteration space
        self.from_space = from_space  # iteration space -> original
        self.space = space  # "permuted" | "original"

    def __call__(self, v):
        return self.apply(v)


def mv_operator(A: SparseMatrix, descr: Optional[MatrixDescriptor] = None, op: Operation = Operation.none) -> MvOperator:
    """Resident operator for chained y = A x iteration (power methods,
    Krylov loops written by the user), mv.py:671-714 of the JAX package.

    `mv` returns y in the original index space, so a gen operand pays two
    O(m) permutes a call. Here `to_space` permutes once before the loop,
    `apply` iterates without permutes (a symmetric permutation preserves
    norms and maps iterates one to one), and `from_space` permutes back
    once. For every other form the spaces are the identity and `apply` is
    the mv core."""
    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descr = MatrixDescriptor() if descr is None else descr
    op = Operation(op)
    nx = A.shape[1] if op == Operation.none else A.shape[0]
    op, _x, _y, _ny = _validate(A, descr, op, torch.zeros(nx, dtype=A.dtype, device=A.device), None)
    if not isinstance(A.data, CSR):
        raise AoclSparseError(
            Status.not_implemented, "ELL/DIA/BSR mv paths are not ported yet (ROADMAP.md queue 1 item 10)"
        )
    form = get_plan(A).exec_form_for(descr, op, dtype=A.dtype)
    form.precision_mode = A.precision_mode
    if form.kind == "gen" and form.gen_bandt:
        from ...solvers.fused import _gen_pspace

        matvec_p, to_p, from_p = _gen_pspace(form)
        return MvOperator(matvec_p, to_p, from_p, "permuted")
    return MvOperator(
        lambda v: _run_exec_form(form, _as_operand(v, A, "v").contiguous(), None),
        lambda v: _as_operand(v, A, "v"),
        lambda v: v,
        "original",
    )


def dotmv(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    x,
    beta,
    y=None,
    kid: Optional[int] = None,
):
    """Fused y = alpha*op(A)x + beta*y then d = <x, y> (conjugated for complex
    x, matching aoclsparse_dotmv.hpp:32). Returns (y, d)."""
    ynew = mv(alpha, A, descr, op, x, beta, y, kid=kid)
    xv = _as_operand(x, A, "x").to(ynew.dtype)
    return ynew, torch.sum(torch.conj_physical(xv) * ynew)

