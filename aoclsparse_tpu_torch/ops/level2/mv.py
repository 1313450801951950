"""Level-2 SpMV: ``mv`` (aoclsparse_?mv) and the fused ``dotmv``.

PyTorch counterpart of ``aoclsparse_tpu/ops/level2/mv.py``. Reference:
entry/validation at level2/aoclsparse_mv.cpp:39-382 (null/size/base checks,
empty-matrix beta-scale quick exit, DOID copy lookup, format switch) and
the fused dotmv template (level2/aoclsparse_dotmv.hpp:32).

The (descr, op) pair resolves through the planner to an EffectiveCSR copy
and an ExecForm; the registry Oracle picks the kernel row for the form, and
y = alpha*op(A)x + beta*y is applied in the epilogue. This package runs the
`bandt`, `bwd` (KID 5, the group-window kernel), `gen` (general structure,
its spill through the spill-route kernels), `route` (the whole-matrix spill
route), `bwdg` (a SpGEMM product's band, or KID 9), `diag` (KID 6), `sell`
(KID 10), `ell`, `ellhyb` and `segsum` forms (KID 0, the CSR row-gather
kernel, kernels/spmv_csr.py, which the card's default takes for general
structure; like the JAX package's segsum it ignores the mixed-precision
policy); ELL, DIA and BSR handles run their native products (KIDs 1, 4
and 3) on the general, untransposed operation, as the reference's format
switch does (mv.cpp:179), and go through the planner's CSR otherwise.
`mv_operator` keeps a gen operand's iterations in permuted space. A
product whose values are still pending runs on its seeded band without
materializing them. The host engine (KID 11, kernels/host.py) runs when
`kid=11` asks for it, or without a kid where `autotune_mv` pinned it on
an existing plan (`plan._mv_engine`, the JAX package's mv.py:552-560),
and then returns a CPU tensor.
"""

from __future__ import annotations

import os
from numbers import Number
from typing import Optional

import torch

from ...core.descr import MatrixDescriptor
import numpy as np

from ...core.formats import BSR, DIA, ELL
from ...core.matrix import SparseMatrix, as_values
from ...core.types import (
    AoclSparseError,
    MatrixType,
    MemoryPolicy,
    Operation,
    Status,
)
from ...core.validate import check_base_match, check_dtype_compat, host_array
from ...kernels.host import HOST_MV_KID
from ...kernels.registry import registry
from ...planner.plan import get_plan
from ...utils.debug import check_finite

__all__ = ["mv", "dotmv", "mv_operator", "MvOperator"]

#: the execution forms a KID may pin on the planner's CSR (mv.py:497-507 of
#: the JAX package): bsr and dia serve BSR and DIA handles only, and the
#: whole-matrix route is reached through the planner alone
CSR_KINDS = ("segsum", "ell", "ellhyb", "bwd", "diag", "gen", "bandt", "bwdg", "sell")

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


def mixed_env() -> Optional[bool]:
    """The global switch AOCLSPARSE_TPU_MIXED_PRECISION: True for "1" or
    "true", False for any other non-empty value, None when unset or empty
    (the handle's mode decides), as the JAX package reads it
    (ops/level2/mv.py:129-142 there)."""
    env = os.environ.get("AOCLSPARSE_TPU_MIXED_PRECISION")
    if env is None or env == "":
        return None
    return env in ("1", "true")


def _mixed_enabled(form, dtype) -> bool:
    """Precision policy gate (docs/precision.md): bf16-multiply/f32-
    accumulate runs when the handle opted in (set_precision_mode(A,
    "mixed"), copied onto the form by _spmv_core) or the global switch
    forces it; the switch at "0" turns it off even on a "mixed" handle.
    Only f32 operands qualify."""
    if dtype != torch.float32:
        return False
    env = mixed_env()
    return env if env is not None else form.precision_mode == "mixed"


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
        return e.fn(form.ind, form.val, form.row_ids, x, form.m, form.ptr, form.csr_blocks)
    if form.kind == "sell":
        return e.fn(form.ind, form.val, form.row_ids, x, form.m)
    if form.kind == "bwd":
        band = form.band_bf16() if _mixed_enabled(form, x.dtype) else form.bwd_val
        return e.fn(band, x, form.bwd_base8, form.bwd_padL, form.m, form.sp_val, form.sp_ind, form.sp_rows,
                    form.sp_gptr)
    if form.kind == "diag":
        return e.fn(form.dia_val, form.dia_offs, x, form.m, form.dia_L, form.dia_n_pad)
    if form.kind == "host":
        return torch.from_numpy(e.fn(form.host_ptr, form.host_ind, form.host_values(), host_array(x)))
    if form.kind == "gen":
        route = form.spill_route() if _spill_route_on(form, x.device) else None
        return e.fn(form, x, mixed=_mixed_enabled(form, x.dtype), route=route)
    if form.kind == "route":
        return e.fn(form._spill_route, x, form.m)
    if form.kind == "ell":
        return e.fn(form.ell_ind, form.ell_val, x)
    if form.kind == "ellhyb":
        return e.fn(form.ell_ind, form.ell_val, form.sp_ind, form.sp_val, form.sp_rows, x, form.m)
    if form.kind == "bwdg":
        return e.fn(form.bwd_val, x, form.bwd_G, form.bwd_W, form.bwd_rel, form.m, _mixed_enabled(form, x.dtype))
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


def _native_mv(data, x: torch.Tensor, kid: Optional[int]) -> torch.Tensor:
    """An ELL, DIA or BSR handle's own product (the reference's format
    switch, mv.cpp:179; mv.py:472-487 of the JAX package)."""
    if isinstance(data, ELL):
        return registry.select("mv", fmt="ell", kid=kid, device=x.device).fn(data.ind, data.val, x)
    if isinstance(data, DIA):
        return registry.select("mv", fmt="dia", kid=kid, device=x.device).fn(data.dist, data.val, x, data.m, data.n)
    e = registry.select("mv", fmt="bsr", kid=kid, device=x.device)
    brow = torch.repeat_interleave(torch.arange(data.mb, device=x.device), data.ptr.diff(), output_size=data.nnzb)
    return e.fn(brow, data.ind, data.val, x, data.mb, data.block_dim)[: data.m]


def _spmv_core(A: SparseMatrix, descr: MatrixDescriptor, op: Operation, x, kid=None):
    """op(descr(A)) @ x without the alpha/beta epilogue."""
    general_n = MatrixType(descr.type) == MatrixType.general and Operation(op) == Operation.none
    seed = getattr(A, "_seed_bwdg", None)
    if general_n and kid is None and A.plan is None and A.values_pending and seed is not None and (
        A.mem_policy != MemoryPolicy.restricted
    ):
        # a lazy band-engine SpGEMM product (mv.py:455-470 of the JAX
        # package): run straight on its seeded band; reading A.data would
        # pay the CSR extraction this mode exists to skip
        seed.precision_mode = A.precision_mode
        return _run_exec_form(seed, x.contiguous(), None)
    if general_n and isinstance(A.data, (ELL, DIA, BSR)):
        return _native_mv(A.data, x.contiguous(), kid)
    plan = get_plan(A)
    # the restricted memory policy forbids format copies: the gather form
    kind = "segsum" if A.mem_policy == MemoryPolicy.restricted else None
    if kid is not None:
        # an explicit KID pins the kernel, hence its execution format
        # (invalid_kid when unsupported, cntx_dispatcher.hpp:272-364)
        for e in registry.table("mv"):
            if e.kid == kid:
                if e.fmt not in CSR_KINDS:
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


#: numpy dtypes of the host engine
_NP_DTYPES = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
    torch.float16: np.float16,
}


def _mv_host(alpha, A: SparseMatrix, descr: MatrixDescriptor, op: Operation, x, beta, y) -> torch.Tensor:
    """The whole call on the host engine (mv.py:523-607 of the JAX
    package): numpy validation, the CSR product and the epilogue; the
    result is a CPU tensor. Native-format handles keep their own rows
    (invalid_kid), as in the JAX package."""
    descr.validate()
    check_base_match(A, descr)
    op = Operation(op)
    m, n = A.shape
    nx, ny = (n, m) if op == Operation.none else (m, n)
    xh = host_array(x)
    if xh.shape != (nx,):
        raise AoclSparseError(Status.invalid_size, f"x must have shape ({nx},), got {xh.shape}")
    yh = None if y is None else host_array(y)
    if yh is not None and yh.shape != (ny,):
        raise AoclSparseError(Status.invalid_size, f"y must have shape ({ny},), got {yh.shape}")
    if MatrixType(descr.type) in (MatrixType.symmetric, MatrixType.hermitian, MatrixType.triangular) and m != n:
        raise AoclSparseError(Status.invalid_size, f"{descr.type.name} requires square A")
    check_dtype_compat(A.dtype, xh.dtype, "x")
    if A.dtype not in _NP_DTYPES:
        raise AoclSparseError(Status.wrong_type, f"the host engine has no {A.dtype}")
    general_n = MatrixType(descr.type) == MatrixType.general and op == Operation.none
    if general_n and isinstance(A.data, (ELL, DIA, BSR)):
        raise AoclSparseError(Status.invalid_kid, "the host mv engine serves the CSR planner path")
    dtype = np.result_type(_NP_DTYPES[A.dtype], xh.dtype)
    y0 = np.zeros(ny, dtype=dtype) if yh is None else yh.astype(dtype)
    beta_is_zero = _is_zero(beta)
    if A.nnz == 0 or _is_zero(alpha):
        out = np.zeros(ny, dtype=dtype) if beta_is_zero else (alpha * 0) * np.zeros(ny, dtype=dtype) + beta * y0
        return torch.from_numpy(np.asarray(out, dtype=dtype))
    form = get_plan(A).exec_form_for(descr, op, kind="host", dtype=A.dtype)
    e = registry.select("mv", fmt="host", kid=HOST_MV_KID)
    ax = e.fn(form.host_ptr, form.host_ind, form.host_values(), xh.astype(dtype, copy=False))
    if beta_is_zero:
        out = ax if isinstance(alpha, Number) and alpha == 1 else alpha * ax
    else:
        out = alpha * ax + beta * y0
    return torch.from_numpy(np.asarray(out, dtype=dtype))


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
    """y = alpha * op(descr(A)) @ x + beta * y  (aoclsparse_?mv).

    The result lies on A's device, except with ``kid=11``: the host engine
    (kernels/host.py) computes the whole call on the host from host copies
    of x and y and returns a CPU tensor."""
    if A is None or descr is None or x is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to mv")
    if kid == HOST_MV_KID or (kid is None and _host_pinned(A, descr, op)):
        return check_finite("mv", _mv_host(alpha, A, descr, op, x, beta, y))
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
        return check_finite("mv", (alpha * 0) * zeros + beta * y0)
    ax = _spmv_core(A, descr, op, x.to(A.dtype), kid).to(dtype)
    if beta_is_zero:
        return check_finite("mv", ax if isinstance(alpha, Number) and alpha == 1 else alpha * ax)
    return check_finite("mv", alpha * ax + beta * y0)


def _host_pinned(A: SparseMatrix, descr: MatrixDescriptor, op) -> bool:
    """Has autotune_mv pinned the host engine for (descr, op)? Only an
    existing plan is asked: no plan is built and no lazy values are
    materialized to look (mv.py:552-560 of the JAX package); native-format
    handles keep their own products."""
    if A.values_pending or A.plan is None:
        return False
    general_n = MatrixType(descr.type) == MatrixType.general and Operation(op) == Operation.none
    if general_n and isinstance(A.data, (ELL, DIA, BSR)):
        return False
    return A.plan._mv_engine.get((descr.type, descr.fill_mode, descr.diag_type, Operation(op))) == "host"


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
    # the host engine's y is a CPU tensor: the dot follows it there
    xv = (_as_operand(x, A, "x") if ynew.device == A.device else torch.as_tensor(host_array(x))).to(ynew.dtype)
    return ynew, torch.sum(torch.conj_physical(xv) * ynew)

