"""Level-3 SpMM: ``mm``, C = alpha * op(descr(A)) @ B + beta * C.

PyTorch counterpart of ``aoclsparse_tpu/ops/level3/csrmm.py``. Reference:
aoclsparse_?csrmm (level3/aoclsparse_csrmm.cpp:32-46) with row- or
column-major B and C. The (descr, op) pair resolves through the planner to
an effective CSR and an execution form, as for mv; the registry's mm table
picks the kernel for the form (kernels/registry.py).

Without a kid the form is `choose_mm_format`'s (planner/plan.py): the band
SpMM kernel on band operands, the diagonal kernel on few-diagonal ones
(stencils), the gather forms otherwise; `MemoryPolicy.restricted` takes
segsum. `order=Order.column` reads B and C transposed (the caller passes
B^T and C^T) and returns C^T. The mixed precision mode streams bf16 block
windows through KID 5, bf16 diagonals through KID 7 and bf16 groups
through KID 3, accumulating in f32. The AOCLSPARSE_TPU_MIXED_PRECISION
variable decides it when set ("1" on, "0" off), as in the JAX package
(csrmm.py:251-336 there); unset, the handle's mode decides
(`set_precision_mode(A, "mixed")`, docs/precision.md), which the JAX
package's mm does not read (ROADMAP.md queue 3).

Not ported yet: KID 6, the general-sparsity composite (ROADMAP.md queue 1
item 14), and the autotune pin `_mm_tuned` (item 16).
"""

from __future__ import annotations

from numbers import Number
from typing import Optional

import torch

from ...core.descr import MatrixDescriptor
from ...core.matrix import SparseMatrix
from ...core.types import AoclSparseError, MatrixType, Operation, Order, Status
from ...core.validate import check_base_match, check_dtype_compat
from ...kernels.registry import registry
from ...planner.plan import get_plan, mm_kind
from ..level2.mv import _as_operand, _is_zero, mixed_env

__all__ = ["mm"]

#: mm KIDs of the JAX package that the port does not run yet
_UNPORTED_KIDS = {6: "the general-sparsity composite spmm_gen (ROADMAP.md queue 1 item 14)"}


def _mm_core(A: SparseMatrix, descr: MatrixDescriptor, op: Operation, B: torch.Tensor, kid):
    """op(descr(A)) @ B in A's dtype, without the alpha/beta epilogue."""
    if kid in _UNPORTED_KIDS:
        raise AoclSparseError(Status.not_implemented, f"mm kid {kid}: {_UNPORTED_KIDS[kid]} is not ported yet")
    plan = get_plan(A)
    if kid is None:
        kind = mm_kind(A, plan, descr, op)
    else:
        for e in registry.table("mm"):
            if e.kid == kid:
                kind = e.fmt
                break
        else:
            raise AoclSparseError(Status.invalid_kid, f"kid {kid} not in table for 'mm'")
    form = plan.exec_form_for(descr, op, kind=kind)
    env = mixed_env()
    return _run_mm_form(form, B, kid, mixed=env if env is not None else A.precision_mode == "mixed")


def _run_mm_form(form, B: torch.Tensor, kid: Optional[int], mixed: bool = False) -> torch.Tensor:
    """form @ B through the mm table's kernel for the form (and kid). The
    mixed mode applies to float32 B only. A bf16 handle's band and diagonal
    kernels take B widened to f32 (exact) and return f32, as the JAX
    package's band kernel does (kernels/pallas/spmv.py:199 there); `mm`
    rounds to the result dtype."""
    e = registry.select("mm", fmt=form.kind, kid=kid, device=B.device)
    mixed = mixed and B.dtype == torch.float32
    if B.dtype == torch.bfloat16 and form.kind in ("bandtm", "diag"):
        B = B.float()
    if form.kind == "bandtm":
        spill = (form.sp_val, form.sp_ind, form.sp_rows)
        if e.kid == 5:
            return e.fn(form.band_mxu_dt(bf16=mixed), B, *spill, m=form.m,
                        start=form.bandt_start, padL=form.bwd_padL, W=form.bwd_W)
        return e.fn(form.bwd_val, B, *spill, start=form.bandt_start, padL=form.bwd_padL)
    if form.kind == "diag":
        return e.fn(form.dia_bf16() if mixed else form.dia_val, form.dia_offs, B, offs_static=form.dia_offs_static)
    if form.kind == "segsum":
        return e.fn(form.ind, form.val, form.row_ids, B, form.m)
    if form.kind == "ell":
        return e.fn(form.ell_ind, form.ell_val, B)
    if form.kind == "ellhyb":
        return e.fn(form.ell_ind, form.ell_val, form.sp_ind, form.sp_val, form.sp_rows, B, form.m)
    if form.kind == "bwdg":
        Bp = torch.nn.functional.pad(B, (0, 0, form.bwd_padL, form.bwd_n_pad - form.bwd_padL - form.n))
        wv = form.band_bf16() if mixed else form.bwd_val
        return e.fn(wv, Bp, form.bwd_G, form.bwd_W, form.bwd_base8, form.bwd_n_pad, mixed)[: form.m]
    raise AoclSparseError(Status.internal_error, f"bad exec form {form.kind}")


def mm(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    B,
    beta,
    C=None,
    order: Order = Order.row,
    kid: Optional[int] = None,
) -> torch.Tensor:
    """C = alpha * op(descr(A)) @ B + beta * C  (aoclsparse_?csrmm)."""
    if A is None or descr is None or B is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to mm")
    descr.validate()
    check_base_match(A, descr)
    op = Operation(op)
    order = Order(order)
    B = _as_operand(B, A, "B")
    if order == Order.column:
        B = B.T
    if B.dim() != 2:
        raise AoclSparseError(Status.invalid_size, "B must be 2-D")
    m, n = A.shape
    ma, na = (m, n) if op == Operation.none else (n, m)
    if B.shape[0] != na:
        raise AoclSparseError(Status.invalid_size, f"B rows {B.shape[0]} != op(A) cols {na}")
    k = B.shape[1]
    if C is not None:
        C = _as_operand(C, A, "C")
        if order == Order.column:
            C = C.T
        if tuple(C.shape) != (ma, k):
            raise AoclSparseError(Status.invalid_size, f"C must be ({ma},{k}), got {tuple(C.shape)}")
    if MatrixType(descr.type) != MatrixType.general and m != n:
        raise AoclSparseError(Status.invalid_size, f"{descr.type.name} requires square A")
    check_dtype_compat(A.dtype, B.dtype, "B")
    dtype = torch.promote_types(A.dtype, B.dtype)
    dev = A.device

    def out(x):
        return x.T if order == Order.column else x

    # beta == 0: C is not read, so NaN/Inf in C stays out (the reference
    # overwrites C, csrmv_kr.hpp:54-56 semantics shared by csrmm); a NaN/Inf
    # beta compares unequal to 0 and takes the full epilogue
    beta_is_zero = _is_zero(beta)
    if A.nnz == 0 or _is_zero(alpha):
        zeros = torch.zeros(ma, k, dtype=dtype, device=dev)
        if beta_is_zero:
            return out(zeros)
        return out((alpha * 0) * zeros + beta * (zeros if C is None else C.to(dtype)))
    c_new = _mm_core(A, descr, op, B.to(A.dtype).contiguous(), kid).to(dtype)
    if beta_is_zero:
        return out(c_new if isinstance(alpha, Number) and alpha == 1 else alpha * c_new)
    c_old = torch.zeros(ma, k, dtype=dtype, device=dev) if C is None else C.to(dtype)
    return out(alpha * c_new + beta * c_old)
