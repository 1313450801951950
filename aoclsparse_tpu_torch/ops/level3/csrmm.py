"""Level-3 SpMM: ``mm``, C = alpha * op(descr(A)) @ B + beta * C.

PyTorch counterpart of ``aoclsparse_tpu/ops/level3/csrmm.py``. Reference:
aoclsparse_?csrmm (level3/aoclsparse_csrmm.cpp:32-46) with row- or
column-major B and C. The (descr, op) pair resolves through the planner to
an effective CSR and an execution form, as for mv; the registry's mm table
picks the kernel for the form (kernels/registry.py).

Without a kid the form is `choose_mm_format`'s (planner/plan.py): the band
SpMM kernel on band operands, the diagonal kernel on few-diagonal ones
(stencils), the general-structure composite (KID 6, kernels/spmm_gen.py:
its band leg on the band SpMM kernel) on square general structure whose
permuted band passes KID 6's gate (`gen_mm_ok`) and, on the card, beats
the CSR SpMM kernel (`gen_beats_csr_mm`), the gather forms otherwise: on
the card `segsum` (KID 0, the CSR SpMM kernel, kernels/spmm_csr.py), on the
CPU the JAX rule's `ell` / `ellhyb`; `MemoryPolicy.restricted` takes
segsum. Where KID 6's gate fails (a band wider than the kernel's plan,
complex values, a structure the gen planner rejects) the form is rebuilt
as that gather form (`Plan.mm_form_for`), as the JAX package does
(csrmm.py:225-241 there), and an explicit ``kid=6`` then finds no kernel
row for it and raises ``invalid_kid``, as there. An
`autotune_mm` pin (`plan._mm_tuned`, kernels/autotune.py) replaces the
default for its (descriptor, op, K); an explicit kid replaces both.
`order=Order.column` reads B and C transposed (the caller passes B^T and
C^T) and returns C^T.
The mixed precision mode streams bf16 block windows through KID 5, a bf16
band through KID 6, bf16 diagonals through KID 7 and bf16 groups through
KID 3, accumulating in f32. The AOCLSPARSE_TPU_MIXED_PRECISION variable
decides it when set ("1" on, "0" off), as in the JAX package
(csrmm.py:251-336 there); unset, the handle's mode decides
(`set_precision_mode(A, "mixed")`, docs/precision.md), which the JAX
package's mm does not read (ROADMAP.md queue 3).
"""

from __future__ import annotations

from numbers import Number
from typing import Optional

import torch

from ...core.descr import MatrixDescriptor
from ...core.matrix import SparseMatrix
from ...core.types import AoclSparseError, MatrixType, MemoryPolicy, Operation, Order, Status
from ...core.validate import check_base_match, check_dtype_compat
from ...kernels.registry import registry
from ...planner.plan import get_plan, mm_kind
from ...utils.debug import check_finite
from ..level2.mv import _as_operand, _is_zero, mixed_env

__all__ = ["mm"]

#: the autotune label of mm KID 5, which shares the bandtm form with KID 4
#: (kernels/autotune.py, the JAX package's csrmm.py:133-145)
MXU_LABEL, MXU_KID = "bandmxu", 5


def _tuned(plan, descr: MatrixDescriptor, op: Operation, k: int):
    """(kind, kid) of an `autotune_mm` pin for (descr, op, K), or (None, None)."""
    kind = plan._mm_tuned.get((descr.type, descr.fill_mode, descr.diag_type, op, k))
    if kind == MXU_LABEL:
        return "bandtm", MXU_KID
    return kind, None


def _mm_core(A: SparseMatrix, descr: MatrixDescriptor, op: Operation, B: torch.Tensor, kid):
    """op(descr(A)) @ B in A's dtype, without the alpha/beta epilogue."""
    plan = get_plan(A)
    if kid is None:
        kind = None
        if A.mem_policy != MemoryPolicy.restricted:
            kind, kid = _tuned(plan, descr, op, B.shape[1])
        if kind is None:
            kind = mm_kind(A, plan, descr, op)
    else:
        for e in registry.table("mm"):
            if e.kid == kid:
                kind = e.fmt
                break
        else:
            raise AoclSparseError(Status.invalid_kid, f"kid {kid} not in table for 'mm'")
    form = plan.mm_form_for(descr, op, kind)
    env = mixed_env()
    return _run_mm_form(form, B, kid, mixed=env if env is not None else A.precision_mode == "mixed")


def _run_mm_form(form, B: torch.Tensor, kid: Optional[int], mixed: bool = False) -> torch.Tensor:
    """form @ B through the mm table's kernel for the form (and kid). The
    mixed mode applies to float32 B only. A bf16 handle's band, diagonal
    and CSR SpMM kernels take B widened to f32 (exact) and return f32, as
    the JAX package's band kernel does (kernels/pallas/spmv.py:199 there); `mm`
    rounds to the result dtype."""
    e = registry.select("mm", fmt=form.kind, kid=kid, device=B.device)
    mixed = mixed and B.dtype == torch.float32
    if B.dtype == torch.bfloat16 and form.kind in ("bandtm", "diag", "gen", "segsum"):
        B = B.float()
    if form.kind == "gen":
        return e.fn(form, B, mixed=mixed)
    if form.kind == "bandtm":
        spill = (form.sp_val, form.sp_ind, form.sp_rows)
        if e.kid == 5:
            return e.fn(form.band_mxu_dt(bf16=mixed), B, *spill, m=form.m,
                        start=form.bandt_start, padL=form.bwd_padL, W=form.bwd_W)
        return e.fn(form.bwd_val, B, *spill, start=form.bandt_start, padL=form.bwd_padL)
    if form.kind == "diag":
        return e.fn(form.dia_bf16() if mixed else form.dia_val, form.dia_offs, B, offs_static=form.dia_offs_static)
    if form.kind == "segsum":
        # the CSR SpMM kernel reads the row pointers and the block schedule
        # (a form on the card keeps no row ids); the CPU's plain gather
        # reads the form's row ids
        return e.fn(form.ind, form.val, form.row_ids, B, form.m, form.ptr, form.csr_blocks)
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
        return check_finite("mm", x.T if order == Order.column else x)

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
