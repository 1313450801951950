"""ILU(0) preconditioner.

PyTorch counterpart of ``aoclsparse_tpu/solvers/ilu.py``. Reference: the
sequential IKJ factorization in place on a copy of the values
(aoclsparse_ilu0_factorization, solvers/aoclsparse_ilu0.hpp:37-112), the
L/U substitution (:115-162) and the entry point aoclsparse_?ilu_smoother
(aoclsparse_ilu.cpp); the factorization runs once and is cached
(ilu0.hpp:180-195).

The one-time factorization is host planner work (the C++ IKJ sweep of
native/, numpy when the library is missing). The apply, which runs in
every preconditioned Krylov step, is two blocked window solves over the
cached factors: unit L, then U on reversed indices, each one launch of the
window-solve kernel (kernels/trsv_win.py).

A 2-D b (m, k) takes the multi-RHS window solve, one launch a factor.

Not ported yet: the level-scheduled and host-substitution applies (kid=1,
and the JAX package's fallback for factors whose window is too wide,
ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.descr import MatrixDescriptor
from ..core.matrix import SparseMatrix, as_values
from ..core.types import (
    AoclSparseError,
    DiagType,
    FillMode,
    MatrixType,
    Operation,
    Status,
)
from ..ops.level2.trsv import pad_solve
from ..planner.plan import CleanCSR, build_effective_csr, get_plan
from ..planner.triangular import (
    TrsvForm,
    adaptive_nb,
    build_trsv_form,
    build_trsv_form_native,
    check_solve_dtype,
)

__all__ = ["IluState", "ilu0_factorize", "ilu_smoother"]

L_DESCR = MatrixDescriptor(
    type=MatrixType.triangular, fill_mode=FillMode.lower, diag_type=DiagType.unit
)
U_DESCR = MatrixDescriptor(
    type=MatrixType.triangular, fill_mode=FillMode.upper, diag_type=DiagType.non_unit
)


@dataclasses.dataclass
class IluState:
    lu: torch.Tensor  # (nnz,) LU values on the clean structure, on A's device
    lu_clean: CleanCSR  # clean structure with the LU values
    l_form: Optional[TrsvForm] = None  # unit-L solve form
    u_form: Optional[TrsvForm] = None  # U solve form (reversed indices)


def _ilu0_host(m, ptr, ind, val) -> np.ndarray:
    """IKJ ILU(0) on the sorted CSR pattern (ilu0.hpp:37-112) by the native
    C++ kernel, raising the reference's statuses on a missing diagonal or a
    zero pivot (ilu0.hpp:76-77,97-101)."""
    from .. import native

    try:
        lu, _diag = native.ilu0_factor(m, ptr, ind, np.asarray(val))
    except ValueError as e:
        kind, _, row = str(e).partition(":")
        if kind == "missing_diag":
            raise AoclSparseError(
                Status.invalid_value, f"ILU0: missing diagonal in row {row}"
            ) from None
        raise AoclSparseError(Status.numerical_error, f"ILU0: zero pivot at row {row}") from None
    return lu


def ilu0_factorize(A: SparseMatrix) -> IluState:
    """Factorize once; cached on the handle (the reference's working-copy
    model, aoclsparse_optimize_ilu analysis.cpp:390-425) until
    update_values drops it. The solve forms come from the native builder,
    else from the numpy builder."""
    if A.ilu_state is not None:
        return A.ilu_state
    if A.shape[0] != A.shape[1]:
        raise AoclSparseError(Status.invalid_size, "ILU0 requires square A")
    check_solve_dtype(A.dtype)
    clean = get_plan(A).clean
    lu = _ilu0_host(clean.m, clean.ptr, clean.ind, clean.host_val())
    dev = clean.val.device
    lu_clean = CleanCSR(
        ptr=clean.ptr,
        ind=clean.ind,
        val=torch.from_numpy(lu).to(dev),
        perm=np.arange(lu.size, dtype=np.int64),
        idiag=clean.idiag,
        iurow=clean.iurow,
        has_diag=clean.has_diag,
        fulldiag=clean.fulldiag,
        shape=clean.shape,
        val_host=lu,
    )
    st = IluState(lu=lu_clean.val, lu_clean=lu_clean)
    nb = adaptive_nb(lu_clean.m, dtype=lu.dtype)
    st.l_form = build_trsv_form_native(lu_clean, L_DESCR, Operation.none, nb, lu, dev)
    st.u_form = build_trsv_form_native(lu_clean, U_DESCR, Operation.none, nb, lu, dev)
    if st.l_form is None or st.u_form is None:
        _ilu_numpy_forms(st, lu_clean, lu, nb)
    A.ilu_state = st
    return st


def _ilu_numpy_forms(st: IluState, lu_clean: CleanCSR, lu: np.ndarray, nb: int) -> None:
    """Forms from the numpy builder, filled from host values over each
    effective triangle (the factored lu, with 1.0 for the injected unit
    diagonal)."""

    def host_vals(eff):
        src = np.asarray(eff.src, dtype=np.int64)
        return np.where(src >= 0, lu[np.maximum(src, 0)], np.asarray(eff.const_val, dtype=lu.dtype))

    for slot, descr in (("l", L_DESCR), ("u", U_DESCR)):
        eff = build_effective_csr(lu_clean, descr, Operation.none)
        form = build_trsv_form(descr, Operation.none, eff, nb, val_override=host_vals(eff))
        setattr(st, f"{slot}_form", form)


def ilu_apply(st: IluState, r: torch.Tensor) -> torch.Tensor:
    """z = U^{-1} L^{-1} r over the cached factors, r of (m,) or (m, k):
    two window solves."""
    return pad_solve(st.u_form, pad_solve(st.l_form, r))


def ilu_smoother(
    A: SparseMatrix,
    descr: Optional[MatrixDescriptor] = None,
    b=None,
    op: Operation = Operation.none,
    kid: Optional[int] = None,
):
    """x = U^{-1} L^{-1} b over the cached ILU0 factors
    (aoclsparse_?ilu_smoother). The LU working values are inspectable as
    ``A.ilu_state.lu`` (the precond_csr_val analog). kid 0/None is the
    blocked window solve."""
    if A is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    if Operation(op) != Operation.none:
        raise AoclSparseError(Status.not_implemented, "ilu_smoother supports op=none (parity)")
    if kid not in (None, 0, 1):
        raise AoclSparseError(Status.invalid_kid, f"ilu_smoother kid {kid}")
    if kid == 1:
        raise AoclSparseError(
            Status.not_implemented,
            "the level-scheduled ILU apply (kid 1) is not ported yet (ROADMAP.md queue 1 item 12)",
        )
    st = ilu0_factorize(A)
    b = as_values(b, A.device).to(A.dtype)
    if b.dim() not in (1, 2) or b.shape[0] != A.shape[0]:
        raise AoclSparseError(Status.invalid_size, "b size mismatch")
    return ilu_apply(st, b)
