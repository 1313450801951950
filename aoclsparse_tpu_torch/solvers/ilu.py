"""ILU(0) preconditioner.

PyTorch counterpart of ``aoclsparse_tpu/solvers/ilu.py``. Reference: the
sequential IKJ factorization in place on a copy of the values
(aoclsparse_ilu0_factorization, solvers/aoclsparse_ilu0.hpp:37-112), the
L/U substitution (:115-162) and the entry point aoclsparse_?ilu_smoother
(aoclsparse_ilu.cpp); the factorization runs once and is cached
(ilu0.hpp:180-195).

The one-time factorization is host planner work (the C++ IKJ sweep of
native/, numpy when the library is missing). The apply, which runs in
every preconditioned Krylov step, is two blocked solves over the cached
factors: unit L, then U on reversed indices. The forms come from the
native ``win`` builder, else from the numpy builder (``win``, ``dwin`` or
``gather``, planner/triangular.py), so a solve is the window-solve kernels
(kernels/trsv_win.py) or one launch of the chain kernel
(kernels/trsv_blocked.py). A 2-D b (m, k) solves all columns at once.

On the card the default solves each factor whose blocked form runs the
chain kernel (``dwin``, ``gather``) by the level kernel where its DAG is
shallow against the chain (planner/triangular.py `pick_sv_engine`, the
rule of every default solve); kid 0 pins the blocked forms. kid 1 applies
the level-scheduled sweeps (kernels/trsv_level.py); so does the default
where both blocked forms were refused (``memory_error``: a
padded ELL past the cap), unless the factor's DAG is deeper than 8192
levels in all. There the JAX package escapes to its host substitution;
the port raises ``memory_error`` naming kid=2, which runs that host
substitution (the reference's own apply, ilu0.hpp:115-162) and returns a
CPU tensor. The JAX package answers kid=2 with invalid_kid (ROADMAP.md
queue 3).

Every handle dtype of the JAX package factors and applies: f32, f64,
complex64 and complex128 in their dtype (the host IKJ sweep has complex
instances), bf16 on f32 host values rounded once to bf16 (numpy has no
bfloat16; the JAX package factors its bf16 host copy in bf16 arithmetic,
so the two factors differ within the bf16 model tolerance). A complex
factor's blocked forms solve by their plain route, and on the card by the
level kernel where its levels allow (planner/triangular.py
`pick_sv_engine`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
from ..planner.plan import CleanCSR, build_effective_csr, get_plan, host_values
from ..planner.triangular import (
    TrsvForm,
    adaptive_nb,
    build_trsv_form,
    build_trsv_form_native,
    check_solve_dtype,
    pick_sv_engine,
)

__all__ = ["IluState", "ilu0_factorize", "ilu_smoother"]

L_DESCR = MatrixDescriptor(
    type=MatrixType.triangular, fill_mode=FillMode.lower, diag_type=DiagType.unit
)
U_DESCR = MatrixDescriptor(
    type=MatrixType.triangular, fill_mode=FillMode.upper, diag_type=DiagType.non_unit
)


#: the level sweeps' reach as the default apply: levels of L and U together
LEVEL_MAX_NLEV = 8192


@dataclasses.dataclass
class IluState:
    lu: torch.Tensor  # (nnz,) LU values on the clean structure, on A's device
    lu_clean: CleanCSR  # clean structure with the LU values
    l_form: Optional[TrsvForm] = None  # unit-L solve form (None: refused)
    u_form: Optional[TrsvForm] = None  # U solve form (reversed indices)
    l_level: Optional[object] = None  # LevelForm twins, built by the first level apply
    u_level: Optional[object] = None
    level_nlev: Optional[Tuple[int, int]] = None  # levels of L and U, from the structure
    _host_tri: Optional[tuple] = None  # host CSR triangles of the kid=2 apply


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
    else from the numpy builder; where that refuses them (memory_error),
    both stay None and the applies take the level sweeps."""
    if A.ilu_state is not None:
        return A.ilu_state
    if A.shape[0] != A.shape[1]:
        raise AoclSparseError(Status.invalid_size, "ILU0 requires square A")
    check_solve_dtype(A.dtype)
    clean = get_plan(A).clean
    lu = _ilu0_host(clean.m, clean.ptr, clean.ind, clean.host_val())
    dev = clean.val.device
    lu_t = torch.from_numpy(lu).to(A.dtype)
    if A.dtype == torch.bfloat16:
        lu = lu_t.float().numpy()  # the host copy holds the rounded factor
    lu_clean = CleanCSR(
        ptr=clean.ptr,
        ind=clean.ind,
        val=lu_t.to(dev),
        perm=np.arange(lu.size, dtype=np.int64),
        idiag=clean.idiag,
        iurow=clean.iurow,
        has_diag=clean.has_diag,
        fulldiag=clean.fulldiag,
        shape=clean.shape,
        val_host=lu,
    )
    st = IluState(lu=lu_clean.val, lu_clean=lu_clean)
    nb = adaptive_nb(lu_clean.m, dtype=A.dtype)
    st.l_form = build_trsv_form_native(lu_clean, L_DESCR, Operation.none, nb, lu, dev, A.dtype)
    st.u_form = build_trsv_form_native(lu_clean, U_DESCR, Operation.none, nb, lu, dev, A.dtype)
    if st.l_form is None or st.u_form is None:
        try:
            _ilu_numpy_forms(st, lu_clean, lu, nb)
        except AoclSparseError as e:
            if e.status != Status.memory_error:
                raise
            st.l_form = st.u_form = None
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


def _level_forms(st: IluState):
    """The level-scheduled twins of the factor sweeps, built once
    (solvers/ilu.py:226 there)."""
    if st.l_level is None:
        from ..kernels.trsv_level import build_level_form
        from ..planner.triangular import _reverse_structure

        eff_l = build_effective_csr(st.lu_clean, L_DESCR, Operation.none)
        eff_u = build_effective_csr(st.lu_clean, U_DESCR, Operation.none)
        st.l_level = build_level_form(
            eff_l.ptr, eff_l.ind, np.arange(eff_l.nnz, dtype=np.int64), eff_l.m, False, True, eff_l.val
        )
        rev = _reverse_structure(eff_u)
        st.u_level = build_level_form(rev.ptr, rev.ind, rev.src, eff_u.m, True, False, eff_u.val)
    return st.l_level, st.u_level


def _factor_nlev(st: IluState) -> Tuple[int, int]:
    """(nlev(L), nlev(U)) from the structure alone, before any level form
    is built (solvers/ilu.py:207 there), cached on the state."""
    if st.level_nlev is None:
        from ..kernels.trsv_level import level_form_stats
        from ..planner.triangular import _reverse_structure

        eff_l = build_effective_csr(st.lu_clean, L_DESCR, Operation.none)
        rev = _reverse_structure(build_effective_csr(st.lu_clean, U_DESCR, Operation.none))
        st.level_nlev = (level_form_stats(eff_l.ptr, eff_l.ind, eff_l.m)[0],
                         level_form_stats(rev.ptr, rev.ind, rev.m)[0])
    return st.level_nlev


def _level_depth(st: IluState) -> int:
    """nlev(L) + nlev(U)."""
    return sum(_factor_nlev(st))


def _factor_solve(st: IluState, i: int, r: torch.Tensor, pin_blocked: bool) -> torch.Tensor:
    """Solve with factor i (0: L, 1: U) by the default's engine, or by its
    blocked form when pinned."""
    form = (st.l_form, st.u_form)[i]
    if not pin_blocked and pick_sv_engine(form, lambda: _factor_nlev(st)[i], r.device) == "level":
        return _level_forms(st)[i].solve(r)
    return pad_solve(form, r)


def ilu_apply(st: IluState, r: torch.Tensor, pin_blocked: bool = False) -> torch.Tensor:
    """z = U^{-1} L^{-1} r over the cached factors, r of (m,) or (m, k):
    each factor by the default's engine (its blocked form, or on the card
    the level kernel where `pick_sv_engine` picks it; `pin_blocked` keeps
    the blocked forms), or the level sweeps where the blocked forms were
    refused."""
    if st.l_form is None:
        l_lvl, u_lvl = _level_forms(st)
        return u_lvl.solve(l_lvl.solve(r))
    return _factor_solve(st, 1, _factor_solve(st, 0, r, pin_blocked), pin_blocked)


def _host_lu_apply(st: IluState, b: torch.Tensor) -> torch.Tensor:
    """Sequential host substitution over the cached LU values, the
    reference's own apply (ilu0.hpp:115-162; solvers/ilu.py:315 there), on
    host CSR triangles built once per factor: a CPU tensor."""
    from .. import native

    if st._host_tri is None:
        cl = st.lu_clean
        ptr = cl.ptr.astype(np.int64)
        ind = cl.ind.astype(np.int64)
        lu = cl.host_val()
        idiag = cl.idiag.astype(np.int64)
        m = cl.m
        # unit lower: the strict lower part and a 1.0 diagonal at each row's end
        lptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(idiag - ptr[:-1] + 1, out=lptr[1:])
        diag_slot = lptr[1:] - 1
        keep = np.ones(int(lptr[-1]), dtype=bool)
        keep[diag_slot] = False
        take = _ranges_concat(ptr[:-1], idiag)
        lind = np.empty(int(lptr[-1]), dtype=np.int64)
        lval = np.empty(int(lptr[-1]), dtype=lu.dtype)
        lind[keep], lval[keep] = ind[take], lu[take]
        lind[diag_slot], lval[diag_slot] = np.arange(m), 1.0
        # upper with its diagonal
        uptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(ptr[1:] - idiag, out=uptr[1:])
        take_u = _ranges_concat(idiag, ptr[1:])
        st._host_tri = (m, lptr, lind, lval, uptr, ind[take_u], lu[take_u])
    m, lptr, lind, lval, uptr, uind, uval = st._host_tri
    bh = host_values(b).astype(lval.dtype, copy=False)
    if bh.ndim == 1:
        y = native.trsv_seq(m, lptr, lind, lval, bh, True)
        return torch.from_numpy(native.trsv_seq(m, uptr, uind, uval, y, False)).to(b.dtype)
    y = native.trsm_seq(m, lptr, lind, lval, bh, True)
    return torch.from_numpy(native.trsm_seq(m, uptr, uind, uval, y, False)).to(b.dtype)


def _ranges_concat(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The index ranges [lo_i, hi_i) concatenated (vectorised)."""
    cnt = (hi - lo).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(lo.size, dtype=np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) + np.repeat(lo - starts, cnt)


def ilu_smoother(
    A: SparseMatrix,
    descr: Optional[MatrixDescriptor] = None,
    b=None,
    op: Operation = Operation.none,
    kid: Optional[int] = None,
):
    """x = U^{-1} L^{-1} b over the cached ILU0 factors
    (aoclsparse_?ilu_smoother). The LU working values are inspectable as
    ``A.ilu_state.lu`` (the precond_csr_val analog). kid None: the
    default's engines (`ilu_apply`); 0: the blocked solves (the level
    sweeps where the blocked forms were refused); 1: the level sweeps; 2:
    the host substitution, a CPU tensor."""
    if A is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    if Operation(op) != Operation.none:
        raise AoclSparseError(Status.not_implemented, "ilu_smoother supports op=none (parity)")
    if kid not in (None, 0, 1, 2):
        raise AoclSparseError(Status.invalid_kid, f"ilu_smoother kid {kid}")
    st = ilu0_factorize(A)
    b = as_values(b, A.device).to(A.dtype)
    if b.dim() not in (1, 2) or b.shape[0] != A.shape[0]:
        raise AoclSparseError(Status.invalid_size, "b size mismatch")
    if kid == 2:
        return _host_lu_apply(st, b)
    if kid == 1 or st.l_form is None:
        if kid is None and _level_depth(st) > LEVEL_MAX_NLEV:
            raise AoclSparseError(
                Status.memory_error,
                "the factor's blocked forms were refused and its DAG is too deep for the level sweeps; "
                "call kid=2 (the host substitution, which returns a CPU tensor)",
            )
        l_lvl, u_lvl = _level_forms(st)
        return u_lvl.solve(l_lvl.solve(b))
    return ilu_apply(st, b, pin_blocked=kid == 0)
