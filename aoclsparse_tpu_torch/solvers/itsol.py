"""Iterative solver framework: CG + restarted GMRES, RCI + forward interfaces.

PyTorch counterpart of ``aoclsparse_tpu/solvers/itsol.py``. Reference:
handle + per-type data (src/include/aoclsparse_itsol_data.hpp:108-184), CG
task state machine (solvers/aoclsparse_itsol_functions.hpp:619), GMRES
restarted Arnoldi + Givens (:893-1290), forward interfaces driving the RCI
internally (:1352 cg, :1493 gmres), entry points
aoclsparse_itsol_?_init/_solve/_rci_solve (aoclsparse_itsol_functions.cpp:
115-497), rinfo[100] statistics (RES_NORM=0, RHS_NORM=1, ITER=30,
itsol_functions.hpp:40-44).

The RCI protocol keeps its job vocabulary (interrupt/stop/start/mv/precond/
stopping_criterion) as a Python stepper object; its vectors are tensors on
the handle's device (``itsol_init(device=)``, cuda:0 unless named; the
forward `itsol_solve` uses A's device), and each step reads to the host only
the scalars its tests need: a norm, a dot, or, for a GMRES inner step, the
new Hessenberg column. The GMRES stepper keeps H, g and the rotations
(c real, s carrying the complex phase) in host numpy, orthogonalizes by
modified Gram-Schmidt on the device, as the JAX stepper does, and solves
the rotated H by back substitution. The forward interface drives the
stepper with this package's mv and preconditioners, matching the
reference's option wiring ("cg preconditioner" = None/User/SGS, "gmres
preconditioner" = None/User/ILU0).
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.context import resolve_device
from ..core.descr import MatrixDescriptor
from ..core.matrix import SparseMatrix
from ..core.types import AoclSparseError, Operation, Status, check_value_dtype
from ..ops.level2.mv import mv
from ..utils.debug import check_finite
from .fused import _HOST_DTYPE
from .options import (
    OptionRegistry,
    PRECOND_ILU0,
    PRECOND_NONE,
    PRECOND_SGS,
    PRECOND_USER,
    SOLVER_CG,
    default_registry,
)

__all__ = [
    "RciJob",
    "RINFO_RES_NORM",
    "RINFO_RHS_NORM",
    "RINFO_ITER",
    "ItsolHandle",
    "itsol_handle_prn_options",
    "itsol_init",
    "itsol_option_set",
    "itsol_rci_input",
    "itsol_rci_solve",
    "itsol_solve",
    "itsol_solve_operator",
    "CgRci",
    "GmresRci",
]

RINFO_RES_NORM = 0
RINFO_RHS_NORM = 1
RINFO_ITER = 30

class RciJob(enum.IntEnum):
    """aoclsparse_itsol_rci_job (include/aoclsparse_solvers.h:113-134)."""

    interrupt = -1
    stop = 0
    start = 1
    mv = 2
    precond = 3
    stopping_criterion = 4


class ItsolHandle:
    """aoclsparse_itsol_handle analog: options + problem data."""

    def __init__(self, dtype=torch.float64, device=None):
        self.dtype = check_value_dtype(dtype)
        self.device = resolve_device(device)
        self.options: OptionRegistry = default_registry(self.dtype)
        self.b = None
        self.n = None
        self.rci = None
        self.rinfo = np.zeros(100, dtype=np.float64)

    def solving(self) -> bool:
        return self.rci is not None


def itsol_init(dtype=torch.float64, device=None) -> ItsolHandle:
    """aoclsparse_itsol_?_init: a handle for vectors of `dtype` on `device`
    (cuda:0 unless named)."""
    return ItsolHandle(dtype, device)


def itsol_option_set(handle: ItsolHandle, name: str, value) -> None:
    """aoclsparse_itsol_option_set; rejected mid-solve like the reference."""
    if handle.solving():
        raise AoclSparseError(Status.invalid_operation, "cannot set options mid-solve")
    handle.options.set(name, value)


def itsol_handle_prn_options(handle: ItsolHandle, file=None) -> str:
    """aoclsparse_itsol_handle_prn_options (solvers.h:147): print the
    handle's option table (name, value, default, description) to `file`
    (default stdout) and return it."""
    text = handle.options.print_options()
    print(text, file=file)
    return text


def _as_vector(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor, numpy array or sequence as a tensor of `dtype` on `device`."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v))
    return v.to(device=device, dtype=dtype)


def _input(handle: ItsolHandle, n: int, b, device: torch.device) -> None:
    if tuple(np.shape(b)) != (n,):
        raise AoclSparseError(Status.invalid_size, f"b must be ({n},)")
    handle.n = int(n)
    handle.b = _as_vector(b, handle.dtype, device)
    handle.rci = None


def itsol_rci_input(handle: ItsolHandle, n: int, b) -> None:
    """aoclsparse_itsol_?_rci_input: register problem size + rhs."""
    _input(handle, n, b, handle.device)


# ---------------------------------------------------------------------------
# vector steps (device tensors; the callers read scalars to the host)
# ---------------------------------------------------------------------------


def _nrm2(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.abs(x) ** 2))


def _dotu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unconjugated dot: the complex-symmetric CG's (cblas dotu)."""
    return torch.sum(x * y)


def _dotc(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Conjugated dot x^H y: GMRES's orthogonalization."""
    return torch.sum(torch.conj(x) * y)


def _breakdown(value: complex, is_complex: bool) -> bool:
    """Real dtypes: the value must stay positive (is_negative_or_nearzero);
    complex (unconjugated dots): only a vanishing magnitude breaks."""
    if is_complex:
        return abs(value) < 1e-300
    return value.real <= 0 or abs(value.real) < 1e-300


# ---------------------------------------------------------------------------
# CG RCI state machine (itsol_functions.hpp:619-870)
# ---------------------------------------------------------------------------


class CgRci:
    """Preconditioned CG with the reference's exact task graph:
    start -> init_res -> check_conv -> start_iter -> compute_beta ->
    take_step -> check_conv."""

    def __init__(self, n, b, x0, rtol, atol, maxit, precond: bool, rinfo):
        self.n = n
        self.b = b
        self.x = _as_vector(x0, b.dtype, b.device)
        self.rtol, self.atol, self.maxit = float(rtol), float(atol), int(maxit)
        self.precond = bool(precond)
        self.rinfo = rinfo
        self.task = "start"
        self.niter = 0
        self.r = None
        self.p = None
        self.q = None
        self.z = None
        self.rz = None
        self.status = Status.success

    def _vec(self, v) -> torch.Tensor:
        return _as_vector(v, self.b.dtype, self.b.device)

    def step(self, result=None) -> Tuple[RciJob, Optional[torch.Tensor]]:
        """Advance until the next external job. `result` answers the
        previous job (v = A u or v = M^{-1} u). Returns (job, u)."""
        while True:
            if self.task == "start":
                self.rinfo[:] = 0.0
                self.niter = 0
                self.r = -self.b
                self.p = self.x
                bnorm = float(_nrm2(self.b))
                if np.isnan(bnorm):
                    raise AoclSparseError(Status.invalid_value, "b contains NaN")
                self.bnorm2 = bnorm
                self.rinfo[RINFO_RHS_NORM] = bnorm
                self.brtol = self.rtol * bnorm
                self.task = "init_res"
                return RciJob.mv, self.p  # q = A p

            if self.task == "init_res":
                self.q = self._vec(result)
                self.r = self.r + self.q
                rnorm = float(_nrm2(self.r))
                if np.isnan(rnorm):
                    self.status = Status.numerical_error
                    return RciJob.stop, None
                self.rnorm2 = rnorm
                self.rinfo[RINFO_RES_NORM] = rnorm
                self.p = torch.zeros_like(self.p)
                self.rz = torch.ones((), dtype=self.b.dtype, device=self.b.device)
                self.task = "check_conv"
                continue

            if self.task == "check_conv":
                if 0.0 < self.atol and self.rnorm2 <= self.atol:
                    return RciJob.stop, None
                if 0.0 < self.rtol and self.rnorm2 <= self.brtol:
                    return RciJob.stop, None
                if self.maxit > 0 and self.niter > self.maxit:
                    self.status = Status.maxit
                    return RciJob.stop, None
                self.task = "start_iter"
                return RciJob.stopping_criterion, self.r

            if self.task == "start_iter":
                self.niter += 1
                self.rinfo[RINFO_ITER] = self.niter
                self.task = "compute_beta"
                if not self.precond:
                    self.z = self.r
                    continue
                return RciJob.precond, self.r  # z = M^{-1} r

            if self.task == "compute_beta":
                if self.precond and result is not None:
                    self.z = self._vec(result)
                rz_new = _dotu(self.r, self.z)
                if _breakdown(complex(self.rz.item()), self.b.is_complex()):
                    raise AoclSparseError(Status.numerical_error, "CG breakdown: rz <= 0 or ~ 0")
                beta = rz_new / self.rz
                self.rz = rz_new
                self.p = beta * self.p - self.z
                self.task = "take_step"
                return RciJob.mv, self.p  # q = A p

            if self.task == "take_step":
                self.q = self._vec(result)
                pq = _dotu(self.p, self.q)
                if _breakdown(complex(pq.item()), self.b.is_complex()):
                    raise AoclSparseError(
                        Status.numerical_error, "CG: matrix not positive definite (pq <= 0 or ~ 0)"
                    )
                alpha = self.rz / pq
                self.x = self.x + alpha * self.p
                self.r = self.r + alpha * self.q
                rnorm = float(_nrm2(self.r))
                if np.isnan(rnorm):
                    self.status = Status.numerical_error
                    return RciJob.stop, None
                self.rnorm2 = rnorm
                self.rinfo[RINFO_RES_NORM] = rnorm
                self.task = "check_conv"
                continue

            raise AoclSparseError(Status.internal_error, f"bad CG task {self.task}")


# ---------------------------------------------------------------------------
# GMRES RCI state machine (itsol_functions.hpp:893-1290)
# ---------------------------------------------------------------------------


class GmresRci:
    """Right-preconditioned restarted GMRES with Givens rotations, restart
    cycle m = "gmres restart iterations"."""

    def __init__(self, n, b, x0, rtol, atol, maxit, restart, precond: bool, rinfo):
        self.n = n
        self.b = b
        self.x = _as_vector(x0, b.dtype, b.device)
        self.rtol, self.atol = float(rtol), float(atol)
        self.maxit, self.m = int(maxit), int(restart)
        self.precond = bool(precond)
        self.rinfo = rinfo
        self.task = "start"
        self.niter = 0
        self.status = Status.success
        dt = _HOST_DTYPE[b.dtype]
        self.V = []  # Krylov basis vectors (device)
        self.Z = []  # preconditioned vectors (when precond)
        self.H = np.zeros((self.m + 1, self.m), dtype=dt)
        self.g = np.zeros(self.m + 1, dtype=dt)
        self.c = np.zeros(self.m, dtype=np.float64)
        self.s = np.zeros(self.m, dtype=dt)
        self.j = 0

    def _vec(self, v) -> torch.Tensor:
        return _as_vector(v, self.b.dtype, self.b.device)

    # Givens: lartg(f, g) -> c, s, r with c*f + s*g = r; c real
    @staticmethod
    def _lartg(f, g):
        af, ag = abs(f), abs(g)
        if ag == 0:
            return 1.0, 0.0 * g, f
        if af == 0:
            return 0.0, np.conj(g) / ag, ag
        d = np.sqrt(af * af + ag * ag)
        c = af / d
        r = f / af * d
        s = np.conj(g) * (f / af) / d
        return c, s, r

    @staticmethod
    def _backsolve(R, g):
        """Upper-triangular back substitution y = R^{-1} g.

        The reference solves the rotated Hessenberg system the same way
        (itsol_functions.hpp:1237-1255) rather than with a general solver:
        H[:j,:j] is upper triangular by construction after the Givens sweep,
        and a general LU here could silently mask a rotation bug."""
        j = len(g)
        y = np.zeros(j, dtype=R.dtype)
        for i in range(j - 1, -1, -1):
            acc = g[i] - R[i, i + 1 :] @ y[i + 1 :]
            y[i] = acc / R[i, i]
        return y

    def _start_cycle_residual(self, v):
        """v = A x computed; build r0 = b - v, check convergence, set v0.

        beta == 0 (exact initial guess / b == 0) counts as converged: the
        basis normalization r0/beta below would otherwise produce NaN."""
        r0 = self.b - self._vec(v)
        beta = float(_nrm2(r0))
        self.rinfo[RINFO_RES_NORM] = beta
        self.rnorm2 = beta
        if beta <= self.atol or beta <= self.brtol:
            self.rinfo[RINFO_ITER] = self.niter
            return True
        self.V = [r0 / beta]
        self.Z = []
        self.H[:] = 0
        self.g[:] = 0
        self.g[0] = beta
        self.j = 0
        return False

    def _orthogonalize(self, w: torch.Tensor):
        """Modified Gram-Schmidt of w against V[0..j] on the device, as the
        JAX stepper orders it; returns (w, the column h_0..h_j, ||w||) with
        the column and the norm read to the host in one transfer."""
        hs = []
        for v in self.V[: self.j + 1]:
            h = _dotc(v, w)
            if not w.is_complex():
                h = h.real
            hs.append(h)
            w = w - h * v
        hh = _nrm2(w)
        wide = torch.complex128 if w.is_complex() else torch.float64
        col = torch.stack(hs + [hh.to(w.dtype)]).to(wide).cpu().numpy()
        return w, col[:-1].astype(self.H.dtype), float(col[-1].real)

    def step(self, result=None) -> Tuple[RciJob, Optional[torch.Tensor]]:
        while True:
            if self.task == "start":
                bnorm = float(_nrm2(self.b))
                if np.isnan(bnorm):
                    raise AoclSparseError(Status.invalid_value, "b contains NaN")
                self.rinfo[RINFO_RHS_NORM] = bnorm
                self.brtol = self.rtol * bnorm
                if self.atol <= 0 and self.brtol <= 0:
                    raise AoclSparseError(Status.invalid_value, "both tolerances zero")
                self.task = "init_res"
                return RciJob.mv, self.x

            if self.task == "init_res":
                if self._start_cycle_residual(result):
                    return RciJob.stop, None
                self.task = "inner_precond"
                continue

            if self.task == "inner_precond":
                self.task = "inner_mv"
                if not self.precond:
                    result = None
                    continue
                return RciJob.precond, self.V[self.j]

            if self.task == "inner_mv":
                if self.precond:
                    u = self._vec(result)
                    self.Z.append(u)
                else:
                    u = self.V[self.j]
                self.task = "arnoldi"
                return RciJob.mv, u  # w = A u

            if self.task == "arnoldi":
                j, m = self.j, self.m
                w, hvals, hh = self._orthogonalize(self._vec(result))
                hcol = np.zeros(j + 2, dtype=self.H.dtype)
                hcol[: j + 1] = hvals
                breakdown = (hh < self.atol) or (hh < self.brtol)
                if not breakdown:
                    self.V.append(w / hh)
                hcol[j + 1] = hh
                # apply previous rotations, then the new one, also on the
                # happy-breakdown path, so H[:j+1,:j+1] stays a complete
                # upper-triangular factor for the x-update back-solve
                for i in range(j):
                    r1, r2 = hcol[i], hcol[i + 1]
                    hcol[i] = self.c[i] * r1 + self.s[i] * r2
                    hcol[i + 1] = -np.conj(self.s[i]) * r1 + self.c[i] * r2
                cj, sj, rj = self._lartg(hcol[j], hcol[j + 1])
                self.c[j], self.s[j] = cj, sj
                hcol[j], hcol[j + 1] = rj, 0.0
                self.H[: j + 2, j] = hcol
                g0 = self.g[j]
                self.g[j] = cj * g0
                self.g[j + 1] = -np.conj(sj) * g0
                self.rnorm2 = abs(self.g[j + 1])
                self.rinfo[RINFO_RES_NORM] = self.rnorm2
                self.j += 1
                if breakdown:
                    # residual already (numerically) in span(V): solve with the
                    # j+1 completed columns and accept the updated x
                    self.niter += self.j
                    self.rinfo[RINFO_ITER] = self.niter
                    self.task = "x_update_ortho"
                    continue
                self.task = "x_update" if self.j >= m else "inner_precond"
                continue

            if self.task in ("x_update", "x_update_ortho"):
                j = self.j
                if j > 0:
                    y = self._backsolve(self.H[:j, :j], self.g[:j])
                    basis = self.Z if self.precond else self.V
                    upd = torch.zeros_like(self.x)
                    for i in range(j):
                        upd = upd + y[i].item() * basis[i]
                    self.x = self.x + upd
                if self.task == "x_update_ortho":
                    return RciJob.stop, None
                self.niter += j
                self.rinfo[RINFO_ITER] = self.niter
                converged = self.rnorm2 <= self.atol or self.rnorm2 <= self.brtol
                if self.maxit > 0 and self.niter >= self.maxit and not converged:
                    self.status = Status.maxit
                    return RciJob.stop, None
                # bounce stopping_criterion at every cycle boundary so RCI
                # drivers can monitor or interrupt there (the reference's
                # gmres RCI monitoring cadence, itsol_functions.hpp:893)
                self.task = "stopped" if converged else "restart_bounce"
                return RciJob.stopping_criterion, self.x

            if self.task == "restart_bounce":
                self.task = "init_res"
                return RciJob.mv, self.x

            if self.task == "stopped":
                return RciJob.stop, None

            raise AoclSparseError(Status.internal_error, f"bad GMRES task {self.task}")


# ---------------------------------------------------------------------------
# RCI + forward entry points
# ---------------------------------------------------------------------------


def _make_rci(handle: ItsolHandle, x0):
    opts = handle.options
    solver = opts.get("iterative method", lock=True)
    if handle.b is None:
        raise AoclSparseError(Status.invalid_value, "call itsol_rci_input first")
    if solver == SOLVER_CG:
        pre = opts.get("cg preconditioner", lock=True)
        return CgRci(
            handle.n,
            handle.b,
            x0,
            opts.get("cg rel tolerance", lock=True),
            opts.get("cg abs tolerance", lock=True),
            opts.get("cg iteration limit", lock=True),
            precond=(pre != PRECOND_NONE),
            rinfo=handle.rinfo,
        )
    pre = opts.get("gmres preconditioner", lock=True)
    return GmresRci(
        handle.n,
        handle.b,
        x0,
        opts.get("gmres rel tolerance", lock=True),
        opts.get("gmres abs tolerance", lock=True),
        opts.get("gmres iteration limit", lock=True),
        opts.get("gmres restart iterations", lock=True),
        precond=(pre != PRECOND_NONE),
        rinfo=handle.rinfo,
    )


def _x0(handle: ItsolHandle, x0) -> torch.Tensor:
    if x0 is None:
        return torch.zeros(handle.n, dtype=handle.dtype, device=handle.b.device)
    return _as_vector(x0, handle.dtype, handle.b.device)


def itsol_rci_solve(handle: ItsolHandle, x0=None):
    """aoclsparse_itsol_?_rci_solve analog: returns the stepper. Drive it:

        rci = itsol_rci_solve(h, x0)
        job, u = rci.step()
        while job not in (RciJob.stop,):
            if job == RciJob.mv:        job, u = rci.step(A @ u)
            elif job == RciJob.precond: job, u = rci.step(M_inv(u))
            else:                       job, u = rci.step()   # monitoring
        x = rci.x
    """
    if handle.b is None or handle.n is None:
        raise AoclSparseError(Status.invalid_value, "call itsol_rci_input first")
    handle.rci = _make_rci(handle, _x0(handle, x0))
    return handle.rci


def _precond_id(handle: ItsolHandle, precond) -> int:
    opts = handle.options
    solver = opts.get("iterative method")
    pre_id = opts.get("cg preconditioner" if solver == SOLVER_CG else "gmres preconditioner")
    if pre_id == PRECOND_USER and precond is None:
        raise AoclSparseError(Status.invalid_value, "User preconditioner requires callable")
    return pre_id


def _drive(handle: ItsolHandle, x0, matvec: Callable, precond_fn: Optional[Callable],
           monitoring: Optional[Callable]):
    """The forward interface's RCI loop: answer mv with `matvec`, precond
    with `precond_fn` (the identity when None; a None result requests
    user_stop, as the reference's nonzero precond flag does,
    itsol_functions.hpp:1366), and pass each stopping_criterion bounce to
    `monitoring(u as numpy, rinfo)`, whose nonzero return requests
    user_stop. The options unlock whatever happens. Returns (x, rinfo,
    status)."""
    rci = _make_rci(handle, x0)
    handle.rci = rci
    try:
        job, u = rci.step()
        while job != RciJob.stop:
            if job == RciJob.mv:
                job, u = rci.step(check_finite("itsol_solve iteration", matvec(u)))
            elif job == RciJob.precond:
                if precond_fn is None:
                    job, u = rci.step(u)
                    continue
                v = precond_fn(u)
                if v is None:
                    rci.status = Status.user_stop
                    break
                job, u = rci.step(v)
            else:  # stopping_criterion: the monitoring bounce
                if monitoring is not None and monitoring(u.detach().cpu().numpy(), handle.rinfo):
                    rci.status = Status.user_stop
                    break
                job, u = rci.step()
    finally:
        handle.rci = None
        handle.options.unlock_all()
    # at maxit the reference returns its best x with the maxit status
    return rci.x, handle.rinfo, rci.status


def itsol_solve(
    handle: ItsolHandle,
    n: int,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    b,
    x0=None,
    precond: Optional[Callable] = None,
    monitoring: Optional[Callable] = None,
):
    """Forward interface (aoclsparse_itsol_?_solve, itsol_functions.hpp:543):
    drives the RCI loop internally on A's device, wiring mv and the
    option-selected preconditioner (User -> `precond` callable; SGS -> one
    `symgs` sweep from zero, ILU0 -> `ilu_smoother`). Returns (x, rinfo,
    status). `monitoring(x_or_r, rinfo)` may return nonzero to request
    user_stop."""
    if A is None or descr is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix/descriptor")
    if tuple(A.shape) != (n, n):
        raise AoclSparseError(Status.invalid_size, f"A must be ({n},{n})")
    _input(handle, n, b, A.device)
    x0 = _x0(handle, x0)
    pre_id = _precond_id(handle, precond)
    if pre_id == PRECOND_SGS:
        from .symgs import symgs

        def precond_fn(u):
            return symgs(Operation.none, A, descr, 1.0, u)

    elif pre_id == PRECOND_ILU0:
        from .ilu import ilu_smoother

        def precond_fn(u):
            return ilu_smoother(A, descr, u)

    else:
        precond_fn = precond if pre_id == PRECOND_USER else None
    return _drive(handle, x0, lambda u: mv(1.0, A, descr, Operation.none, u, 0.0), precond_fn, monitoring)


def itsol_solve_operator(
    handle: ItsolHandle,
    n: int,
    matvec: Callable,
    b,
    x0=None,
    precond: Optional[Callable] = None,
    monitoring: Optional[Callable] = None,
):
    """Matrix-free forward interface: like itsol_solve but `matvec` is any
    callable v -> A@v, on the handle's device (the reference reaches
    matrix-free use only by hand-driving aoclsparse_itsol_?_rci_solve). The
    SGS/ILU0 preconditioner options need a matrix handle and therefore raise
    invalid_value here: pass a `precond` callable with the "User" option
    instead. Returns (x, rinfo, status)."""
    if matvec is None:
        raise AoclSparseError(Status.invalid_pointer, "null matvec")
    _input(handle, n, b, handle.device)
    x0 = _x0(handle, x0)
    pre_id = _precond_id(handle, precond)
    if pre_id not in (PRECOND_NONE, PRECOND_USER):
        raise AoclSparseError(
            Status.invalid_value,
            "matrix-free solve supports only None/User preconditioners",
        )
    return _drive(handle, x0, matvec, precond if pre_id == PRECOND_USER else None, monitoring)
