"""Restarted GMRES over the group-window operand, single-process and
distributed (the JAX package's parallel/gmres.py).

The JAX package compiles the whole restarted iteration (classical
Gram-Schmidt Arnoldi, Givens rotations, restart cycles) into one program.
Here the loop is Python: each Arnoldi step runs its matvec (kernel #4,
kernels/spmv_bwd.py) and projections on the device and reads its
Hessenberg column and ||w|| to the host in one transfer, where the Givens
rotations and, at a cycle's end, the small triangular solve run in the
vector dtype. The recurrence and counts are the JAX package's: every cycle
takes all R steps, convergence is tested between cycles on |g[R]| (the
reference's, itsol_functions.hpp:1133-1160), and the returned count is
cycles * R. Real dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.spmv_bwd import spmv_bwd_any
from ..utils import collectives as coll
from .cg import _apply_precond, _halo_setup, _pad_vec, _prep_precond, _replicated_rows, _result, _scalar, _spill, _values
from .placement import Mesh, P
from .spmv import _vec_dtype, _x_for

__all__ = ["gmres_bwd_jit", "dist_gmres_bwd", "dist_gmres_bwd_halo"]

_HOST = {torch.float32: np.float32, torch.float64: np.float64}


def _gmres_loop(matvec, b, x0, rtol, atol, R: int, maxcycles: int, red=None, prec=None):
    """The restarted loop. `red(t)` sums a tensor over the ranks (an
    all-reduce on a mesh; None: local). `prec` is the right
    preconditioner (x += M^-1 V^T y). Returns (x, cycles, |g[R]|)."""
    dt, dev = b.dtype, b.device
    if dt not in _HOST:
        raise ValueError(f"GMRES here takes real f32 or f64 vectors, got {dt}")
    hdt = _HOST[dt]
    tiny = hdt(np.finfo(hdt).tiny * 1e3)
    red = red or (lambda t: t)
    prec = prec or (lambda v: v)

    def nrm(v):
        return torch.sqrt(red(torch.sum(v * v)))

    rt, at = _scalar(rtol, b), _scalar(atol, b)
    brtol = rt * nrm(b)
    x = x0
    rnorm = nrm(b - matvec(x0))
    mask = torch.arange(R + 1, device=dev)
    ncyc = 0
    while ncyc < maxcycles and bool((rnorm > at) & (rnorm > brtol)):  # a cycle's host read
        with coll.loop_body(ncyc):
            r0 = b - matvec(x)
            beta_t = nrm(r0)
            V = torch.zeros((R + 1, b.shape[0]), dtype=dt, device=dev)
            V[0] = r0 / torch.clamp(beta_t, min=float(tiny))
            H = np.zeros((R + 1, R), dtype=hdt)
            g = np.zeros(R + 1, dtype=hdt)
            g[0] = hdt(beta_t.item())
            c = np.zeros(R, dtype=hdt)
            s = np.zeros(R, dtype=hdt)
            for j in range(R):
                with coll.loop_body(j):
                    w = matvec(prec(V[j]))
                    hc = red(V @ w)  # the whole projection in ONE reduction
                    hc = torch.where(mask <= j, hc, torch.zeros((), dtype=dt, device=dev))
                    w = w - hc @ V
                    hh_t = nrm(w)
                    V[j + 1] = w / torch.clamp(hh_t, min=float(tiny))
                    col = torch.cat([hc, hh_t[None]]).cpu().numpy()  # the step's host read
                hcol = col[: R + 1].astype(hdt)
                hcol[j + 1] = col[R + 1]
                for i in range(j):  # the previous rotations
                    r1, r2 = hcol[i], hcol[i + 1]
                    hcol[i] = c[i] * r1 + s[i] * r2
                    hcol[i + 1] = -s[i] * r1 + c[i] * r2
                denom = max(np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2), tiny)
                c[j], s[j] = hcol[j] / denom, hcol[j + 1] / denom
                hcol[j], hcol[j + 1] = denom, 0
                H[:, j] = hcol
                gj = g[j]
                g[j], g[j + 1] = c[j] * gj, -s[j] * gj
            Hs = H[:R, :R] + np.eye(R, dtype=hdt) * tiny
            y = np.zeros(R, dtype=hdt)
            for i in range(R - 1, -1, -1):  # back substitution, upper triangular
                y[i] = (g[i] - Hs[i, i + 1 :] @ y[i + 1 :]) / Hs[i, i]
            x = x + prec(torch.from_numpy(y).to(dev) @ V[:R])
            rnorm = torch.tensor(abs(g[R]), dtype=dt, device=dev)
        ncyc += 1
    return x, ncyc, rnorm


def gmres_bwd_jit(win_val, b, x0, rtol, atol, R: int, maxcycles: int, W: int, base8: int, padL: int, n_pad: int,
                  sp_ind=None, sp_rows=None, sp_val=None, sp_gptr=None):
    """Restarted GMRES over the group-window operand, matvec on kernel #4
    with the peel spill in the same launch. R is the restart length. W and
    n_pad are kept for the JAX signature. Returns (x, cycles, rnorm)."""
    sv, si, sr, gp = _spill(sp_ind, sp_rows, sp_val, win_val.shape[0], win_val.device, sp_gptr)
    b = _x_for(win_val, _values(b, win_val.device))

    def matvec(v):
        return spmv_bwd_any(win_val, v, base8, padL, b.shape[0], sv, si, sr, gp)

    return _gmres_loop(matvec, b, _values(x0, b.device).to(b), rtol, atol, int(R), int(maxcycles))


def dist_gmres_bwd(mesh: Mesh, form, b, x0=None, rtol: float = 1e-8, atol: float = 0.0, restart: int = 20,
                   maxit: int = 150, axis: str = "x"):
    """Distributed restarted GMRES over a ``bwd`` form: its groups
    row-sharded (kernel #4 on each rank's, the blocks all-gathered), vectors
    replicated. Returns (x, cycles * restart, rnorm), x replicated."""
    ndev = mesh.shape[axis]
    m_pad = -(-form.bwd_val.shape[0] // ndev) * ndev * 8
    dt = _vec_dtype(form.bwd_val)
    bp = _pad_vec(b, m_pad, dt, mesh, P())
    x0p = torch.zeros_like(bp) if x0 is None else _pad_vec(x0, m_pad, dt, mesh, P())
    R = int(restart)
    x, ncyc, rn = _gmres_loop(_replicated_rows(mesh, form, m_pad), bp, x0p, rtol, atol, R, max(1, -(-int(maxit) // R)))
    return x[: form.m], int(ncyc) * R, float(rn)


def dist_gmres_bwd_halo(mesh: Mesh, form, b, x0=None, rtol: float = 1e-8, atol: float = 0.0, restart: int = 20,
                        maxit: int = 150, axis: str = "x", dinv=None):
    """Distributed restarted GMRES with a sharded Krylov basis and the band
    halos: every vector (b, x, r, the rows of V) is row-sharded, so a rank
    stores O(R n / P). An Arnoldi step moves the W-wide halos of V[j] (two
    ppermutes in the halo matvec on kernel #4), the whole CGS projection as
    ONE all-reduce of an (R+1)-vector, and one scalar all-reduce for the
    normalisation, independent of n.

    `dinv` (optional) adds shard-local right preconditioning (Jacobi for a
    length-m array, block-Jacobi for (m_pad/nb, nb, nb) block inverses): the
    Arnoldi operator is A M^-1 and a cycle's correction is M^-1 (V^T y), so
    the tracked residual stays the true one. Same contract as
    dist_cg_bwd_halo (spill-free band form, halo narrower than one shard,
    real dtypes). Returns (x Shard, cycles * restart, rnorm)."""
    matvec, bl, xl, m, m_pad = _halo_setup(mesh, form, b, x0, axis)
    dl, kind = _prep_precond(dinv, mesh, axis, m, m_pad, bl.dtype)
    R = int(restart)
    x, ncyc, rn = _gmres_loop(matvec, bl, xl, rtol, atol, R, max(1, -(-int(maxit) // R)),
                              red=lambda t: coll.all_reduce(t, mesh), prec=lambda v: _apply_precond(kind, dl, v))
    return _result(mesh, x, m), int(ncyc) * R, float(rn)
