"""CG loops over the band, window and padded-ELL forms, and their
distributed forms (the JAX package's parallel/cg.py).

The JAX package compiles each loop into one `lax.while_loop`. Here the
loops are Python, as in the port's solvers/fused.py: every iteration
launches its work on the current stream and reads back to the host only
what its stopping test needs (one read an iteration). The update order and
the count of reductions an iteration are the JAX package's: r = A x - b,
p = beta p - z, alpha = rz / pq (the reference CG task machine,
itsol_functions.hpp:619-870); the classic halo loop fuses its dots into 2
all-reduces an iteration, the pipelined loop into 1.

The matvecs:

- `cg_bwd_jit`, `dist_cg_bwd`, `dist_cg_bwd_halo`, `dist_cg_pipelined`: the
  group-window kernel of the ``bwd`` form (kernels/spmv_bwd.py, #4), its
  peel spill added in the same launch;
- `cg_bandv_jit`: the band kernel (kernels/band_spmv.py; #1 on an f32
  band, #2 on a bf16 one), where the JAX package runs its vertical-layout
  Pallas band kernel;
- `cg_ell_jit`, `dist_cg`, `dist_cg_ell_halo`: plain padded-ELL reduces, the
  JAX package's XLA formulation.

Every loop marks its iterations for the collective ledger
(utils/collectives.py `loop_body`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.context import resolve_device
from ..kernels.band_spmv import band_spmv
from ..kernels.spmv_bwd import spill_group_ptr, spmv_bwd_any
from ..utils import collectives as coll
from .placement import Mesh, P, Shard, fetch, local, put
from .spmv import (
    _band_rows,
    _bwd_halo_matvec,
    _check_band,
    _ell_rows,
    _general_halo_matvec,
    _halo_geometry,
    _halo_plan_operands,
    _np,
    _vec_dtype,
    _win_args,
    _x_for,
)

__all__ = [
    "cg_ell_jit",
    "cg_bandv_jit",
    "cg_bwd_jit",
    "dist_cg",
    "dist_cg_bwd",
    "dist_cg_bwd_halo",
    "dist_cg_pipelined",
    "dist_cg_ell_halo",
    "prepare_dist_ell",
]


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=like.dtype)
    return torch.tensor(float(np.asarray(v)), dtype=like.dtype, device=like.device)


def _cg_loop(matvec, b, x0, rtol, atol, maxit: int, dots=None, prec=None):
    """The classic CG loop. `dots(*pairs)` returns the sums of u * v of each
    pair in one reduction (an all-reduce on a mesh, local otherwise). With
    no preconditioner and local dots, r.r doubles as ||r||^2 (2 reductions
    an iteration); otherwise (rz, rr) ride one fused reduction, and p.q
    another. Returns (x, iterations, ||r|| as a 0-d tensor)."""
    fused = dots is not None or prec is not None
    if dots is None:
        def dots(*pairs):
            return torch.stack([torch.sum(u * v) for u, v in pairs])
    if prec is None:
        def prec(r):
            return r
    rt, at = _scalar(rtol, b), _scalar(atol, b)
    brtol = rt * torch.sqrt(dots((b, b))[0])
    r = matvec(x0) - b
    if fused:
        z = prec(r)
        rz, rr = dots((r, z), (r, r))
    else:
        z = r
        rz = rr = dots((r, r))[0]
    x, p = x0, torch.zeros_like(x0)
    rz_prev = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    while k < maxit:
        rnorm = torch.sqrt(rr)
        if not bool((rnorm > at) & (rnorm > brtol)):  # the one host read
            break
        with coll.loop_body(k):
            beta = torch.zeros_like(rz) if k == 0 else rz / rz_prev
            p = beta * p - z
            q = matvec(p)
            alpha = rz / dots((p, q))[0]
            x = x + alpha * p
            r = r + alpha * q
            if fused:
                z = prec(r)
                rz_prev, (rz, rr) = rz, dots((r, z), (r, r))
            else:
                z = r
                rz_prev, rz = rz, dots((r, r))[0]
                rr = rz
        k += 1
    return x, k, torch.sqrt(rr)


def _mesh_dots(mesh: Mesh):
    """dots(*pairs): the local sums of every pair in ONE all-reduce."""

    def dots(*pairs):
        return coll.all_reduce(torch.stack([torch.sum(u * v) for u, v in pairs]), mesh)

    return dots


def _gptr(sp_rows, nblk: int, device) -> torch.Tensor:
    rows = sp_rows.detach().cpu().numpy() if isinstance(sp_rows, torch.Tensor) else np.asarray(sp_rows)
    return torch.from_numpy(spill_group_ptr(rows, nblk)).to(device)


def _spill(sp_ind, sp_rows, sp_val, nblk: int, device, sp_gptr=None):
    """The spill operands of kernel #4 on `device`, with its group pointer
    (None where the form has no spill)."""
    if sp_ind is None or int(sp_ind.shape[0]) == 0:
        return None, None, None, None
    t = [torch.as_tensor(_np(a)).to(device) for a in (sp_val, sp_ind, sp_rows)]
    t[1], t[2] = t[1].long(), t[2].long()
    gp = sp_gptr.to(device) if sp_gptr is not None else _gptr(sp_rows, nblk, device)
    return t[0], t[1], t[2], gp


def cg_bwd_jit(win_val, b, x0, rtol, atol, maxit: int, W: int, base8: int, padL: int, n_pad: int,
               sp_ind=None, sp_rows=None, sp_val=None, sp_gptr=None):
    """CG over the group-window operand: the matvec is kernel #4 with the
    form's peel spill in the same launch (sp_*, may be None; sp_gptr the
    spill's group pointer, built here when not given). W and n_pad are
    kept for the JAX signature: the kernel reads x outside [0, n) as zero.
    Returns (x, iterations, ||r||)."""
    sv, si, sr, gp = _spill(sp_ind, sp_rows, sp_val, win_val.shape[0], win_val.device, sp_gptr)
    b = _x_for(win_val, _values(b, win_val.device))

    def matvec(v):
        return spmv_bwd_any(win_val, v, base8, padL, v.shape[0], sv, si, sr, gp)

    return _cg_loop(matvec, b, _values(x0, b.device).to(b), rtol, atol, int(maxit))


def cg_bandv_jit(vt4, b, x0, rtol, atol, maxit: int, W: int, padL: int, start: int, TM: int = 2048,
                 sp_ind=None, sp_rows=None, sp_val=None, interpret: bool = False):
    """CG whose matvec is the band kernel (#1 on an f32 band, #2 on a bf16
    one) over the (W, m) band `vt4` (a ``bandt`` form's `bwd_val`, or its
    `band_bf16()`), plus the peel spill. The JAX package passes its
    vertical tile layout here; TM and interpret have no counterpart and
    are accepted for its signature. Returns (x, iterations, ||r||)."""
    if vt4.shape[0] != W:
        raise ValueError(f"band has {vt4.shape[0]} rows, W={W}")
    b = _x_for(vt4, _values(b, vt4.device))
    spilled = sp_ind is not None and int(sp_ind.shape[0]) > 0

    def matvec(v):
        y = band_spmv(vt4, v, start, padL)[: v.shape[0]].to(v.dtype)
        if spilled:
            y = y.index_add(0, sp_rows, (sp_val * v[sp_ind]).to(y.dtype))
        return y

    return _cg_loop(matvec, b, _values(x0, b.device).to(b), rtol, atol, int(maxit))


def cg_ell_jit(ell_ind, ell_val, b, x0, rtol, atol, maxit: int, device=None):
    """CG on a padded-ELL operand, the reference CG task order. A tensor
    `ell_val` sets the device; host arrays go to `device` (cuda:0 when
    None). Returns (x, iterations, ||r||)."""
    ell_val = _values(ell_val, resolve_device(device))
    b = _values(b, ell_val.device).to(ell_val.dtype)
    x0 = _values(x0, b.device).to(b)
    ell_ind = _values(ell_ind, b.device)
    return _cg_loop(lambda v: _ell_rows(ell_ind, ell_val, v), b, x0, rtol, atol, int(maxit))


def prepare_dist_ell(mesh: Mesh, ell_ind, ell_val, axis: str = "x"):
    """Row-shard the padded-ELL operand; pad rows to a rank multiple.
    Returns (ind Shard, val Shard, m_pad)."""
    from .spmv import shard_ell

    return shard_ell(mesh, ell_ind, ell_val, axis)


def _prep_precond(dinv, mesh: Mesh, axis: str, m: int, m_pad: int, dtype):
    """This rank's part of a shard-local preconditioner: (operand, kind),
    kind None / "diag" (a length-m or m_pad Jacobi array, zero-padded) /
    "block" ((m_pad/nb, nb, nb) block inverses, parallel/precond.py; the
    block count must split over the ranks)."""
    if dinv is None:
        return None, None
    d = _np(dinv)
    if d.ndim == 1:
        if d.shape[0] not in (m, m_pad):
            raise ValueError(f"Jacobi dinv must have length m={m} (or m_pad={m_pad}), got {d.shape[0]}")
        dv = np.zeros(m_pad, dtype=np.float64)
        dv[: d.shape[0]] = d
        return put(dv, mesh, P(axis)).local.to(dtype), "diag"
    if d.ndim == 3:
        nblk, nb, nb2 = d.shape
        if nb != nb2 or nblk * nb != m_pad:
            raise ValueError("block dinv must be (m_pad/nb, nb, nb)")
        if nblk % mesh.shape[axis]:
            raise ValueError("block count must divide evenly over the mesh axis")
        return put(d, mesh, P(axis, None, None)).local.to(dtype), "block"
    raise ValueError("dinv must be 1-D (Jacobi) or 3-D (block-Jacobi)")


def _apply_precond(kind, dl, r):
    """Shard-local z = M^-1 r for the kinds of _prep_precond."""
    if kind is None:
        return r
    if kind == "diag":
        return dl * r
    nb = dl.shape[1]
    return torch.bmm(dl, r.reshape(-1, nb, 1)).reshape(-1)


def _pad_vec(v, m_pad: int, dtype, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's part, by spec, of a vector zero-padded to m_pad: a host
    array, a tensor, or a Shard (whose blocks are used as they are when
    they already split m_pad)."""
    if isinstance(v, Shard):
        if spec != P() and v.dim == 0 and v.local.shape[0] * mesh.size == m_pad:
            return v.local.to(dtype)
        v = fetch(v, mesh)
    if isinstance(v, torch.Tensor):
        v = torch.nn.functional.pad(v.to(dtype), (0, m_pad - v.shape[0]))
    else:
        v = np.pad(np.asarray(v), (0, m_pad - np.shape(v)[0]))
    return local(v, mesh, spec).to(dtype)


def _values(a, device) -> torch.Tensor:
    """A tensor as it is; a host array as a tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _halo_setup(mesh: Mesh, form, b, x0, axis: str):
    """The halo loops' operands: (matvec, b_loc, x0_loc, m, m_pad)."""
    _check_band(form)
    ndev = mesh.shape[axis]
    m = form.m
    m_pad = -(-m // (8 * ndev)) * 8 * ndev
    _W, rel_lo, HL, HR, _mloc = _halo_geometry(form, m_pad, ndev)
    matvec = _bwd_halo_matvec(mesh, rel_lo, HL, HR)
    band = _band_rows(form, mesh, m_pad // 8)
    dt = _vec_dtype(band)
    bl = _pad_vec(b, m_pad, dt, mesh, P(axis))
    xl = torch.zeros_like(bl) if x0 is None else _pad_vec(x0, m_pad, dt, mesh, P(axis))
    return (lambda v: matvec(band, v)), bl, xl, m, m_pad


def _result(mesh: Mesh, x_loc: torch.Tensor, m: int):
    return Shard(x_loc, mesh.rank * x_loc.shape[0], (m,), 0)


def _replicated_rows(mesh: Mesh, form, m_pad: int):
    """dist_cg_bwd's matvec: kernel #4 on this rank's groups (their peel
    spill in the same launch) over the replicated vector, the blocks
    all-gathered."""
    band = _band_rows(form, mesh, m_pad // 8)
    gloc = band.shape[0]
    g_lo = mesh.rank * gloc
    off = 8 * (g_lo + form.bwd_base8) - form.bwd_padL
    sp = (None, None, None, None)
    if form.sp_ind is not None and int(form.sp_ind.shape[0]):
        rows = _np(form.sp_rows).astype(np.int64)
        keep = (rows >= 8 * g_lo) & (rows < 8 * (g_lo + gloc))
        sp = _spill(_np(form.sp_ind)[keep], rows[keep] - 8 * g_lo, _np(form.sp_val)[keep], gloc, mesh.device)

    def matvec(v):
        y = spmv_bwd_any(band, v, *_win_args(off), 8 * gloc, *sp)
        return coll.all_gather(y, mesh)

    return matvec


def dist_cg_bwd(mesh: Mesh, form, b, x0=None, rtol: float = 1e-8, atol: float = 0.0, maxit: int = 500,
                axis: str = "x"):
    """Distributed CG over a ``bwd`` form: its groups row-sharded, vectors
    replicated; each matvec runs kernel #4 on the rank's groups and
    all-gathers the blocks. Returns (x, iterations, ||r||), x replicated."""
    ndev = mesh.shape[axis]
    nblk = form.bwd_val.shape[0]
    m_pad = -(-nblk // ndev) * ndev * 8
    dt = _vec_dtype(form.bwd_val)
    bp = _pad_vec(b, m_pad, dt, mesh, P())
    x0p = torch.zeros_like(bp) if x0 is None else _pad_vec(x0, m_pad, dt, mesh, P())
    x, k, rn = _cg_loop(_replicated_rows(mesh, form, m_pad), bp, x0p, rtol, atol, int(maxit))
    return x[: form.m], int(k), float(rn)


def dist_cg_bwd_halo(mesh: Mesh, form, b, x0=None, rtol: float = 1e-8, atol: float = 0.0, maxit: int = 500,
                     axis: str = "x", dinv=None):
    """Distributed CG with fully sharded vectors and the band halos inside
    the loop: per iteration each rank moves the W-wide boundary windows of p
    over the ring (the halo matvec on kernel #4) and two all-reduces (p.q;
    r.z and r.r fused into one).

    `dinv` (optional) preconditions shard-locally with no collective: a
    length-m array is Jacobi, an (m_pad/nb, nb, nb) array of block inverses
    (parallel/precond.py block_jacobi_inv) block-Jacobi. Convergence on
    ||r||_2. Contract: square spill-free band form (ValueError otherwise),
    halo narrower than one shard. Returns (x Shard, iterations, ||r||)."""
    matvec, bl, xl, m, m_pad = _halo_setup(mesh, form, b, x0, axis)
    dl, kind = _prep_precond(dinv, mesh, axis, m, m_pad, bl.dtype)
    x, k, rn = _cg_loop(matvec, bl, xl, rtol, atol, int(maxit), dots=_mesh_dots(mesh),
                        prec=lambda r: _apply_precond(kind, dl, r))
    return _result(mesh, x, m), int(k), float(rn)


def dist_cg_pipelined(mesh: Mesh, form, b, x0=None, rtol: float = 1e-8, atol: float = 0.0, maxit: int = 500,
                      axis: str = "x", dinv=None):
    """Distributed pipelined CG (the Ghysels-Vanroose single-reduction
    variant) over the band-halo matvec: an iteration's dots ride ONE
    all-reduce, started before the matvec q = A w, which does not depend on
    it, so the halo transfers and kernel #4 run while it is on the wire.

    Recurrence (unpreconditioned): g = (r, r), d = (w, r) [one all-reduce];
    q = A w; beta = g / g_prev; alpha = g / (d - beta g / alpha_prev);
    z <- q + beta z; s <- w + beta s; p <- r + beta p; x <- x + alpha p;
    r <- r - alpha s; w <- w - alpha z. Convergence on the g of the previous
    reduction (the pipelining lag): an iteration whose g is already within
    the tolerance stops before its update.

    `dinv` switches to the preconditioned recurrence with a shard-local
    M^-1 (Jacobi or block-Jacobi, as in dist_cg_bwd_halo): its three dots
    (r, u), (w, u), (r, r) ride the same one all-reduce; convergence on
    (r, r). Same contract as dist_cg_bwd_halo. Returns (x Shard,
    iterations, ||r||)."""
    matvec, bl, xl, m, m_pad = _halo_setup(mesh, form, b, x0, axis)
    dl, kind = _prep_precond(dinv, mesh, axis, m, m_pad, bl.dtype)
    rt, at = _scalar(rtol, bl), _scalar(atol, bl)

    def dots_async(*pairs):
        return coll.all_reduce(torch.stack([torch.sum(u * v) for u, v in pairs]), mesh, async_op=True)

    def ar(v):
        return coll.all_reduce(v, mesh)

    brtol = rt * torch.sqrt(ar(torch.sum(bl * bl)))
    r = bl - matvec(xl)
    zv = torch.zeros_like(xl)
    rn0sq = ar(torch.sum(r * r))
    tolsq = torch.maximum(at, brtol) ** 2
    x, k = xl, 0
    z = s = p = zv
    one = torch.ones_like(rn0sq)
    g_old, a_old = one, one
    if kind is None:
        w = matvec(r)
        go = bool(rn0sq > tolsq)
        while go and k < maxit:
            with coll.loop_body(k):
                pend = dots_async((r, r), (w, r))  # ONE collective an iteration ...
                q = matvec(w)  # ... on the wire while the matvec runs
                g, d = pend.wait()
                if bool(g <= tolsq):  # the one host read: converged, no update
                    break
                beta = torch.zeros_like(g) if k == 0 else g / g_old
                alpha = g / (d - beta * g / (one if k == 0 else a_old))
                z = q + beta * z
                s = w + beta * s
                p = r + beta * p
                x = x + alpha * p
                r = r - alpha * s
                w = w - alpha * z
                g_old, a_old = g, alpha
            k += 1
    else:
        u = _apply_precond(kind, dl, r)
        w = matvec(u)
        q = zv
        go = bool(rn0sq > tolsq)
        while go and k < maxit:
            with coll.loop_body(k):
                pend = dots_async((r, u), (w, u), (r, r))  # ONE collective ...
                mh = _apply_precond(kind, dl, w)
                nh = matvec(mh)  # ... overlapped with the matvec
                g, d, rho = pend.wait()
                if bool(rho <= tolsq):
                    break
                beta = torch.zeros_like(g) if k == 0 else g / g_old
                alpha = g / (d - beta * g / (one if k == 0 else a_old))
                z = nh + beta * z
                q = mh + beta * q
                s = w + beta * s
                p = u + beta * p
                x = x + alpha * p
                r = r - alpha * s
                u = u - alpha * q
                w = w - alpha * z
                g_old, a_old = g, alpha
            k += 1
    rnorm = torch.sqrt(ar(torch.sum(r * r)))
    return _result(mesh, x, m), int(k), float(rnorm)


def dist_cg(mesh: Mesh, ell_ind, ell_val, b, x0=None, rtol: float = 1e-8, atol: float = 0.0, maxit: int = 500,
            axis: str = "x"):
    """Distributed CG on a padded-ELL operand: rows and vectors sharded; each
    matvec all-gathers p and reduces the rank's rows, the dots are
    all-reduced. Returns (x Shard, iterations, ||r||)."""
    ind_s, val_s, m_pad = prepare_dist_ell(mesh, ell_ind, ell_val, axis)
    m = int(np.shape(b)[0]) if not isinstance(b, Shard) else b.shape[0]
    dt = val_s.local.dtype
    bl = _pad_vec(b, m_pad, dt, mesh, P(axis))
    xl = torch.zeros_like(bl) if x0 is None else _pad_vec(x0, m_pad, dt, mesh, P(axis))

    def matvec(v):
        return _ell_rows(ind_s.local, val_s.local, coll.all_gather(v, mesh))

    x, k, rn = _cg_loop(matvec, bl, xl, rtol, atol, int(maxit), dots=_mesh_dots(mesh))
    return _result(mesh, x, m), int(k), float(rn)


def dist_cg_ell_halo(mesh: Mesh, ell_ind, ell_val, b, x0=None, rtol: float = 1e-8, atol: float = 0.0,
                     maxit: int = 500, axis: str = "x", dinv=None):
    """Distributed CG on general structure with the plan-derived halo inside
    the loop: per iteration each rank packs the x entries its neighbours'
    rows reference (plan_general_halo), trades them in ONE all_to_all and
    reduces its padded-ELL rows; dots all-reduced, (rz, rr) fused; optional
    `dinv` (Jacobi / block-Jacobi) as in the band variants. Square
    operands. Returns (x Shard, iterations, ||r||)."""
    ndev = mesh.shape[axis]
    ell_ind = _np(ell_ind)
    m = int(b.shape[0]) if isinstance(b, Shard) else int(np.shape(b)[0])
    m_pad = -(-max(m, ell_ind.shape[0]) // ndev) * ndev
    ev = _values(ell_val, mesh.device)
    dt = ev.dtype
    if ell_ind.shape[0] != m_pad:
        ell_ind = np.pad(ell_ind, ((0, m_pad - ell_ind.shape[0]), (0, 0)), constant_values=-1)
        ev = torch.nn.functional.pad(ev, (0, 0, 0, m_pad - ev.shape[0]))
    ind, val, pidx = _halo_plan_operands(mesh, ell_ind, ev, m_pad, axis)
    bl = _pad_vec(b, m_pad, dt, mesh, P(axis))
    xl = torch.zeros_like(bl) if x0 is None else _pad_vec(x0, m_pad, dt, mesh, P(axis))
    dl, kind = _prep_precond(dinv, mesh, axis, m, m_pad, dt)
    mv = _general_halo_matvec(mesh)
    x, k, rn = _cg_loop(lambda v: mv(ind, val, pidx, v), bl, xl, rtol, atol, int(maxit), dots=_mesh_dots(mesh),
                        prec=lambda r: _apply_precond(kind, dl, r))
    return _result(mesh, x, m), int(k), float(rn)
