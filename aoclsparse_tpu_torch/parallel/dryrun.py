"""Spawning a world of ranks, and a dry run of every distributed path.

`spawn_world(fn, n, *args, backend=..., device=...)` starts n processes
(the spawn method: a parent that has initialised CUDA cannot fork), joins
each to a run through a file rendezvous in a fresh temporary directory,
calls `fn(mesh, *args)` on every rank and returns the ranks' results in
rank order (`device` as in `init_multiprocess`: None is cuda:0 under gloo
and the rank's card under nccl; pass "cpu" for CPU shards); `start_world`
does the same and returns at once, its `join()` later. `fn` must be
importable (module level). A rank that raises fails the call.

`dryrun_multichip(n)` is the counterpart of the JAX package's
``__graft_entry__.py`` dry run: n CPU gloo ranks run every path of the
distributed layer once on tiny operands and hold each result against the
port's single-process answer on the same operand. Returns {path: max
error}; raises AssertionError when one exceeds the float64 tolerance.

    python -c "from aoclsparse_tpu_torch.parallel import dryrun_multichip; print(dryrun_multichip(4))"
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

__all__ = ["World", "dryrun_multichip", "spawn_world", "start_world"]


def _rank_main(rank, nprocs, fn, args, backend, device, tmp, timeout_s):
    from .multiproc import global_mesh, init_multiprocess, shutdown

    init_multiprocess(f"file://{os.path.join(tmp, 'rdv')}", nprocs, rank, backend=backend, device=device,
                      timeout_s=timeout_s)
    try:
        out = fn(global_mesh(), *args)
    finally:
        shutdown()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class World:
    """Ranks started by `start_world`; `join()` waits for them and returns
    their results in rank order (a rank that raised raises here, and the
    others are stopped)."""

    def __init__(self, ctx, tmp, nprocs):
        self._ctx, self._tmp, self._nprocs = ctx, tmp, nprocs

    def join(self):
        try:
            while not self._ctx.join():
                pass
            out = []
            for r in range(self._nprocs):
                with open(os.path.join(self._tmp.name, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))  # written by this world's ranks
            return out
        finally:
            self._tmp.cleanup()


def start_world(fn, nprocs: int, *args, backend: str = "gloo", device=None, timeout_s: float = 300.0) -> World:
    """Start fn(mesh, *args) on `nprocs` spawned ranks; returns at once."""
    tmp = tempfile.TemporaryDirectory(prefix="aoclsparse_world_")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(nprocs, fn, args, backend, device, tmp.name, timeout_s), nprocs=nprocs, join=False,
        start_method="spawn",
    )
    return World(ctx, tmp, nprocs)


def spawn_world(fn, nprocs: int, *args, backend: str = "gloo", device=None, timeout_s: float = 300.0):
    """Run fn(mesh, *args) on `nprocs` spawned ranks; return their results."""
    return start_world(fn, nprocs, *args, backend=backend, device=device, timeout_s=timeout_s).join()


def _band(m: int, half: int, seed: int, shift: float):
    """Banded matrix with entries in |i - j| <= half, diagonal + shift: CSR."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 2 * half + 1)
    cols = rows + np.tile(np.arange(-half, half + 1), m)
    ok = (cols >= 0) & (cols < m)
    rows, cols = rows[ok], cols[ok]
    val = rng.standard_normal(rows.size)
    val[rows == cols] += shift
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m))])
    return ptr, cols, val


def _dryrun_rank(mesh):
    """Every path once on tiny operands against the single-process port."""
    import aoclsparse_tpu_torch as tt

    from . import (
        block_jacobi_inv,
        dist_cg_bwd_halo,
        dist_cg_ell_halo,
        dist_cg_pipelined,
        dist_gmres_bwd_halo,
        dist_ilu_apply,
        dist_spgemm_numeric,
        dist_spmm_bwd_halo,
        dist_spmv_bwd_halo,
        dist_spmv_bwd_halo_overlap,
        dist_spmv_ell_halo_plan,
        dist_symgs,
        dist_trsm,
        dist_trsv_levels,
        dist_trsv_pipeline,
        fetch,
        put,
    )
    from ..ops.level3.spgemm import _effective, _symbolic
    from ..planner.plan import get_plan
    from ..planner.triangular import trsv_form_for, trsv_level_form_for
    from .placement import P

    dev, n = mesh.device, mesh.size
    gen, none = tt.MatrixDescriptor(), tt.Operation.none
    lower = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
    m = 64 * n
    ptr, ind, val = _band(m, 3, 5, 12.0)
    dense = np.zeros((m, m))
    dense[np.repeat(np.arange(m), np.diff(ptr)), ind] = val
    spd = (dense + dense.T) / 2
    msk = spd != 0
    sptr = np.concatenate([[0], np.cumsum(msk.sum(1))])
    sind, sym_val = np.nonzero(msk)[1], spd[msk]
    A = tt.create_csr(m, m, ptr, ind, val, device=dev)
    S = tt.create_csr(m, m, sptr, sind, sym_val, device=dev)
    x = np.random.default_rng(1).standard_normal(m)
    xd = torch.from_numpy(x).to(dev)
    err = {}

    def rel(got, want):
        got, want = np.asarray(got), np.asarray(want)
        return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0))

    plan, splan = get_plan(A), get_plan(S)
    fb = plan.exec_form_for(gen, none, kind="bwd")
    want = fetch(tt.mv(1.0, A, gen, none, xd, 0.0))
    err["dist_spmv_bwd_halo"] = rel(fetch(dist_spmv_bwd_halo(mesh, fb, put(x, mesh, P("x"))), mesh), want)
    err["dist_spmv_bwd_halo_overlap"] = rel(fetch(dist_spmv_bwd_halo_overlap(mesh, fb, put(x, mesh, P("x"))), mesh),
                                            want)
    fg = plan.exec_form_for(gen, none, kind="bwdg")
    Bm = np.random.default_rng(2).standard_normal((m, 3))
    mpad = -(-m // (fg.bwd_G * n)) * fg.bwd_G * n
    Bp = np.pad(Bm, ((0, mpad - m), (0, 0)))
    err["dist_spmm_bwd_halo"] = rel(fetch(dist_spmm_bwd_halo(mesh, fg, put(Bp, mesh, P("x", None))), mesh)[:m],
                                    dense @ Bm)
    fe = plan.exec_form_for(gen, none, kind="ell")
    err["dist_spmv_ell_halo_plan"] = rel(
        fetch(dist_spmv_ell_halo_plan(mesh, fe.ell_ind, fe.ell_val, put(x, mesh, P("x"))), mesh), want)
    fs = splan.exec_form_for(gen, none, kind="bwd")
    b = spd @ np.ones(m)
    xs = np.linalg.solve(spd, b)
    for name, fn in (("dist_cg_bwd_halo", dist_cg_bwd_halo), ("dist_cg_pipelined", dist_cg_pipelined)):
        xr, _k, _rn = fn(mesh, fs, b, rtol=1e-12, maxit=500)
        err[name] = rel(fetch(xr, mesh), xs)
    dblk = block_jacobi_inv(splan.effective_for(gen, none, S.dtype), 8, -(-m // (8 * n)) * 8 * n)
    xr, _k, _rn = dist_cg_bwd_halo(mesh, fs, b, rtol=1e-12, maxit=500, dinv=dblk)
    err["dist_cg_bwd_halo(block-Jacobi)"] = rel(fetch(xr, mesh), xs)
    fse = splan.exec_form_for(gen, none, kind="ell")
    xr, _k, _rn = dist_cg_ell_halo(mesh, fse.ell_ind, fse.ell_val, b, rtol=1e-12, maxit=500)
    err["dist_cg_ell_halo"] = rel(fetch(xr, mesh), xs)
    bn = dense @ np.ones(m)
    xr, _it, _rn = dist_gmres_bwd_halo(mesh, fb, bn, rtol=1e-12, restart=20, maxit=400)
    err["dist_gmres_bwd_halo"] = rel(fetch(xr, mesh), np.ones(m))
    lw = trsv_form_for(plan, lower, none, nb=16)
    want_l = fetch(tt.trsv(1.0, A, lower, none, xd, kid=0))
    err["dist_trsv_pipeline"] = rel(fetch(dist_trsv_pipeline(mesh, lw, x)), want_l)
    err["dist_trsv_levels"] = rel(fetch(dist_trsv_levels(mesh, trsv_level_form_for(plan, lower, none), x)), want_l)
    Bk = np.random.default_rng(3).standard_normal((m, 2 * n))
    err["dist_trsm"] = rel(fetch(dist_trsm(mesh, lw, Bk), mesh),
                           fetch(tt.trsm(1.0, A, lower, none, torch.from_numpy(Bk).to(dev), kid=0)))
    want_ilu = fetch(tt.ilu_smoother(S, gen, torch.from_numpy(b).to(dev)))
    for engine in ("pipeline", "level"):
        err[f"dist_ilu_apply({engine})"] = rel(fetch(dist_ilu_apply(mesh, S, b, engine=engine)), want_ilu)
    want_gs = fetch(tt.symgs(none, S, gen, 1.0, torch.from_numpy(b).to(dev)))
    for engine in ("pipeline", "level"):
        err[f"dist_symgs({engine})"] = rel(fetch(dist_symgs(mesh, S, gen, 1.0, b, engine=engine)), want_gs)
    effA = _effective(A, gen, none)
    sp = _symbolic(effA, effA)
    err["dist_spgemm_numeric"] = rel(fetch(dist_spgemm_numeric(mesh, sp, effA.val, effA.val), mesh),
                                     _spgemm_ref(sp, dense))
    return err


def _spgemm_ref(plan, dense):
    """C's values on the plan's pattern from the dense product."""
    rows = np.repeat(np.arange(plan.shape[0]), np.diff(plan.ptr))
    return (dense @ dense)[rows, plan.ind]


def dryrun_multichip(n_devices: int = 4) -> dict:
    """n CPU gloo ranks through every distributed path on tiny operands,
    each against the single-process port. Returns {path: max error}."""
    from .. import native

    native.available()  # build the host library once, before the ranks start
    errs = spawn_world(_dryrun_rank, int(n_devices), backend="gloo", device="cpu")
    worst = {k: max(e[k] for e in errs) for k in errs[0]}
    bad = {k: v for k, v in worst.items() if not v <= 1e-9}
    if bad:
        raise AssertionError(f"distributed paths off the single-process answer: {bad}")
    return worst
