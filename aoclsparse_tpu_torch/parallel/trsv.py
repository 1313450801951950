"""Distributed triangular solves: the block-row pipeline and the sharded
level sweep (the JAX package's parallel/trsv.py).

- `dist_trsv_pipeline` / `dist_trsm_pipeline`: the blocked ``win`` form's
  inverted diagonal blocks and left windows are split over the ranks by
  block rows, and the WL-wide rolling solve window is handed to the next
  rank over the ring (ppermute). One right-hand side: rank d solves its
  chunk on tick d. Several: the columns flow through the ring in groups,
  rank d working on group t - d at tick t (a wavefront). A chunk's solve
  (`_local_chunk_scan`) is the JAX package's XLA scan, plain torch here: a
  loop over the chunk's blocks.
- `dist_trsv_levels`: the level-scheduled form's rows of every level are
  split over the ranks; each rank solves its part of a level
  (kernels/trsv_level.py `level_step`, plain torch) and ONE all_gather a
  level gives every rank the level's new entries. The level kernel solves
  the whole DAG in one launch, which per-level gathers cannot split, so
  this path stays on the plain step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.trsv_level import level_step
from ..utils import collectives as coll
from .placement import Mesh, P, Shard, local

__all__ = ["dist_trsv_pipeline", "dist_trsm_pipeline", "dist_trsv_levels", "pipeline_runner"]


def _rhs(b, dtype, device) -> torch.Tensor:
    t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(b))
    return t.to(device=device, dtype=dtype)


def _prep(mesh: Mesh, form, axis: str):
    """This rank's chunk of the win form: (Dinv chunk, Lwin chunk, ndev,
    nb, WL, nblk_pad), the block rows padded with identity blocks and zero
    windows to a rank multiple."""
    if form.kind != "win":
        raise ValueError("distributed pipeline requires the dense-window (win) form")
    ndev = mesh.shape[axis]
    nb, WL, nblk = form.nb, form.WL, form.nblk
    nblk_pad = -(-nblk // ndev) * ndev
    gloc = nblk_pad // ndev
    lo = mesh.rank * gloc
    hi = min(lo + gloc, nblk)
    dinvT, _ = form.operands()  # the inverted diagonal blocks, transposed
    Dinv = dinvT[lo:hi].transpose(1, 2).to(mesh.device)
    Lwin = form.Lval[lo:hi].to(mesh.device)
    if hi - lo < gloc:
        n = gloc - max(hi - lo, 0)
        eye = torch.eye(nb, dtype=Dinv.dtype, device=mesh.device).expand(n, nb, nb)
        Dinv = torch.cat([Dinv, eye])
        Lwin = torch.cat([Lwin, torch.zeros((n, nb, WL), dtype=Lwin.dtype, device=mesh.device)])
    return Dinv.contiguous(), Lwin.contiguous(), ndev, nb, WL, nblk_pad


def _local_chunk_scan(Dinv_c, Lwin_c, b_c, w0, nb: int, WL: int):
    """Sequential solve of this rank's block chunk given the incoming
    rolling window w0 (WL, k); returns (final window, solved (gloc nb, k))."""
    gloc = Dinv_c.shape[0]
    bs = b_c.reshape(gloc, nb, -1)
    w = w0
    xs = []
    for i in range(gloc):
        xk = Dinv_c[i] @ (bs[i] - Lwin_c[i] @ w)
        w = torch.cat([w, xk])[-WL:]
        xs.append(xk)
    return w, torch.cat(xs) if xs else b_c[:0]


def pipeline_runner(mesh: Mesh, axis: str, ndev: int, nb: int, WL: int, k: int):
    """The block-row ring pipeline on pre-placed chunks: (Dinv_c, Lwin_c,
    b_c) -> x_c, this rank's solved rows (gloc nb, k). Rank d solves on tick
    d; every tick hands the window one rank on (ppermute)."""

    def _run(Dinv_c, Lwin_c, b_c):
        w = torch.zeros((WL, k), dtype=Dinv_c.dtype, device=b_c.device)
        xs = torch.zeros_like(b_c)
        for t in range(ndev):
            with coll.loop_body(t):
                if mesh.rank == t:
                    w, xs = _local_chunk_scan(Dinv_c, Lwin_c, b_c, w, nb, WL)
                w = coll.ppermute(w, mesh, 1)
        return xs

    return _run


def dist_trsv_pipeline(mesh: Mesh, form, b, axis: str = "x"):
    """Solve the planner's blocked-lower (win) form with its block rows
    sharded over the ranks, the window handed on by ppermute. b: (m,) or
    (m, k). Returns x replicated on every rank."""
    Dinv, Lwin, ndev, nb, WL, nblk_pad = _prep(mesh, form, axis)
    m_pad = nblk_pad * nb
    b2 = _rhs(b, Dinv.dtype, mesh.device)
    squeeze = b2.dim() == 1
    if squeeze:
        b2 = b2[:, None]
    k = b2.shape[1]
    if form.reversed_:
        b2 = b2.flip(0)
    b2 = torch.nn.functional.pad(b2, (0, 0, 0, m_pad - b2.shape[0]))
    xs = pipeline_runner(mesh, axis, ndev, nb, WL, k)(Dinv, Lwin, local(b2, mesh, P(axis, None)))
    x = coll.all_gather(xs, mesh)[: form.m]
    if form.reversed_:
        x = x.flip(0)
    return x[:, 0] if squeeze else x


def dist_trsm_pipeline(mesh: Mesh, form, B, axis: str = "x"):
    """Multi-RHS pipelined solve: the columns flow through the ring in one
    group a rank, so every rank works on a different group at once (a
    wavefront over ndev + ndev - 1 ticks). B: (m, k). Returns X replicated."""
    Dinv, Lwin, ndev, nb, WL, nblk_pad = _prep(mesh, form, axis)
    m_pad = nblk_pad * nb
    B2 = _rhs(B, Dinv.dtype, mesh.device)
    if B2.dim() != 2:
        raise ValueError("dist_trsm_pipeline expects a (m, k) RHS")
    if form.reversed_:
        B2 = B2.flip(0)
    k = B2.shape[1]
    ncg = ndev  # column groups = ranks keeps the pipeline full
    kc = -(-k // ncg)
    B2 = torch.nn.functional.pad(B2, (0, ncg * kc - k, 0, m_pad - B2.shape[0]))
    b_c = local(B2, mesh, P(axis, None))
    w = torch.zeros((WL, kc), dtype=Dinv.dtype, device=mesh.device)
    xs = torch.zeros_like(b_c)
    for t in range(ndev + ncg - 1):
        with coll.loop_body(t):
            cg = t - mesh.rank  # the column group this rank works on at tick t
            if 0 <= cg < ncg:
                w, xs[:, cg * kc:(cg + 1) * kc] = _local_chunk_scan(
                    Dinv, Lwin, b_c[:, cg * kc:(cg + 1) * kc], w, nb, WL)
            w = coll.ppermute(w.contiguous(), mesh, 1)
    X = coll.all_gather(xs, mesh)[: form.m, :k]
    return X.flip(0) if form.reversed_ else X


def _level_slices(mesh: Mesh, form):
    """This rank's slice of every level, per run: ((rows (nl, Rp)),
    (rows, rv, cols, cv, lv, di) of the slice), the runs' widths padded to
    a rank multiple (padding rows solve the scratch row m). Cached on the
    form for its values epoch."""
    key = (form.values_epoch, mesh.size, mesh.rank, str(mesh.device))
    cache = getattr(form, "_dist_levels", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    ndev, dev = mesh.size, mesh.device
    out = []
    for (rows, rv, cols, cv), (lv, di) in zip(form._run_struct, form._run_vals):
        nl, R = rows.shape
        Rp = -(-R // ndev) * ndev
        pad = Rp - R

        def padr(a, fill):
            if not pad:
                return a.to(dev)
            shape = (nl, pad) + tuple(a.shape[2:])
            return torch.cat([a.to(dev), torch.full(shape, fill, dtype=a.dtype, device=dev)], dim=1)

        full_rows = padr(rows, form.m)
        parts = (full_rows, padr(rv, False), padr(cols, 0), padr(cv, False), padr(lv, 0), padr(di, 1))
        Rl = Rp // ndev
        sl = slice(mesh.rank * Rl, (mesh.rank + 1) * Rl)
        out.append((full_rows, tuple(p[:, sl].contiguous() for p in parts)))
    form._dist_levels = (key, out)
    return out


def dist_trsv_levels(mesh: Mesh, form, b, axis: str = "x"):
    """Sharded level-scheduled solve for general structure: every rank
    solves its slice of each level at once, then ONE all_gather of the
    level's new entries (O(R_max) values) makes them visible for the next
    level. x stays replicated (any later level may read any row). b: (m,)
    or (m, k) on any device. Returns x replicated."""
    runs = _level_slices(mesh, form)
    dtype = form._run_vals[0][0].dtype if form._run_vals else form.lval.dtype
    b2 = _rhs(b, dtype, mesh.device)
    squeeze = b2.dim() == 1
    if squeeze:
        b2 = b2[:, None]
    if form.reversed_:
        b2 = b2.flip(0)
    k = b2.shape[1]
    m = form.m
    x = torch.zeros((m + 1, k), dtype=b2.dtype, device=mesh.device)
    bp = torch.cat([b2, torch.zeros((1, k), dtype=b2.dtype, device=mesh.device)])
    lvl = 0
    for full_rows, (r, rv, c, cv, lv, di) in runs:
        for i in range(full_rows.shape[0]):
            with coll.loop_body(lvl):
                xi = level_step(x, bp, r[i], rv[i], c[i], cv[i], lv[i], di[i])
                # ONE collective a level: every rank learns the level's entries
                x[full_rows[i]] = coll.all_gather(xi, mesh)
            lvl += 1
    x = x[:m]
    if form.reversed_:
        x = x.flip(0)
    return x[:, 0] if squeeze else x
