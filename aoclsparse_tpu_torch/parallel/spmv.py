"""Distributed SpMV and SpMM over a process-group mesh (the JAX package's
parallel/spmv.py).

Rows of the padded execution form are split over the mesh's ranks, one
block a rank. The JAX package maps each call over the devices with
shard_map; here every rank runs it on its own block, and the collectives of
utils/collectives.py replace ppermute, all_gather and all_to_all. Results
are `Shard`s (parallel/placement.py): the rank's block and its offset;
`fetch` reassembles them.

The local legs:

- the band halo (`_bwd_halo_matvec`, `dist_spmv_bwd_halo[_overlap]`): the
  group-window SpMV kernel of the ``bwd`` form (kernels/spmv_bwd.py,
  csrc/spmv_bwd.cu; its plain version on a CPU tensor) on the rank's
  groups, over the local x with the W-wide halos of its ring neighbours
  stitched on. The kernel reads x indices outside [0, n) as zero, so the
  window offsets pass as (base8, padL) and no padded copy is made;
- the group-band SpMM halo (`dist_spmm_bwd_halo`): mm KID 3's batched
  product (kernels/spmm_plain.py `spmm_bwd`), plain torch as in the port's
  mm, where the JAX package runs an XLA scan;
- the padded-ELL paths (replicated x, all-gathered x, nnz-balanced rows,
  the plan-derived general halo): plain gather-multiply-reduce, the JAX
  package's XLA formulations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.spmm_plain import spmm_bwd, spmm_ell
from ..kernels.spmv_bwd import spmv_bwd_any
from ..utils import collectives as coll
from .multiproc import global_mesh
from .placement import Mesh, P, Shard, fetch, put

__all__ = [
    "make_mesh",
    "shard_ell",
    "spmv_ell_runner",
    "dist_spmv_ell",
    "dist_spmv_ell_sharded_x",
    "dist_spmv_bwd_halo",
    "dist_spmv_bwd_halo_overlap",
    "dist_spmm_bwd_halo",
    "dist_spmv_ell_balanced",
    "plan_general_halo",
    "dist_spmv_ell_halo_plan",
    "dist_spmm_ell_halo_plan",
    "dist_spmv_balanced_halo",
    "compact_balanced",
]


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    """The mesh over the initialised run (parallel/multiproc.py): one rank a
    device. n_devices other than the world size raises invalid_value."""
    return global_mesh(axis, n_devices)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _is_index(a) -> bool:
    if isinstance(a, torch.Tensor):
        return not (a.is_floating_point() or a.is_complex())
    return np.issubdtype(a.dtype, np.integer)


def _pad_rows(a, m_pad: int):
    """Rows padded to m_pad: -1 for index arrays, 0 for values."""
    if a.shape[0] == m_pad:
        return a
    fill = -1 if _is_index(a) else 0
    if isinstance(a, torch.Tensor):
        pad = torch.full((m_pad - a.shape[0],) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
        return torch.cat([a, pad])
    return np.pad(a, [(0, m_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1), constant_values=fill)


def _loc(a) -> torch.Tensor:
    return a.local if isinstance(a, Shard) else a


def _ell_rows(ind, val, x) -> torch.Tensor:
    """Rows of a padded-ELL block (-1 padding) times x (n,) or (n, K)."""
    if x.dim() == 1:
        return spmm_ell(ind, val, x[:, None])[:, 0]
    return spmm_ell(ind, val, x)


def shard_ell(mesh: Mesh, ell_ind, ell_val, axis: str = "x"):
    """Pad the (m, w) padded-row arrays to a rank multiple and keep this
    rank's row block. Returns (ind Shard, val Shard, m_pad)."""
    n = mesh.shape[axis]
    m = ell_ind.shape[0]
    m_pad = -(-m // n) * n
    ind = put(_pad_rows(ell_ind, m_pad), mesh, P(axis, None))
    val = put(_pad_rows(ell_val, m_pad), mesh, P(axis, None))
    return ind, val, m_pad


def spmv_ell_runner(mesh: Mesh, axis: str = "x"):
    """The row-sharded, replicated-x ELL SpMV on pre-placed operands:
    (ind, val, x) -> y, the rank's rows as a Shard (parallel/sweeps.py
    composes sweeps from it)."""

    def _local(ind, val, xloc):
        y = _ell_rows(_loc(ind), _loc(val), _loc(xloc))
        off = ind.offset if isinstance(ind, Shard) else 0
        return Shard(y, off, (y.shape[0] * mesh.size,), 0)

    return _local


def dist_spmv_ell(mesh: Mesh, ell_ind, ell_val, x, axis: str = "x"):
    """y = A @ x with A row-sharded and x replicated: each rank reduces its
    row block, no collective."""
    xr = put(x, mesh, P())
    return spmv_ell_runner(mesh, axis)(ell_ind, ell_val, xr)


def dist_spmv_ell_sharded_x(mesh: Mesh, ell_ind, ell_val, x_sharded, axis: str = "x"):
    """y = A @ x with A's rows and x sharded: the x blocks are all-gathered
    before the local reduce."""
    xs = put(x_sharded, mesh, P(axis))
    xall = coll.all_gather(xs.local, mesh)
    return spmv_ell_runner(mesh, axis)(ell_ind, ell_val, xall)


def _win_args(off: int):
    """(base8, padL) that start group 0's window at x index `off` in the
    group-window kernel's contract (8 (b + base8) + t - padL)."""
    base8 = max(0, -(-off // 8))
    return base8, 8 * base8 - off


def _vec_dtype(band: torch.Tensor) -> torch.dtype:
    """The vector dtype of a band's kernel instance (f32 for a bf16 band)."""
    return torch.float32 if band.dtype == torch.bfloat16 else band.dtype


def _x_for(band: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x in the dtype the band's kernel instance takes."""
    return x.to(_vec_dtype(band)).contiguous()


def _bwd_kernel(band: torch.Tensor, x: torch.Tensor, off: int, rows: int) -> torch.Tensor:
    """`rows` rows of the group windows `band` over x, group 0's window at
    x index off: kernel #4 on the card, its plain version on the CPU."""
    if rows == 0:
        return torch.zeros(0, dtype=x.dtype, device=x.device)
    return spmv_bwd_any(band, _x_for(band, x), *_win_args(off), rows)


def _halos(mesh: Mesh, xloc: torch.Tensor, HL: int, HR: int, async_op: bool = False):
    """Start the two ring transfers of the band halo: the last HL entries to
    the right neighbour, the first HR to the left one. Returns a function
    that waits and gives (left, right), zero at the global edges."""
    pl = coll.ppermute(xloc[-HL:], mesh, 1, async_op=True) if HL else None
    pr = coll.ppermute(xloc[:HR], mesh, -1, async_op=True) if HR else None

    def wait():
        empty = xloc.new_zeros((0,) + tuple(xloc.shape[1:]))
        left = pl.wait() if pl is not None else empty
        right = pr.wait() if pr is not None else empty
        if HL and mesh.rank == 0:
            left = torch.zeros_like(left)  # the global left edge: padding
        if HR and mesh.rank == mesh.size - 1:
            right = torch.zeros_like(right)
        return left, right

    return wait if async_op else wait()


def _bwd_halo_matvec(mesh: Mesh, rel_lo: int, HL: int, HR: int):
    """The per-rank halo matvec `(band, xloc) -> y_loc` of the halo SpMV and
    the halo Krylov loops (geometry from `_halo_geometry`): the HL / HR
    boundary rows over the ring, the local x stitched between them, and
    kernel #4 over the rank's groups."""

    def matvec(band, xloc):
        left, right = _halos(mesh, xloc, HL, HR)
        xe = torch.cat([left, xloc, right]) if (HL or HR) else xloc
        return _bwd_kernel(band, xe, rel_lo + HL, xloc.shape[0])

    return matvec


def _check_band(form):
    if form.sp_ind is not None and int(form.sp_ind.shape[0]):
        raise ValueError("halo path requires a spill-free band form")


def _band_rows(form, mesh: Mesh, nblk_pad: int) -> torch.Tensor:
    """This rank's groups of the form's (ngrp, G, W) band on mesh.device,
    the global band zero-padded to nblk_pad groups."""
    wv = form.bwd_val
    gloc = nblk_pad // mesh.size
    lo, hi = mesh.rank * gloc, (mesh.rank + 1) * gloc
    part = wv[lo:min(hi, wv.shape[0])].to(mesh.device)
    if part.shape[0] < gloc:
        pad = torch.zeros((gloc - part.shape[0],) + tuple(wv.shape[1:]), dtype=wv.dtype, device=mesh.device)
        part = torch.cat([part, pad])
    return part.contiguous()


def _halo_geometry(form, m_pad: int, ndev: int):
    """(W, rel_lo, HL, HR, mloc) of a bwd form's band halo over `ndev`
    shards of m_pad rows: the window's offset from its group, the rows a
    shard needs from its left and right neighbours, and the shard's rows."""
    W = form.bwd_W
    rel_lo = 8 * form.bwd_base8 - form.bwd_padL
    HL, HR = max(0, -rel_lo), max(0, rel_lo + W - 8)
    mloc = m_pad // ndev
    if m_pad % (8 * ndev):
        raise ValueError(f"x must be padded to a multiple of 8 * {ndev} rows")
    if HL > mloc or HR > mloc:
        raise ValueError("halo wider than a shard: use the all-gather path")
    return W, rel_lo, HL, HR, mloc


def dist_spmv_bwd_halo(mesh: Mesh, form, x_sharded, axis: str = "x"):
    """Band SpMV with x sharded and only the band halos exchanged: each rank
    receives the W-wide boundary windows of its ring neighbours (two
    ppermutes, O(W) entries), stitches them around its x block and runs
    kernel #4 on its groups.

    Requires a square spill-free band form (ValueError otherwise) whose halo
    fits inside one neighbour shard; x_sharded is (m_pad,) over `axis`,
    m_pad a multiple of 8 * ranks. Returns y as a Shard."""
    _check_band(form)
    xs = put(x_sharded, mesh, P(axis))
    m_pad = xs.shape[0]
    _W, rel_lo, HL, HR, _mloc = _halo_geometry(form, m_pad, mesh.shape[axis])
    matvec = _bwd_halo_matvec(mesh, rel_lo, HL, HR)
    y = matvec(_band_rows(form, mesh, m_pad // 8), xs.local)
    return Shard(y, xs.offset, (m_pad,), 0)


def dist_spmv_bwd_halo_overlap(mesh: Mesh, form, x_sharded, axis: str = "x"):
    """dist_spmv_bwd_halo with the transfers overlapped: the halo sends are
    started first, kernel #4 runs the interior groups (whose windows lie in
    the local block) while they are on the wire, and after the wait two
    launches run the edge groups on the stitched x. Same contract; shards
    too small to have an interior take the unsplit path."""
    _check_band(form)
    xs = put(x_sharded, mesh, P(axis))
    m_pad = xs.shape[0]
    W, rel_lo, HL, HR, mloc = _halo_geometry(form, m_pad, mesh.shape[axis])
    gloc = mloc // 8
    g0 = max(0, -(-HL // 8))
    g1 = min(gloc, (mloc - rel_lo - W) // 8 + 1)
    if g1 <= g0:  # shard too small for an interior: nothing to overlap
        return dist_spmv_bwd_halo(mesh, form, xs, axis=axis)
    band = _band_rows(form, mesh, m_pad // 8)
    xloc = xs.local
    wait = _halos(mesh, xloc, HL, HR, async_op=True)
    y_int = _bwd_kernel(band[g0:g1], xloc, 8 * g0 + rel_lo, 8 * (g1 - g0))
    left, right = wait()
    xe = torch.cat([left, xloc, right])
    base = rel_lo + HL
    parts = []
    if g0:
        parts.append(_bwd_kernel(band[:g0], xe, base, 8 * g0))
    parts.append(y_int)
    if g1 < gloc:
        parts.append(_bwd_kernel(band[g1:], xe, base + 8 * g1, 8 * (gloc - g1)))
    return Shard(torch.cat(parts), xs.offset, (m_pad,), 0)


def _spmm_groups(band, B, G: int, W: int, g_start: int) -> torch.Tensor:
    """Groups of `band` times the rows of B, group 0's window at row
    G * g_start: mm KID 3's batched product, accumulated in f32 for f32 and
    bf16 bands, returned in the band's dtype."""
    ngrp = band.shape[0]
    if ngrp == 0:
        return torch.zeros(0, B.shape[1], dtype=band.dtype, device=B.device)
    acc = torch.float32 if band.dtype in (torch.float32, torch.bfloat16) else band.dtype
    need = G * (g_start + ngrp - 1) + W
    Bp = B.to(acc)
    if Bp.shape[0] < need:
        Bp = torch.nn.functional.pad(Bp, (0, 0, 0, need - Bp.shape[0]))
    return spmm_bwd(band.to(acc), Bp, G, W, g_start, Bp.shape[0]).to(band.dtype)


def dist_spmm_bwd_halo(mesh: Mesh, form, B_sharded, axis: str = "x"):
    """C = A @ B with A's group-band (bwdg) form and the dense B row-sharded:
    each rank trades only the band's boundary rows of B over the ring (two
    ppermutes), runs its interior groups (windows inside the local block)
    while they are on the wire, then the edge groups on the stitched rows.

    Contract: square spill-free bwdg form (ValueError otherwise), B_sharded
    (m_pad, K) over `axis` with m_pad a multiple of G * ranks and the halo
    narrower than one shard. Returns C as a Shard."""
    _check_band(form)
    ndev = mesh.shape[axis]
    Bs = put(B_sharded, mesh, P(axis, None))
    G, W, rel = form.bwd_G, form.bwd_W, form.bwd_rel
    m_pad, K = Bs.shape[0], Bs.shape[1]
    if m_pad % (G * ndev):
        raise ValueError("B rows must be padded to a multiple of G * n_devices")
    mloc = m_pad // ndev
    HL, HR = max(0, -rel), max(0, rel + W - G)
    if HL > mloc or HR > mloc:
        raise ValueError("halo wider than a shard: use a replicated-B path")
    ngl = mloc // G
    nslice = -(-W // G)
    gi0 = max(0, -(-HL // G))
    gi1 = min(ngl, mloc // G - rel // G - nslice + 1)
    band = _band_rows(form, mesh, m_pad // G)
    Bloc = Bs.local
    wait = _halos(mesh, Bloc, HL, HR, async_op=True)
    off = (rel + HL) // G  # stitched-row group of local group 0's window
    parts = []
    if gi1 > gi0:
        y_int = _spmm_groups(band[gi0:gi1], Bloc, G, W, gi0 + rel // G)
        left, right = wait()
        xe = torch.cat([left, Bloc, right])
        if gi0:
            parts.append(_spmm_groups(band[:gi0], xe, G, W, off))
        parts.append(y_int)
        if gi1 < ngl:
            parts.append(_spmm_groups(band[gi1:], xe, G, W, off + gi1))
    else:
        left, right = wait()
        parts.append(_spmm_groups(band, torch.cat([left, Bloc, right]), G, W, off))
    C = torch.cat(parts).reshape(mloc, K)
    return Shard(C, Bs.offset, (m_pad, K), 0)


def dist_spmv_ell_balanced(mesh: Mesh, ell_ind_stack, x, bounds, val_stack, axis: str = "x"):
    """Row-sharded SpMV over nnz-balanced parts (parallel/partition.py): rank
    d holds the (mloc, w) padded-ELL block of rows [bounds[d], bounds[d+1]).
    x replicated; returns the stacked padded (n_parts, mloc) result as a
    Shard (compact with the bounds)."""
    xr = put(x, mesh, P())
    ind = put(ell_ind_stack, mesh, P(axis, None, None)).local[0]
    val = put(val_stack, mesh, P(axis, None, None)).local[0]
    y = _ell_rows(ind, val, xr)
    return Shard(y[None], mesh.rank, (mesh.size, y.shape[0]), 0)


def plan_general_halo(ell_ind, ndev: int, n_loc: int):
    """Host planning of the general-sparsity halo exchange: from the
    row-sharded padded-ELL indices, which x entries each (src -> dst) pair
    must move, so a matvec trades O(halo) values in ONE all_to_all.

    ell_ind: (m_pad, w) global column indices, -1 padding, m_pad divisible
    by ndev; x is split uniformly into ndev shards of n_loc entries.
    Returns (ind_remap, pack_idx, S_max):
      - pack_idx (ndev, ndev, S_max): pack_idx[src, dst] = local positions
        (into src's x shard) of the entries src sends dst, zero-padded;
      - ind_remap (m_pad, w): per-rank local indices into the stitched
        [x_loc | recv(ndev, S_max)] buffer (-1 padding preserved)."""
    ell_ind = _np(ell_ind)
    m_pad, w = ell_ind.shape
    if m_pad % ndev:
        raise ValueError("ell rows must be padded to a device multiple")
    m_loc = m_pad // ndev
    valid_cols = ell_ind[ell_ind >= 0]
    if valid_cols.size and int(valid_cols.max()) >= ndev * n_loc:
        raise ValueError(
            f"column index {int(valid_cols.max())} outside the sharded x "
            f"(ndev*n_loc = {ndev * n_loc}); pad x / check operand width"
        )
    need = []  # need[dst][src] = sorted unique cols dst needs from src
    for d in range(ndev):
        sl = ell_ind[d * m_loc : (d + 1) * m_loc]
        cols = np.unique(sl[sl >= 0])
        owner = cols // n_loc
        need.append([cols[owner == s] for s in range(ndev)])
    S_max = 1
    for d in range(ndev):
        for s in range(ndev):
            if s != d:
                S_max = max(S_max, need[d][s].size)
    pack_idx = np.zeros((ndev, ndev, S_max), dtype=np.int64)
    for s in range(ndev):
        for d in range(ndev):
            if s == d:
                continue
            lst = need[d][s]
            pack_idx[s, d, : lst.size] = lst - s * n_loc
    ind_remap = np.full_like(ell_ind, -1, dtype=np.int64)
    for d in range(ndev):
        sl = ell_ind[d * m_loc : (d + 1) * m_loc]
        out = np.full(sl.shape, -1, dtype=np.int64)
        valid = sl >= 0
        cols = np.where(valid, sl, 0)
        owner = cols // n_loc
        mine = owner == d
        out[valid & mine] = (cols - d * n_loc)[valid & mine]
        for s in range(ndev):
            if s == d:
                continue
            msk = valid & (owner == s)
            if not msk.any():
                continue
            pos = np.searchsorted(need[d][s], cols[msk])
            out[msk] = n_loc + s * S_max + pos
        ind_remap[d * m_loc : (d + 1) * m_loc] = out
    return ind_remap, pack_idx, S_max


def _general_halo_matvec(mesh: Mesh):
    """The local body of the plan-derived general halo: pack the scheduled
    entries with one gather, trade them in ONE all_to_all, stitch
    [local | received] and run the masked padded-ELL reduce. `v` may be
    (n_loc,) (SpMV, CG) or (n_loc, K) rows (SpMM)."""

    def matvec(ind, val, pidx2, v):
        recv = coll.all_to_all(v[pidx2].contiguous(), mesh)
        buf = torch.cat([v, recv.reshape((-1,) + tuple(v.shape[1:]))])
        return _ell_rows(ind, val, buf)

    return matvec


def _halo_plan_operands(mesh: Mesh, ell_ind, ell_val, n_rows: int, axis: str):
    """The plan and this rank's remapped rows, values and pack indices."""
    ndev = mesh.shape[axis]
    if n_rows % ndev:
        raise ValueError("x must be padded to a device multiple")
    ell_ind = _np(ell_ind)
    if ell_ind.shape[0] % ndev:
        raise ValueError("ell rows must be padded to a device multiple")
    ind_remap, pack_idx, _S = plan_general_halo(ell_ind, ndev, n_rows // ndev)
    ind = put(ind_remap, mesh, P(axis, None)).local
    val = put(ell_val, mesh, P(axis, None)).local
    pidx = put(pack_idx, mesh, P(axis, None, None)).local[0]
    return ind, val, pidx


def dist_spmv_ell_halo_plan(mesh: Mesh, ell_ind, ell_val, x_sharded, axis: str = "x"):
    """General-sparsity SpMV with x sharded and a plan-derived halo: the host
    schedule (plan_general_halo) says which x entries each rank pair trades;
    one all_to_all moves them, then the padded-ELL reduce runs on the
    remapped indices. Returns y as a Shard."""
    xs = put(x_sharded, mesh, P(axis))
    ind, val, pidx = _halo_plan_operands(mesh, ell_ind, ell_val, xs.shape[0], axis)
    y = _general_halo_matvec(mesh)(ind, val, pidx, xs.local)
    return Shard(y, mesh.rank * y.shape[0], (y.shape[0] * mesh.size,), 0)


def dist_spmm_ell_halo_plan(mesh: Mesh, ell_ind, ell_val, B_sharded, axis: str = "x"):
    """General-sparsity SpMM C = A @ B with B row-sharded: the same host
    schedule decides which B rows each rank pair trades (one all_to_all of
    (ndev, S_max, K) slabs). Returns C as a Shard."""
    Bs = put(B_sharded, mesh, P(axis, None))
    ind, val, pidx = _halo_plan_operands(mesh, ell_ind, ell_val, Bs.shape[0], axis)
    C = _general_halo_matvec(mesh)(ind, val, pidx, Bs.local)
    return Shard(C, mesh.rank * C.shape[0], (C.shape[0] * mesh.size, C.shape[1]), 0)


def dist_spmv_balanced_halo(mesh: Mesh, ptr, ind, val, x_sharded, axis: str = "x"):
    """NNZ-balanced row parts composed with the plan-derived halo: rows split
    on the cumulative-nnz curve, x uniformly sharded, only the scheduled
    cross-shard x entries move (one all_to_all). Returns (y_padded Shard,
    bounds, mloc); compact with `compact_balanced`."""
    from .partition import nnz_balanced_bounds, pack_balanced_ell

    ndev = mesh.shape[axis]
    ptr = _np(ptr)
    # align=1: the halo path has no row alignment, and 8-row cuts can
    # collapse to 0 under extreme skew
    bounds = nnz_balanced_bounds(ptr, ndev, align=1)
    src, ind_stack, mloc, bounds = pack_balanced_ell(ptr, _np(ind), ndev, bounds=bounds)
    valh = _np(val)
    vals = np.where(src >= 0, valh[np.clip(src, 0, None)], np.zeros((), valh.dtype))
    w = ind_stack.shape[2]
    y = dist_spmv_ell_halo_plan(
        mesh, ind_stack.reshape(ndev * mloc, w), vals.reshape(ndev * mloc, w), x_sharded, axis=axis
    )
    return y, bounds, mloc


def compact_balanced(y, bounds, mloc: int, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Drop the per-part row padding of a balanced-partition result (host)."""
    yh = fetch(y, mesh)
    parts = [yh[p * mloc : p * mloc + (int(bounds[p + 1]) - int(bounds[p]))] for p in range(len(bounds) - 1)]
    return np.concatenate(parts) if parts else yh[:0]
