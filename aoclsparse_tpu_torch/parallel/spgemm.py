"""Distributed SpGEMM (the JAX package's parallel/spgemm.py).

The reference's shared-memory Gustavson row merge
(level3/aoclsparse_csr2m.cpp:89-200, a static row split) becomes, over the
ranks: the host symbolic stage (the port's native expansion,
native/__init__.py `spgemm_expand`) partitions the product list by C rows,
every rank reduces its products with a local scatter-add on its device,
and the C blocks concatenate row-aligned. Every rank plans, as every JAX
process does; each keeps only its own products on its device. The numeric
stage is the JAX package's XLA segment-sum, plain torch here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import collectives as coll
from .partition import nnz_balanced_bounds
from .placement import Mesh, Shard
from .spmv import _np

__all__ = ["partition_products", "dist_spgemm_numeric", "dist_spgemm_rowpart", "dist_spgemm_halo"]


def _expand(m: int, ptr, ind, effB):
    """The native symbolic stage of rows with (ptr, ind) against B:
    (pa, pb, pc, Cptr, Cind)."""
    from .. import native

    nat = native.spgemm_expand(m, ptr, ind, effB.ptr, effB.ind)
    if nat is None:
        raise RuntimeError(
            "shard product list exceeds int32 triple capacity" if native.available() else "native spgemm_expand unavailable"
        )
    return nat


def _segment_sum(av, bv, pa, pb, pc, n: int, device) -> torch.Tensor:
    """out[c] = sum of av[pa] * bv[pb] over the products with pc == c, for
    c < n (pc == n: padding)."""
    pa, pb, pc = (_dev(a, device) for a in (pa, pb, pc))
    prods = av[pa] * bv[pb]
    return torch.zeros(n + 1, dtype=prods.dtype, device=device).index_add_(0, pc, prods)[:n]


def _gather_blocks(mesh: Mesh, block: torch.Tensor, n_max: int) -> np.ndarray:
    """Every rank's C block (zero-padded to n_max) on every rank: (ndev, n_max)."""
    pad = torch.nn.functional.pad(block, (0, n_max - block.shape[0]))
    full = coll.all_gather(pad, mesh).reshape(mesh.size, n_max)
    return full.cpu().numpy()


def _assemble(m: int, bounds, shard_plans, c_blocks):
    """Global (Cptr, Cind, Cval) from the shards' (Cptr_l, Cind_l) and values."""
    offs = np.cumsum([0] + [int(p[-2][-1]) for p in shard_plans])
    Cptr = np.zeros(m + 1, dtype=np.int64)
    Cind_parts, Cval_parts = [], []
    for d, plan in enumerate(shard_plans):
        Cptr_l, Cind_l = plan[-2], plan[-1]
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        Cptr[lo + 1 : hi + 1] = Cptr_l[1:] + offs[d]
        nnz_l = int(Cptr_l[-1])
        Cind_parts.append(Cind_l[:nnz_l])
        Cval_parts.append(c_blocks[d, :nnz_l])
    Cind = np.concatenate(Cind_parts) if Cind_parts else np.zeros(0, np.int32)
    Cval = np.concatenate(Cval_parts) if Cval_parts else np.zeros(0)
    return Cptr, Cind, Cval


def dist_spgemm_rowpart(mesh: Mesh, effA, effB, axis: str = "x"):
    """Fully row-partitioned distributed SpGEMM: C's row block d depends only
    on A's row block d, so the symbolic stage splits into per-part marker
    scans on nnz-balanced row blocks, and each rank's numeric stage is a
    local scatter-add with no traffic (B's values replicate). Returns
    (Cptr, Cind, Cval) as host arrays on every rank."""
    n_dev = mesh.shape[axis]
    mA = effA.shape[0]
    bounds = nnz_balanced_bounds(effA.ptr, n_dev, align=1)
    ptrA = np.asarray(effA.ptr, dtype=np.int64)
    indA = np.asarray(effA.ind, dtype=np.int64)
    shard_plans = []
    for d in range(n_dev):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        pa, pb, pc, Cptr_l, Cind_l = _expand(hi - lo, ptrA[lo : hi + 1] - ptrA[lo], indA[ptrA[lo] : ptrA[hi]], effB)
        shard_plans.append((pa.astype(np.int64) + int(ptrA[lo]), pb, pc, Cptr_l, Cind_l))
    nnzC_max = max(1, max(int(p[3][-1]) for p in shard_plans))
    pa, pb, pc, Cptr_l, _ = shard_plans[mesh.rank]
    av, bv = effA.val.to(mesh.device), effB.val.to(mesh.device)
    block = _segment_sum(av, bv, pa, pb, pc, int(Cptr_l[-1]), mesh.device)
    return _assemble(mA, bounds, shard_plans, _gather_blocks(mesh, block, nnzC_max))


def partition_products(plan, n_dev: int):
    """Split a SpgemmPlan's (pa, pb, pc) by C-value blocks into n_dev equal
    shards, padded with no-op products pointing at a scratch slot. Returns
    (pa_s, pb_s, pc_s, chunk), pc_s local offsets."""
    pa = np.asarray(plan.pa)
    pb = np.asarray(plan.pb)
    pc = np.asarray(plan.pc)
    nnzC = plan.nnz
    chunk = -(-nnzC // n_dev) if nnzC else 1
    owner = np.minimum(pc // chunk, n_dev - 1) if pc.size else pc
    counts = np.bincount(owner, minlength=n_dev) if pc.size else np.zeros(n_dev, np.int64)
    P_max = max(int(counts.max()) if counts.size else 0, 1)
    pa_s = np.zeros((n_dev, P_max), dtype=np.int64)
    pb_s = np.zeros((n_dev, P_max), dtype=np.int64)
    pc_s = np.full((n_dev, P_max), chunk, dtype=np.int64)  # pad -> scratch slot
    for d in range(n_dev):
        sel = owner == d
        cnt = int(counts[d])
        pa_s[d, :cnt] = pa[sel]
        pb_s[d, :cnt] = pb[sel]
        pc_s[d, :cnt] = pc[sel] - d * chunk
    return pa_s, pb_s, pc_s, chunk


def _own_products(plan, n_dev: int, rank: int):
    """This rank's row of partition_products without building the others:
    a contiguous range of the products when pc is sorted, as the symbolic
    stage orders them. Returns (pa, pb, pc local, chunk)."""
    pc = np.asarray(plan.pc)
    nnzC = plan.nnz
    chunk = -(-nnzC // n_dev) if nnzC else 1
    if pc.size > 1 and not np.all(pc[1:] >= pc[:-1]):
        pa_s, pb_s, pc_s, chunk = partition_products(plan, n_dev)
        return pa_s[rank], pb_s[rank], pc_s[rank], chunk
    lo = int(np.searchsorted(pc, rank * chunk, side="left")) if rank else 0
    hi = pc.size if rank == n_dev - 1 else int(np.searchsorted(pc, (rank + 1) * chunk, side="left"))
    return np.asarray(plan.pa)[lo:hi], np.asarray(plan.pb)[lo:hi], pc[lo:hi] - rank * chunk, chunk


def _dev(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def dist_spgemm_numeric(mesh: Mesh, plan, a_val, b_val, axis: str = "x"):
    """The numeric stage over the ranks: rank d reduces the products of C
    values [d chunk, (d + 1) chunk). The rank's products go to its device
    once a plan (kept on the plan, as the single-process engine keeps its
    triples). Returns the (nnzC,) C values as a Shard of this rank's chunk."""
    n_dev = mesh.shape[axis]
    key = (n_dev, mesh.rank, str(mesh.device))
    own = getattr(plan, "_dist_own", None)
    if own is None or own[0] != key:
        pa, pb, pc, chunk = _own_products(plan, n_dev, mesh.rank)
        own = plan._dist_own = (key, _dev(pa, mesh.device), _dev(pb, mesh.device), _dev(pc, mesh.device), chunk)
    _key, pa, pb, pc, chunk = own
    av = (a_val if isinstance(a_val, torch.Tensor) else torch.from_numpy(np.asarray(a_val))).to(mesh.device)
    bv = (b_val if isinstance(b_val, torch.Tensor) else torch.from_numpy(np.asarray(b_val))).to(mesh.device)
    prods = av[pa] * bv[pb]
    block = torch.zeros(chunk + 1, dtype=prods.dtype, device=mesh.device).index_add_(0, pc, prods)[:chunk]
    return Shard(block, mesh.rank * chunk, (plan.nnz,), 0)


def dist_spgemm_halo(mesh: Mesh, effA, effB, axis: str = "x"):
    """Distributed SpGEMM with B-row halo exchange: both operands split by
    rows on the same uniform bounds; when a rank's products reference B rows
    only within its ring neighbours, just the boundary B-value slabs move,
    as two ppermutes of host-packed slabs, and pb is remapped into the
    rank's [left halo | local | right halo] buffer, so the numeric stage is
    one local scatter-add.

    Raises ValueError when a rank needs B rows beyond its ring neighbours
    (callers fall back to dist_spgemm_rowpart). Returns (Cptr, Cind, Cval)."""
    n_dev = mesh.shape[axis]
    mA, mB = effA.shape[0], effB.shape[0]
    bA = np.linspace(0, mA, n_dev + 1).astype(np.int64)
    bB = np.linspace(0, mB, n_dev + 1).astype(np.int64)
    ptrA = np.asarray(effA.ptr, dtype=np.int64)
    indA = np.asarray(effA.ind, dtype=np.int64)
    ptrB = np.asarray(effB.ptr, dtype=np.int64)

    shard_plans = []
    for d in range(n_dev):
        lo, hi = int(bA[d]), int(bA[d + 1])
        lind = indA[ptrA[lo] : ptrA[hi]]
        if lind.size:
            blo = int(bB[d - 1]) if d > 0 else 0
            bhi = int(bB[d + 2]) if d + 2 <= n_dev else mB
            if lind.min() < blo or lind.max() >= bhi:
                raise ValueError(f"shard {d} references B rows outside its ring neighbors")
        pa, pb, pc, Cptr_l, Cind_l = _expand(hi - lo, ptrA[lo : hi + 1] - ptrA[lo], lind, effB)
        shard_plans.append((pa.astype(np.int64) + int(ptrA[lo]), pb.astype(np.int64), pc, Cptr_l, Cind_l))
    nnzC_max = max(1, max(int(p[3][-1]) for p in shard_plans))

    # per rank: the local B values, the outgoing right slab (its last rows,
    # for d + 1's left halo) and left slab (its first rows, for d - 1's)
    loc_nnz = [int(ptrB[bB[d + 1]] - ptrB[bB[d]]) for d in range(n_dev)]
    L_max = max(max(loc_nnz), 1)
    need_lo, need_hi = [], []
    for d in range(n_dev):
        lind = indA[ptrA[bA[d]] : ptrA[bA[d + 1]]]
        nlo = int(lind.min()) if lind.size else int(bB[d])
        nhi = int(lind.max()) + 1 if lind.size else int(bB[d])
        need_lo.append(min(nlo, int(bB[d])))
        need_hi.append(max(nhi, int(bB[d])))
    out_r, out_l = [], []
    for d in range(n_dev):
        take_lo = need_lo[d + 1] if d + 1 < n_dev else int(bB[d + 1])
        out_r.append(int(ptrB[bB[d + 1]] - ptrB[max(take_lo, int(bB[d]))]))
        take_hi = need_hi[d - 1] if d > 0 else int(bB[d])
        out_l.append(int(ptrB[min(take_hi, int(bB[d + 1]))] - ptrB[bB[d]]))
    H_r, H_l = max(max(out_r), 1), max(max(out_l), 1)

    d = mesh.rank
    bval = _np(effB.val)
    s, e = int(ptrB[bB[d]]), int(ptrB[bB[d + 1]])
    locB = np.zeros(L_max, dtype=bval.dtype)
    locB[: e - s] = bval[s:e]
    outR = np.zeros(H_r, dtype=bval.dtype)
    outL = np.zeros(H_l, dtype=bval.dtype)
    if out_r[d]:
        outR[: out_r[d]] = bval[e - out_r[d] : e]
    if out_l[d]:
        outL[: out_l[d]] = bval[s : s + out_l[d]]
    # pb remap: global B value position -> the rank's buffer
    # [in_left (H_r, from d - 1's right slab) | local (L_max) | in_right (H_l)]
    pa, pb, pc = shard_plans[d][:3]
    pbl = np.empty_like(pb)
    mine = (pb >= s) & (pb < e)
    pbl[mine] = H_r + (pb[mine] - s)
    below = pb < s
    if below.any():
        pbl[below] = pb[below] - (s - out_r[d - 1])
    above = pb >= e
    if above.any():
        pbl[above] = H_r + L_max + (pb[above] - e)

    dev = mesh.device
    in_left = coll.ppermute(torch.from_numpy(outR).to(dev), mesh, 1)
    in_right = coll.ppermute(torch.from_numpy(outL).to(dev), mesh, -1)
    buf = torch.cat([in_left, torch.from_numpy(locB).to(dev), in_right])
    block = _segment_sum(effA.val.to(dev), buf, pa, pbl, pc, int(shard_plans[d][3][-1]), dev)
    return _assemble(mA, bA, shard_plans, _gather_blocks(mesh, block, nnzC_max))
