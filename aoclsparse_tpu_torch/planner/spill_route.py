"""Plan-time construction of the spill-route engine.

PyTorch counterpart of ``aoclsparse_tpu/planner/spill_route.py``. Turns
unstructured (row, col, val) triplets (the gen form's spill, in permuted
block space, or every entry of a matrix for the whole-matrix `route` form)
into the operands of the engine's three phases:

1. column-sorted select chunks: entries grouped by 1024-wide x block, each
   block's entries packed into (8, 128) tiles (pad slots hold value 0);
2. a Benes routing plan moving each entry's contribution from its select
   slot to its accumulate slot (``native.benes_plan``, split by
   ``kernels/route.py`` `plan_route_arrays`);
3. row-sorted accumulate chunks: entries grouped by 1024-row y block, with
   monotone block ids covering EVERY y block (an untouched block gets one
   all-pad chunk naming the trailing zero tile).

The arrays equal the JAX package's, array for array. One operand is added:
`acc_start` (nyblk + 1,), the first chunk of each y block, which the
accumulate kernel reads in place of a data-dependent grid. Values refresh
through the stored select-slot map (`refresh`), keeping the update_values
contract.

`striped_route_apply` differs from the JAX package on purpose: each stripe
adds into its own [lo, hi) rows of one zero vector of the full length, so
an empty 1024-row block between or after the stripes cannot shift later
rows (the JAX package concatenates the stripes' outputs,
planner/spill_route.py:287-298, and loses such blocks).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels.route import apply_route, plan_route_arrays
from ..kernels.spill_route import oh_accum, oh_select

__all__ = [
    "SpillRoute",
    "StripedRoute",
    "build_spill_route",
    "build_striped_route",
    "spill_route_apply",
    "striped_route_apply",
]

#: stripe size of the whole-matrix engine: slots a stripe's sub-network
#: aims at (the JAX package's 2^19)
STRIPE_SLOTS = 1 << 19


def _dev32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


@dataclasses.dataclass
class SpillRoute:
    k: int
    n: int  # 2**k routed slots
    nxblk: int
    nyblk: int
    n_sel_tiles: int
    n_acc_tiles: int  # real (entry-bearing) accumulate chunks
    m_pad: int
    sel_idx: torch.Tensor  # (n_sel_tiles, 8, 128) int32 local column index
    sel_val: torch.Tensor  # (n_sel_tiles, 8, 128) values (0 in pad slots)
    sel_blk: torch.Tensor  # (n_sel_tiles,) int32 x block per chunk
    acc_idx: torch.Tensor  # (n_chunks, 8, 128) int32 local row index
    acc_blk: torch.Tensor  # (n_chunks,) int32 monotone y block ids
    acc_cid: torch.Tensor  # (n_chunks,) int32 contribution tile (n_acc_tiles = zero)
    acc_start: torch.Tensor  # (nyblk + 1,) int32 first chunk of each y block
    masks: Optional[torch.Tensor]  # outer stages (k > 20), or every stage (k < 7)
    masks_packed: Optional[torch.Tensor]  # (2^d, ceil(S/8), 2^kc) packed networks
    _val_slot: torch.Tensor  # select slot of each entry (the refresh map)

    def refresh(self, vals: torch.Tensor) -> None:
        flat = torch.zeros(self.n_sel_tiles * 1024, dtype=vals.dtype, device=vals.device)
        flat[self._val_slot] = vals
        self.sel_val = flat.reshape(self.n_sel_tiles, 8, 128)

    def nbytes(self) -> int:
        ts = (self.sel_idx, self.sel_val, self.sel_blk, self.acc_idx, self.acc_blk, self.acc_cid,
              self.acc_start, self.masks, self.masks_packed)
        return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _chunk_side(keys: np.ndarray, blk_width: int):
    """Group entries by key // blk_width and pack each group into 1024-slot
    chunks: (slot_of_entry, chunk_blk_ids, n_tiles)."""
    P = keys.size
    blk = keys // blk_width
    order = np.argsort(blk, kind="stable")
    ub, counts = np.unique(blk[order], return_counts=True)
    tiles_per = -(-counts // 1024)
    base = np.zeros(ub.size + 1, dtype=np.int64)
    np.cumsum(tiles_per, out=base[1:])
    starts = np.zeros(ub.size, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(P, dtype=np.int64) - np.repeat(starts, counts)
    slot = np.empty(P, dtype=np.int64)
    slot[order] = np.repeat(base[:-1], counts) * 1024 + pos
    return slot, np.repeat(ub, tiles_per).astype(np.int32), int(base[-1])


def build_spill_route(sp_rows, sp_ind, sp_val, m_pad: int, n_pad_x: Optional[int] = None) -> SpillRoute:
    """sp_rows / sp_ind: host index arrays (rows into y of m_pad, columns
    into x of n_pad_x, default m_pad); sp_val: the values as a tensor on
    the device the route runs on."""
    from .. import native

    rows = np.asarray(sp_rows, dtype=np.int64)
    cols = np.asarray(sp_ind, dtype=np.int64)
    dev = sp_val.device
    n_x = int(n_pad_x if n_pad_x is not None else m_pad)
    nxblk = -(-n_x // 1024)
    nyblk = -(-m_pad // 1024)
    sel_slot, sel_chunk_blk, n_sel_tiles = _chunk_side(cols, 1024)
    acc_slot, acc_chunk_blk, n_acc_tiles = _chunk_side(rows, 1024)
    n = 1 << max(int(np.ceil(np.log2(max(n_sel_tiles, n_acc_tiles, 1) * 1024))), 10)
    k = int(np.log2(n))
    # Benes source: out[acc_slot] = in[sel_slot]; the other outputs (chunk
    # pad slots and the tail) take the unused, zero-valued inputs in order
    src = np.full(n, -1, dtype=np.int64)
    src[acc_slot] = sel_slot
    used = np.zeros(n, dtype=bool)
    used[sel_slot] = True
    src[src == -1] = np.nonzero(~used)[0]
    outer_np, packed_np = plan_route_arrays(k, native.benes_plan(k, src))
    sel_idx_f = np.zeros(n_sel_tiles * 1024, dtype=np.int32)
    sel_idx_f[sel_slot] = (cols % 1024).astype(np.int32)
    acc_idx_f = np.zeros(n_acc_tiles * 1024, dtype=np.int32)
    acc_idx_f[acc_slot] = (rows % 1024).astype(np.int32)
    # the full accumulate chunk list: the real chunks plus one all-pad chunk
    # for every untouched y block, merged in block order
    touched = np.zeros(nyblk, dtype=bool)
    touched[acc_chunk_blk] = True
    missing = np.nonzero(~touched)[0].astype(np.int32)
    all_blk = np.concatenate([acc_chunk_blk, missing])
    all_cid = np.concatenate(
        [np.arange(n_acc_tiles, dtype=np.int32), np.full(missing.size, n_acc_tiles, dtype=np.int32)]
    )
    order_c = np.argsort(all_blk, kind="stable")
    all_blk, all_cid = all_blk[order_c], all_cid[order_c]
    acc_idx_tiles = np.zeros((all_blk.size, 8, 128), dtype=np.int32)
    real = all_cid < n_acc_tiles
    acc_idx_tiles[real] = acc_idx_f.reshape(n_acc_tiles, 8, 128)[all_cid[real]]
    acc_start = np.searchsorted(all_blk, np.arange(nyblk + 1)).astype(np.int32)
    slot_d = torch.from_numpy(sel_slot).to(dev)
    sr = SpillRoute(
        k=k,
        n=n,
        nxblk=nxblk,
        nyblk=nyblk,
        n_sel_tiles=n_sel_tiles,
        n_acc_tiles=n_acc_tiles,
        m_pad=int(m_pad),
        sel_idx=_dev32(sel_idx_f.reshape(n_sel_tiles, 8, 128), dev),
        sel_val=None,
        sel_blk=_dev32(sel_chunk_blk, dev),
        acc_idx=_dev32(acc_idx_tiles, dev),
        acc_blk=_dev32(all_blk, dev),
        acc_cid=_dev32(all_cid, dev),
        acc_start=_dev32(acc_start, dev),
        masks=None if outer_np is None else torch.from_numpy(outer_np).to(dev),
        masks_packed=None if packed_np is None else torch.from_numpy(packed_np).to(dev),
        _val_slot=slot_d,
    )
    sr.refresh(sp_val)
    return sr


def spill_route_apply(xp: torch.Tensor, yp: torch.Tensor, sr: SpillRoute, out=None) -> torch.Tensor:
    """yp + the routed entries' contributions, gather-free on the card:
    select, route, accumulate. Writes `out` (may be yp) or a new tensor."""
    contrib = oh_select(xp, sr.sel_idx, sr.sel_val, sr.sel_blk, n_out=sr.n)
    routed = apply_route(contrib, sr.masks, sr.masks_packed, sr.k)
    return oh_accum(routed, sr.acc_idx, sr.acc_cid, sr.acc_start, sr.n_acc_tiles, yp, out=out)


@dataclasses.dataclass
class StripedRoute:
    """Row stripes of the whole-matrix engine, each its own SpillRoute over
    rows [lo, hi) of y: one sub-network of about STRIPE_SLOTS slots a stripe
    keeps each plan's Benes walk cache-resident, and the stripes plan in
    parallel threads (benes_plan releases the GIL)."""

    stripes: List[SpillRoute]
    row_lo: List[int]  # first row of each stripe (1024-aligned)
    row_hi: List[int]
    m: int  # rows of y (padded to 1024)
    _val_src: List[Tuple[int, int]]  # per stripe: its [e0, e1) range of the CSR values

    def refresh(self, vals: torch.Tensor) -> None:
        for sr, (e0, e1) in zip(self.stripes, self._val_src):
            sr.refresh(vals[e0:e1])

    def nbytes(self) -> int:
        return sum(sr.nbytes() for sr in self.stripes)


def build_striped_route(
    rows, cols, vals: torch.Tensor, m_pad: int, n_pad_x: int, target_slots: Optional[int] = None,
    threads: Optional[int] = None,
) -> StripedRoute:
    """rows sorted (CSR order). Stripe boundaries fall on 1024-row blocks
    with about 0.75 * target_slots entries a stripe."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    P = rows.size
    budget = max(1024, int((STRIPE_SLOTS if target_slots is None else target_slots) * 0.75))
    blk_starts = np.searchsorted(rows, np.arange(0, m_pad + 1024, 1024))
    bounds = [0]
    for b in blk_starts[1:]:
        if (b - bounds[-1] >= budget or b == P) and b > bounds[-1]:
            bounds.append(int(b))
    if bounds[-1] != P:
        bounds.append(P)
    stripes_io = []
    for i in range(len(bounds) - 1):
        e0, e1 = bounds[i], bounds[i + 1]
        lo = 0 if e0 == 0 else int(rows[e0] // 1024) * 1024
        hi = min(m_pad, (int(rows[e1 - 1]) // 1024 + 1) * 1024)
        stripes_io.append((e0, e1, lo, hi))
    results: List[Optional[SpillRoute]] = [None] * len(stripes_io)

    def one(i):
        e0, e1, lo, hi = stripes_io[i]
        results[i] = build_spill_route(rows[e0:e1] - lo, cols[e0:e1], vals[e0:e1], m_pad=hi - lo, n_pad_x=n_pad_x)

    nt = min(4, os.cpu_count() or 1) if threads is None else threads
    if nt > 1 and len(stripes_io) > 1:
        with cf.ThreadPoolExecutor(nt) as ex:
            list(ex.map(one, range(len(stripes_io))))
    else:
        for i in range(len(stripes_io)):
            one(i)
    return StripedRoute(
        stripes=results,
        row_lo=[s[2] for s in stripes_io],
        row_hi=[s[3] for s in stripes_io],
        m=int(m_pad),
        _val_src=[(s[0], s[1]) for s in stripes_io],
    )


def striped_route_apply(x: torch.Tensor, sr: StripedRoute) -> torch.Tensor:
    """y (sr.m,) = A @ x: every stripe accumulates in place into its own
    rows of one zero vector, so rows outside every stripe stay 0 and no
    row moves."""
    y = torch.zeros(sr.m, dtype=x.dtype, device=x.device)
    for part, lo, hi in zip(sr.stripes, sr.row_lo, sr.row_hi):
        rows = y[lo:hi]
        spill_route_apply(x, rows, part, out=rows)
    return y
