"""The spill-route engine's Hopper design, emulated on the CPU: the route
kernel's pass schedule and the accumulate kernel's run segmentation.

- `route_passes` (kernels/benes.py) is the schedule the route wrapper
  launches. `_emulate_passes` runs it as the kernel does: for each pass it
  gathers every CTA's owned set of addresses, reads its mask bytes through
  the kernel's row addressing, applies the pass's stages (each pair swapped
  by the mask bit of its lower index) and scatters the set back. It must be
  bit-equal to `apply_benes`, the plain stage loop, on one network, on a
  split plan and with passes split for a small shared-memory budget.
- `_emulate_accum` runs the accumulate kernel's segmented scan in its
  order (4 slots a thread, a warp scan of trailing runs, the carry across
  8 warps, one add a run tail) and must match `oh_accum_plain` within
  utils/tolerances.py's f32 model, expected_precision(float32) on
  max |a - b| / max(|b|, 1): the same contributions summed in another order.
- The planner's plans (the gen spill, the route stripes) have row-sorted
  real slots and trailing pads in every accumulate chunk: on them each row
  is one run a chunk, so the kernel's sum has the same bits on every call.

The kernels themselves run in the `cuda`-marked tests (skipped without a
card).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import native
from aoclsparse_tpu_torch.kernels import benes
from aoclsparse_tpu_torch.kernels import route as troute
from aoclsparse_tpu_torch.kernels.benes import benes_apply, benes_apply_plain, benes_route, route_passes
from aoclsparse_tpu_torch.kernels.spill_route import oh_accum, oh_accum_plain, oh_select
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.planner import spill_route as tsr
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

F32 = expected_precision(torch.float32)
GEN = tt.MatrixDescriptor()
N = tt.Operation.none


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def _plan(k, seed, fused=None, monkeypatch=None):
    """(src, outer, packed) of a random permutation's route, split as the
    planner splits it (FUSED_MAX_K lowered to `fused` if given)."""
    if fused is not None:
        monkeypatch.setattr(troute, "FUSED_MAX_K", fused)
    src = np.random.default_rng(seed).permutation(1 << k)
    outer, packed = troute.plan_route_arrays(k, native.benes_plan(k, src))
    return src, None if outer is None else torch.from_numpy(outer), torch.from_numpy(packed)


def _addresses(p, k):
    """(CTAs, 2^F) addresses each CTA of pass p owns, in its local order."""
    j = torch.arange(1 << p.free_bits)
    q = torch.arange(1 << (k - p.free_bits))[:, None]
    mid = p.blo - p.c
    fixed = ((q & ((1 << mid) - 1)) << p.c) | ((q >> mid) << p.bhi)
    return (j & ((1 << p.c) - 1)) | ((j >> p.c) << p.blo) | fixed


def _emulate_passes(v, outer, packed, k, passes):
    d = packed.shape[0].bit_length() - 1
    kc, R = k - d, packed.shape[1]
    flat = packed.reshape(-1)
    out = v.clone()
    for p in passes:
        addr = _addresses(p, k)
        vals = out[addr]
        word = torch.zeros(addr.shape, dtype=torch.int64)  # bit s: stage s's mask bit
        for (kind, r), (shift, mask, w) in zip(p.rows, p.row_words()):
            byte = outer[r][addr] if kind == 0 else flat[((addr >> kc) * R + r) * (1 << kc) + (addr & ((1 << kc) - 1))]
            word |= ((byte.long() >> shift) & mask) << w
        local = torch.arange(addr.shape[1])
        for s0, n in p.groups:  # a group's values in registers: 2^n of them a base
            lbs = [st[0] for st in p.stages[s0 : s0 + n]]
            gmask = sum(1 << lb for lb in lbs)
            bases = local[(local & gmask) == 0]
            at = bases[:, None] | sum(((torch.arange(1 << n)[None, :] >> g) & 1) << lb for g, lb in enumerate(lbs))
            regs, w = vals[:, at], word[:, at]  # (CTAs, bases, 2^n)
            for g in range(n):
                for e in range(1 << n):
                    if e & (1 << g):
                        continue
                    swap = ((w[..., e] >> (s0 + g)) & 1).bool()
                    lo, hi = regs[..., e].clone(), regs[..., e | (1 << g)].clone()
                    regs[..., e] = torch.where(swap, hi, lo)
                    regs[..., e | (1 << g)] = torch.where(swap, lo, hi)
            vals[:, at] = regs
        out[addr] = vals
    return out


#: (tb, c, smem): the kernel's schedule, and a small tile that gives every k
#: here three passes
SCHEDULES = {"kernel": (benes.TILE_LOG, benes.RUN_LOG, benes.PASS_SMEM), "small": (4, 2, benes.PASS_SMEM)}


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("k", [7, 10, 13, 16])
def test_route_passes_emulated_equal_apply_benes(k, sched):
    src, outer, packed = _plan(k, 500 + k)
    passes = route_passes(k, 0, *SCHEDULES[sched])
    assert len(passes) == (1 if sched == "kernel" and k <= benes.TILE_LOG else 3)
    v = torch.from_numpy(np.random.default_rng(k).standard_normal(1 << k).astype(np.float32))
    got = _emulate_passes(v, outer, packed, k, passes)
    assert torch.equal(got, troute.apply_benes(v, troute.route_masks(outer, packed, k), k))
    assert torch.equal(got, v[torch.from_numpy(src)])


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("k", [9, 10])
def test_route_passes_split_plan(monkeypatch, k, sched):
    """FUSED_MAX_K lowered to 7: outer stages around 2^(k-7) subnetworks; a
    pass A / C set spans the subnetworks and reads each one's masks."""
    src, outer, packed = _plan(k, 600 + k, fused=7, monkeypatch=monkeypatch)
    assert packed.shape[0] == 1 << (k - 7)
    passes = route_passes(k, k - 7, *SCHEDULES[sched])
    assert len(passes) == 3
    v = torch.from_numpy(np.random.default_rng(k).standard_normal(1 << k).astype(np.float32))
    got = _emulate_passes(v, outer, packed, k, passes)
    assert torch.equal(got, v[torch.from_numpy(src)])
    assert torch.equal(troute.apply_route(v, outer, packed, k), got)  # the wrapper's CPU side


def test_route_passes_extra_passes_for_small_smem(monkeypatch):
    """A shared-memory budget too small for one pass A / C set splits them
    into more passes of the same kernel; the route stays bit-equal."""
    k = 12
    src, outer, packed = _plan(k, 700, fused=9, monkeypatch=monkeypatch)
    passes = route_passes(k, 3, 4, 2, 1 << 10)
    assert len(passes) > 3 and all(p.smem() <= 1 << 10 for p in passes)
    v = torch.from_numpy(np.random.default_rng(7).standard_normal(1 << k).astype(np.float32))
    assert torch.equal(_emulate_passes(v, outer, packed, k, passes), v[torch.from_numpy(src)])


@pytest.mark.parametrize("k,d,launches", [(7, 0, 1), (13, 0, 1), (14, 0, 3), (20, 0, 3), (21, 1, 3), (22, 2, 3),
                                          (23, 3, 5)])
def test_route_passes_schedule_shape(k, d, launches):
    """Every stage once, in order; each pass within the kernel's limits and
    the card's shared memory; three launches up to k = 22 (the webbase
    spill is k = 21), more from k = 23; every pass's sets partition the
    addresses."""
    passes = route_passes(k, d)
    assert len(passes) == launches
    assert [t for p in passes for t in p.ts] == list(range(2 * k - 1))
    for p in passes:
        assert p.smem() <= benes.PASS_SMEM and len(p.rows) <= benes.MAX_ROWS and len(p.stages) <= benes.MAX_STAGES
        assert 2 <= p.c <= p.blo <= p.bhi <= k and len(p.groups) <= benes.MAX_GROUPS
        assert [s for s0, n in p.groups for s in range(s0, s0 + n)] == list(range(len(p.stages)))
        for s0, n in p.groups:  # distinct bits: a group's stages commute with its register layout
            assert n <= 4 and len({st[0] for st in p.stages[s0 : s0 + n]}) == n
        if k <= 16:
            addr = _addresses(p, k).reshape(-1)
            assert torch.equal(torch.sort(addr).values, torch.arange(1 << k))


def test_route_entries_refuse_bad_plans():
    from aoclsparse_tpu_torch import AoclSparseError, Status

    v = torch.zeros(1 << 9)
    _src, outer, packed = _plan(9, 1)
    with pytest.raises(AoclSparseError) as e:
        benes_apply(v, outer, packed, 8)
    assert e.value.status == Status.invalid_size
    with pytest.raises(AoclSparseError) as e:
        benes_apply(v, torch.zeros((2, 1 << 9), dtype=torch.uint8), packed, 9)  # outer rows without a split
    assert e.value.status == Status.invalid_size
    with pytest.raises(AoclSparseError) as e:
        benes_route(torch.zeros(64), torch.zeros((2, 64), dtype=torch.uint8), 6)  # below the packed networks
    assert e.value.status == Status.invalid_size


# -- the accumulate's run segmentation ----------------------------------------


def _fold(l, r):
    """(row, sum, whole) of the range l then r (csrc/spill_route.cu fold)."""
    lr, ls, lw = l
    rr, rs, rw = r
    join = rw & (lr == rr)
    return rr, torch.where(join, ls + rs, rs), torch.where(rw, join & lw, rw)


def _shift(x, o, fill):
    """x[..., lane - o] along the last axis (shfl_up), `fill` below o."""
    pad = torch.full(x.shape[:-1] + (o,), fill, dtype=x.dtype)
    return torch.cat([pad, x[..., :-o]], dim=-1)


def _emulate_accum(contrib, acc_idx, acc_cid, blk_start, n_real, y):
    """The accumulate kernel's order: returns (y_out, adds) with adds the
    (chunk, row) of every run tail that adds."""
    nyblk = blk_start.shape[0] - 1
    blk = torch.repeat_interleave(torch.arange(nyblk), (blk_start[1:] - blk_start[:-1]).long())
    real = torch.nonzero(acc_cid.long() < n_real).reshape(-1)
    R = acc_idx.reshape(-1, 1024)[real].long().reshape(-1, 8, 32, 4)
    V = contrib.reshape(-1)[: n_real * 1024].reshape(-1, 1024)[acc_cid[real].long()].reshape(-1, 8, 32, 4)
    r0, r1, r2, r3 = R.unbind(-1)
    v0, v1, v2, v3 = V.unbind(-1)
    s3, m = v3.clone(), r3 == r2
    s3 = torch.where(m, s3 + v2, s3)
    m &= r2 == r1
    s3 = torch.where(m, s3 + v1, s3)
    m &= r1 == r0
    s3 = torch.where(m, s3 + v0, s3)
    run = (r3, s3, (r0 == r1) & (r1 == r2) & (r2 == r3))
    for o in (1, 2, 4, 8, 16):
        left = tuple(_shift(x, o, 0) for x in run)
        lane = torch.arange(32) >= o
        folded = _fold(left, run)
        run = tuple(torch.where(lane, f, x) for f, x in zip(folded, run))
    before = tuple(_shift(x, 1, 0) for x in run)
    wrun = tuple(x[..., 31] for x in run)  # (chunks, 8)
    carry = [tuple(x[:, 0] for x in wrun)]
    for u in range(1, 7):
        carry.append(_fold(carry[-1], tuple(x[:, u] for x in wrun)))
    wcarry = tuple(torch.stack([carry[0][i]] + [c[i] for c in carry], dim=1)[..., None].expand(-1, -1, 32)
                   for i in range(3))  # warp w: warps 0 .. w-1 (warp 0: unused)
    has_w = (torch.arange(8) > 0)[None, :, None].expand_as(r0)
    lane0 = (torch.arange(32) == 0).expand_as(r0)
    joined = _fold(wcarry, before)
    crow = torch.where(lane0, wcarry[0], torch.where(has_w, joined[0], before[0]))
    csum = torch.where(lane0, wcarry[1], torch.where(has_w, joined[1], before[1]))
    has = has_w | ~lane0
    firsts = r0[..., 0]  # each warp's first row
    nxt_w = torch.cat([firsts[:, 1:], torch.full((firsts.shape[0], 1), -1)], dim=1)
    after = torch.cat([r0[..., 1:], nxt_w[..., None]], dim=-1)
    s = torch.where(has & (crow == r0), csum + v0, v0)
    tails = [(r0, s, r0 != r1)]
    s = torch.where(r1 == r0, s + v1, v1)
    tails.append((r1, s, r1 != r2))
    s = torch.where(r2 == r1, s + v2, v2)
    tails.append((r2, s, r2 != r3))
    s = torch.where(r3 == r2, s + v3, v3)
    tails.append((r3, s, r3 != after))
    chunk = torch.arange(real.numel())[:, None, None].expand_as(r0)
    rows = torch.stack([t[0] for t in tails], -1).reshape(-1)
    sums = torch.stack([t[1] for t in tails], -1).reshape(-1)
    tail = torch.stack([t[2] for t in tails], -1).reshape(-1) & (sums != 0)
    chunks = chunk[..., None].expand(-1, -1, -1, 4).reshape(-1)
    ypad = torch.zeros(nyblk * 1024, dtype=y.dtype)
    ypad[: y.shape[0]] = y
    ypad.index_add_(0, blk[real][chunks[tail]] * 1024 + rows[tail], sums[tail])
    return ypad[: y.shape[0]], torch.stack([real[chunks[tail]], rows[tail]], 1)


def _route_case(rows, cols, m_pad, n_x, seed):
    """A planner SpillRoute, the routed contributions of a random x (the
    engine's select and route: zeros in the pad slots) and a random y."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.standard_normal(rows.size).astype(np.float32))
    sr = tsr.build_spill_route(rows, cols, vals, m_pad, n_pad_x=n_x)
    x = torch.from_numpy(rng.standard_normal(n_x or m_pad).astype(np.float32))
    contrib = troute.apply_route(oh_select(x, sr.sel_idx, sr.sel_val, sr.sel_blk, n_out=sr.n), sr.masks,
                                 sr.masks_packed, sr.k)
    return sr, contrib, torch.from_numpy(rng.standard_normal(m_pad).astype(np.float32))


def _hot_row_rows(rng, m_pad=5000):
    """Block 0: 40 entries of row 0 (the pad tail's row) at the head, then
    1,500 of row 17 across its two chunks, then a few others; the rest
    spread; sorted as the planner's triplets come."""
    return np.sort(np.r_[np.zeros(40, np.int64), np.full(1500, 17), rng.integers(18, 1024, 100),
                         rng.integers(1024, m_pad, 3000)])


ACCUM_CASES = {
    # (m_pad, P, n_x, rows_from) as test_torch_route_kernels.ROUTE_CASES
    "plain": lambda rng: (np.sort(rng.integers(0, 8192, 3000)), 8192, None),
    "ragged": lambda rng: (np.sort(rng.integers(2100, 6000, 2500)), 6000, 5003),
    "several_chunks": lambda rng: (np.sort(rng.integers(0, 4096, 6000)), 4096, 1500),
    "hot_row": lambda rng: (_hot_row_rows(rng), 5000, None),
    "unsorted": lambda rng: (rng.integers(0, 6000, 5000), 6000, None),
}


def _accum_case(name, seed=31):
    rng = np.random.default_rng(seed)
    rows, m_pad, n_x = ACCUM_CASES[name](rng)
    cols = rng.integers(0, n_x or m_pad, rows.size)
    return _route_case(rows, cols, m_pad, n_x, seed + 1)


@pytest.mark.parametrize("name", ACCUM_CASES)
def test_accum_run_segmentation_matches_plain(name):
    sr, contrib, y = _accum_case(name)
    args = (sr.acc_idx, sr.acc_cid, sr.acc_start, sr.n_acc_tiles)
    got, adds = _emulate_accum(contrib, *args, y)
    assert near_error(got.numpy(), oh_accum_plain(contrib, *args, y).numpy()) <= F32
    pairs = {tuple(a) for a in adds.tolist()}
    if name == "unsorted":
        assert len(pairs) < adds.shape[0]  # a row with two runs in one chunk: two adds
    else:
        assert len(pairs) == adds.shape[0]  # one add a (chunk, row): the same bits every call
    if name == "hot_row":
        assert int(sr.acc_start[1] - sr.acc_start[0]) == 2
        block0 = range(int(sr.acc_start[0]), int(sr.acc_start[1]))
        assert sum(1 for c, r in pairs if r == 17 and c in block0) == 2  # the 1,500-entry row: one add a chunk


def _assert_row_sorted(sr):
    """Every real accumulate chunk: the real slots (found by routing each
    entry's number) form a prefix with rows in order; the pads trail."""
    mark = torch.zeros(sr.n)
    mark[sr._val_slot] = torch.arange(1, sr._val_slot.numel() + 1, dtype=torch.float32)
    routed = troute.apply_route(mark, sr.masks, sr.masks_packed, sr.k)
    tiles = routed[: sr.n_acc_tiles * 1024].reshape(-1, 1024)
    for c in torch.nonzero(sr.acc_cid < sr.n_acc_tiles).reshape(-1).tolist():
        real = tiles[int(sr.acc_cid[c])] > 0
        cnt = int(real.sum())
        assert cnt > 0 and bool(real[:cnt].all())
        idx = sr.acc_idx.reshape(-1, 1024)[c]
        assert bool((idx[1:cnt] >= idx[: cnt - 1]).all()) and not idx[cnt:].any()


def test_planner_plans_are_row_sorted(monkeypatch):
    """The gen spill (a circuit-like operand with scattered entries) and
    the whole-matrix route's stripes."""
    rng = np.random.default_rng(41)
    m = 1024
    dense = np.zeros((m, m))
    for i in range(m):
        dense[i, np.clip(i + rng.integers(-10, 11, 6), 0, m - 1)] = rng.standard_normal(6)
    dense[rng.integers(0, m, 600), rng.integers(0, m, 600)] = rng.standard_normal(600)
    S = sp.csr_matrix(dense.astype(np.float32))
    T = tt.create_csr(m, m, S.indptr, S.indices, S.data, device="cpu")
    form = tplan.get_plan(T).exec_form_for(GEN, N)
    assert form.kind == "gen" and form.sp_rows is not None
    _assert_row_sorted(form.spill_route())
    monkeypatch.setattr(tplan, "ROUTE_MIN_NNZ", 0)
    m = 4096
    Q = sp.random(m, m, density=8.0 / m, random_state=np.random.RandomState(43), dtype=np.float32, format="csr")
    Q.sort_indices()
    T = tt.create_csr(m, m, Q.indptr, Q.indices, Q.data, device="cpu")
    form = tplan.get_plan(T).exec_form_for(GEN, N)
    assert form.kind == "route"
    _assert_row_sorted(form._spill_route)
    # the stripes a route past 2^18 entries takes, at a smaller stripe size
    rows = np.repeat(np.arange(m), np.diff(Q.indptr))
    striped = tsr.build_striped_route(rows, Q.indices, torch.from_numpy(Q.data), m, m, target_slots=1 << 13)
    assert len(striped.stripes) > 1
    for part in striped.stripes:
        _assert_row_sorted(part)


# -- on the card: the route entry and the accumulate against their plain versions


@pytest.mark.cuda
def test_cuda_route_split_k21_three_launches(cuda):
    """The webbase spill's shape: k = 21, two packed subnetworks of 2^20
    and two outer stages, in three launches, in place too."""
    k = 21
    src, outer, packed = _plan(k, 800)
    outer, packed = outer.to(cuda), packed.to(cuda)
    v = torch.from_numpy(np.random.default_rng(8).standard_normal(1 << k).astype(np.float32)).to(cuda)
    c0 = benes_route.launches["f32"]
    got = benes_apply(v, outer, packed, k)
    torch.cuda.synchronize()
    assert benes_route.launches["f32"] - c0 == 3
    assert torch.equal(got, benes_apply_plain(v, outer, packed, k))
    assert torch.equal(got.cpu(), v.cpu()[torch.from_numpy(src)])
    w = v.clone()
    benes_apply(w, outer, packed, k, out=w)
    assert torch.equal(w, got)


@pytest.mark.cuda
def test_cuda_route_extra_passes(cuda, monkeypatch):
    """PASS_SMEM lowered: passes A and C split into more launches of the
    same kernel, and the route stays bit-equal."""
    k = 22
    src, outer, packed = _plan(k, 900)
    monkeypatch.setattr(benes, "PASS_SMEM", 96 * 1024)
    v = torch.from_numpy(np.random.default_rng(9).standard_normal(1 << k).astype(np.float32)).to(cuda)
    c0 = benes_route.launches["f32"]
    got = benes_apply(v, outer.to(cuda), packed.to(cuda), k)
    torch.cuda.synchronize()
    assert benes_route.launches["f32"] - c0 == len(route_passes(k, 2, smem=96 * 1024)) > 3
    assert torch.equal(got.cpu(), v.cpu()[torch.from_numpy(src)])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hot_row", "unsorted", "several_chunks"])
def test_cuda_accum_matches_plain(cuda, name):
    sr, contrib, y = _accum_case(name)
    args = tuple(t.to(cuda) for t in (sr.acc_idx, sr.acc_cid, sr.acc_start))
    c, yd = contrib.to(cuda), y.to(cuda)
    got = oh_accum(c, *args, sr.n_acc_tiles, yd)
    want = oh_accum_plain(c, *args, sr.n_acc_tiles, yd)
    torch.cuda.synchronize()
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= F32
    if name != "unsorted":  # row-sorted chunks: the same bits on every call
        assert torch.equal(oh_accum(c, *args, sr.n_acc_tiles, yd), got)
