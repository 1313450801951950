"""The Hopper designs of the diagonal SpMM (#10, csrc/spmm_diag.cu) and the
band SpMM (#8, csrc/spmm_band.cu spmm_band), emulated on the CPU.

- `_emulate_diag` runs the diagonal kernel's schedule: the windows and runs
  of kernels/spmm_diag.py `diag_schedule`, R-row tiles by 128-byte column
  chunks taken by a persistent CTA (tiles b, b + grid, ...), each step
  (tile, window) staging the window's values (zero past m) and its
  R + span B rows of the chunk (zero outside [0, n) and past K) into a
  ring of STAGES stages, the stage STAGES - 1 steps ahead written before
  the current one is read, and each thread's 8 rows x 16 bytes of sums
  fed run by run: staged row 8g + p + u into every (row a, offset u - a)
  it meets.
- `_emulate_band` runs the band kernel's schedule (kernels/spmm_band.py
  BAND_*): 128-row tiles by 256-byte column chunks, the band in j-major
  chunks of JC (16 f32, 8 f64) through a three-stage ring, the B window
  through a 256-row ring that each chunk feeds with its new rows (both
  written two chunks ahead, before the current chunk's reads, as the
  copies may land), and each thread's register window of eight B rows,
  slot (j + a) % 8, one new row a step.
- Both must match the plain versions and the JAX package's Pallas kernels
  in interpret mode (`pallas_spmm_diag`; `pallas_spmm_band_t` with K a
  multiple of 128, as the JAX side takes it), on seeded numpy operands:
  the 27-point stencil, 192 diagonals, a lone far offset, offsets past
  +-n, odd m, m below one tile, K in {1, 7, 13, 70}, W from 1 to the cap.
  Unread ring slots and stages are NaN, so a read of a row that was never
  staged, or was overwritten, fails the comparison.
- `diag_windows` / `diag_runs`: every offset once, in increasing order;
  each window's stage fits the budget; and `band_max_w` still gives 400 /
  184, the planner's bandtm gate.

Tolerances: utils/tolerances.py's model, expected_precision(accumulation
dtype) on max |a - b| / max(|b|, 1): the same products summed in the same
order of offsets or j, with one rounding more per product here than the
card's fused multiply-add (bf16 diagonals are widened exactly to f32 on
both sides).

The kernels themselves run in the `cuda`-marked tests of
tests/test_torch_spmm_kernels.py.
"""

import numpy as np
import pytest
import torch

from aoclsparse_tpu_torch import AoclSparseError, Status
from aoclsparse_tpu_torch.kernels.build import MAX_SMEM
from aoclsparse_tpu_torch.kernels.spmm_band import (
    BAND_JC,
    BAND_RING,
    BAND_STAGES,
    BAND_TM,
    band_max_w,
    spmm_band,
    spmm_band_plain,
)
from aoclsparse_tpu_torch.kernels.spmm_diag import (
    DIAG_ROWS,
    RUN_MAX,
    STAGE_BUDGET,
    STAGES,
    diag_runs,
    diag_schedule,
    diag_windows,
    spmm_diag,
    spmm_diag_plain,
)
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

F32 = expected_precision(torch.float32)
F64 = expected_precision(torch.float64)
NAN = float("nan")


@pytest.fixture(scope="module")
def pallas_spmv():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.kernels.pallas import spmv

    return spmv


def _stencil_offsets(nx):
    return [(dz * nx + dy) * nx + dx for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


# ---------------------------------------------------------------- #10 ----


def _emulate_diag(dv, offs, B, inst, grid=3):
    """C by the diagonal kernel's schedule (module note), CTA by CTA."""
    sched = diag_schedule(offs, inst)
    tab = sched.table.tolist()
    nwin = len(sched.windows)
    wtab = [tab[6 * w: 6 * w + 6] for w in range(nwin)]
    rtab = tab[6 * nwin:]
    ndiag, m = dv.shape
    n, K = B.shape
    acc_t = torch.float64 if B.dtype == torch.float64 else torch.float32
    V = 16 // B.element_size()
    KC = 8 * V
    R = sched.rows
    nchunks = -(-K // KC)
    ntiles = -(-m // R) * nchunks
    dvw = dv.to(acc_t)
    Bc = B.to(acc_t)
    g8 = torch.arange(R // 8) * 8
    C = torch.full((m, K), NAN, dtype=acc_t)

    def stage(w, tile):
        o0, d0, nd, span = wtab[w][:4]
        i0, k0 = (tile // nchunks) * R, (tile % nchunks) * KC
        i = i0 + torch.arange(R)
        vs = torch.where(i[None, :] < m, dvw[d0:d0 + nd, i.clamp(max=m - 1)], torch.zeros((), dtype=acc_t))
        br = i0 + o0 + torch.arange(R + span)
        col = k0 + torch.arange(KC)
        inside = ((br >= 0) & (br < n))[:, None] & (col < K)[None, :]
        bs = torch.where(inside, Bc[br.clamp(0, n - 1)][:, col.clamp(max=K - 1)], torch.zeros((), dtype=acc_t))
        return vs, bs

    for b in range(min(grid, ntiles)):
        my_tiles = (ntiles - b + grid - 1) // grid
        nsteps = my_tiles * nwin
        ring = [None] * STAGES
        for k in range(min(STAGES - 1, nsteps)):
            ring[k] = stage(k % nwin, b + (k // nwin) * grid)
        acc = None
        for s in range(nsteps):
            sn = s + STAGES - 1
            if sn < nsteps:  # lands before this step's reads, as it may
                ring[sn % STAGES] = stage(sn % nwin, b + (sn // nwin) * grid)
            w, tile = s % nwin, b + (s // nwin) * grid
            if w == 0:
                acc = torch.zeros(R // 8, 8, KC, dtype=acc_t)
            vs, bs = ring[s % STAGES]
            for r in range(wtab[w][4], wtab[w][5]):
                dd, c, p = rtab[3 * r: 3 * r + 3]
                assert 1 <= c <= RUN_MAX
                for u in range(c + 7):
                    brow = bs[g8 + p + u]  # (R / 8, KC): one 16-byte load a thread
                    for a in range(8):
                        k = u - a
                        if 0 <= k < c:
                            acc[:, a] += vs[dd + k, g8 + a][:, None] * brow
            ring[s % STAGES] = (torch.full_like(vs, NAN), torch.full_like(bs, NAN))  # read once
            if w == nwin - 1:
                i0, k0 = (tile // nchunks) * R, (tile % nchunks) * KC
                rows = min(R, m - i0)
                cols = min(KC, K - k0)
                C[i0:i0 + rows, k0:k0 + cols] = acc.reshape(R, KC)[:rows, :cols]
    return C


def _diag_operand(seed, m, n, offs, K, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dv = np.zeros((len(offs), m), dtype)
    for d, off in enumerate(offs):
        i = np.arange(max(0, -off), min(m, n - off))
        dv[d, i] = rng.standard_normal(i.size)
    return dv, rng.standard_normal((n, K)).astype(dtype)


DIAG_CASES = [
    # (m, n, offsets, K): the 12^3 stencil (two windows, at K = 13 and, odd
    # m, K = 1); 192 diagonals; a lone far offset and offsets past +-n;
    # K = 70 takes three f32 chunks
    (1728, 1728, tuple(_stencil_offsets(12)), 13),
    (1727, 1728, tuple(_stencil_offsets(12)), 1),
    (700, 700, tuple(range(-96, 96)), 7),
    (901, 950, (-1200, -517, -7, -1, 0, 1, 3, 515, 949, 1000), 70),
    (37, 40, (-2, 0, 3), 5),
]


@pytest.mark.parametrize("inst", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("m,n,offs,K", DIAG_CASES)
def test_diag_emulation_matches_plain(inst, m, n, offs, K):
    dtype = np.float64 if inst == "f64" else np.float32
    dv, B = (torch.from_numpy(a) for a in _diag_operand(m + K, m, n, offs, K, dtype))
    if inst == "bf16":
        dv = dv.to(torch.bfloat16)
    got = _emulate_diag(dv, offs, B, inst)
    want = spmm_diag_plain(dv, torch.tensor(offs), B)
    assert not torch.isnan(got).any()
    assert near_error(got.numpy(), want.numpy()) <= (F64 if inst == "f64" else F32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n,offs,K", [DIAG_CASES[0], (900, 900, (-517, -130, -7, -1, 0, 1, 3, 37, 515), 8)])
def test_diag_emulation_matches_pallas(pallas_spmv, m, n, offs, K, bf16):
    import jax.numpy as jnp

    dv, B = _diag_operand(m + K, m, n, offs, K)
    L = max(0, -min(offs))
    n_pad = max(L + n, L + max(offs) + m)
    tile = pallas_spmv.diagmm_tiles(max(offs) - min(offs), -(-K // 8) * 8, -(-len(offs) // 8) * 8)
    dv_j = jnp.asarray(dv, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    want = np.asarray(pallas_spmv.pallas_spmm_diag(dv_j, jnp.asarray(B), offs, m, L, n_pad, TMl=tile[0],
                                                   interpret=True))
    dv_t = torch.from_numpy(dv)
    got = _emulate_diag(dv_t.to(torch.bfloat16) if bf16 else dv_t, offs, torch.from_numpy(B), "bf16" if bf16 else "f32")
    assert near_error(got.numpy(), want) <= F32


def _check_windows(offs, rows, val_bytes, budget=STAGE_BUDGET):
    wins = diag_windows(offs, rows, budget, val_bytes)
    assert [d for d0, d1 in wins for d in range(d0, d1)] == list(range(len(offs)))  # each offset once, in order
    for d0, d1 in wins:
        assert d1 > d0
        span = offs[d1 - 1] - offs[d0]
        assert (d1 - d0) * rows * val_bytes + (rows + span) * 128 <= budget
        assert all(b - a < rows for a, b in zip(offs[d0:d1], offs[d0 + 1:d1]))
        runs = diag_runs(offs, d0, d1)
        assert [dd for dd, c, _p in runs for dd in range(dd, dd + c)] == list(range(d1 - d0))
        for dd, c, p in runs:
            assert 1 <= c <= RUN_MAX and p == offs[d0 + dd] - offs[d0]
            assert list(offs[d0 + dd: d0 + dd + c]) == list(range(offs[d0 + dd], offs[d0 + dd] + c))
    return wins


@pytest.mark.parametrize("inst", ["f32", "bf16", "f64"])
def test_diag_windows_cover_offsets_within_budget(inst):
    rows, vb = DIAG_ROWS[inst], {"f32": 4, "bf16": 2, "f64": 8}[inst]
    # the 104^3 stencil: 3 windows of 9, each spanning 210 rows past the tile
    wins = _check_windows(_stencil_offsets(104), rows, vb)
    assert wins == [(0, 9), (9, 18), (18, 27)]
    assert diag_schedule(_stencil_offsets(104), inst).runs[0] == ((0, 3, 0), (3, 3, 104), (6, 3, 208))
    # 192 consecutive diagonals (DIA_MAX_WIDE): split by the budget, runs of
    # 4; the ring's stages fit one CTA's shared memory
    wide = _check_windows(list(range(-96, 96)), rows, vb)
    assert len(wide) > 1
    assert STAGES * diag_schedule(range(-96, 96), inst).stage_bytes <= MAX_SMEM
    # a lone far offset, and offsets past +-n (n = 1000): windows of their own
    far = [-5000, -3, -1, 0, 1, 2, 4, 900000]
    assert _check_windows(far, rows, vb) == [(0, 1), (1, 7), (7, 8)]
    # a window the budget cannot hold is split, never refused
    assert _check_windows([0, 1, 2, 3], rows, vb, budget=(2 * rows * vb + (rows + 1) * 128)) == [(0, 2), (2, 4)]


def test_diag_windows_reject_unsorted_and_oversized():
    for bad in ([0, 0], [3, 1]):
        with pytest.raises(AoclSparseError) as e:
            diag_windows(bad, 512)
        assert e.value.status == Status.invalid_value
    with pytest.raises(AoclSparseError) as e:
        diag_windows([0], 512, budget=1000)
    assert e.value.status == Status.invalid_size
    assert diag_windows([], 512) == []


def test_diag_schedule_table_and_staged_bytes():
    offs = _stencil_offsets(104)
    s = diag_schedule(offs, "f32")
    assert s is diag_schedule(tuple(offs), "f32")  # cached per offset set
    tab = s.table.tolist()
    assert tab[:6] == [offs[0], 0, 9, 210, 0, 3] and len(tab) == 3 * 6 + 9 * 3
    assert STAGES * s.stage_bytes <= MAX_SMEM and s.stage_bytes == 9 * 512 * 4 + 722 * 128
    b, v = s.staged_bytes(104**3, 64, 4)
    tiles = -(-104**3 // 512) * 2
    assert b == tiles * 3 * 722 * 128 and v == tiles * 27 * 512 * 4


def test_diag_wrapper_checks_static_offsets():
    dv, B = torch.zeros(2, 10), torch.zeros(12, 4)
    # a CPU tensor takes the plain version; the static offsets are the card's key
    assert spmm_diag(dv, torch.tensor([0, 1]), B, offs_static=(0, 1)).shape == (10, 4)


# ----------------------------------------------------------------- #8 ----


def _emulate_band(v, B, start, padL):
    """C by the band kernel's schedule (module note), tile by tile."""
    m, W = v.shape
    n, K = B.shape
    T = v.dtype
    es = v.element_size()
    TM, RING, V = BAND_TM, BAND_RING, 16 // es
    KC, JC, TMS = 16 * V, BAND_JC[es], BAND_TM + 8
    g8 = torch.arange(TM // 8) * 8
    C = torch.full((m, K), NAN, dtype=T)
    nq = -(-W // JC)
    for i0 in range(0, m, TM):
        nrows = min(TM, m - i0)
        brow0 = start + i0 - padL
        for k0 in range(0, K, KC):
            ring = torch.full((RING, KC), NAN, dtype=T)
            vs = [torch.full((JC, TMS), NAN, dtype=T) for _ in range(BAND_STAGES)]

            def stage(q):
                r = torch.arange(TM)
                j = q * JC + torch.arange(JC)
                ok = (j[:, None] < W) & (r[None, :] < nrows)
                vals = v[(i0 + r).clamp(max=m - 1)][:, j.clamp(max=W - 1)].T
                vs[q % BAND_STAGES][:, :TM] = torch.where(ok, vals, torch.zeros((), dtype=T))
                t0 = 0 if q == 0 else q * JC + TM - 1
                t = torch.arange(t0, (q + 1) * JC + TM - 1)
                br, col = brow0 + t, k0 + torch.arange(KC)
                inside = ((br >= 0) & (br < n))[:, None] & (col < K)[None, :]
                ring[t % RING] = torch.where(inside, B[br.clamp(0, n - 1)][:, col.clamp(max=K - 1)],
                                             torch.zeros((), dtype=T))

            acc = torch.zeros(TM // 8, 8, KC, dtype=T)
            win = [None] * 8
            for q in range(min(BAND_STAGES - 1, nq)):
                stage(q)
            for q in range(nq):
                if q + BAND_STAGES - 1 < nq:  # the copies may land before this chunk's reads
                    stage(q + BAND_STAGES - 1)
                if q == 0:
                    for k in range(7):
                        win[k] = ring[g8 + k]
                for jl in range(min(JC, W - q * JC)):
                    j = q * JC + jl
                    win[(j + 7) % 8] = ring[(g8 + j + 7) % RING]
                    for a in range(8):
                        acc[:, a] += vs[q % BAND_STAGES][jl, g8 + a][:, None] * win[(j + a) % 8]
                vs[q % BAND_STAGES].fill_(NAN)  # read once
            cols = min(KC, K - k0)
            C[i0:i0 + nrows, k0:k0 + cols] = acc.reshape(TM, KC)[:nrows, :cols]
    return C


def _band(seed, m, W, n, K, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, W)).astype(dtype), rng.standard_normal((n, K)).astype(dtype)


# (m, n, W, start, padL, K): W = 1; the caps 400 (f32) and 184 (f64); m off
# a multiple of 128 and below one tile; K = 1, 7 and 70 (two f32 / three
# f64 chunks); start > 0 and padL > 0 move the window both ways; n shorter
# than the window exercises the zero fill
BAND_CASES = [
    (300, 300, 1, 0, 0, 64),
    (301, 330, 24, 5, 0, 7),
    (90, 100, 33, 2, 5, 1),
    (257, 250, 129, 3, 64, 70),
    (260, 280, 184, 7, 90, 9),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,W,start,padL,K", BAND_CASES + [(200, 600, 400, 1, 200, 4)])
def test_band_emulation_matches_plain(dtype, m, n, W, start, padL, K):
    if W > band_max_w(torch.float64) and dtype == np.float64:
        W = band_max_w(torch.float64)
    v, B = (torch.from_numpy(a) for a in _band(m + W, m, W, n, K, dtype))
    got = _emulate_band(v, B, start, padL)
    assert not torch.isnan(got).any()
    want = spmm_band_plain(v, B, start, padL)
    assert near_error(got.numpy(), want.numpy()) <= (F64 if dtype == np.float64 else F32)


@pytest.mark.parametrize("m,n,W,start,padL", [(300, 300, 16, 0, 8), (257, 250, 40, 3, 11), (130, 140, 1, 0, 0)])
def test_band_emulation_matches_pallas(pallas_spmv, m, n, W, start, padL):
    import jax.numpy as jnp

    v, B = _band(m + W, m, W, n, 128)
    Be = jnp.asarray(np.pad(B, ((padL, 0), (0, 0))))
    want = np.asarray(pallas_spmv.pallas_spmm_band_t(jnp.asarray(v), Be, W, start, TM=64, interpret=True))
    got = _emulate_band(torch.from_numpy(v), torch.from_numpy(B), start, padL)
    assert near_error(got.numpy(), want) <= F32


def test_band_max_w_is_the_planner_gate():
    """The band kernel takes any W through its rings; the planner's bandtm
    gate stays where the earlier shared-memory tile put it."""
    assert band_max_w(torch.float32) == 400
    assert band_max_w(torch.float64) == 184
    assert band_max_w(torch.bfloat16) == 400
    v, B = torch.zeros(4, 408), torch.zeros(12, 4)
    with pytest.raises(AoclSparseError) as e:
        spmm_band(v, B, 0, 0)
    assert e.value.status == Status.invalid_size
