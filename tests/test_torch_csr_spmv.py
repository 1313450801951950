"""mv KID 0 of the PyTorch port: the CSR row-gather kernel's plan, its
plain version against the JAX package's ``spmv_segsum``, and the card's
default rule for general structure.

- The schedule (kernels/spmv_csr.py `csr_blocks`): every row in exactly
  one block, in order; a block of several rows within TILE entries and
  MAX_ROWS rows and free of long rows, each block as full as the greedy
  rule makes it, a row past LONG_ROW alone; empty rows, no rows, pointers
  that do not start at 0, int32 and int64 pointers, a hub row among rows
  of 3, the webbase stand-in's mean; and the kernel's slots, row groups and
  sum order replayed on the CPU against the plain version.
- Parity: the port's ``mv(kid=0)`` (on the CPU, the plain version) against
  the JAX package's ``mv(kid=0)`` (its XLA ``spmv_segsum``,
  kernels/xla/spmv.py:51) and a float64 scipy product, in float32,
  float64, complex64 and complex128: a power-law operand whose hub rows
  pass the long-row threshold, empty rows, an all-empty matrix, one row of
  10,000 entries, int32 and int64 row pointers, alpha and beta with op
  transposed.
- The rule (planner/plan.py `pick_mv_format`, `choose_mv_format(eff,
  device)`): on ``cuda`` general structure takes ``segsum``, bands
  ``bandt`` and HPCG's stencil ``diag``; on the CPU the forms stay as they
  were (``gen``, then ``route`` or a gather form). Pins: kid=7 and an
  autotune pin still give ``gen``; a plan snapshot of a ``segsum`` form,
  one written before the form carried its CSR plan and one with the
  earlier schedule (sub-warp width, long rows) give the same mv.
- On the card (marked cuda, skipped elsewhere): the kernel against its
  plain version in every instance, with int32 and int64 indices, a hub
  row, runs of empty rows, a tile filled exactly and unaligned streams,
  the same bits twice, one launch a call, and the default mv on general
  structure.

All inputs are made with numpy from a seed. Tolerance: utils/tolerances.py
`expected_precision` of the dtype on max |a - b| / max(|b|, 1); the kernel,
the plain version and the JAX package sum the same products in three
orders.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.io import load_plan, save_plan
from aoclsparse_tpu_torch.kernels import spmv_csr as csr_mod
from aoclsparse_tpu_torch.kernels.plain_spmv import spmv_segsum
from aoclsparse_tpu_torch.kernels.spmv_csr import (
    LONG_ROW,
    block_stats,
    csr_blocks,
    csr_launches,
    spmv_csr,
    spmv_csr_any,
    spmv_csr_plain,
    tile_of,
)
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
DTYPES = (np.float32, np.float64, np.complex64, np.complex128)
TORCH = {np.float32: torch.float32, np.float64: torch.float64, np.complex64: torch.complex64,
         np.complex128: torch.complex128}


def tol(dtype):
    return expected_precision(TORCH[dtype])


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_csr_spmv.py there")
    return torch.device("cuda", 0)


# -- operands -----------------------------------------------------------------


def _values(rng, n, dtype):
    v = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    return v.astype(dtype)


def _csr(rows, cols, m, n, dtype, seed):
    """Deduplicated scipy CSR of the pattern with seeded values."""
    S = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(m, n))
    S.sum_duplicates()
    S.sort_indices()
    S.data = _values(np.random.default_rng(seed), S.nnz, dtype)
    return S


def power_law(seed, m=3000, dtype=np.float32):
    """A web graph in small: a few local links a row, a uniform tail, and
    hub rows of up to 900 entries, far past the long-row threshold."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, m, 2 * m)
    c = np.clip(r + rng.integers(-16, 17, r.size), 0, m - 1)
    hubs = rng.choice(m, 12, replace=False)
    deg = np.clip(rng.zipf(1.5, hubs.size) * 40, 60, 900)
    rh = np.repeat(hubs, deg)
    ch = rng.integers(0, m, rh.size)
    rt, ct = rng.integers(0, m, m), rng.integers(0, m, m)
    d = np.arange(m)
    return _csr(np.r_[r, rh, rt, d], np.r_[c, ch, ct, d], m, m, dtype, seed + 1)


def with_empty_rows(seed, m=700, dtype=np.float32):
    """Rows of 0-12 entries, a third of them empty, non-square."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 13, m) * (rng.random(m) > 0.33)
    r = np.repeat(np.arange(m), lens)
    return _csr(r, rng.integers(0, m + 50, r.size), m, m + 50, dtype, seed + 1)


def one_long_row(seed, m=64, n=20000, dtype=np.float32):
    """Row 5 holds 10,000 entries; the rest hold 0-3."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 4, m)
    r = np.repeat(np.arange(m), lens)
    c = rng.integers(0, n, r.size)
    cl = rng.choice(n, 10000, replace=False)
    return _csr(np.r_[r, np.full(cl.size, 5)], np.r_[c, cl], m, n, dtype, seed + 1)


def scatter(seed, m=2048, per_row=8, dtype=np.float32):
    """chip_smoke.py's scatter operand in small: the diagonal plus uniform
    random columns."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), per_row)
    d = np.arange(m)
    return _csr(np.r_[r, d], np.r_[rng.integers(0, m, r.size), d], m, m, dtype, seed + 1)


def circuit(seed, m=4000, dtype=np.float32):
    """The scircuit stand-in in small: local couplings, rail rows and
    columns of 120-353 entries, a scatter tail, structurally symmetric."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 2)
    c = np.clip(r + rng.integers(-24, 25, r.size), 0, m - 1)
    rails = rng.choice(m, 6, replace=False)
    rr = np.repeat(rails, np.clip(rng.zipf(1.35, 6), 120, 353))
    rc = rng.integers(0, m, rr.size)
    sr, sc = rng.integers(0, m, m // 3), rng.integers(0, m, m // 3)
    r1, c1 = np.r_[r, rr, sr], np.r_[c, rc, sc]
    d = np.arange(m)
    return _csr(np.r_[r1, c1, d], np.r_[c1, r1, d], m, m, dtype, seed + 1)


def band(seed, m=2000, half_bw=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 6)
    return _csr(r, np.clip(r + rng.integers(-half_bw, half_bw + 1, r.size), 0, m - 1), m, m, dtype, seed + 1)


def stencil27(nx=12, dtype=np.float32):
    """HPCG's 27-point stencil on an nx^3 grid: 26 on the diagonal, -1 off."""
    g = np.arange(nx)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = (0 <= z + dz) & (z + dz < nx) & (0 <= y + dy) & (y + dy < nx) & (0 <= x + dx) & (x + dx < nx)
                i = (z * nx + y) * nx + x
                rows.append(i[ok])
                cols.append(i[ok] + (dz * nx + dy) * nx + dx)
    r, c = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((np.where(r == c, 26.0, -1.0).astype(dtype), (r, c)), shape=(nx**3, nx**3))


def _handle(S, device="cpu", ptr_dtype=np.int32):
    return tt.create_csr(S.shape[0], S.shape[1], S.indptr.astype(ptr_dtype), S.indices, S.data, device=device)


# -- the schedule -------------------------------------------------------------

THREADS = 256  # csrc/spmv_csr.cu kThreads
TILE, MAX_ROWS = tile_of(torch.float32)  # the widest tile
#: the tiles of the value types: float32 (and narrower), the wider ones
TILES = sorted({tile_of(d) for d in (torch.float32, torch.float64, torch.complex128)})


def _ptr(lens, start=0):
    return start + np.r_[0, np.cumsum(np.asarray(lens, dtype=np.int64))]


def webbase_lens(seed=7):
    """Row lengths of the webbase stand-in's size and mean: 3,085,975
    entries over 1,000,005 rows, most rows 1-5 long, 200 hub rows up to
    4,698."""
    m, nnz = 1000005, 3085975
    rng = np.random.default_rng(seed)
    lens = rng.geometric(0.36, m)
    hubs = rng.choice(m, 200, replace=False)
    lens[hubs] = np.clip(rng.zipf(1.6, hubs.size) * 33, 33, 4698)
    short = np.setdiff1d(np.arange(m), hubs)
    lens[rng.choice(short, nnz - int(lens.sum()), replace=False)] += 1
    assert lens.sum() == nnz
    return lens


def _runs_of_empty_rows(seed=5):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(6):
        parts += [rng.integers(1, 13, 300), np.zeros(int(rng.integers(1, 3 * MAX_ROWS)), np.int64)]
    return np.concatenate(parts)


SCHEDULES = {
    "scatter": lambda: _ptr(np.full(5000, 9)),
    "webbase": lambda: _ptr(webbase_lens()),
    "hub_among_rows_of_3": lambda: _ptr(np.r_[np.full(1234, 3), 5000, np.full(2765, 3)]),
    "runs_of_empty_rows": lambda: _ptr(_runs_of_empty_rows()),
    "all_empty": lambda: _ptr(np.zeros(5000, np.int64)),
    "no_rows": lambda: _ptr([]),
    "offset_pointers": lambda: _ptr(np.random.default_rng(3).integers(0, 21, 2000), start=1000),
    "tiles_filled_exactly": lambda: _ptr(np.r_[np.full(3 * TILE // 16, 16), TILE, np.full(TILE // 8, 8)]),
    "long_row_edges": lambda: _ptr(np.r_[3, LONG_ROW, 3, LONG_ROW + 1, 3, TILE, TILE + 1, 1, 1]),
    "band_rows_of_64": lambda: _ptr(np.full(4096, 64)),
    "power_law": lambda: power_law(3).indptr,
}


def check_schedule(ptr, blocks, tile, max_rows):
    """The schedule's guarantees: every row in exactly one block, in
    order; a block of several rows within TILE entries and MAX_ROWS rows,
    none of them past LONG_ROW; a row past LONG_ROW alone; each block as
    full as the greedy rule allows (the next row would break a bound)."""
    p = np.asarray(ptr, dtype=np.int64)
    m = p.size - 1
    assert blocks.dtype == np.int64 and blocks.ndim == 2 and blocks.shape[1] == 2
    rows = blocks[:, 0]
    assert rows[0] == 0 and rows[-1] == m
    assert np.array_equal(blocks[:, 1], p[rows])
    assert np.all(np.diff(rows) >= 1)
    lens = np.diff(p)
    r0, r1 = rows[:-1], rows[1:]
    multi = r1 - r0 > 1
    assert np.all((p[r1] - p[r0])[multi] <= tile) and np.all((r1 - r0)[multi] <= max_rows)
    cap = np.maximum.reduceat(lens, r0) if m else np.zeros(0, np.int64)
    assert np.all(cap[multi] <= LONG_ROW)
    for r in np.nonzero(lens > LONG_ROW)[0]:
        b = np.searchsorted(rows, r, side="right") - 1
        assert rows[b] == r and rows[b + 1] == r + 1
    grow = (r1 < m) & (lens[r0] <= LONG_ROW if m else False)
    nxt = np.minimum(r1 + 1, m)
    full = (p[nxt] - p[r0] > tile) | (nxt - r0 > max_rows) | (lens[np.minimum(r1, m - 1)] > LONG_ROW)
    assert np.all(full[grow])


@pytest.mark.parametrize("ptr_dtype", [np.int32, np.int64], ids=["ptr32", "ptr64"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_keeps_its_guarantees(name, ptr_dtype):
    p = SCHEDULES[name]().astype(ptr_dtype)
    for tile, max_rows in TILES:
        blocks = csr_blocks(p, tile, max_rows)
        check_schedule(p, blocks, tile, max_rows)
        nblk, single = block_stats(blocks)
        assert csr_launches(nblk) == (1 if p.size > 1 else 0)
        assert single >= int(np.count_nonzero(np.diff(p.astype(np.int64)) > LONG_ROW))


def test_tile_of_the_value_types():
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert tile_of(dt) == (2048, 1024)
    for dt in (torch.float64, torch.complex64, torch.complex128):
        assert tile_of(dt) == (1024, 512)
    assert all(LONG_ROW < tile for tile, _rows in TILES)


def test_schedule_of_small_pointers():
    # a row of 300 (past LONG_ROW) alone between short rows
    assert csr_blocks(_ptr([3, 300, 3, 3]), TILE, MAX_ROWS).tolist() == [[0, 0], [1, 3], [2, 303], [4, 309]]
    # rows of LONG_ROW entries: eight fill the float32 tile exactly, four
    # the wider types'; the next starts a block
    assert csr_blocks(_ptr([LONG_ROW] * 9), 2048, 1024).tolist() == [[0, 0], [8, 2048], [9, 2304]]
    assert csr_blocks(_ptr([LONG_ROW] * 9), 1024, 512).tolist() == [[0, 0], [4, 1024], [8, 2048], [9, 2304]]
    # max_rows empty rows and one more
    assert csr_blocks(np.zeros(MAX_ROWS + 2, np.int32), TILE, MAX_ROWS).tolist() == \
        [[0, 0], [MAX_ROWS, 0], [MAX_ROWS + 1, 0]]
    # pointers that start at 5; no rows; one row
    assert csr_blocks(np.array([5, 6, 7]), TILE, MAX_ROWS).tolist() == [[0, 5], [2, 7]]
    assert csr_blocks(np.array([7], np.int32), TILE, MAX_ROWS).tolist() == [[0, 7]]
    assert csr_blocks(np.array([0, 10000]), TILE, MAX_ROWS).tolist() == [[0, 0], [1, 10000]]
    with pytest.raises(tt.AoclSparseError):
        csr_blocks(np.zeros(0, np.int64), TILE, MAX_ROWS)


def test_webbase_mean_schedule():
    """The webbase stand-in's size: one launch of about nnz / TILE CTAs,
    its hub rows on CTAs of their own."""
    lens = webbase_lens()
    for tile, max_rows in TILES:
        nblk, single = block_stats(csr_blocks(_ptr(lens), tile, max_rows))
        assert int(lens.sum()) / tile < nblk < 1.1 * int(lens.sum()) / tile + single
        assert single == int(np.count_nonzero(lens > LONG_ROW))
        assert csr_launches(nblk) == 1


def test_segsum_form_carries_its_block_schedule():
    S = power_law(3)
    form = tplan.get_plan(_handle(S)).exec_form_for(GEN, NONE, kind="segsum")
    assert form.csr_blocks.dtype == torch.int64 and form.csr_blocks.device == form.val.device
    np.testing.assert_array_equal(form.csr_blocks.numpy(), csr_blocks(S.indptr, *tile_of(torch.float32)))
    F = tplan.get_plan(_handle(power_law(3, dtype=np.complex128))).exec_form_for(GEN, NONE, kind="segsum")
    np.testing.assert_array_equal(F.csr_blocks.numpy(), csr_blocks(S.indptr, *tile_of(torch.complex128)))
    assert form.ptr.dtype == torch.int32 and form.ind.dtype == torch.int32
    np.testing.assert_array_equal(form.ptr.numpy(), S.indptr)
    assert form.nbytes() >= form.ptr.numel() * 4 + form.csr_blocks.numel() * 8
    assert block_stats(form.csr_blocks)[1] == int(np.count_nonzero(np.diff(S.indptr) > LONG_ROW))


def _tree(vals):
    """lane 0 of a __shfl_down_sync butterfly over len(vals) lanes"""
    vals, off = list(vals), len(vals) // 2
    while off:
        for i in range(off):
            vals[i] = vals[i] + vals[i + off]
        off //= 2
    return vals[0]


def replay(ptr, ind, val, x, blocks, idx_bytes):
    """csrc/spmv_csr.cu replayed on the CPU in the value type: a block of
    one row strided by the CTA (four running sums a thread, warp trees,
    warps in order); a block of several rows staged in V-entry slots from
    its aligned start, then G lanes a row (four running sums a lane, a
    tree). Checks the slots fit the kernel's registers and shared tile."""
    dt = val.dtype
    zero = dt.type(0)
    tile, _rows = tile_of(TORCH[dt.type])
    V = 16 // max(dt.itemsize, idx_bytes)
    S = (tile // V + 1 + THREADS - 1) // THREADS
    y = np.zeros(len(ptr) - 1, dt)
    for b in range(len(blocks) - 1):
        (r0, s), (r1, e) = blocks[b], blocks[b + 1]
        nr = r1 - r0
        if nr == 1:
            part = []
            for t in range(THREADS):
                a, p = [zero] * 4, s + t
                while p + 3 * THREADS < e:
                    for k in range(4):
                        a[k] = a[k] + val[p + k * THREADS] * x[ind[p + k * THREADS]]
                    p += 4 * THREADS
                while p < e:
                    a[0] = a[0] + val[p] * x[ind[p]]
                    p += THREADS
                part.append((a[0] + a[1]) + (a[2] + a[3]))
            warps = [_tree(part[w:w + 32]) for w in range(0, THREADS, 32)]
            tot = warps[0]
            for w in warps[1:]:
                tot = tot + w
            y[r0] = tot
            continue
        sa = s - s % V
        nslot = -(-(e - sa) // V)
        assert nslot <= S * THREADS and nslot * V <= tile + 4
        prod = np.zeros(tile + 4, dt)
        prod[s - sa:e - sa] = val[s:e] * x[ind[s:e]]
        rp = np.asarray(ptr[r0:r1 + 1], np.int64) - sa
        G = 1 if nr >= THREADS else min(32, 1 << int(np.log2(THREADS // nr)))
        for r in range(nr):
            lanes = []
            for lane in range(G):
                a, q, qe = [zero] * 4, rp[r] + lane, rp[r + 1]
                while q + 3 * G < qe:
                    for k in range(4):
                        a[k] = a[k] + prod[q + k * G]
                    q += 4 * G
                while q < qe:
                    a[0] = a[0] + prod[q]
                    q += G
                lanes.append((a[0] + a[1]) + (a[2] + a[3]))
            y[r0 + r] = _tree(lanes)
    return y


def tile_exact(seed, dtype=np.float32):
    """Rows of 16 that fill tiles exactly, a row of exactly TILE, a row of
    exactly LONG_ROW among rows of 8, and a run of empty rows."""
    lens = np.r_[np.full(2 * TILE // 16, 16), TILE, np.full(40, 8), LONG_ROW, np.full(40, 8),
                 np.zeros(MAX_ROWS + 5, np.int64), 5]
    m = lens.size
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), lens)
    c = np.concatenate([rng.choice(3 * TILE, k, replace=False) for k in lens])
    return _csr(r, c, m, 3 * TILE, dtype, seed + 1)


REPLAYED = {"power_law": power_law, "empty_rows": with_empty_rows, "one_long_row": one_long_row,
            "tile_exact": tile_exact}


@pytest.mark.parametrize("idx_bytes", [4, 8], ids=["ind32", "ind64"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", sorted(REPLAYED))
def test_kernel_replay_matches_plain(name, dtype, idx_bytes):
    S = REPLAYED[name](41, dtype=dtype)
    x = _values(np.random.default_rng(42), S.shape[1], dtype)
    blocks = csr_blocks(S.indptr, *tile_of(TORCH[dtype]))
    got = replay(S.indptr, S.indices, S.data, x, blocks, idx_bytes)
    want = spmv_csr_plain(torch.from_numpy(S.indptr), torch.from_numpy(S.indices), torch.from_numpy(S.data),
                          torch.from_numpy(x)).numpy()
    assert near_error(got, want) <= tol(dtype)

# -- parity with the JAX package (its XLA spmv_segsum) --------------------------


OPERANDS = {"power_law": power_law, "empty_rows": with_empty_rows, "one_long_row": one_long_row}


def _both(ast, S, ptr_dtype=np.int32):
    m, n = S.shape
    ptr = S.indptr.astype(ptr_dtype)
    return ast.create_csr(m, n, ptr, S.indices, S.data), tt.create_csr(m, n, ptr, S.indices, S.data, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", sorted(OPERANDS))
def test_kid0_matches_jax_and_scipy(ast, name, dtype):
    S = OPERANDS[name](11, dtype=dtype)
    J, T = _both(ast, S)
    x = _values(np.random.default_rng(12), S.shape[1], dtype)
    yj = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0, kid=0))
    yt = tt.mv(1.0, T, GEN, NONE, torch.from_numpy(x), 0.0, kid=0).numpy()
    ref = S.astype(np.complex128 if np.iscomplexobj(x) else np.float64) @ x
    assert yt.dtype == dtype
    assert near_error(yt, yj) <= tol(dtype)
    assert near_error(yt, ref) <= tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("ptr_dtype", [np.int32, np.int64], ids=["ptr32", "ptr64"])
def test_kid0_alpha_beta_transposed(ast, dtype, ptr_dtype):
    S = power_law(13, m=900, dtype=dtype)
    J, T = _both(ast, S, ptr_dtype)
    rng = np.random.default_rng(14)
    x, y = _values(rng, S.shape[0], dtype), _values(rng, S.shape[1], dtype)
    alpha, beta = 1.5, -0.5
    yj = np.asarray(ast.mv(alpha, J, ast.MatrixDescriptor(), ast.Operation.transpose, x, beta, y=y, kid=0))
    yt = tt.mv(alpha, T, GEN, tt.Operation.transpose, torch.from_numpy(x), beta, torch.from_numpy(y), kid=0).numpy()
    wide = np.complex128 if np.iscomplexobj(x) else np.float64
    ref = alpha * (S.T.astype(wide) @ x) + beta * y
    assert near_error(yt, yj) <= tol(dtype)
    assert near_error(yt, ref) <= tol(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.complex128], ids=lambda d: d.__name__)
def test_kid0_all_empty_matrix(ast, dtype):
    m = 300
    J = ast.create_csr(m, m, np.zeros(m + 1, np.int32), np.zeros(0, np.int32), np.zeros(0, dtype))
    T = tt.create_csr(m, m, np.zeros(m + 1, np.int32), np.zeros(0, np.int32), np.zeros(0, dtype), device="cpu")
    x = _values(np.random.default_rng(15), m, dtype)
    y = _values(np.random.default_rng(16), m, dtype)
    yj = np.asarray(ast.mv(2.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.5, y=y, kid=0))
    yt = tt.mv(2.0, T, GEN, NONE, torch.from_numpy(x), 0.5, torch.from_numpy(y), kid=0).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=0)
    np.testing.assert_allclose(yt, 0.5 * y, rtol=0, atol=0)
    # the form of an empty matrix: one block of its 300 empty rows
    form = tplan.get_plan(T).exec_form_for(GEN, NONE, kind="segsum")
    assert form.csr_blocks.tolist() == [[0, 0], [m, 0]] and block_stats(form.csr_blocks) == (1, 0)


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_wrapper_plain_path_takes_either_index_width(idx):
    S = one_long_row(17, dtype=np.float64)
    blocks = torch.from_numpy(csr_blocks(S.indptr, *tile_of(torch.float64)))
    ptr = torch.from_numpy(S.indptr).to(idx)
    ind = torch.from_numpy(S.indices).to(idx)
    val, x = torch.from_numpy(S.data), torch.from_numpy(np.random.default_rng(18).standard_normal(S.shape[1]))
    got = spmv_csr(ptr, ind, val, x, blocks)
    assert near_error(got.numpy(), S @ x.numpy()) <= tol(np.float64)
    rows = torch.repeat_interleave(torch.arange(S.shape[0]), torch.from_numpy(np.diff(S.indptr)))
    assert torch.equal(got, spmv_segsum(ind, val, rows, x, S.shape[0]))
    # on the CPU every dtype takes the plain version: bf16 sums in f32 and
    # rounds once (the kernel's arithmetic), mixed dtypes promote
    xb = x.to(torch.bfloat16)
    vb = val.to(torch.bfloat16)
    assert torch.equal(spmv_csr_any(ind, vb, rows, xb, S.shape[0], ptr, None),
                       spmv_segsum(ind, vb.float(), rows, xb.float(), S.shape[0]).to(torch.bfloat16))
    assert spmv_csr_any(ind, val, rows, x.float(), S.shape[0], ptr, None).dtype == torch.float64
    # and on the CPU the kernel's dtypes take the wrapper's plain path
    assert torch.equal(spmv_csr_any(ind, val, rows, x, S.shape[0], ptr, blocks), got)


def test_bf16_segsum_sums_in_f32(ast):
    """A bf16 handle's mv by kid=0 sums in f32 and rounds once (the
    kernel's arithmetic, on the CPU its plain version): within 2^-8 of
    float64 scipy on the bf16 values, where the JAX package's mv(kid=0)
    sums the bf16 products in bf16; the two agree within the bf16 model
    tolerance on rows of 0-12 entries (a deliberate divergence, ROADMAP)."""
    import jax.numpy as jnp

    S = with_empty_rows(47)
    vb = torch.from_numpy(S.data).to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(48).standard_normal(S.shape[1])).to(torch.bfloat16)
    T = tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, vb, device="cpu")
    got = tt.mv(1.0, T, GEN, NONE, x, 0.0, kid=0)
    assert got.dtype == torch.bfloat16
    Sb = sp.csr_matrix((vb.double().numpy(), S.indices, S.indptr), shape=S.shape)
    assert near_error(got.double().numpy(), Sb @ x.double().numpy()) <= 2.0**-8
    J = ast.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, jnp.asarray(vb.float().numpy(), dtype=jnp.bfloat16))
    want = ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, jnp.asarray(x.float().numpy(),
                                                                                  dtype=jnp.bfloat16), 0.0, kid=0)
    assert near_error(got.double().numpy(), np.asarray(want).astype(np.float64)) <= expected_precision(torch.bfloat16)


def test_wrapper_validates():
    S = scatter(19, m=64)
    ptr, ind = torch.from_numpy(S.indptr.astype(np.int32)), torch.from_numpy(S.indices)
    val = torch.from_numpy(S.data)
    x, bl = torch.ones(64), torch.from_numpy(csr_blocks(S.indptr, TILE, MAX_ROWS))
    for args, status in (
        ((ptr, ind, val.to(torch.float16), x.to(torch.float16), bl), tt.Status.wrong_type),
        ((ptr, ind, val, x.double(), bl), tt.Status.wrong_type),
        ((ptr.to(torch.int16), ind, val, x, bl), tt.Status.wrong_type),
        ((ptr, ind[:-1], val, x, bl), tt.Status.invalid_size),
        ((ptr, ind, val, x, bl.reshape(-1)), tt.Status.invalid_size),
        ((ptr, ind, val, torch.ones(128)[::2], bl), tt.Status.invalid_value),
        ((ptr, ind, val, x, bl[:, :1]), tt.Status.invalid_size),
        ((ptr, ind, val, x, bl.t().contiguous().t()), tt.Status.invalid_value),
        ((ptr, ind, val, x, bl.int()), tt.Status.wrong_type),
    ):
        with pytest.raises(tt.AoclSparseError) as e:
            spmv_csr(*args)
        assert e.value.status == status


# -- the rule on the card, and pins ---------------------------------------------


def test_rule_on_cuda_takes_segsum_for_general_structure():
    """The device-taking rule on small stand-ins: scatter, webbase (a
    scaled-down power law) and scircuit take segsum on cuda and gen on the
    CPU; a band stays bandt and the 27-point stencil diag on both."""
    cases = {"scatter": (scatter(21), "gen"), "webbase": (power_law(22), "gen"), "scircuit": (circuit(23), "gen"),
             "band": (band(24), "bandt"), "stencil": (stencil27(12), "diag")}
    for name, (S, cpu_kind) in cases.items():
        eff = tplan.get_plan(_handle(S)).effective_for(GEN, NONE)
        assert tplan.structure_mv_format(eff) == cpu_kind, name
        assert tplan.choose_mv_format(eff) == cpu_kind, name
        assert tplan.choose_mv_format(eff, device="cpu") == cpu_kind, name
        want = "segsum" if cpu_kind == "gen" else cpu_kind
        assert tplan.choose_mv_format(eff, device="cuda") == want, name
        assert tplan.choose_mv_format(eff, device=torch.device("cuda", 0)) == want, name
    for dt, want in ((torch.float32, "segsum"), (torch.float64, "segsum"), (torch.bfloat16, "gen")):
        assert tplan.pick_mv_format("gen", "cuda", dt) == want
        assert tplan.pick_mv_format("gen", "cpu", dt) == "gen"
    for kind in ("bandt", "diag", "segsum", "ell"):
        assert tplan.pick_mv_format(kind, "cuda", torch.float32) == kind
    # mm keeps gen by structure (mm KID 6) on every device
    eff = tplan.get_plan(_handle(circuit(23))).effective_for(GEN, NONE)
    assert tplan.choose_mm_format(eff) == "gen"


MV_SLOT = (GEN.type, GEN.fill_mode, GEN.diag_type, NONE, None)


def _plant_segsum(A):
    """The card's default asked of a CPU handle: the segsum form planted in
    the default mv slot, where autotune_mv writes its pin."""
    plan = tplan.get_plan(A)
    plan.exec_form_for(GEN, NONE, kind="segsum")
    plan.exec_forms[MV_SLOT] = plan.exec_forms.pop(MV_SLOT[:4] + ("segsum",))
    return plan


def test_default_form_on_the_cpu_is_unchanged_and_pins_give_gen():
    S = circuit(25)
    T = _handle(S)
    plan = tplan.get_plan(T)
    assert plan.exec_form_for(GEN, NONE).kind == "gen"
    x = torch.from_numpy(np.random.default_rng(26).standard_normal(S.shape[0]).astype(np.float32))
    ref = S.astype(np.float64) @ x.numpy().astype(np.float64)
    y7 = tt.mv(1.0, T, GEN, NONE, x, 0.0, kid=7)
    y0 = tt.mv(1.0, T, GEN, NONE, x, 0.0, kid=0)
    assert near_error(y7.numpy(), ref) <= tol(np.float32) and near_error(y0.numpy(), ref) <= tol(np.float32)
    # the card's default (segsum) planted on a CPU handle: gen by pin
    U = _handle(S)
    assert _plant_segsum(U).exec_form_for(GEN, NONE).kind == "segsum"
    assert near_error(tt.mv(1.0, U, GEN, NONE, x, 0.0).numpy(), ref) <= tol(np.float32)
    assert tplan.get_plan(U).exec_form_for(GEN, NONE, kind="gen").kind == "gen"
    assert near_error(tt.mv(1.0, U, GEN, NONE, x, 0.0, kid=7).numpy(), ref) <= tol(np.float32)
    res = tt.autotune_mv(U, kinds=("gen",), iters=1, chunks=1)
    assert set(res) == {"gen", "segsum"}
    winner = min(res, key=res.get)
    assert tplan.get_plan(U).exec_forms[(GEN.type, GEN.fill_mode, GEN.diag_type, NONE, None)].kind == winner
    # a gen pin planted in the default slot (what autotune_mv writes when
    # gen wins) sends mv_operator and the solvers to permuted space
    tplan.get_plan(U).exec_forms[(GEN.type, GEN.fill_mode, GEN.diag_type, NONE, None)] = \
        tplan.get_plan(U).gen_form_for(GEN, NONE)
    assert tt.mv_operator(U).space == "permuted"


def _rewrite_snapshot(path, out, edit):
    """Copy the snapshot at `path` to `out`, `edit(manifest entry, arrays,
    slot)` applied to each stored form."""
    with np.load(path) as npz:
        arrays = {k: npz[k] for k in npz.files}
    manifest = json.loads(bytes(arrays["__manifest__"]).decode())
    for i, entry in enumerate(manifest["exec_forms"]):
        if "same_as" not in entry:
            edit(entry, arrays, f"ef{i}")
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez_compressed(out, **arrays)


def _segsum_snapshot(tmp_path):
    S = power_law(27)
    T = _handle(S)
    _plant_segsum(T)
    x = torch.from_numpy(np.random.default_rng(28).standard_normal(S.shape[0]).astype(np.float32))
    y = tt.mv(1.0, T, GEN, NONE, x, 0.0)
    form = tplan.get_plan(T).exec_form_for(GEN, NONE)
    assert form.kind == "segsum"
    path = tmp_path / "plan.npz"
    save_plan(T, path)
    return S, x, y, form, path


def test_plan_snapshot_of_a_segsum_form(tmp_path):
    """save_plan / load_plan of a segsum form: the same mv bit for bit;
    a snapshot without the CSR fields (as written before segsum forms
    carried them) rebuilds them on load."""
    S, x, y, form, path = _segsum_snapshot(tmp_path)
    T2 = _handle(S)
    assert load_plan(T2, path) == 1
    f2 = tplan.get_plan(T2).exec_form_for(GEN, NONE)
    assert f2.kind == "segsum" and torch.equal(f2.csr_blocks, form.csr_blocks)
    assert torch.equal(f2.ptr, form.ptr) and f2.ptr.dtype == torch.int32
    assert torch.equal(tt.mv(1.0, T2, GEN, NONE, x, 0.0), y)

    # strip the CSR fields: the layout of a snapshot from before
    def strip(entry, arrays, slot):
        entry["kinds"] = {k: v for k, v in entry["kinds"].items() if k not in ("ptr", "csr_blocks")}
        entry["kinds"]["ind"] = ["torch", "int64"]
        del arrays[f"{slot}::ptr"], arrays[f"{slot}::csr_blocks"]
        arrays[f"{slot}::ind"] = arrays[f"{slot}::ind"].astype(np.int64)

    old = tmp_path / "old.npz"
    _rewrite_snapshot(path, old, strip)
    T3 = _handle(S)
    assert load_plan(T3, old) == 1
    f3 = tplan.get_plan(T3).exec_form_for(GEN, NONE)
    assert torch.equal(f3.csr_blocks, form.csr_blocks)
    assert f3.ind.dtype == torch.int64 and torch.equal(f3.ptr, form.ptr)
    assert torch.equal(tt.mv(1.0, T3, GEN, NONE, x, 0.0), y)


def test_plan_snapshot_with_the_earlier_schedule(tmp_path):
    """A snapshot written with the CSR kernel's earlier schedule (its
    sub-warp width `csr_lanes` and long-row list `csr_long`) loads, drops
    those fields and rebuilds the block schedule from ptr: the same mv."""
    S, x, y, form, path = _segsum_snapshot(tmp_path)

    def earlier(entry, arrays, slot):
        del entry["kinds"]["csr_blocks"], arrays[f"{slot}::csr_blocks"]
        entry["statics"]["csr_lanes"] = 4
        entry["kinds"]["csr_long"] = ["torch", "int64"]
        arrays[f"{slot}::csr_long"] = np.nonzero(np.diff(S.indptr) > 32)[0].astype(np.int64)

    old = tmp_path / "earlier.npz"
    _rewrite_snapshot(path, old, earlier)
    with np.load(old) as npz:
        assert any(k.endswith("::csr_long") for k in npz.files)
    T2 = _handle(S)
    assert load_plan(T2, old) == 1
    f2 = tplan.get_plan(T2).exec_form_for(GEN, NONE)
    assert f2.kind == "segsum" and not hasattr(f2, "csr_long") and not hasattr(f2, "csr_lanes")
    assert torch.equal(f2.csr_blocks, form.csr_blocks) and torch.equal(f2.ptr, form.ptr)
    assert torch.equal(tt.mv(1.0, T2, GEN, NONE, x, 0.0), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segsum_rows_are_built_from_ptr_where_missing(dtype):
    """A segsum form's row ids: kept where the plain gather runs its mv (a
    CPU form; on the card only a dtype without a kernel instance), else
    built from ptr at first use by mm; mv without them derives them."""
    S = with_empty_rows(37)
    T = tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, S.data, device="cpu")
    if dtype != torch.float32:
        T = tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices,
                          torch.from_numpy(S.data).to(dtype), device="cpu")
    form = tplan.get_plan(T).exec_form_for(GEN, NONE, kind="segsum")
    want = np.repeat(np.arange(S.shape[0]), np.diff(S.indptr))
    assert form.row_ids is not None and np.array_equal(form.row_ids.numpy(), want)
    x = torch.from_numpy(np.random.default_rng(38).standard_normal(S.shape[1]).astype(np.float32)).to(dtype)
    y = spmv_csr_any(form.ind, form.val, form.row_ids, x, form.m, form.ptr, form.csr_blocks)
    y_none = spmv_csr_any(form.ind, form.val, None, x, form.m, form.ptr, form.csr_blocks)
    assert torch.equal(y, y_none)
    form.row_ids = None
    rows = form.segsum_rows()
    assert rows.dtype == torch.int64 and np.array_equal(rows.numpy(), want) and form.row_ids is rows
    # attach_csr_plan on a CPU form without row ids gives them back
    form.row_ids = None
    tplan.attach_csr_plan(form, S.indptr)
    assert np.array_equal(form.row_ids.numpy(), want)


# -- on the card ------------------------------------------------------------------


INSTANCE = {np.float32: "f32", np.float64: "f64", np.complex64: "c64", np.complex128: "c128"}


def _on_card(S, dtype, idx, cuda):
    ptr = torch.from_numpy(S.indptr).to(cuda, idx)
    ind = torch.from_numpy(S.indices).to(cuda, idx)
    val = torch.from_numpy(S.data).to(cuda)
    x = torch.from_numpy(_values(np.random.default_rng(32), S.shape[1], dtype)).to(cuda)
    return ptr, ind, val, x, torch.from_numpy(csr_blocks(S.indptr, *tile_of(TORCH[dtype]))).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", ["power_law", "empty_rows", "one_long_row", "scatter", "tile_exact"])
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_cuda_kernel_matches_plain(cuda, dtype, name, idx):
    """The kernel against its plain version (both index widths; a hub row
    of 10,000 entries, runs of empty rows, tiles filled exactly), the same
    bits twice, and one launch a call."""
    S = {**OPERANDS, **REPLAYED, "scatter": scatter}[name](31, dtype=dtype)
    ptr, ind, val, x, blocks = _on_card(S, dtype, idx, cuda)
    before = spmv_csr.launches[INSTANCE[dtype]]
    got = spmv_csr(ptr, ind, val, x, blocks)
    torch.cuda.synchronize()
    assert spmv_csr.launches[INSTANCE[dtype]] - before == 1
    want = spmv_csr_plain(ptr, ind, val, x)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= tol(dtype)
    assert torch.equal(spmv_csr(ptr, ind, val, x, blocks), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_cuda_kernel_on_unaligned_streams(cuda, dtype):
    """ind and val as views one entry into their storage (ind off its
    16-byte alignment, so no 16-byte loads: every slot scalar): the same
    result as on aligned copies."""
    S = power_law(43, dtype=dtype)
    ptr, ind, val, x, blocks = _on_card(S, dtype, torch.int32, cuda)
    ind_u = torch.cat([ind[:1], ind])[1:]
    val_u = torch.cat([val[:1], val])[1:]
    assert ind_u.data_ptr() % 16 and ind_u.is_contiguous() and val_u.is_contiguous()
    got = spmv_csr(ptr, ind_u, val_u, x, blocks)
    assert near_error(got.cpu().numpy(), spmv_csr_plain(ptr, ind, val, x).cpu().numpy()) <= tol(dtype)
    assert torch.equal(got, spmv_csr(ptr, ind_u, val_u, x, blocks))


@pytest.mark.cuda
def test_cuda_default_mv_on_general_structure_launches_the_csr_kernel(cuda):
    from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv

    circuit_s = circuit(33)
    for S in (circuit_s, power_law(34), scatter(35)):
        A = _handle(S, device=cuda)
        form = tplan.get_plan(A).exec_form_for(GEN, NONE)
        assert form.kind == "segsum"
        x = torch.from_numpy(np.random.default_rng(36).standard_normal(S.shape[0]).astype(np.float32)).to(cuda)
        c0, b0 = spmv_csr.launches["f32"], band_spmv.launches["f32"]
        y = tt.mv(1.0, A, GEN, NONE, x, 0.0)
        torch.cuda.synchronize()
        assert spmv_csr.launches["f32"] - c0 == 1
        assert band_spmv.launches["f32"] == b0
        ref = S.astype(np.float64) @ x.cpu().numpy().astype(np.float64)
        assert near_error(y.cpu().numpy(), ref) <= tol(np.float32)
        # a gen pin still runs the composite, not the CSR kernel, where
        # _build_gen takes the structure (the circuit-like operand does)
        if tplan.get_plan(A).gen_form_for(GEN, NONE) is None:
            assert S is not circuit_s
            continue
        c1 = spmv_csr.launches["f32"]
        y7 = tt.mv(1.0, A, GEN, NONE, x, 0.0, kid=7)
        torch.cuda.synchronize()
        assert spmv_csr.launches["f32"] == c1
        assert near_error(y7.cpu().numpy(), ref) <= tol(np.float32)
    assert csr_mod.KERNEL_DTYPES == (torch.float32, torch.float64, torch.complex64, torch.complex128, torch.bfloat16)
    assert tplan.CARD_MV_CSR_DTYPES == csr_mod.KERNEL_DTYPES[:4]


@pytest.mark.cuda
def test_cuda_segsum_form_keeps_no_row_ids(cuda):
    """On the card a segsum form holds ptr, ind and val: no row ids, since
    mm's CSR SpMM kernel reads ptr too (the plain version's comparison
    builds them from ptr), and mm and mv agree with scipy."""
    S = power_law(39)
    A = _handle(S, device=cuda)
    form = tplan.get_plan(A).exec_form_for(GEN, NONE)
    assert form.kind == "segsum" and form.row_ids is None
    assert form.nbytes() == sum(t.numel() * t.element_size() for t in (form.ptr, form.ind, form.val, form.csr_blocks))
    B = np.random.default_rng(40).standard_normal((S.shape[1], 3)).astype(np.float32)
    C = tt.mm(1.0, A, GEN, NONE, torch.from_numpy(B).to(cuda), 0.0, kid=0)
    ref = S.astype(np.float64) @ B.astype(np.float64)
    assert near_error(C.cpu().numpy(), ref) <= tol(np.float32)
    # mm kid=0 shares the default's form and builds no rows; segsum_rows
    # builds them from ptr for the plain version
    assert tplan.get_plan(A).exec_form_for(GEN, NONE, kind="segsum") is form and form.row_ids is None
    assert np.array_equal(form.segsum_rows().cpu().numpy(), np.repeat(np.arange(S.shape[0]), np.diff(S.indptr)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["power_law", "empty_rows", "one_long_row", "scatter", "tile_exact"])
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_cuda_bf16_instance(cuda, name, idx):
    """The bf16 instance (f32 sums, y rounded once) against its plain
    version, f32 sums of the same bf16 values rounded once (the sums in
    another order: four bf16 units in the last place), and against float64
    scipy on the bf16 values (two units); the same bits twice, one launch a
    call; a bf16 handle's mv by kid=0 and under the restricted memory policy
    launches it."""
    S = {**OPERANDS, **REPLAYED, "scatter": scatter}[name](31, dtype=np.float32)
    ptr, ind, val, x, _b = _on_card(S, np.float32, idx, cuda)
    val, x = val.to(torch.bfloat16), x.to(torch.bfloat16)
    blocks = torch.from_numpy(csr_blocks(S.indptr, *tile_of(torch.bfloat16))).to(cuda)
    before = spmv_csr.launches["bf16"]
    got = spmv_csr(ptr, ind, val, x, blocks)
    torch.cuda.synchronize()
    assert spmv_csr.launches["bf16"] - before == 1 and got.dtype == torch.bfloat16
    f32 = spmv_csr_plain(ptr, ind, val, x)
    assert f32.dtype == torch.bfloat16
    assert near_error(got.double().cpu().numpy(), f32.double().cpu().numpy()) <= 4 * 2.0**-7
    Sb = sp.csr_matrix((val.double().cpu().numpy(), S.indices, S.indptr), shape=S.shape)
    assert near_error(got.double().cpu().numpy(), Sb @ x.double().cpu().numpy()) <= 2 * 2.0**-7
    assert torch.equal(spmv_csr(ptr, ind, val, x, blocks), got)
    if name == "power_law":
        A = tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, torch.from_numpy(S.data).to(torch.bfloat16),
                          device=cuda)
        for run in (lambda: tt.mv(1.0, A, GEN, NONE, x, 0.0, kid=0),
                    lambda: (tt.set_memory_hint(A, tt.MemoryPolicy.restricted), tt.mv(1.0, A, GEN, NONE, x, 0.0))[1]):
            c0 = spmv_csr.launches["bf16"]
            y = run()
            torch.cuda.synchronize()
            assert spmv_csr.launches["bf16"] - c0 == 1
            assert near_error(y.double().cpu().numpy(), f32.double().cpu().numpy()) <= 4 * 2.0**-7


@pytest.mark.cuda
def test_cuda_other_dtypes_raise(cuda):
    """No CUDA tensor takes the plain version: float16 values, and values
    and x of two dtypes, raise in the registry's KID 0 function; a float16
    handle's mv on general structure (a segsum form) raises (a deliberate
    divergence: the JAX package computes it)."""
    S = power_law(45)
    ptr, ind, val, x, blocks = _on_card(S, np.float32, torch.int32, cuda)
    for v, xx in ((val.half(), x.half()), (val, x.double()), (val.to(torch.bfloat16), x)):
        with pytest.raises(tt.AoclSparseError):
            spmv_csr_any(ind, v, None, xx, S.shape[0], ptr, blocks)
    A = tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, torch.from_numpy(S.data).half(), device=cuda)
    assert tplan.get_plan(A).exec_form_for(GEN, NONE).kind == "segsum"
    with pytest.raises(tt.AoclSparseError):
        tt.mv(1.0, A, GEN, NONE, x.half(), 0.0)
