"""The level-solve kernel of the PyTorch port (csrc/trsv_level.cu, sv KID 1)
on the CPU: its compact level-ordered layout, its grid, an emulation of its
schedule, the gate that sends the default solve to it, and the routing of
the solves and solvers through that gate.

Triangles, made with numpy from seeds: the ILU0 L and U factors of HPCG's
27-point stencil on an 8^3 grid (the port's own factorization), the lower
and upper triangles of a scatter operand (m = 2048, the diagonal 4.0 plus 8
uniform random columns a row, seed 23), and the lower triangle of a
tridiagonal (one level a row). Upper triangles solve reversed, as the
planner orients them. Complex triangles carry the real values times
(1 + 0.25i).

The emulation replays the kernel's schedule (csrc/trsv_level.cu): a grid of
resident warps deals the positions of the level order in turn (warp w
takes w, w + W, ...), the warps visited in a seeded random order; a row
solves only when every column is ready: by its readiness word's epoch at
K = 1 (the word carries the value), by its ready flag at K > 1 (the value
is read from x, whose unsolved rows hold NaN as torch.empty may). Its
value is summed in the kernel's order: at K = 1 lane l of 32 sums entries
l, l + 32, ... in order, then a fixed xor butterfly; at K > 1 each column
sums the row's entries in order. It does not reproduce the card's fused
multiply-add rounding: its results are held to the plain version, the JAX
package's `solve_levels` and scipy's substitution at expected_precision of
the dtype (utils/tolerances.py) on max |a - b| / max(|b|, 1), the same
sums taken in another order, and to its own bits under other grids and
visiting orders.

The cuda-marked tests hold the kernel to its plain version on the card.
"""

import types

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels import trsv_blocked as tb
from aoclsparse_tpu_torch.kernels import trsv_level as tl
from aoclsparse_tpu_torch.kernels.trsv_level import build_level_form, trsv_level, trsv_level_plain
from aoclsparse_tpu_torch.planner import triangular as ttri
from aoclsparse_tpu_torch.solvers import ilu as ilu_mod
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

NONE = tt.Operation.none
DTYPES = {"f32": np.float32, "f64": np.float64, "c64": np.complex64, "c128": np.complex128}


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def stencil27(nx):
    """HPCG's 27-point stencil on an nx^3 grid: (ptr, ind, val f64)."""
    m = nx**3
    i = np.arange(m, dtype=np.int64)
    z, y, x = i // (nx * nx), (i // nx) % nx, i % nx
    offs, masks = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                offs.append((dz * nx + dy) * nx + dx)
                masks.append((0 <= z + dz) & (z + dz < nx) & (0 <= y + dy) & (y + dy < nx)
                             & (0 <= x + dx) & (x + dx < nx))
    valid = np.stack(masks, axis=1)
    cols = (i[:, None] + np.asarray(offs)[None, :])[valid]
    ptr = np.concatenate([[0], np.cumsum(valid.sum(1))])
    val = np.where(cols == np.repeat(i, valid.sum(1)), 26.0, -1.0)
    return ptr, cols, val


def scatter(m, per_row=8, seed=23):
    """The diagonal 4.0 plus per_row uniform random columns a row with
    standard normal values (duplicates summed): scipy CSR, f64."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), per_row)
    cols = rng.integers(0, m, rows.size)
    d = np.arange(m)
    S = sp.csr_matrix((np.r_[rng.standard_normal(rows.size), np.full(m, 4.0)], (np.r_[rows, d], np.r_[cols, d])),
                      shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S


def _ilu_factors(nx=8):
    """(L strict lower, U with its diagonal) of the port's ILU0 of the nx^3
    stencil, as scipy CSR."""
    ptr, ind, val = stencil27(nx)
    m = len(ptr) - 1
    st = tt.ilu0_factorize(tt.create_csr(m, m, ptr, ind, val, device="cpu"))
    LU = sp.csr_matrix((st.lu.numpy(), ind, ptr), shape=(m, m))
    return sp.tril(LU, -1).tocsr(), sp.triu(LU).tocsr()


def _triangles():
    """name -> (scipy CSR triangle, upper, unit diagonal)."""
    L, U = _ilu_factors()
    S = scatter(2048)
    m = 3000
    T = sp.diags([np.full(m - 1, -0.5), np.full(m, 2.0), np.full(m - 1, -0.5)], [-1, 0, 1]).tocsr()
    out = {
        "ilu_L": (L, False, True),
        "ilu_U": (U, True, False),
        "scatter_L": (sp.tril(S).tocsr(), False, False),
        "scatter_U": (sp.triu(S).tocsr(), True, False),
        "tridiag_L": (sp.tril(T).tocsr(), False, False),
    }
    for T_, _u, _d in out.values():
        T_.sort_indices()
    return out


TRI = _triangles()


def oriented(T, upper):
    """(ptr, ind, src) of the lower-oriented structure: an upper triangle
    reversed (row and column i -> m - 1 - i), src the positions in T.data."""
    if not upper:
        return T.indptr.astype(np.int64), T.indices.astype(np.int64), np.arange(T.nnz, dtype=np.int64)
    m = T.shape[0]
    rows = np.repeat(np.arange(m), np.diff(T.indptr))
    r, c = m - 1 - rows, m - 1 - T.indices
    order = np.lexsort((c, r))
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=m), out=ptr[1:])
    return ptr, c[order].astype(np.int64), order.astype(np.int64)


def tri_values(name, dtype):
    """The triangle's stored values in `dtype`: complex ones times (1 + 0.25i)."""
    v = TRI[name][0].data
    if np.issubdtype(dtype, np.complexfloating):
        v = v * (1 + 0.25j)
    return v.astype(dtype)


def port_form(name, dtype):
    T, upper, unit = TRI[name]
    ptr, ind, src = oriented(T, upper)
    return build_level_form(ptr, ind, src, T.shape[0], upper, unit, torch.from_numpy(tri_values(name, dtype)))


def dense_ref(name, b, dtype=np.float64):
    """scipy's substitution in float64 / complex128 (the unit triangle with
    its 1s), on the values of `dtype`."""
    T, upper, unit = TRI[name]
    wide = np.complex128 if np.issubdtype(dtype, np.complexfloating) else np.float64
    T = sp.csr_matrix((tri_values(name, dtype).astype(wide), T.indices, T.indptr), shape=T.shape)
    if unit:
        T = (T + sp.eye(T.shape[0])).tocsr()
    return spla.spsolve_triangular(T, b, lower=not upper)


def rhs(m, K, seed=7, dtype=np.float64):
    rng = np.random.default_rng(seed)
    shape = (m,) if K == 1 else (m, K)
    b = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        b = b + 1j * rng.standard_normal(shape)
    return b.astype(dtype)


# ---------------------------------------------------------------------------
# the emulation of the kernel's schedule
# ---------------------------------------------------------------------------


def _row_value(form_np, fetch, B, p):
    """Row lrow[p]'s new values (K,) in the kernel's sum order, against
    fetch(cols) (len(cols), K): at K = 1 lane l of the row's warp sums
    entries l, l + 32, ... in order, then the lanes meet in the xor
    butterfly; at K > 1 each column sums the entries in order."""
    lrow, lptr, lcol, lval, dinv = form_np
    dt = lval.dtype
    beg, end = int(lptr[p]), int(lptr[p + 1])
    vals, xs = lval[beg:end, None], fetch(lcol[beg:end])
    if B.shape[1] > 1:
        acc = np.zeros(B.shape[1], dtype=dt)
        for j in range(end - beg):
            acc = (vals[j] * xs[j] + acc).astype(dt)
        return ((B[lrow[p]] - acc) * dinv[p]).astype(dt)
    part = np.zeros((32, 1), dtype=dt)
    for t0 in range(0, end - beg, 32):
        n = min(32, end - beg - t0)
        part[:n] = (vals[t0:t0 + n] * xs[t0:t0 + n] + part[:n]).astype(dt)
    sh = 16
    while sh:
        part = (part + part[np.arange(32) ^ sh]).astype(dt)
        sh //= 2
    return ((B[lrow[p]] - part[0]) * dinv[p]).astype(dt)


def emulate(form, b, warps=48, seed=0, epoch=1, state=None, accept=None):
    """Replay the kernel's schedule on the host: `warps` resident warps,
    warp w taking positions w, w + warps, ... in order, visited in a seeded
    random order; a row solves once every column's word (K = 1) or flag
    (K > 1) passes accept(ep, epoch) (the kernel's test: ep == epoch), then
    marks its row. `state` carries the words (epoch and value) and flags
    (epoch) across calls, as the form's do. Raises on a round with no
    progress (a deadlock). Returns (x, state)."""
    form_np = tuple(t.numpy() for t in (form.lrow, form.lptr, form.lcol, form.lval, form.dinv))
    lrow, lptr, lcol = form_np[:3]
    m = form.m
    B = b.numpy().reshape(m, -1)
    words = B.shape[1] == 1
    X = np.full(B.shape, np.nan, dtype=form_np[3].dtype)
    if state is None:
        state = {"ep": np.zeros(m, dtype=np.int64), "val": np.zeros(B.shape, dtype=X.dtype)}
    accept = accept or (lambda ep, want: ep == want)
    rng = np.random.default_rng(seed)

    def fetch(cols):
        return state["val"][cols] if words else X[cols]

    at = {w: w for w in range(min(warps, m))}  # warp -> its current position
    while at:
        progress = False
        for w in rng.permutation(sorted(at)):
            p = at[w]
            if np.all(accept(state["ep"][lcol[lptr[p]:lptr[p + 1]]], epoch)):
                row = lrow[p]
                X[row] = _row_value(form_np, fetch, B, p)
                state["ep"][row] = epoch
                if words:
                    state["val"][row] = X[row]
                progress = True
                at[w] = p + warps
                if at[w] >= m:
                    del at[w]
        if not progress:
            raise AssertionError("the emulated schedule made no progress")
    x = torch.from_numpy(X)
    return (x[:, 0] if b.dim() == 1 else x), state


# ---------------------------------------------------------------------------
# the compact layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TRI))
def test_compact_layout(name):
    """lrow is a permutation in level order (lvl_ptr bounds each level,
    every strict column lies in an earlier level), the entries are the
    triangle's strict entries with their values, and dinv inverts its
    diagonal (1 for a unit triangle)."""
    T, upper, unit = TRI[name]
    m = T.shape[0]
    f = port_form(name, np.float64)
    lrow, lptr, lcol, lvl = (t.numpy().astype(np.int64) for t in (f.lrow, f.lptr, f.lcol, f.lvl_ptr))
    assert all(t.dtype == torch.int32 for t in (f.lrow, f.lptr, f.lcol, f.lvl_ptr))
    assert np.array_equal(np.sort(lrow), np.arange(m))
    assert lvl[0] == 0 and lvl[-1] == m and lvl.size == f.nlev + 1 and np.all(np.diff(lvl) > 0)
    level_of = np.empty(m, dtype=np.int64)
    level_of[lrow] = np.repeat(np.arange(f.nlev), np.diff(lvl))
    rows = np.repeat(lrow, np.diff(lptr))
    assert np.all(level_of[lcol] < level_of[rows])
    # the same entries and values as the triangle's strict part
    strict = sp.triu(T, 1) if upper else sp.tril(T, -1)
    got = sp.csr_matrix((f.lval.numpy(), (rows, lcol)), shape=(m, m))
    assert (got != strict).nnz == 0 and got.nnz == strict.nnz
    d = np.ones(m) if unit else 1.0 / T.diagonal()
    assert np.array_equal(f.dinv.numpy(), d[lrow])
    if name == "tridiag_L":
        assert f.nlev == m


@pytest.mark.parametrize(
    "m,nlev,sms,per_sm,want",
    [
        (1124864, 722, 132, 3, 244),  # the 104^3 stencil's factor: 2.5 warps a row of its mean level
        (262144, 29, 132, 3, 396),  # the scatter triangle: wide levels fill the card
        (20000, 20000, 132, 3, 132),  # a chain: at least a CTA an SM
        (7, 1, 132, 1, 132),
    ],
)
def test_grid_for(monkeypatch, m, nlev, sms, per_sm, want):
    """The launch's grid: LEVEL_SLACK warps a row of the mean level, within
    a CTA an SM and what the card holds."""
    monkeypatch.setattr(tl, "LEVEL_SLACK", 2.5)
    assert tl.grid_for(m, nlev, sms, per_sm) == want


def _emulated_vs_references(ast, name, K, dtype, check_bits=True):
    from aoclsparse_tpu.kernels.xla import trsv_level as jl

    T, upper, unit = TRI[name]
    m = T.shape[0]
    npdt = DTYPES[dtype]
    f = port_form(name, npdt)
    b = torch.from_numpy(rhs(m, K, dtype=npdt))
    tol = expected_precision(f.lval.dtype)
    plain = trsv_level_plain(f, b).numpy()
    ptr, ind, src = oriented(T, upper)
    jf = jl.build_level_form(ptr, ind, src, m, upper, unit, tri_values(name, npdt))
    want_j = np.asarray(jl.solve_levels(jf, b.numpy()))
    want_s = dense_ref(name, b.numpy().astype(np.complex128 if np.iscomplexobj(b.numpy()) else np.float64), npdt)
    assert near_error(plain, want_s) <= tol
    x, _st = emulate(f, b)
    x = x.numpy()
    for want in (plain, want_j, want_s):
        assert near_error(x, want) <= tol
    if check_bits:
        for warps, seed in ((7, 99), (301, 5)):
            again, _st = emulate(f, b, warps=warps, seed=seed)
            assert np.array_equal(x, again.numpy())
    return f, b, x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", sorted(TRI))
def test_emulated_schedule_matches_plain_jax_and_scipy(ast, name, K, dtype):
    """The emulated kernel against the plain version, the JAX package's
    solve_levels on the same structure and scipy, at the dtype's model
    tolerance; its bits depend neither on the grid's size nor on the order
    the warps run in."""
    _emulated_vs_references(ast, name, K, dtype)


@pytest.mark.parametrize("dtype", ["f32", "c128"])
@pytest.mark.parametrize("name", ["ilu_L", "scatter_U"])
def test_emulated_schedule_k16(ast, name, dtype):
    """trsm's width, K = 16 (16 of a warp's lanes, one column each), as
    above, on two grids."""
    f, b, x = _emulated_vs_references(ast, name, 16, dtype, check_bits=False)
    again, _st = emulate(f, b, warps=5, seed=4)
    assert np.array_equal(x, again.numpy())


@pytest.mark.parametrize("name", ["ilu_L", "scatter_U", "tridiag_L"])
def test_epoch_flags_across_launches(name):
    """Three emulated launches on one set of readiness words (K = 1) and of
    ready flags (K = 2), epochs 1, 2, 3, each give the plain solve of their
    own rhs; a wait that took any set word or flag as ready would read the
    last launch's values (words: a wrong solve) or rows not yet solved in
    this launch (flags: NaN), so the epoch carries the ordering and no
    launch resets them."""
    f = port_form(name, np.float64)
    for K in (1, 2):
        state = None
        for epoch in (1, 2, 3):
            b = torch.from_numpy(rhs(f.m, K, seed=epoch))
            x, state = emulate(f, b, epoch=epoch, state=state, seed=epoch)
            assert near_error(x.numpy(), trsv_level_plain(f, b).numpy()) <= expected_precision(torch.float64)
            assert np.all(state["ep"] == epoch)
        b = torch.from_numpy(rhs(f.m, K, seed=4))
        stale, _st = emulate(f, b, epoch=4, state=state, accept=lambda ep, want: ep > 0)
        if K == 1:
            assert near_error(stale.numpy(), trsv_level_plain(f, b).numpy()) > 1e-3
        else:
            assert not np.all(np.isfinite(stale.numpy()))


def test_refresh_regathers_compact_values():
    """refresh() with new effective values gives the compact values and the
    solves of a form built from them; through the API, update_values
    reaches the kid=1 solve."""
    T, upper, unit = TRI["scatter_U"]
    ptr, ind, src = oriented(T, upper)
    m = T.shape[0]
    f = port_form("scatter_U", np.float64)
    new = T.data * np.random.default_rng(3).uniform(0.5, 2.0, T.nnz)
    fresh = build_level_form(ptr, ind, src, m, upper, unit, torch.from_numpy(new))
    f.refresh(torch.from_numpy(new))
    assert torch.equal(f.lval, fresh.lval) and torch.equal(f.dinv, fresh.dinv)
    b = torch.from_numpy(rhs(m, 1))
    x, _st = emulate(f, b)
    want = spla.spsolve_triangular(sp.csr_matrix((new, T.indices, T.indptr), shape=(m, m)), b.numpy(), lower=False)
    assert near_error(x.numpy(), want) <= expected_precision(torch.float64)
    S = scatter(2048)
    A = tt.create_csr(m, m, S.indptr, S.indices, S.data, device="cpu")
    up = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.upper)
    tt.trsv(1.0, A, up, NONE, b, kid=1)
    tt.update_values(A, S.data * 3.0)
    want = spla.spsolve_triangular(sp.triu(S).tocsr() * 3.0, b.numpy(), lower=False)
    assert near_error(tt.trsv(1.0, A, up, NONE, b, kid=1).numpy(), want) <= expected_precision(torch.float64)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def _lower(diag=tt.DiagType.non_unit):
    return tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower, diag_type=diag)


def _upper():
    return tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.upper)


@pytest.mark.parametrize(
    "kind,nblk,nlev,want",
    [
        ("dwin", 17576, 722, True),  # the 104^3 stencil's lower triangle (nb = 64)
        ("gather", 4096, 29, True),  # the scatter operand's lower triangle
        ("dwin", 47, 3000, False),  # a tridiagonal: one level a row
        ("win", 17576, 722, False),  # a win form keeps its window solve
        ("dwin", 10**6, ttri.LEVEL_MAX_NLEV + 1, False),  # past the level engine's reach
        ("dwin", 10**6, ttri.LEVEL_MAX_NLEV, True),
    ],
)
def test_level_wins_pure(kind, nblk, nlev, want):
    assert ttri.level_wins(kind, nblk, nlev) is want


def test_gate_on_real_forms(monkeypatch):
    """sv_engine_for on the planner's forms: a 24^3 stencil's triangles
    (dwin) and the scatter triangles (gather) pick the level kernel where
    it is allowed, a tridiagonal keeps its blocked form, and the CPU's
    default stays blocked; the level count is cached on the plan."""
    ptr, ind, val = stencil27(24)
    m = len(ptr) - 1
    H = tt.optimize(tt.create_csr(m, m, ptr, ind, val, device="cpu"))
    S = scatter(2048)
    Q = tt.optimize(tt.create_csr(2048, 2048, S.indptr, S.indices, S.data, device="cpu"))
    T = TRI["tridiag_L"][0]
    D = tt.optimize(tt.create_csr(T.shape[0], T.shape[0], T.indptr, T.indices, T.data, device="cpu"))
    cpu = torch.device("cpu")
    cases = [(H, _lower(), "dwin"), (H, _upper(), "dwin"), (Q, _lower(), "gather"), (Q, _upper(), "gather")]
    for plan, descr, kind in cases:
        assert ttri.trsv_form_for(plan, descr, NONE).kind == kind
        assert ttri.sv_engine_for(plan, descr, NONE, cpu) == "blocked"
    assert ttri.trsv_form_for(D, _lower(), NONE).kind == "win"
    monkeypatch.setattr(ttri, "SV_LEVEL_DEVICES", ("cuda", "cpu"))
    for plan, descr, kind in cases:
        form = ttri.trsv_form_for(plan, descr, NONE)
        nlev = ttri.trsv_level_stats_for(plan, descr, NONE)[0]
        want = "level" if ttri.level_wins(kind, form.nblk, nlev) else "blocked"
        assert ttri.sv_engine_for(plan, descr, NONE, cpu) == want
        assert plan.trsv_level_stats[(descr.fill_mode, descr.diag_type, NONE)][0] == nlev
    # at these small sizes the levels and the blocks are close (162 levels
    # against 216 blocks of 64 on the 24^3 stencil): a cheaper level wins
    monkeypatch.setattr(ttri, "T_LEVEL_US", 0.1)
    for plan, descr, _kind in cases:
        assert ttri.sv_engine_for(plan, descr, NONE, cpu) == "level"
    assert ttri.sv_engine_for(D, _lower(), NONE, cpu) == "blocked"
    # a deep chain in a chain-kernel form: one level a row against m / 64 blocks
    chain = types.SimpleNamespace(kind="dwin", nblk=-(-T.shape[0] // 64), D=torch.empty(0, 64, 64))
    assert ttri.pick_sv_engine(chain, lambda: T.shape[0], cpu) == "blocked"
    assert ttri.pick_sv_engine(chain, lambda: 5, cpu) == "level"
    assert ttri.pick_sv_engine(chain, lambda: 5, torch.device("meta")) == "blocked"


# ---------------------------------------------------------------------------
# the routing, with the gate opened to the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def routed(monkeypatch):
    """The gate opened to the CPU with a level cost that picks the level
    solve on the 24^3 stencil, and counts of the plain versions the CPU
    takes: the level solve's and the chain's (dwin, gather)."""
    monkeypatch.setattr(ttri, "SV_LEVEL_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(ttri, "T_LEVEL_US", 0.1)  # the level solve wins at these sizes
    calls = {"level": 0, "chain": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)

        return wrapped

    monkeypatch.setattr(tl, "trsv_level_plain", count("level", tl.trsv_level_plain))
    monkeypatch.setattr(tb, "trsv_dwin_plain", count("chain", tb.trsv_dwin_plain))
    monkeypatch.setattr(tb, "trsv_gather_plain", count("chain", tb.trsv_gather_plain))
    return calls


def _stencil_handle(nx=24):
    ptr, ind, val = stencil27(nx)
    m = len(ptr) - 1
    return tt.create_csr(m, m, ptr, ind, val, device="cpu"), sp.csr_matrix((val, ind, ptr), shape=(m, m))


def _delta(calls, fn):
    c0 = dict(calls)
    out = fn()
    return out, {k: calls[k] - c0[k] for k in calls}


def test_routing_trsv_trsm(routed):
    """trsv and trsm with no kid take the level solve on a chain-kernel
    triangle once the gate admits the device; kid=0 pins the chain."""
    A, S = _stencil_handle()
    m = S.shape[0]
    b = rhs(m, 1)
    tol = expected_precision(torch.float64)
    for descr, T, lower in ((_lower(), sp.tril(S), True), (_upper(), sp.triu(S), False)):
        want = spla.spsolve_triangular(T.tocsr(), b, lower=lower)
        x, d = _delta(routed, lambda: tt.trsv(1.0, A, descr, NONE, torch.from_numpy(b)))
        assert d == {"level": 1, "chain": 0} and near_error(x.numpy(), want) <= tol
        x, d = _delta(routed, lambda: tt.trsv(1.0, A, descr, NONE, torch.from_numpy(b), kid=0))
        assert d == {"level": 0, "chain": 1} and near_error(x.numpy(), want) <= tol
    B = rhs(m, 3)
    X, d = _delta(routed, lambda: tt.trsm(1.0, A, _lower(), NONE, torch.from_numpy(B)))
    assert d == {"level": 1, "chain": 0}
    assert near_error(X.numpy(), spla.spsolve_triangular(sp.tril(S).tocsr(), B, lower=True)) <= tol


def test_routing_ilu(routed):
    """ilu_smoother with no kid solves both factors by the level solve,
    kid=0 by the chain, kid=1 by the level solve; the results agree."""
    A, S = _stencil_handle()
    b = torch.from_numpy(rhs(S.shape[0], 1))
    x_lvl, d = _delta(routed, lambda: tt.ilu_smoother(A, tt.MatrixDescriptor(), b))
    assert d == {"level": 2, "chain": 0}
    st = tt.ilu0_factorize(A)
    assert st.level_nlev is not None and ilu_mod._level_depth(st) == sum(st.level_nlev)
    x_chain, d = _delta(routed, lambda: tt.ilu_smoother(A, tt.MatrixDescriptor(), b, kid=0))
    assert d == {"level": 0, "chain": 2}
    x_1, d = _delta(routed, lambda: tt.ilu_smoother(A, tt.MatrixDescriptor(), b, kid=1))
    assert d == {"level": 2, "chain": 0}
    tol = expected_precision(torch.float64)
    assert near_error(x_lvl.numpy(), x_chain.numpy()) <= tol and torch.equal(x_lvl, x_1)


def test_routing_symgs(routed):
    """symgs with no kid: both sweeps by the level solve, against scipy's
    sweep; with kid=0 by the chain."""
    A, S = _stencil_handle()
    m = S.shape[0]
    b, x0 = rhs(m, 1, seed=1), rhs(m, 1, seed=2)
    Ls, Us, D = sp.tril(S, -1), sp.triu(S, 1), sp.diags(S.diagonal())
    x1 = spla.spsolve_triangular((Ls + D).tocsr(), b - 0.5 * (Us @ x0), lower=True)
    want = spla.spsolve_triangular((Us + D).tocsr(), b - Ls @ x1, lower=False)
    gen = tt.MatrixDescriptor()
    tol = expected_precision(torch.float64)
    for kid, exp in ((None, {"level": 2, "chain": 0}), (0, {"level": 0, "chain": 2})):
        x, d = _delta(routed, lambda: tt.symgs(NONE, A, gen, 0.5, torch.from_numpy(b), torch.from_numpy(x0), kid=kid))
        assert d == exp and near_error(x.numpy(), want) <= tol


@pytest.mark.parametrize("omega, alpha", [(1.2, 0.7), (0.8, 0.0)])
def test_routing_sorv(routed, monkeypatch, ast, omega, alpha):
    """sorv's (D + omega L) solve takes the level solve on the stencil's
    chain-kernel triangle once the gate admits the device, and the chain
    where it does not (the CPU's default); both agree with scipy's sweep
    and with the JAX package's sorv."""
    A, S = _stencil_handle()
    m = S.shape[0]
    b, x0 = rhs(m, 1, seed=3), rhs(m, 1, seed=4)
    Ls, Us, D = sp.tril(S, -1), sp.triu(S, 1), sp.diags(S.diagonal())
    want = spla.spsolve_triangular((D + omega * Ls).tocsr(), omega * b - (omega * Us + (omega - 1.0) * D) @ (alpha * x0),
                                   lower=True)
    ptr, ind, val = stencil27(24)
    jax_x = np.asarray(ast.sorv(ast.SorType.forward, ast.MatrixDescriptor(), ast.create_csr(m, m, ptr, ind, val), omega,
                                alpha, x0, b))
    tol = expected_precision(torch.float64)

    def call():
        return tt.sorv(tt.SorType.forward, tt.MatrixDescriptor(), A, omega, alpha, torch.from_numpy(x0),
                       torch.from_numpy(b))

    x, d = _delta(routed, call)
    assert d == {"level": 1, "chain": 0}
    assert near_error(x.numpy(), want) <= tol and near_error(x.numpy(), jax_x) <= tol
    form = A.plan.levels[("sorv", omega)]
    assert form.kind == "dwin" and ttri.sv_engine_for(A.plan, _lower(), NONE, "cpu", form=form) == "level"
    monkeypatch.setattr(ttri, "SV_LEVEL_DEVICES", ("cuda",))  # the CPU's default: the gate closed
    x, d = _delta(routed, call)
    assert d == {"level": 0, "chain": 1} and near_error(x.numpy(), jax_x) <= tol


@pytest.mark.parametrize("precond", ["sgs", "ilu0"])
def test_routing_pcg(routed, monkeypatch, precond):
    """pcg_solve's preconditioner applies through the level solve (two a
    preconditioner apply, none by the chain) and converges as with the
    chain."""
    A, S = _stencil_handle()
    b = rhs(S.shape[0], 1, seed=5)
    (x, k, _r), d = _delta(routed, lambda: tt.pcg_solve(A, torch.from_numpy(b), rtol=1e-8, precond=precond))
    assert d["chain"] == 0 and d["level"] >= 2 * k and d["level"] % 2 == 0
    assert np.linalg.norm(S @ x.numpy() - b) <= 1.01e-8 * np.linalg.norm(b)
    B, _ = _stencil_handle()
    monkeypatch.setattr(ttri, "SV_LEVEL_DEVICES", ("cuda",))
    _x, k_chain, _r = tt.pcg_solve(B, torch.from_numpy(b), rtol=1e-8, precond=precond)
    assert abs(k - k_chain) <= 1


def test_wrapper_checks():
    """The wrapper's refusals: a dtype without an instance, a mismatched
    rhs dtype or size."""
    f = port_form("scatter_L", np.float64)
    with pytest.raises(tt.AoclSparseError):
        trsv_level(f, torch.zeros(f.m, dtype=torch.float32))
    with pytest.raises(tt.AoclSparseError):
        trsv_level(f, torch.zeros(f.m + 1, dtype=torch.float64))
    with pytest.raises(tt.AoclSparseError):
        trsv_level(f, torch.zeros(f.m, 2, 2, dtype=torch.float64))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card_forms(dev, dtype):
    out = []
    for name in ("ilu_L", "ilu_U", "scatter_L", "scatter_U", "tridiag_L"):
        T, upper, unit = TRI[name]
        ptr, ind, src = oriented(T, upper)
        out.append((name, build_level_form(ptr, ind, src, T.shape[0], upper, unit,
                                           torch.from_numpy(tri_values(name, dtype)).to(dev))))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_cuda_kernel_matches_plain(cuda, dtype, monkeypatch):
    """The kernel against its plain version at K = 1, 4 and 16 within the
    dtype's model tolerance, one launch a call, the same bits on a second
    call and on the smallest and the largest grid."""
    inst = {np.float32: "f32", np.float64: "f64", np.complex64: "c64", np.complex128: "c128"}[dtype]
    for name, f in _card_forms(cuda, dtype):
        for K in (1, 4, 16):
            b = torch.from_numpy(rhs(f.m, K, dtype=dtype)).to(cuda)
            c0 = trsv_level.launches[inst]
            got, again = trsv_level(f, b), trsv_level(f, b)
            torch.cuda.synchronize()
            assert trsv_level.launches[inst] - c0 == 2
            assert torch.equal(got, again), (name, K)
            want = trsv_level_plain(f, b)
            assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= expected_precision(f.lval.dtype), (name, K)
            for slack in (0.0, 1e9):
                monkeypatch.setattr(tl, "LEVEL_SLACK", slack)
                assert torch.equal(trsv_level(f, b), got), (name, K, slack)
                monkeypatch.undo()


@pytest.mark.cuda
def test_cuda_nonfinite_rhs(cuda):
    """An Inf and a NaN in the rhs spread as in the plain version: the
    kernel multiplies every stored entry, so the same rows are non-finite,
    at K = 1 (readiness words) and K = 16 (flags)."""
    for name, f in _card_forms(cuda, np.float64):
        for K in (1, 16):
            b = torch.from_numpy(rhs(f.m, K)).to(cuda)
            b[3], b[f.m // 2] = float("inf"), float("nan")
            got, want = trsv_level(f, b).cpu().numpy(), trsv_level_plain(f, b).cpu().numpy()
            assert np.array_equal(np.isnan(got), np.isnan(want)) and np.array_equal(np.isinf(got), np.isinf(want)), name
            ok = np.isfinite(want)
            assert near_error(got[ok], want[ok]) <= expected_precision(torch.float64), name


@pytest.mark.cuda
def test_cuda_default_routes_to_the_kernel(cuda):
    """On the card the stencil's default trsv, ILU0-PCG and sorv take the
    level kernel (no chain launch); kid=0 keeps the chain kernel."""
    ptr, ind, val = stencil27(24)
    m = len(ptr) - 1
    S = sp.csr_matrix((val, ind, ptr), shape=(m, m))
    A = tt.create_csr(m, m, ptr, ind, val, device=cuda)
    b = rhs(m, 1, seed=17)
    bd = torch.from_numpy(b).to(cuda)
    want = spla.spsolve_triangular(sp.tril(S).tocsr(), b, lower=True)
    c0, d0 = trsv_level.launches["f64"], tb.trsv_dwin.launches["f64"]
    assert near_error(tt.trsv(1.0, A, _lower(), NONE, bd).cpu().numpy(), want) <= expected_precision(torch.float64)
    assert (trsv_level.launches["f64"] - c0, tb.trsv_dwin.launches["f64"] - d0) == (1, 0)
    assert near_error(tt.trsv(1.0, A, _lower(), NONE, bd, kid=0).cpu().numpy(), want) <= expected_precision(
        torch.float64)
    assert tb.trsv_dwin.launches["f64"] - d0 == 1
    c0 = trsv_level.launches["f64"]
    x, k, _r = tt.pcg_solve(A, bd, rtol=1e-8, precond="ilu0")
    assert trsv_level.launches["f64"] - c0 >= 2 * k and tb.trsv_dwin.launches["f64"] - d0 == 1
    assert np.linalg.norm(S @ x.cpu().numpy() - b) <= 1.01e-8 * np.linalg.norm(b)
    # sorv's (D + omega L) solve: the level kernel too
    Ls, Us, D = sp.tril(S, -1), sp.triu(S, 1), sp.diags(S.diagonal())
    want = spla.spsolve_triangular((D + 1.2 * Ls).tocsr(), 1.2 * b - (1.2 * Us + 0.2 * D) @ (0.7 * b), lower=True)
    c0 = trsv_level.launches["f64"]
    x = tt.sorv(tt.SorType.forward, tt.MatrixDescriptor(), A, 1.2, 0.7, bd, bd)
    assert near_error(x.cpu().numpy(), want) <= expected_precision(torch.float64)
    assert (trsv_level.launches["f64"] - c0, tb.trsv_dwin.launches["f64"] - d0) == (1, 1)
