"""mv KID 6 of the PyTorch port: the diagonal SpMV kernel's contract, its
plain version against the JAX package's ``spmv_diag``, and the KID 6
dispatch.

- Parity: the port's wrapper (``kernels/spmv_diag.py`` `spmv_diag`; on the
  CPU, the plain version) against the JAX package's ``spmv_diag``
  (kernels/xla/spmv.py:606) by both of its branches, the unrolled static
  slices (``offs_static``) and ``spmv_diag_scan``, in float32, float64 and
  bfloat16, on a 7-point 6^3 stencil, an odd-m operand with negative
  offsets, 192 diagonals, and a lone diagonal on each side beyond +-n.
- The kernel's schedule replayed on the CPU (tiles of R x threads rows,
  R = 4 as the kernel is built, at several thread counts;
  whole diagonals skipped, unguarded and guarded rows) against the plain
  version, every unguarded read checked to lie inside the operands.
- The public ``mv(kid=6)`` of both packages on the 7-point and 27-point
  stencils, and Inf in x meeting a stored zero: NaN in the same rows.
- The dispatch: the registry's KID 6 row, the device rule of
  `spmv_diag_any`, the wrapper's checks, the byte count of the bound.
- On the card (marked cuda, skipped elsewhere): the kernel against its
  plain version in every instance, odd m, the same bits twice, one launch
  a ``mv``, a CUDA tensor never on the plain path, and an error for the
  dtypes the kernel has no instance for.

All inputs are made with numpy from a seed. Tolerance: utils/tolerances.py
`expected_precision` of the accumulation dtype on max |a - b| / max(|b|, 1)
(float32 or float64; the bfloat16 model for bfloat16, where the JAX package
sums in bfloat16 and the port's plain version rounds each product).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels import spmv_diag as diag_mod
from aoclsparse_tpu_torch.kernels.plain_spmv import spmv_diag as plain_spmv_diag
from aoclsparse_tpu_torch.kernels.registry import registry
from aoclsparse_tpu_torch.kernels.spmv_diag import (
    diag_bytes,
    spmv_diag,
    spmv_diag_any,
    spmv_diag_plain,
)
from aoclsparse_tpu_torch.core.types import AoclSparseError
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.planner.plan import get_plan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def tol(name):
    return expected_precision(DTYPES[name])


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


@pytest.fixture(scope="module")
def jnp(ast):
    import jax.numpy as jnp

    return jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_diag_spmv.py there")
    return torch.device("cuda", 0)


# -- operands -----------------------------------------------------------------


def stencil_offsets(nx, points):
    """The offsets of the 7- or 27-point stencil on an nx^3 grid."""
    steps = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    if points == 7:
        steps = [s for s in steps if sum(map(abs, s)) <= 1]
    return tuple(sorted((dz * nx + dy) * nx + dx for dz, dy, dx in steps))


def stencil(nx, points, seed=5):
    """The 7- or 27-point stencil on an nx^3 grid as a scipy CSR with
    seeded values (the centre 6 or 26 plus a little noise, the neighbours
    -1 plus noise)."""
    g = np.arange(nx)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if points == 7 and abs(dz) + abs(dy) + abs(dx) > 1:
                    continue
                ok = (0 <= z + dz) & (z + dz < nx) & (0 <= y + dy) & (y + dy < nx) & (0 <= x + dx) & (x + dx < nx)
                rows.append(((z * nx + y) * nx + x)[ok])
                cols.append((((z + dz) * nx + (y + dy)) * nx + (x + dx))[ok])
    r, c = np.concatenate(rows), np.concatenate(cols)
    noise = np.random.default_rng(seed).uniform(-0.1, 0.1, r.size)
    S = sp.csr_matrix((np.where(r == c, points - 1.0, -1.0) + noise, (r, c)), shape=(nx**3, nx**3))
    S.sort_indices()
    return S


def _direct(m, n, offs, seed):
    """Random (ndiag, m) diagonal values, the offsets, x, and the plain
    version's padding (L, n_pad) as the planner's diag form sets it."""
    rng = np.random.default_rng(seed)
    offs = tuple(sorted(offs))
    dv = rng.standard_normal((len(offs), m))
    x = rng.standard_normal(n)
    L = max(0, -offs[0])
    return dv, offs, x, m, L, max(L + n, L + offs[-1] + m)


#: direct operands: (dvals, offsets, x, m, L, n_pad)
DIRECT = {
    "stencil7_6cubed": lambda: _direct(216, 216, stencil_offsets(6, 7), 11),
    "odd_m_negative_offsets": lambda: _direct(301, 301, (-40, -3, 0, 2, 17), 12),
    "192_diagonals": lambda: _direct(400, 400, tuple(range(-96, 96)), 13),
    "lone_diagonals_beyond_n": lambda: _direct(199, 150, (-300, -1, 0, 5, 190), 14),
}


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax_both(jnp, dv, offs, x, m, L, n_pad, dtype):
    """The JAX package's spmv_diag by its unrolled branch and its scan."""
    from aoclsparse_tpu.kernels.xla.spmv import spmv_diag as jspmv_diag, spmv_diag_scan

    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64, torch.bfloat16: jnp.bfloat16}[dtype]
    jd, jx = jnp.asarray(dv).astype(jdt), jnp.asarray(x).astype(jdt)
    jo = jnp.asarray(np.asarray(offs, dtype=np.int64))
    unrolled = jspmv_diag(jd, jo, jx, m, L, n_pad, offs_static=offs)
    scan = spmv_diag_scan(jd, jo, jx, m, L, n_pad)
    return [np.asarray(v.astype(jnp.float64)) for v in (unrolled, scan)]


def _host(t):
    return t.to(torch.float64).numpy()


# -- the kernel's schedule, replayed ------------------------------------------


def replay(dvals, offs, x, R, threads):
    """csrc/spmv_diag.cu's schedule on the CPU: tiles of R * threads rows,
    thread t's rows r0 + t + k * threads; a diagonal whose columns miss
    [0, n) for the whole tile is skipped, one whose columns all fall inside
    a whole tile read unguarded (each read checked to lie inside the
    operands), any other row by row; the sums in the accumulation dtype,
    offsets in order, rounded once."""
    ndiag, m = dvals.shape
    n = x.shape[0]
    acc_t = torch.float64 if dvals.dtype == torch.float64 else torch.float32
    dv, xv = dvals.to(acc_t), x.to(acc_t)
    y = torch.zeros(m, dtype=acc_t)
    T = R * threads
    for r0 in range(0, m, T):
        r1 = min(r0 + T, m)
        whole = r1 - r0 == T
        rows = r0 + torch.arange(threads)[:, None] + threads * torch.arange(R)[None, :]
        acc = torch.zeros(threads, R, dtype=acc_t)
        for d, o in enumerate(offs):
            if r1 - 1 + o < 0 or r0 + o >= n:
                continue
            if whole and r0 + o >= 0 and r1 - 1 + o < n:
                assert int(rows.max()) < m and int((rows + o).min()) >= 0 and int((rows + o).max()) < n
                acc += dv[d, rows] * xv[rows + o]
            else:
                c = rows + o
                ok = (rows < r1) & (c >= 0) & (c < n)
                acc += torch.where(ok, dv[d, rows.clamp(max=m - 1)] * xv[c.clamp(0, n - 1)], torch.zeros((), dtype=acc_t))
        keep = rows < r1
        y[rows[keep]] = acc[keep]
    return y.to(dvals.dtype)


@pytest.mark.parametrize("threads", [2, 4, 8, 16])
@pytest.mark.parametrize("name", sorted(DIRECT))
def test_kernel_replay_matches_plain(name, threads):
    """The replay at the kernel's 4 rows a thread and a few threads a
    tile (so the small operands span many tiles of several widths, and
    their edges) against the plain version, f32 and f64."""
    dv, offs, x, m, L, n_pad = DIRECT[name]()
    for inst in ("f32", "f64"):
        dt = DTYPES[inst]
        d_t, x_t, o_t = _torch(dv, dt), _torch(x, dt), torch.tensor(offs)
        want = spmv_diag_plain(d_t, o_t, x_t, m, L, n_pad)
        assert near_error(_host(replay(d_t, offs, x_t, 4, threads=threads)), _host(want)) <= tol(inst)


# -- parity with the JAX package ----------------------------------------------


@pytest.mark.parametrize("inst", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(DIRECT))
def test_wrapper_matches_jax_spmv_diag(jnp, name, inst):
    """The port's wrapper on CPU tensors (the plain version) against the JAX
    package's unrolled and scanned spmv_diag on the same values (rounded
    to the dtype first), and against a float64 sum of those values."""
    dv, offs, x, m, L, n_pad = DIRECT[name]()
    dt = DTYPES[inst]
    d_t, x_t = _torch(dv, dt), _torch(x, dt)
    before = dict(spmv_diag.launches)
    got = spmv_diag(d_t, torch.tensor(offs), x_t, m, L, n_pad)
    assert got.dtype == dt and got.shape == (m,)
    assert spmv_diag.launches == before  # the CPU runs no kernel
    for want in _jax_both(jnp, dv, offs, x, m, L, n_pad, dt):
        assert near_error(_host(got), want) <= tol(inst)
    ref = replay(d_t.double(), offs, x_t.double(), 1, threads=1).numpy()
    assert near_error(_host(got), ref) <= tol(inst)


def _pair(ast, jnp, S, dt):
    """The same CSR in both packages, values of dtype dt."""
    m, n = S.shape
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64, torch.bfloat16: jnp.bfloat16}[dt]
    J = ast.create_csr(m, n, S.indptr, S.indices, jnp.asarray(S.data).astype(jdt))
    T = tt.create_csr(m, n, S.indptr, S.indices, _torch(S.data, dt), device="cpu")
    return J, T


@pytest.mark.parametrize("inst", sorted(DTYPES))
@pytest.mark.parametrize("points,nx", [(7, 6), (27, 8)])
def test_mv_kid6_matches_jax(ast, jnp, points, nx, inst):
    """mv(kid=6) through both packages' public mv on the stencil, alpha and
    beta included: the same diag form (offsets), the same y within the
    accumulation dtype's tolerance, and the port's default form is diag."""
    S = stencil(nx, points)
    m = S.shape[0]
    dt = DTYPES[inst]
    J, T = _pair(ast, jnp, S, dt)
    rng = np.random.default_rng(17)
    x, y0 = rng.standard_normal(m), rng.standard_normal(m)
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64, torch.bfloat16: jnp.bfloat16}[dt]
    for alpha, beta in ((1.0, 0.0), (1.5, -0.5)):
        want = ast.mv(alpha, J, ast.MatrixDescriptor(), ast.Operation.none, jnp.asarray(x).astype(jdt), beta,
                      jnp.asarray(y0).astype(jdt), kid=6)
        got = tt.mv(alpha, T, GEN, NONE, _torch(x, dt), beta, _torch(y0, dt), kid=6)
        assert got.dtype == dt
        assert near_error(_host(got), np.asarray(want.astype(jnp.float64))) <= tol(inst)
    jf = J.plan.exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="diag")
    tf = T.plan.exec_form_for(GEN, NONE, kind="diag")
    assert tuple(tf.dia_offs_static) == tuple(int(o) for o in jf.dia_offs_static) == stencil_offsets(nx, points)
    assert tt.mv(1.0, T, GEN, NONE, _torch(x, dt), 0.0) is not None
    assert T.plan.exec_form_for(GEN, NONE).kind == "diag"


@pytest.mark.parametrize("inst", ["f32", "f64"])
def test_inf_in_x_meets_stored_zero(ast, jnp, inst):
    """A stored zero of the stencil meets an Inf of x: NaN in the same rows
    of both packages' mv(kid=6), Inf and finite values in the same places,
    the finite values within tolerance."""
    S = stencil(6, 7)
    m = S.shape[0]
    r, c = 100, 101  # a stored +1 neighbour of row 100, made an explicit zero
    lo, hi = S.indptr[r], S.indptr[r + 1]
    S.data[lo + int(np.nonzero(S.indices[lo:hi] == c)[0][0])] = 0.0
    dt = DTYPES[inst]
    J, T = _pair(ast, jnp, S, dt)
    x = np.random.default_rng(19).standard_normal(m)
    x[c] = np.inf
    got = _host(tt.mv(1.0, T, GEN, NONE, _torch(x, dt), 0.0, kid=6))
    want = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, jnp.asarray(x).astype(
        {"f32": jnp.float32, "f64": jnp.float64}[inst]), 0.0, kid=6)).astype(np.float64)
    assert np.isnan(got[r]) and np.isnan(want[r])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(np.sign(got[np.isinf(got)]), np.sign(want[np.isinf(want)]))
    fin = np.isfinite(want)
    assert near_error(got[fin], want[fin]) <= tol(inst)
    # the kernel's replay gives the same NaN rows: it multiplies every slot
    # whose column lies in range
    form = T.plan.exec_form_for(GEN, NONE, kind="diag")
    rep = _host(replay(form.dia_val, form.dia_offs_static, _torch(x, dt), 4, threads=8))
    np.testing.assert_array_equal(np.isnan(rep), np.isnan(want))


# -- the dispatch -------------------------------------------------------------


def test_registry_kid6_is_the_kernel_row():
    e = registry.select("mv", fmt="diag", device="cpu")
    assert (e.kid, e.name, e.fn) == (6, "cuda_diag", spmv_diag_any)
    assert tt.debug_dispatcher("mv", fmt="diag", device="cpu")["name"] == "cuda_diag"
    assert set(spmv_diag.launches) == {"f32", "bf16", "f64"}
    assert spmv_diag_plain is plain_spmv_diag


def test_dtype_rule_sends_other_dtypes_to_plain():
    """On the CPU every dtype takes the plain version: complex values (a
    kid=6 pin), float16 and two dtypes too; the wrapper itself refuses two
    dtypes, and a tensor on a device with no kernel raises."""
    dv, offs, x, m, L, n_pad = DIRECT["odd_m_negative_offsets"]()
    o = torch.tensor(offs)
    for dt in (torch.complex64, torch.complex128, torch.float16):
        d_t, x_t = _torch(dv, dt), _torch(x, dt)
        assert torch.equal(spmv_diag_any(d_t, o, x_t, m, L, n_pad), plain_spmv_diag(d_t, o, x_t, m, L, n_pad))
    d32, x64 = _torch(dv, torch.float32), _torch(x, torch.float64)
    assert torch.equal(spmv_diag_any(d32, o, x64, m, L, n_pad), plain_spmv_diag(d32, o, x64, m, L, n_pad))
    with pytest.raises(AoclSparseError):
        spmv_diag(d32, o, x64, m, L, n_pad)
    dm, xm = _torch(dv, torch.float32).to("meta"), _torch(x, torch.float32).to("meta")
    with pytest.raises(AoclSparseError):
        spmv_diag_any(dm, o.to("meta"), xm, m, L, n_pad)


def test_wrapper_validates():
    dv, offs, x, m, L, n_pad = DIRECT["stencil7_6cubed"]()
    d_t, x_t, o_t = _torch(dv, torch.float32), _torch(x, torch.float32), torch.tensor(offs)
    with pytest.raises(AoclSparseError):  # int32 offsets
        spmv_diag(d_t, o_t.int(), x_t, m, L, n_pad)
    with pytest.raises(AoclSparseError):  # m off the values' rows
        spmv_diag(d_t, o_t, x_t, m + 1, L, n_pad)
    with pytest.raises(AoclSparseError):  # offsets off the values' diagonals
        spmv_diag(d_t, o_t[1:], x_t, m, L, n_pad)
    with pytest.raises(AoclSparseError):  # a padding that does not hold x
        spmv_diag(d_t, o_t, x_t, m, L, L + x_t.shape[0] - 1)
    with pytest.raises(AoclSparseError):  # not contiguous
        spmv_diag(d_t.t().contiguous().t(), o_t, x_t, m, L, n_pad)
    with pytest.raises(AoclSparseError):  # a device with no kernel
        spmv_diag(d_t.to("meta"), o_t.to("meta"), x_t.to("meta"), m, L, n_pad)


def test_diag_bytes_counts_the_slots_in_range():
    """The bound's bytes: the values whose column lies in [0, n), x and y."""
    dv, offs, x, m, L, n_pad = DIRECT["lone_diagonals_beyond_n"]()
    d_t = _torch(dv, torch.float32)
    n = x.shape[0]
    slots = sum(1 for o in offs for i in range(m) if 0 <= i + o < n)
    assert diag_bytes(d_t, offs, n) == diag_bytes(d_t, torch.tensor(offs), n) == (slots + n + m) * 4
    S = stencil(4, 27)
    T = tt.create_csr(64, 64, S.indptr, S.indices, _torch(S.data, torch.float32), device="cpu")
    f = get_plan(T).exec_form_for(GEN, NONE, kind="diag")
    assert diag_bytes(f.dia_val, f.dia_offs, 64) >= (S.nnz + 128) * 4


def _thinned(nx, keep, dtype, seed=31):
    """The 27-point stencil on an nx^3 grid whose off-centre entries each
    stay with probability `keep` (the centre always): diagonals that store
    about 1 / keep slots a nonzero."""
    S = stencil(nx, 27, seed).tocoo()
    r, c, v = S.row, S.col, S.data
    ok = (r == c) | (np.random.default_rng(seed).random(r.size) < keep)
    T = sp.csr_matrix((v[ok], (r[ok], c[ok])), shape=S.shape)
    T.sort_indices()
    return tt.create_csr(T.shape[0], T.shape[1], T.indptr, T.indices, _torch(T.data, dtype), device="cpu")


@pytest.mark.parametrize("keep,want_f32,want_f64", [(1.0, "diag", "diag"), (0.7, "diag", "diag"),
                                                     (0.6, "diag", "segsum"), (0.25, "segsum", "segsum")])
def test_card_rule_weighs_diag_against_the_csr_kernel(keep, want_f32, want_f64):
    """planner/plan.py `choose_mv_format`: on the card the diag branch also
    needs `diag_beats_csr` (the stored slots a nonzero within the measured
    crossover, DIAG_CSR_SLOTS: 2.05 in f32, 1.75 in f64; these operands store
    1.19, 1.66, 1.92 and 4.26); bf16, which has no CSR kernel
    instance, and the CPU keep the JAX rule's diag; `structure_mv_format`
    (which mm's rule reads) stays as it was."""
    for dt, want in ((torch.float32, want_f32), (torch.float64, want_f64), (torch.bfloat16, "diag")):
        T = _thinned(12, keep, dt)
        eff = get_plan(T).effective_for(GEN, NONE)
        ndiag = int(np.unique(np.repeat(np.arange(eff.m), np.diff(eff.ptr)) - eff.ind).size)
        pad = ndiag * eff.m / eff.nnz
        assert tplan.structure_mv_format(eff) == "diag", (keep, dt)
        assert tplan.choose_mv_format(eff) == tplan.choose_mv_format(eff, device="cpu") == "diag"
        assert tplan.choose_mv_format(eff, device="cuda") == want, (keep, dt, pad)
        if dt != torch.bfloat16:  # past diag, general structure: gen, which the card turns into segsum
            assert tplan.structure_mv_format(eff, card_csr=True) == ("diag" if want == "diag" else "gen")
            assert tplan.diag_beats_csr(eff, ndiag) == (pad <= tplan.DIAG_CSR_SLOTS[dt])
    # the stencil itself stays diag on the card (1.02 slots a nonzero at 104^3)
    S = stencil(12, 27)
    T = tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, _torch(S.data, torch.float32), device="cpu")
    assert tplan.choose_mv_format(get_plan(T).effective_for(GEN, NONE), device="cuda") == "diag"


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("inst", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(DIRECT) + ["stencil27_20cubed_odd_m"])
def test_cuda_kernel_matches_plain(cuda, name, inst):
    """Every instance against the plain version (float32 sums of the
    same bfloat16 values for bf16, rounded once: the kernel's arithmetic),
    the same bits twice, one launch a call."""
    if name in DIRECT:
        dv, offs, x, m, L, n_pad = DIRECT[name]()
    else:
        dv, offs, x, m, L, n_pad = _direct(7999, 8000, stencil_offsets(20, 27), 15)
    dt = DTYPES[inst]
    d_t, x_t, o_t = _torch(dv, dt).to(cuda), _torch(x, dt).to(cuda), torch.tensor(offs, device=cuda)
    if dt == torch.bfloat16:
        want = spmv_diag_plain(d_t.float(), o_t, x_t.float(), m, L, n_pad).to(dt)
        t = 4 * 2.0**-7
    else:
        want, t = spmv_diag_plain(d_t, o_t, x_t, m, L, n_pad), tol(inst)
    c0 = spmv_diag.launches[inst]
    a = spmv_diag(d_t, o_t, x_t, m, L, n_pad)
    b = spmv_diag(d_t, o_t, x_t, m, L, n_pad)
    torch.cuda.synchronize()
    assert spmv_diag.launches[inst] - c0 == 2
    assert a.dtype == dt and torch.equal(a, b)
    assert near_error(_host(a.cpu()), _host(want.cpu())) <= t
    if dt == torch.bfloat16:
        plain = spmv_diag_plain(d_t, o_t, x_t, m, L, n_pad)
        assert near_error(_host(a.cpu()), _host(plain.cpu())) <= tol(inst)


@pytest.mark.cuda
@pytest.mark.parametrize("inst", sorted(DTYPES))
def test_cuda_mv_launches_the_kernel_once(cuda, inst, monkeypatch):
    """The stencil's default mv on a card handle: one launch a call, no
    call of the plain version, y against a float64 scipy product."""
    S = stencil(12, 27)
    m = S.shape[0]
    dt = DTYPES[inst]
    T = tt.create_csr(m, m, S.indptr, S.indices, _torch(S.data, dt), device=cuda)
    x = np.random.default_rng(21).standard_normal(m)
    x_d = _torch(x, dt).to(cuda)
    tt.mv(1.0, T, GEN, NONE, x_d, 0.0)  # builds the plan
    assert T.plan.exec_form_for(GEN, NONE).kind == "diag"

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(diag_mod, "spmv_diag_plain", refuse)
    c0 = spmv_diag.launches[inst]
    y = tt.mv(1.0, T, GEN, NONE, x_d, 0.0)
    torch.cuda.synchronize()
    assert spmv_diag.launches[inst] - c0 == 1
    xr = _host(x_d.cpu())
    Sr = sp.csr_matrix((_host(_torch(S.data, dt)), S.indices, S.indptr), shape=S.shape)
    assert near_error(_host(y.cpu()), Sr @ xr) <= tol(inst)


@pytest.mark.cuda
def test_cuda_other_dtypes_raise(cuda):
    """On the card, dtypes the kernel has no instance for raise, in the
    registry's KID 6 function and through a kid=6 pin of a complex handle:
    no CUDA tensor takes the plain version."""
    dv, offs, x, m, L, n_pad = DIRECT["odd_m_negative_offsets"]()
    o = torch.tensor(offs, device=cuda)
    for dt in (torch.complex64, torch.complex128, torch.float16):
        with pytest.raises(AoclSparseError):
            spmv_diag_any(_torch(dv, dt).to(cuda), o, _torch(x, dt).to(cuda), m, L, n_pad)
    with pytest.raises(AoclSparseError):
        spmv_diag_any(_torch(dv, torch.float32).to(cuda), o, _torch(x, torch.float64).to(cuda), m, L, n_pad)
    S = stencil(6, 7)
    T = tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, _torch(S.data, torch.complex64), device=cuda)
    with pytest.raises(AoclSparseError):
        tt.mv(1.0, T, GEN, NONE, torch.ones(S.shape[0], dtype=torch.complex64, device=cuda), 0.0, kid=6)
