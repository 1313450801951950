"""Blocked triangular solve of the PyTorch port against aoclsparse_tpu.trsv.

Both packages build a ``win`` form of the same triangle. The port solves
with its inverted diagonal blocks (the window-solve kernel's plain version
on the CPU); the JAX package on the CPU with its substitution scan. So the
two differ by rounding only: float64 agrees to 1e-10 relative, float32
within expected_precision(float32) of utils/tolerances.py, both on
max |a - b| / max(|b|, 1). The forms themselves are compared exactly: the
same values land in the same dense slots.
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import interop
from aoclsparse_tpu_torch.kernels.trsv_win import solve_launches, trsv_win
from aoclsparse_tpu_torch.ops.level2.trsv import pad_solve
from aoclsparse_tpu_torch.planner import triangular as ttri
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

M = 1100  # a multiple of no block size


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


def _operand(seed=0, m=M, halfw=9, far=12, dtype=np.float64):
    """A nonsymmetric band plus a few far entries, with a dominant diagonal
    (so every triangle is well conditioned): (ptr, ind, val, dense)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 2 * halfw + 1)
    c = r + np.tile(np.arange(-halfw, halfw + 1), m)
    keep = (c >= 0) & (c < m) & ((rng.random(r.size) < 0.6) | (r == c))
    r, c = r[keep], c[keep]
    fr = rng.integers(0, m, far)
    fc = (fr + rng.integers(100, 300, far) * rng.choice([-1, 1], far)) % m
    r, c = np.r_[r, fr], np.r_[c, fc]
    dense = np.zeros((m, m))
    dense[r, c] = rng.standard_normal(r.size) * 0.3
    dense[np.arange(m), np.arange(m)] = 2.0 + rng.random(m)
    nz = dense != 0
    ptr = np.r_[0, np.cumsum(nz.sum(1))].astype(np.int64)
    return ptr, np.nonzero(nz)[1].astype(np.int32), dense[nz].astype(dtype), dense


def _descrs(ast, fill, diag):
    t = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=fill, diag_type=diag)
    j = ast.MatrixDescriptor(
        type=ast.MatrixType.triangular, fill_mode=ast.FillMode(int(fill)), diag_type=ast.DiagType(int(diag))
    )
    return t, j


@pytest.fixture(scope="module")
def pairs(ast):
    out = {}
    for dt in (np.float64, np.float32):
        ptr, ind, val, dense = _operand(dtype=dt)
        out[dt] = (
            ast.create_csr(M, M, ptr, ind, val),
            tt.create_csr(M, M, ptr, ind, val, device="cpu"),
            dense,
        )
    return out


@pytest.mark.parametrize("op", [tt.Operation.none, tt.Operation.transpose])
@pytest.mark.parametrize("diag", [tt.DiagType.unit, tt.DiagType.non_unit])
@pytest.mark.parametrize("fill", [tt.FillMode.lower, tt.FillMode.upper])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_trsv_matches_jax(ast, pairs, dtype, fill, diag, op):
    J, T, _dense = pairs[dtype]
    dt, dj = _descrs(ast, fill, diag)
    b = np.random.default_rng(int(fill) * 4 + int(diag) * 2 + int(op)).standard_normal(M).astype(dtype)
    want = np.asarray(ast.trsv(0.5, J, dj, ast.Operation(int(op)), b))
    got = tt.trsv(0.5, T, dt, op, torch.from_numpy(b))
    assert got.dtype == torch.from_numpy(b).dtype
    tol = 1e-10 if dtype == np.float64 else expected_precision(torch.float32)
    assert near_error(got.numpy(), want) <= tol


def test_trsv_solves_the_triangle(pairs):
    """Against the dense triangle, independent of the JAX package."""
    _J, T, dense = pairs[np.float64]
    b = np.random.default_rng(9).standard_normal(M)
    for fill, tri in ((tt.FillMode.lower, np.tril(dense)), (tt.FillMode.upper, np.triu(dense))):
        d = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=fill)
        x = tt.trsv(1.0, T, d, tt.Operation.none, torch.from_numpy(b)).numpy()
        assert np.abs(tri @ x - b).max() <= 1e-12 * np.abs(b).max() * M


def test_trsv_strided_and_csrsv_match_jax(ast, pairs):
    J, T, _dense = pairs[np.float64]
    dt, dj = _descrs(ast, tt.FillMode.upper, tt.DiagType.non_unit)
    b = np.random.default_rng(2).standard_normal(3 * M)
    x_out = np.random.default_rng(3).standard_normal(2 * M)
    want = np.asarray(ast.trsv_strided(2.0, J, dj, ast.Operation.none, b, 3, 2, x_out))
    got = tt.trsv_strided(2.0, T, dt, tt.Operation.none, torch.from_numpy(b), 3, 2, torch.from_numpy(x_out))
    assert got.shape == want.shape
    assert near_error(got.numpy(), want) <= 1e-10
    want = np.asarray(ast.trsv_strided(1.0, J, dj, ast.Operation.transpose, b, 3))
    got = tt.trsv_strided(1.0, T, dt, tt.Operation.transpose, torch.from_numpy(b), 3)
    assert near_error(got.numpy(), want) <= 1e-10
    want = np.asarray(ast.csrsv(1.0, J, dj, ast.Operation.none, b[:M]))
    got = tt.csrsv(1.0, T, dt, tt.Operation.none, torch.from_numpy(b[:M]))
    assert near_error(got.numpy(), want) <= 1e-10


def _status(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - both packages raise their own AoclSparseError
        return int(e.status)
    return 0


def test_error_statuses_match_jax(ast):
    m = 40
    ptr, ind, val, dense = _operand(seed=4, m=m, halfw=3, far=0)
    # drop row 7's diagonal entry
    nz = dense != 0
    nz[7, 7] = False
    mptr = np.r_[0, np.cumsum(nz.sum(1))].astype(np.int64)
    mind, mval = np.nonzero(nz)[1].astype(np.int32), dense[nz]
    J, T = ast.create_csr(m, m, mptr, mind, mval), tt.create_csr(m, m, mptr, mind, mval, device="cpu")
    b = np.ones(m)
    bt = torch.ones(m, dtype=torch.float64)
    cases = [
        (tt.FillMode.lower, tt.DiagType.non_unit),  # missing diagonal -> invalid_value
        (tt.FillMode.upper, tt.DiagType.zero),  # zero diagonal -> invalid_value
        (tt.FillMode.lower, tt.DiagType.unit),  # unit: the missing entry is fine
    ]
    for fill, diag in cases:
        dt, dj = _descrs(ast, fill, diag)
        sj = _status(lambda: ast.trsv(1.0, J, dj, ast.Operation.none, b))
        st = _status(lambda: tt.trsv(1.0, T, dt, tt.Operation.none, bt))
        assert st == sj, (fill, diag, st, sj)
    assert st == 0
    # general descriptor, non-square A, wrong b size, unknown kid
    dt, dj = _descrs(ast, tt.FillMode.lower, tt.DiagType.unit)
    assert _status(lambda: tt.trsv(1.0, T, tt.MatrixDescriptor(), tt.Operation.none, bt)) == _status(
        lambda: ast.trsv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, b)
    ) == int(tt.Status.invalid_value)
    R = tt.create_csr(3, 4, np.array([0, 1, 2, 3]), np.array([0, 1, 2], np.int32), np.ones(3), device="cpu")
    RJ = ast.create_csr(3, 4, np.array([0, 1, 2, 3]), np.array([0, 1, 2], np.int32), np.ones(3))
    assert _status(lambda: tt.trsv(1.0, R, dt, tt.Operation.none, torch.ones(3, dtype=torch.float64))) == _status(
        lambda: ast.trsv(1.0, RJ, dj, ast.Operation.none, np.ones(3))
    ) == int(tt.Status.invalid_size)
    assert _status(lambda: tt.trsv(1.0, T, dt, tt.Operation.none, torch.ones(m + 1, dtype=torch.float64))) == _status(
        lambda: ast.trsv(1.0, J, dj, ast.Operation.none, np.ones(m + 1))
    ) == int(tt.Status.invalid_size)
    assert _status(lambda: tt.trsv(1.0, T, dt, tt.Operation.none, bt, kid=5)) == _status(
        lambda: ast.trsv(1.0, J, dj, ast.Operation.none, b, kid=5)
    ) == int(tt.Status.invalid_kid)
    assert _status(lambda: tt.trsv(1.0, None, dt, tt.Operation.none, bt)) == int(tt.Status.invalid_pointer)
    assert _status(lambda: tt.trsv_strided(1.0, T, dt, tt.Operation.none, bt, 0)) == int(tt.Status.invalid_size)


def test_bf16_and_complex_routes_match_jax(ast):
    """bf16 and complex triangles through every sv engine (the blocked
    solve, kid 1 the level engine, kid 2 the host engine) against the JAX
    package's default solve: complex128 within the f64 model tolerance, bf16
    within the bf16 one (4 sqrt(2^-6); both packages round at their own
    places), each result in the handle's dtype. A dtype with no solve
    (float16) raises not_implemented."""
    import jax.numpy as jnp

    ptr, ind, val, _ = _operand(seed=5, m=60, halfw=3, far=0)
    dj = ast.MatrixDescriptor(type=ast.MatrixType.triangular)
    d = tt.MatrixDescriptor(type=tt.MatrixType.triangular)
    rng = np.random.default_rng(5)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.complex128, torch.complex128)):
        v = val + (1j * rng.standard_normal(val.size) if tdt.is_complex else 0.0)
        J = ast.create_csr(60, 60, ptr, ind, jnp.asarray(v, dtype=jdt))
        C = tt.create_csr(60, 60, ptr, ind, torch.from_numpy(v).to(tdt), device="cpu")
        b = rng.standard_normal(60) + (1j * rng.standard_normal(60) if tdt.is_complex else 0.0)
        want = np.asarray(ast.trsv(1.0, J, dj, ast.Operation.none, jnp.asarray(b, dtype=jdt)), dtype=np.complex128)
        for kid in (None, 0, 1, 2):
            got = tt.trsv(1.0, C, d, tt.Operation.none, torch.from_numpy(b).to(tdt), kid=kid)
            assert got.dtype == tdt
            assert near_error(got.to(torch.complex128).numpy(), want) <= expected_precision(tdt)
    H = tt.create_csr(60, 60, ptr, ind, torch.from_numpy(val).to(torch.float16), device="cpu")
    assert _status(lambda: tt.trsv(1.0, H, d, tt.Operation.none, torch.ones(60, dtype=torch.float16))) == int(
        tt.Status.not_implemented
    )


def test_update_values_flows_into_the_solve():
    """tests/test_bandt.py:193-222 on the port, on a triangle the ``win``
    form takes: the cached form and its inverted blocks must drop with the
    values."""
    m = 1100
    _p, _i, _v, full = _operand(seed=6, m=m)
    dense = np.tril(full).astype(np.float32)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    A = tt.create_csr(m, m, ptr, np.nonzero(dense)[1].astype(np.int32), dense[dense != 0], device="cpu")
    tri = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
    b = np.random.default_rng(6).standard_normal(m).astype(np.float32)
    x = tt.trsv(1.0, A, tri, tt.Operation.none, torch.from_numpy(b)).numpy()
    assert np.abs(dense @ x - b).max() < 1e-3
    tt.update_values(A, (dense[dense != 0] * 1.5).astype(np.float32))
    assert A.plan.levels is None
    x2 = tt.trsv(1.0, A, tri, tt.Operation.none, torch.from_numpy(b)).numpy()
    assert np.abs(1.5 * dense @ x2 - b).max() < 1e-3


def test_too_wide_window_raises_not_implemented():
    """A triangle whose dense window passes the cap, with hundreds of
    distinct left offsets: it used to raise not_implemented; now it takes
    the padded-ELL ``gather`` form (planner/triangular.py), which solves
    it, transposed too, to float64 rounding against numpy."""
    m = 1100
    rng = np.random.default_rng(7)
    dense = np.tril(rng.standard_normal((m, m))) * (np.abs(rng.standard_normal((m, m))) < 0.02)
    np.fill_diagonal(dense, 5.0)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    A = tt.create_csr(m, m, ptr, np.nonzero(dense)[1].astype(np.int32), dense[dense != 0], device="cpu")
    tri = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
    b = torch.ones(m, dtype=torch.float64)
    for op, T in ((tt.Operation.none, dense), (tt.Operation.transpose, dense.T)):
        assert ttri.trsv_form_for(A.plan or tt.optimize(A), tri, op).kind == "gather"
        x = tt.trsv(1.0, A, tri, op, b).numpy()
        assert near_error(x, np.linalg.solve(T, np.ones(m))) <= 10 * expected_precision(torch.float64)


# (builder, fill, diag, op); the native builder serves op=none only, in
# both packages
FORM_CASES = [
    ("native", tt.FillMode.lower, tt.DiagType.unit, tt.Operation.none),
    ("native", tt.FillMode.upper, tt.DiagType.non_unit, tt.Operation.none),
    ("numpy", tt.FillMode.lower, tt.DiagType.unit, tt.Operation.none),
    ("numpy", tt.FillMode.upper, tt.DiagType.non_unit, tt.Operation.none),
    ("numpy", tt.FillMode.lower, tt.DiagType.non_unit, tt.Operation.transpose),
]


@pytest.mark.parametrize("builder,fill,diag,op", FORM_CASES)
def test_form_arrays_match_jax(ast, pairs, builder, fill, diag, op):
    """trsv_form_for (native builder for op=none) and the numpy builder,
    against the JAX package's at the same nb: identical arrays."""
    from aoclsparse_tpu.planner import triangular as jtri
    from aoclsparse_tpu.planner.plan import get_plan as jget_plan

    J, T, _dense = pairs[np.float64]
    dt, dj = _descrs(ast, fill, diag)
    nb = 128
    if builder == "native":
        jf = jtri.trsv_form_for(jget_plan(J), dj, ast.Operation(int(op)), nb=nb)
        tf = ttri.trsv_form_for(tt.optimize(T), dt, op, nb=nb)
        assert tf._src_space == "clean"
    else:
        jf = jtri._build_trsv_form_for(jget_plan(J), jtri.MatrixDescriptor(
            type=ast.MatrixType.triangular, fill_mode=dj.fill_mode, diag_type=dj.diag_type), ast.Operation(int(op)), nb)
        tf = ttri._build_trsv_form_for(tt.optimize(T), ttri._tri_descr(dt), op, nb)
        assert tf._src_space == "eff"
    assert jf.kind == tf.kind == "win"
    for k in ("nb", "nblk", "m", "WL", "reversed_", "unit_diag"):
        assert getattr(tf, k) == getattr(jf, k), k
    np.testing.assert_array_equal(tf.D.numpy(), np.asarray(jf.D))
    np.testing.assert_array_equal(tf.Lval.numpy(), np.asarray(jf.Lval))


def test_form_refresh_equals_fresh_build():
    """TrsvForm.refresh over its source space (clean positions for a native
    build, the effective triangle for a numpy one) gives the form a fresh
    build of the new values gives, and drops the kernel operands."""
    from aoclsparse_tpu_torch.planner.plan import build_effective_csr

    ptr, ind, val, _ = _operand(dtype=np.float64)
    T = tt.create_csr(M, M, ptr, ind, val, device="cpu")
    F = tt.create_csr(M, M, ptr, ind, val * 3.0, device="cpu")
    d = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.upper)
    for op in (tt.Operation.none, tt.Operation.transpose):
        form = ttri.trsv_form_for(tt.optimize(T), d, op)
        fresh = ttri.trsv_form_for(tt.optimize(F), d, op)
        form.operands()
        if op == tt.Operation.none:
            assert form._src_space == "clean"
            form.refresh(F.plan.clean.host_val())
        else:
            assert form._src_space == "eff"
            eff = build_effective_csr(F.plan.clean, ttri._tri_descr(d), tt.Operation.none)
            form.refresh(ttri._transpose_eff(eff).val)
        assert form._ops is None
        np.testing.assert_array_equal(form.D.numpy(), fresh.D.numpy())
        np.testing.assert_array_equal(form.Lval.numpy(), fresh.Lval.numpy())
        np.testing.assert_array_equal(form.operands()[0].numpy(), fresh.operands()[0].numpy())


def test_jax_form_carried_across_solves_to_jax(ast, pairs):
    from aoclsparse_tpu.planner import triangular as jtri
    from aoclsparse_tpu.planner.plan import get_plan as jget_plan

    J, _T, _dense = pairs[np.float64]
    _dt, dj = _descrs(ast, tt.FillMode.upper, tt.DiagType.non_unit)
    jf = jtri.trsv_form_for(jget_plan(J), dj, ast.Operation.none, nb=128)
    assert jf.kind == "win"
    arrays = {k: getattr(jf, k) for k in ("nb", "nblk", "m", "WL", "reversed_", "unit_diag")}
    arrays.update(D=np.asarray(jf.D), Lval=np.asarray(jf.Lval))
    form = interop.trsv_form_from_jax(arrays, device="cpu")
    b = np.random.default_rng(8).standard_normal(M)
    want = np.asarray(ast.trsv(1.0, J, dj, ast.Operation.none, b))
    got = pad_solve(form, torch.from_numpy(b))
    assert near_error(got.numpy(), want) <= 1e-10


def test_adaptive_nb_rederived():
    assert ttri.adaptive_nb(262144, np.float32) == 256
    assert ttri.adaptive_nb(2000, torch.float64) == 128
    assert ttri.adaptive_nb(600, np.float32) == 64
    assert ttri.adaptive_nb(262144, np.complex64) == 512  # no kernel instance: the scan's base


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_trsv_matches_cpu_port(cuda, dtype):
    ptr, ind, val, _ = _operand(seed=10, m=5000, far=0, dtype=dtype)
    D = tt.create_csr(5000, 5000, ptr, ind, val, device=cuda)
    C = tt.create_csr(5000, 5000, ptr, ind, val, device="cpu")
    b = np.random.default_rng(11).standard_normal(5000).astype(dtype)
    name = "f64" if dtype == np.float64 else "f32"
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    for fill in (tt.FillMode.lower, tt.FillMode.upper):
        d = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=fill)
        n0 = trsv_win.launches[name]
        got = tt.trsv(1.0, D, d, tt.Operation.none, torch.from_numpy(b).to(cuda))
        torch.cuda.synchronize()
        form = ttri.trsv_form_for(D.plan, d, tt.Operation.none)
        assert trsv_win.launches[name] == n0 + solve_launches(form.nblk, form.nb, form.WL)
        want = tt.trsv(1.0, C, d, tt.Operation.none, torch.from_numpy(b))
        assert got.device.type == "cuda"
        assert near_error(got.cpu().numpy(), want.numpy()) <= expected_precision(tdt)
