"""The level-scheduled solve (sv KID 1) and the host engine (sv KID 2) of
the PyTorch port against aoclsparse_tpu and scipy.

The level form is plain torch on the CPU here; it takes the same level
schedule (the host C++ level_schedule, the same source in both packages)
and the same run packing as the JAX package, which the tests compare
exactly. Solves are held to expected_precision(float64) of
utils/tolerances.py on max |a - b| / max(|b|, 1): the same per-level sums,
taken in another order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import native
from aoclsparse_tpu_torch.kernels.trsv_level import _level_runs, build_level_form, level_form_stats
from aoclsparse_tpu_torch.planner import triangular as ttri
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

TOL64 = expected_precision(torch.float64)
NONE = tt.Operation.none


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


def _triangles():
    """A shallow random triangle (m = 1000, seed 3), the lower triangle of
    the 16^3 27-point stencil, and a deep banded one."""
    rng = np.random.default_rng(3)
    m = 1000
    R = sp.random(m, m, density=4.0 / m, random_state=rng, format="csr")
    A = sp.tril(R, -1) + sp.diags(4.0 + rng.random(m))
    nx = 16
    g = np.arange(nx**3)
    z, y, x = g // nx**2, (g // nx) % nx, g % nx
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = (0 <= z + dz) & (z + dz < nx) & (0 <= y + dy) & (y + dy < nx) & (0 <= x + dx) & (x + dx < nx)
                rows.append(g[ok])
                cols.append(g[ok] + (dz * nx + dy) * nx + dx)
    r, c = np.concatenate(rows), np.concatenate(cols)
    S = sp.tril(sp.csr_matrix((np.where(r == c, 26.0, -1.0), (r, c)), shape=(nx**3, nx**3))).tocsr()
    B = sp.diags([np.full(799, -0.5), np.full(800, 2.0)], [-1, 0]).tocsr()
    out = {}
    for name, T in (("random", A.tocsr()), ("stencil16", S), ("chain", B)):
        T.sort_indices()
        out[name] = T
    return out


TRI = _triangles()


@pytest.mark.parametrize("name", sorted(TRI))
def test_schedule_stats_and_runs_match_jax(ast, name):
    """native.level_schedule, level_form_stats and the run packing equal
    the JAX package's on the same lower triangle."""
    from aoclsparse_tpu import native as jnative
    from aoclsparse_tpu.kernels.xla import trsv_level as jl

    T = TRI[name]
    m = T.shape[0]
    lv, n = native.level_schedule(m, T.indptr, T.indices)
    jlv, jn = jnative.level_schedule(m, T.indptr, T.indices)
    assert n == jn and np.array_equal(lv, jlv)
    assert level_form_stats(T.indptr, T.indices, m) == jl.level_form_stats(T.indptr, T.indices, m)
    counts = np.bincount(lv, minlength=n)
    w = np.zeros(n, dtype=np.int64)
    np.maximum.at(w, lv, np.diff(T.indptr) - 1)
    assert _level_runs(counts, w) == jl._level_runs(counts, w)
    assert _level_runs(counts, w, max_runs=3) == jl._level_runs(counts, w, max_runs=3)


@pytest.mark.parametrize("name,unit", [("random", False), ("stencil16", False), ("chain", True)])
def test_level_form_matches_jax_and_scipy(ast, name, unit):
    """build_level_form: solves (1-D and K = 3) within the model tolerance
    of scipy's substitution (unit: the stored diagonal is ignored), and a
    refresh with doubled values halves them. On the chain, the JAX
    package's form has the same levels and runs and solves the same (its
    build and solve compile a program a run shape, seconds each, so the
    other triangles are held to it through their schedule and runs,
    test_schedule_stats_and_runs_match_jax)."""
    from aoclsparse_tpu.kernels.xla.trsv_level import build_level_form as jbuild

    T = TRI[name]
    m = T.shape[0]
    src = np.arange(T.nnz, dtype=np.int64)
    f = build_level_form(T.indptr, T.indices, src, m, False, unit, torch.from_numpy(T.data))
    Tu = T.copy()
    if unit:
        Tu.setdiag(1.0)
    rng = np.random.default_rng(4)
    for b in (rng.standard_normal(m), rng.standard_normal((m, 3))):
        got = f.solve(torch.from_numpy(b)).numpy()
        assert near_error(got, spla.spsolve_triangular(Tu, b, lower=True)) <= TOL64
    if name == "chain":
        jf = jbuild(T.indptr, T.indices, src, m, False, unit, T.data)
        assert (f.nlev, f.R_max, f.W_max, f.runs) == (jf.nlev, jf.R_max, jf.W_max, jf.runs)
        assert near_error(got, np.asarray(jf.solve(b))) <= TOL64
    f.refresh(torch.from_numpy(2.0 * T.data))
    if not unit:
        assert near_error(f.solve(torch.from_numpy(b)).numpy(), spla.spsolve_triangular(Tu, b, lower=True) / 2) <= TOL64


def test_trsv_kid1_kid2_orientations_against_jax(ast):
    """trsv with kid 1 and kid 2 over every fill, diag and op on a general
    matrix (the 16^3 stencil, its upper part scaled by 0.9), against the JAX
    package's host engine (its kid 2, which the level engine matches there:
    test_level_form_matches_jax_and_scipy); the refusal statuses match."""
    T = TRI["stencil16"]
    full = (T + sp.triu(T.T, 1) * 0.9).tocsr()
    full.sort_indices()
    m = full.shape[0]
    J = ast.create_csr(m, m, full.indptr, full.indices, full.data)
    P = tt.create_csr(m, m, full.indptr, full.indices, full.data, device="cpu")
    b = np.random.default_rng(5).standard_normal(m)
    for fill in (tt.FillMode.lower, tt.FillMode.upper):
        for diag in (tt.DiagType.non_unit, tt.DiagType.unit):
            for op in (NONE, tt.Operation.transpose, tt.Operation.conjugate_transpose):
                dj = ast.MatrixDescriptor(type=ast.MatrixType.triangular, fill_mode=ast.FillMode(int(fill)),
                                          diag_type=ast.DiagType(int(diag)))
                dt = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=fill, diag_type=diag)
                want = np.asarray(ast.trsv(1.5, J, dj, ast.Operation(int(op)), b, kid=2))
                for kid in (1, 2):
                    got = tt.trsv(1.5, P, dt, op, torch.from_numpy(b), kid=kid)
                    assert got.device.type == "cpu"
                    assert near_error(got.numpy(), want) <= TOL64, (fill, diag, op, kid)
    # a missing diagonal: invalid_value in both packages, from every engine
    Z = sp.csr_matrix(full)
    Z.setdiag(0.0)
    Z.eliminate_zeros()
    Jz = ast.create_csr(m, m, Z.indptr, Z.indices, Z.data)
    Pz = tt.create_csr(m, m, Z.indptr, Z.indices, Z.data, device="cpu")
    lo_j = ast.MatrixDescriptor(type=ast.MatrixType.triangular)
    lo_t = tt.MatrixDescriptor(type=tt.MatrixType.triangular)
    for kid in (0, 1):
        with pytest.raises(ast.AoclSparseError) as ej:
            ast.trsv(1.0, Jz, lo_j, ast.Operation.none, b, kid=kid)
        with pytest.raises(tt.AoclSparseError) as et:
            tt.trsv(1.0, Pz, lo_t, NONE, torch.from_numpy(b), kid=kid)
        assert int(et.value.status) == int(ej.value.status) == int(tt.Status.invalid_value)


def test_level_form_drops_with_update_values():
    """The level and host forms are cached on plan.levels, which
    update_values drops: the next kid 1 / kid 2 solve sees the new values."""
    T = TRI["random"]
    m = T.shape[0]
    A = tt.create_csr(m, m, T.indptr, T.indices, T.data, device="cpu")
    lo = tt.MatrixDescriptor(type=tt.MatrixType.triangular)
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(m))
    x1 = [tt.trsv(1.0, A, lo, NONE, b, kid=k) for k in (1, 2)]
    tt.update_values(A, 2.0 * T.data)
    for k, x in zip((1, 2), x1):
        assert near_error(tt.trsv(1.0, A, lo, NONE, b, kid=k).numpy(), x.numpy() / 2) <= TOL64


def test_host_solves_and_numpy_fallback():
    """native.trsv_seq / trsm_seq against scipy, lower and upper, and the
    row-loop numpy fallback against the C++ sweep."""
    T = TRI["random"]
    m = T.shape[0]
    U = T.T.tocsr()
    U.sort_indices()
    rng = np.random.default_rng(7)
    b, B = rng.standard_normal(m), rng.standard_normal((m, 4))
    for M, lower in ((T, True), (U, False)):
        want = spla.spsolve_triangular(M, b, lower=lower)
        assert near_error(native.trsv_seq(m, M.indptr, M.indices, M.data, b, lower), want) <= TOL64
        assert near_error(native._trsv_seq_numpy(m, M.indptr.astype(np.int64), M.indices.astype(np.int64), M.data, b,
                                                 lower), want) <= TOL64
        assert near_error(native.trsm_seq(m, M.indptr, M.indices, M.data, B, lower),
                          spla.spsolve_triangular(M, B, lower=lower)) <= TOL64


def test_host_form_layout():
    """trsv_host_form_for keeps the effective triangle with its diagonal;
    a transposed solve carries the host-transposed structure and flips the
    orientation."""
    T = TRI["chain"]
    m = T.shape[0]
    full = (T + T.T - sp.diags(T.diagonal())).tocsr()
    A = tt.create_csr(m, m, full.indptr, full.indices, full.data, device="cpu")
    plan = tt.optimize(A)
    lo = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
    f = ttri.trsv_host_form_for(plan, lo, NONE)
    ft = ttri.trsv_host_form_for(plan, lo, tt.Operation.transpose)
    assert f.lower and not ft.lower and f.val.size == ft.val.size == 2 * m - 1
    assert ttri.trsv_host_form_for(plan, lo, NONE) is f
