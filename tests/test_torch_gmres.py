"""Restarted GMRES and the matrix-free solvers of the PyTorch port
(solvers/fused.py: pgmres_solve, make_gmres_operator, make_cg_operator) and
the forward solves against each other, against the JAX package's. The
cases mirror tests/test_fused_solvers.py one by one, on the same operands
made from seeds with numpy (m <= 64), plus a small general-structure
operand (m = 1024, as tests/test_torch_gen_cg.py) in permuted space.

Tolerances (utils/tolerances.py). In float64 the two packages take the
same steps and differ by rounding only: GMRES's iteration count is equal,
x agrees within expected_precision(f64) on max |a - b| / max(|b|, 1) and
the residual estimate within it times max(||b||, 1). The forward (RCI)
and fused forms of one method agree within 1 iteration for CG and within
`restart` for GMRES (tests/test_fused_solvers.py:58-59, :80-81); the
matrix-free and matrix paths agree exactly. On the f32 gen operand a
fixed-length solve (rtol = 0) counts equal iterations and x agrees within
1e-3 after them (tests/test_torch_gen_cg.py's bound for 5 CG iterations,
here 20 GMRES steps on a better-conditioned operator), and a converged
solve agrees within 2 iterations with a true relative residual within
10 rtol (the f32 recursive-residual drift).
"""


import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.solvers import RINFO_ITER
from aoclsparse_tpu_torch.solvers import fused as fused_mod
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
N = tt.Operation.none
F64 = expected_precision(torch.float64)


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


def spd(seed, m):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((m, m))
    B[np.abs(B) < 1.1] = 0
    dense = B @ B.T + m * np.eye(m)
    dense[np.abs(dense) < 1e-12] = 0
    return dense


def general(seed, m):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, m))
    dense[np.abs(dense) < 1.0] = 0
    np.fill_diagonal(dense, m / 2.0)
    return dense


def complex_general(seed, m, cut=1.4, diag=None):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    dense[np.abs(dense) < cut] = 0
    np.fill_diagonal(dense, m / 2.0 + 1j if diag is None else diag)
    return dense


def csr(dense):
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    return ptr, np.nonzero(dense)[1].astype(np.int32), dense[dense != 0]


def pair(ast, dense):
    m = dense.shape[0]
    ptr, ind, val = csr(dense)
    return ast.create_csr(m, m, ptr, ind, val), tt.create_csr(m, m, ptr, ind, val, device="cpu")


def rhs(seed, m, dtype=np.float64):
    rng = np.random.default_rng(seed + 200)
    b = rng.standard_normal(m)
    if np.issubdtype(dtype, np.complexfloating):
        b = b + 1j * rng.standard_normal(m)
    return b.astype(dtype)


def rci_iters(A, b, method, precond_name, restart=20):
    """The forward interface's x and iterations (test_fused_solvers.py _rci_iters)."""
    h = tt.itsol_init(A.dtype, device="cpu")
    tt.itsol_option_set(h, "iterative method", method)
    if method == "CG":
        tt.itsol_option_set(h, "cg preconditioner", precond_name)
    else:
        tt.itsol_option_set(h, "gmres preconditioner", precond_name)
        tt.itsol_option_set(h, "gmres restart iterations", restart)
    x, rinfo, st = tt.itsol_solve(h, A.shape[0], A, GEN, b)
    assert st == tt.Status.success
    return x, int(rinfo[RINFO_ITER])


def same_solve(got, want, bnorm):
    """x, iterations and residual of a port solve against the JAX one's."""
    (xt, kt, rt), (xj, kj, rj) = got, want
    assert kt == int(kj)
    assert near_error(xt.numpy(), np.asarray(xj)) <= F64
    assert abs(rt - float(rj)) <= F64 * max(bnorm, 1.0)


# ---------------------------------------------------------------------------
# pgmres_solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precond", [None, "ilu0"])
def test_pgmres_matches_jax_and_rci(ast, precond):
    """test_pgmres_matches_rci: the same x, count and estimate as the JAX
    package's fused GMRES; the forward interface within one cycle."""
    dense = general(1, 40)
    J, T = pair(ast, dense)
    b = rhs(1, 40)
    got = tt.pgmres_solve(T, torch.from_numpy(b), rtol=1e-8, maxit=200, restart=12, precond=precond)
    same_solve(got, ast.pgmres_solve(J, b, rtol=1e-8, maxit=200, restart=12, precond=precond), np.linalg.norm(b))
    x, it, rnorm = got
    np.testing.assert_allclose(dense @ x.numpy(), b, atol=1e-5)
    _x, it_rci = rci_iters(T, torch.from_numpy(b), "GMRES", {None: "None", "ilu0": "ILU0"}[precond], restart=12)
    assert abs(it - it_rci) <= 12
    assert rnorm <= 1e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("maxit, restart, want", [(20, 5, 20), (23, 6, 24), (7, 20, 20)])
def test_pgmres_fixed_length_counts_match_jax(ast, maxit, restart, want):
    """rtol = atol = 0 takes whole cycles: maxit is tested only between
    cycles, so the count passes it by up to restart - 1, as in the JAX
    package; the residual is the Givens estimate."""
    dense = general(2, 48)
    J, T = pair(ast, dense)
    b = rhs(2, 48)
    x0 = np.random.default_rng(3).standard_normal(48)
    got = tt.pgmres_solve(T, torch.from_numpy(b), x0=torch.from_numpy(x0), rtol=0.0, maxit=maxit, restart=restart,
                          precond="ilu0")
    same_solve(got, ast.pgmres_solve(J, b, x0=x0, rtol=0.0, maxit=maxit, restart=restart, precond="ilu0"),
               np.linalg.norm(b))
    assert got[1] == want


def test_pgmres_zero_rhs(ast):
    J, T = pair(ast, general(4, 16))
    xj, kj, _ = ast.pgmres_solve(J, np.zeros(16), rtol=1e-8, maxit=50)
    x, it, rnorm = tt.pgmres_solve(T, torch.zeros(16, dtype=torch.float64), rtol=1e-8, maxit=50)
    assert it == kj == 0 and rnorm == 0.0
    np.testing.assert_array_equal(x.numpy(), 0.0)


@pytest.mark.parametrize("solver", ["pcg", "pgmres"])
def test_exact_initial_guess(ast, solver):
    """test_pcg_exact_initial_guess, and GMRES's: 0 iterations, x0 back."""
    dense = spd(5, 24)
    _J, T = pair(ast, dense)
    xstar = np.random.default_rng(6).standard_normal(24)
    b = torch.from_numpy(dense @ xstar)
    fn = tt.pcg_solve if solver == "pcg" else tt.pgmres_solve
    x, it, _rnorm = fn(T, b, x0=torch.from_numpy(xstar.copy()), rtol=1e-10, maxit=50)
    assert it == 0
    np.testing.assert_allclose(x.numpy(), xstar)


def test_pgmres_complex_solves_matches_jax(ast):
    """Complex Givens (real c, s carrying the phase, conjugated
    orthogonalization): the JAX package's x, count and estimate; the
    forward interface within one cycle."""
    dense = complex_general(7, 40)
    J, T = pair(ast, dense)
    b = rhs(7, 40, np.complex128)
    got = tt.pgmres_solve(T, torch.from_numpy(b), rtol=1e-8, maxit=200, restart=12)
    same_solve(got, ast.pgmres_solve(J, b, rtol=1e-8, maxit=200, restart=12), np.linalg.norm(b))
    x, it, rnorm = got
    np.testing.assert_allclose(dense @ x.numpy(), b, atol=1e-5)
    assert rnorm <= 1e-8 * np.linalg.norm(b) + 1e-12
    _x, it_rci = rci_iters(T, torch.from_numpy(b), "GMRES", "None", restart=12)
    assert abs(it - it_rci) <= 12


def complex_symmetric(seed, m):
    """A complex-symmetric operand (test_pcg_complex_symmetric_matches_rci)."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    B[np.abs(B) < 1.2] = 0
    dense = B @ B.T + m * np.eye(m)
    dense[np.abs(dense) < 1e-12] = 0
    return (dense + dense.T) / 2


@pytest.mark.parametrize("solver, precond", [("pcg", "ilu0"), ("pcg", "sgs"), ("pgmres", "ilu0")])
def test_complex_preconditioned_solves_match_jax(ast, solver, precond):
    """test_pgmres_complex_ilu0 and test_pcg_complex_symmetric_matches_rci
    with a preconditioner: the JAX package's count, x and estimate (f64
    model tolerance), on a complex general operand for GMRES (ILU0:
    pgmres_solve takes no SGS, as in the JAX package) and a
    complex-symmetric one for CG (unconjugated dots); ILU0 takes no more
    GMRES iterations than none."""
    if solver == "pgmres":
        dense = complex_general(8, 48, cut=1.5, diag=48 + 0.5j)
        kw = dict(rtol=1e-8, maxit=200, restart=15)
    else:
        dense = complex_symmetric(8, 40)
        kw = dict(rtol=1e-8, maxit=300)
    J, T = pair(ast, dense)
    b = rhs(8, dense.shape[0], np.complex128)
    fn_t, fn_j = (tt.pcg_solve, ast.pcg_solve) if solver == "pcg" else (tt.pgmres_solve, ast.pgmres_solve)
    got = fn_t(T, torch.from_numpy(b), precond=precond, **kw)
    same_solve(got, fn_j(J, b, precond=precond, **kw), np.linalg.norm(b))
    assert got[0].dtype == torch.complex128
    np.testing.assert_allclose(dense @ got[0].numpy(), b, atol=1e-5)
    if solver == "pgmres":
        assert got[1] <= tt.pgmres_solve(T, torch.from_numpy(b), **kw)[1]


def test_pgmres_errors():
    T = tt.create_csr(16, 16, *csr(general(9, 16)), device="cpu")
    R = tt.create_csr(3, 4, np.array([0, 1, 2, 3]), np.array([0, 1, 2], np.int32), np.ones(3), device="cpu")
    cases = ((lambda: tt.pgmres_solve(None, torch.ones(3)), tt.Status.invalid_pointer),
             (lambda: tt.pgmres_solve(R, torch.ones(3, dtype=torch.float64)), tt.Status.invalid_size),
             (lambda: tt.pgmres_solve(T, torch.ones(17, dtype=torch.float64)), tt.Status.invalid_size),
             (lambda: tt.pgmres_solve(T, torch.ones(16, dtype=torch.float64), precond="jacobi"),
              tt.Status.invalid_value))
    for call, status in cases:
        with pytest.raises(tt.AoclSparseError) as e:
            call()
        assert e.value.status == status


@pytest.mark.parametrize("solver", ["pcg", "pgmres"])
def test_update_values_drops_the_ilu_state(solver):
    """test_fused_cache_invalidated_by_update_values: the second ILU0 solve
    runs on the new values' factors."""
    m = 64
    rng = np.random.default_rng(10)
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.clip(i + rng.integers(-3, 4, 3), 0, m - 1)
        dense[i, js] = rng.standard_normal(js.size)
    dense = dense @ dense.T + m * np.eye(m)
    ptr, ind, val = csr(dense)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    b = torch.from_numpy(rhs(10, m))
    fn = tt.pcg_solve if solver == "pcg" else tt.pgmres_solve
    x1, _, _ = fn(T, b, rtol=1e-10, precond="ilu0")
    np.testing.assert_allclose(dense @ x1.numpy(), b.numpy(), atol=1e-7)
    tt.update_values(T, 2.0 * val)
    assert T.ilu_state is None
    x2, _, _ = fn(T, b, rtol=1e-10, precond="ilu0")
    np.testing.assert_allclose(2.0 * dense @ x2.numpy(), b.numpy(), atol=1e-7)


# ---------------------------------------------------------------------------
# the loop's counts
# ---------------------------------------------------------------------------


def counting(fn, counts, key):
    def wrapped(v):
        counts[key] += 1
        return fn(v)

    return wrapped


@pytest.mark.parametrize("rtol, maxit, restart", [(0.0, 20, 5), (1e-9, 200, 7), (1e-9, 200, 50)])
def test_gmres_loop_counts_and_early_stop_match_jax(ast, rtol, maxit, restart):
    """The cycle stops at its first inactive step where the JAX scan runs
    its remaining steps masked: x, the count and the estimate stay the JAX
    package's (make_gmres_operator on the same dense operator). matvec runs
    once for the initial residual, once a cycle and once a step; the
    preconditioner once a step and once a cycle, on V y."""
    import jax.numpy as jnp

    m = 48
    dense = general(11, m)
    dinv = 1.0 / np.diag(dense)
    b = rhs(11, m)
    counts = {"mv": 0, "pre": 0}
    Dt, dinv_t = torch.from_numpy(dense), torch.from_numpy(dinv)
    solve = tt.make_gmres_operator(counting(lambda v: Dt @ v, counts, "mv"),
                                   precond=counting(lambda r: dinv_t * r, counts, "pre"), maxit=maxit, restart=restart,
                                   device="cpu")
    Dj, dinv_j = jnp.asarray(dense), jnp.asarray(dinv)
    jsolve = ast.solvers.make_gmres_operator(lambda v: Dj @ v, precond=lambda r: dinv_j * r, maxit=maxit,
                                             restart=restart)
    got = solve(b, rtol=rtol)
    same_solve(got, jsolve(b, rtol=rtol), np.linalg.norm(b))
    it = got[1]
    cycles = -(-it // restart)
    assert counts == {"mv": 1 + cycles + it, "pre": it + cycles}
    if rtol > 0 and restart < 50:
        assert it % restart != 0  # the last cycle stopped early
        np.testing.assert_allclose(dense @ got[0].numpy(), b, atol=1e-6)


# ---------------------------------------------------------------------------
# the CG side of tests/test_fused_solvers.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precond", [None, "sgs", "ilu0"])
def test_pcg_matches_rci(ast, precond):
    """test_pcg_matches_rci: fused CG against the forward interface within 1
    iteration (None and SGS, the RCI CG's preconditioners)."""
    dense = spd(12, 48)
    _J, T = pair(ast, dense)
    b = torch.from_numpy(rhs(12, 48))
    x, it, rnorm = tt.pcg_solve(T, b, rtol=1e-8, maxit=200, precond=precond)
    np.testing.assert_allclose(dense @ x.numpy(), b.numpy(), atol=1e-5)
    if precond in (None, "sgs"):
        _x, it_rci = rci_iters(T, b, "CG", {None: "None", "sgs": "SGS"}[precond])
        assert abs(it - it_rci) <= 1
    assert rnorm <= 1e-8 * np.linalg.norm(b.numpy()) + 1e-12


def test_pcg_ilu0_reduces_iterations():
    dense = spd(13, 64)
    T = tt.create_csr(64, 64, *csr(dense), device="cpu")
    b = torch.from_numpy(rhs(13, 64))
    _, it_plain, _ = tt.pcg_solve(T, b, rtol=1e-8, maxit=300, precond=None)
    _, it_ilu, _ = tt.pcg_solve(T, b, rtol=1e-8, maxit=300, precond="ilu0")
    assert it_ilu <= it_plain


def test_pcg_complex_symmetric_matches_rci(ast):
    m = 40
    rng = np.random.default_rng(14)
    B = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    dense = (B @ B.T + m * np.eye(m)).astype(np.complex128)
    dense[np.abs(dense) < 1e-12] = 0
    dense = (dense + dense.T) / 2
    _J, T = pair(ast, dense)
    b = torch.from_numpy(rhs(14, m, np.complex128))
    x, it, _rn = tt.pcg_solve(T, b, rtol=1e-6, maxit=300)
    np.testing.assert_allclose(dense @ x.numpy(), b.numpy(), atol=1e-4)
    h = tt.itsol_init(torch.complex128, device="cpu")
    tt.itsol_option_set(h, "cg rel tolerance", 1e-6)
    _x2, ri, st = tt.itsol_solve(h, m, T, GEN, b)
    assert st == tt.Status.success and abs(it - int(ri[RINFO_ITER])) <= 1


# ---------------------------------------------------------------------------
# the matrix-free operators and itsol_solve_operator
# ---------------------------------------------------------------------------


def test_cg_operator_matches_pcg_and_jax(ast):
    """test_cg_operator_matches_pcg: the same iteration path as pcg_solve on
    the same operator, and as the JAX package's operator."""
    import jax.numpy as jnp

    dense = spd(15, 48)
    J, T = pair(ast, dense)
    b = rhs(15, 48)
    Dt = torch.from_numpy(dense)
    x, it, rn = tt.make_cg_operator(lambda v: Dt @ v, maxit=300, device="cpu")(b, rtol=1e-10)
    assert x.device.type == "cpu"
    xr, itr, _ = tt.pcg_solve(T, torch.from_numpy(b), rtol=1e-10, maxit=300)
    np.testing.assert_allclose(x.numpy(), xr.numpy(), atol=1e-8)
    assert it == itr
    Dj = jnp.asarray(dense)
    same_solve((x, it, rn), ast.solvers.make_cg_operator(lambda v: Dj @ v, maxit=300)(b, rtol=1e-10),
               np.linalg.norm(b))


def test_cg_operator_jacobi_precond():
    dense = spd(16, 48)
    b = torch.from_numpy(rhs(16, 48))
    Dt, dinv = torch.from_numpy(dense), torch.from_numpy(1.0 / np.diag(dense))
    _x0, i0, _ = tt.make_cg_operator(lambda v: Dt @ v, maxit=500)(b, rtol=1e-10)
    x1, i1, _ = tt.make_cg_operator(lambda v: Dt @ v, precond=lambda r: dinv * r, maxit=500)(b, rtol=1e-10)
    np.testing.assert_allclose(x1.numpy(), np.linalg.solve(dense, b.numpy()), atol=1e-7)
    assert i1 <= i0


def test_gmres_operator_matches_pgmres(ast):
    dense = general(17, 40)
    _J, T = pair(ast, dense)
    b = rhs(17, 40)
    Dt = torch.from_numpy(dense)
    x, it, _rn = tt.make_gmres_operator(lambda v: Dt @ v, maxit=300, restart=15, device="cpu")(b, rtol=1e-10)
    xr, itr, _ = tt.pgmres_solve(T, torch.from_numpy(b), rtol=1e-10, maxit=300, restart=15)
    np.testing.assert_allclose(x.numpy(), xr.numpy(), atol=1e-8)
    assert it == itr


def test_gmres_operator_reusable_across_rhs():
    dense = general(18, 32)
    Dt = torch.from_numpy(dense)
    solve = tt.make_gmres_operator(lambda v: Dt @ v, maxit=200, restart=10)
    for k in range(3):
        b = rhs(18 + k, 32)
        x, _it, _rn = solve(torch.from_numpy(b), rtol=1e-10)
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, b), atol=1e-6)


@pytest.mark.parametrize("method", ["CG", "GMRES"])
def test_itsol_solve_operator_matches_matrix_path(method):
    """The matrix-free and matrix paths take the same iterations."""
    dense = spd(19, 40) if method == "CG" else general(19, 40)
    T = tt.create_csr(40, 40, *csr(dense), device="cpu")
    b = rhs(19, 40)
    out = []
    for free in (False, True):
        h = tt.itsol_init(np.float64, device="cpu")
        tt.itsol_option_set(h, "iterative method", method)
        if free:
            Dt = torch.from_numpy(dense)
            out.append(tt.itsol_solve_operator(h, 40, lambda v: Dt @ v, b))
        else:
            out.append(tt.itsol_solve(h, 40, T, GEN, b))
    (x_mat, r_mat, s_mat), (x_op, r_op, s_op) = out
    assert s_mat == s_op == tt.Status.success
    assert r_op[RINFO_ITER] == r_mat[RINFO_ITER]
    np.testing.assert_allclose(x_op.numpy(), x_mat.numpy(), atol=1e-9)


def test_itsol_solve_operator_user_precond_matches_jax(ast):
    import jax.numpy as jnp

    dense = spd(20, 32)
    b = rhs(20, 32)
    dinv = 1.0 / np.diag(dense)
    out = {}
    for lib in (ast, tt):
        h = lib.itsol_init(np.float64) if lib is ast else tt.itsol_init(np.float64, device="cpu")
        lib.itsol_option_set(h, "cg preconditioner", "User")
        if lib is ast:
            Dj, dj = jnp.asarray(dense), jnp.asarray(dinv)
            out[lib] = lib.itsol_solve_operator(h, 32, lambda v: Dj @ v, b, precond=lambda r: dj * r)
        else:
            Dt, dt = torch.from_numpy(dense), torch.from_numpy(dinv)
            out[lib] = lib.itsol_solve_operator(h, 32, lambda v: Dt @ v, b, precond=lambda r: dt * r)
    (xj, rj, sj), (xt, rt, st) = out[ast], out[tt]
    assert sj.name == st.name == "success" and rt[RINFO_ITER] == rj[RINFO_ITER]
    assert near_error(xt.numpy(), np.asarray(xj)) <= F64
    np.testing.assert_allclose(xt.numpy(), np.linalg.solve(dense, b), atol=1e-7)


# ---------------------------------------------------------------------------
# permuted space on a gen operand
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_pallas(ast, monkeypatch):
    from aoclsparse_tpu.core.context import reset_context

    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_PALLAS", "1")
    reset_context()
    yield ast
    monkeypatch.delenv("AOCLSPARSE_TPU_FORCE_PALLAS")
    reset_context()


def circuit(seed, m=1024, scatter=200):
    """Circuit-like (local band + hub columns + scatter), not symmetrised,
    with a Gershgorin shift (tests/test_torch_gen_cg.py's profile): a scipy
    CSR in float32."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-10, 11, 6), 0, m - 1))
        d[i, js] = rng.standard_normal(js.size)
    for h in rng.choice(m, 5, replace=False):
        rs = rng.choice(m, m // 3, replace=False)
        d[rs, h] = rng.standard_normal(rs.size)
    d[rng.integers(0, m, scatter), rng.integers(0, m, scatter)] = rng.standard_normal(scatter)
    d[np.arange(m), np.arange(m)] = np.abs(d).sum(1) + 1.0
    S = sp.csr_matrix(d.astype(np.float32))
    S.sort_indices()
    return S


def test_pgmres_permuted_space_matches_jax(jax_pallas, monkeypatch):
    """pgmres_solve(precond=None) on a gen operand iterates in permuted
    space, the permutes once each a solve, against the JAX package's
    permuted-space GMRES (its _gen_pspace and _build_gmres_run, as its
    pgmres_solve composes them on its TPU)."""
    import jax
    import jax.numpy as jnp

    from aoclsparse_tpu.planner.plan import get_plan
    from aoclsparse_tpu.solvers.fused import _build_gmres_run, _gen_pspace

    S = circuit(21)
    m = S.shape[0]
    T = tt.create_csr(m, m, S.indptr, S.indices, S.data, device="cpu")
    form = tt.optimize(T).exec_form_for(GEN, N)
    assert form.kind == "gen" and form.gen_bandt
    J = jax_pallas.create_csr(m, m, S.indptr, S.indices, S.data)
    jform = get_plan(J).exec_form_for(jax_pallas.MatrixDescriptor(), jax_pallas.Operation.none, kind="gen")
    jform.precision_mode = "full"
    jmv, jto, jfrom = _gen_pspace(jform)
    counts = {"to": 0, "from": 0}
    real = fused_mod._gen_pspace

    def counted_pspace(f):
        mv_p, to_p, from_p = real(f)
        return mv_p, counting(to_p, counts, "to"), counting(from_p, counts, "from")

    monkeypatch.setattr(fused_mod, "_gen_pspace", counted_pspace)
    b = np.random.default_rng(22).standard_normal(m).astype(np.float32)
    zeros = np.zeros(m, np.float32)

    def jax_gmres(rtol, maxit):
        run = jax.jit(_build_gmres_run(jmv, None, 10, maxit))
        xp, k, r = run(jto(jnp.asarray(b)), jto(jnp.asarray(zeros)), jnp.float32(rtol), jnp.float32(0.0))
        return np.asarray(jfrom(xp)), int(k), float(r)

    xt, kt, _rt = tt.pgmres_solve(T, torch.from_numpy(b), rtol=0.0, maxit=20, restart=10)
    xj, kj, _rj = jax_gmres(0.0, 20)
    assert kt == kj == 20 and counts == {"to": 2, "from": 1}  # b and x0 in, x out
    assert near_error(xt.numpy(), xj) <= 1e-3
    xt, kt, rt = tt.pgmres_solve(T, torch.from_numpy(b), rtol=1e-5, maxit=300, restart=10)
    xj, kj, _rj = jax_gmres(1e-5, 300)
    assert abs(kt - kj) <= 2 and rt <= 1e-5 * np.linalg.norm(b) * 1.0001
    for x in (xt.numpy(), xj):
        assert np.linalg.norm(S.astype(np.float64) @ x.astype(np.float64) - b) / np.linalg.norm(b) <= 1e-4


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, precond", [(np.float64, "ilu0"), (np.float32, "ilu0"), (np.float64, None),
                                            (np.complex128, None)])
def test_cuda_pgmres_matches_cpu(cuda, dtype, precond):
    """pgmres_solve on the card: the CPU's count (f64 and complex exactly,
    f32 within one cycle), x within the dtype's model tolerance scaled by
    the solve's rtol, a true residual within 10 rtol."""
    dense = (complex_general(23, 64) if dtype == np.complex128 else general(23, 64)).astype(dtype)
    ptr, ind, val = csr(dense)
    b = rhs(23, 64, dtype)
    rtol = 1e-10 if dtype != np.float32 else 1e-5
    out = {}
    for dev in (cuda, torch.device("cpu")):
        A = tt.create_csr(64, 64, ptr, ind, val, device=dev)
        out[dev.type] = tt.pgmres_solve(A, torch.from_numpy(b).to(dev), rtol=rtol, restart=8, precond=precond)
    (xd, kd, _), (xc, kc, _) = out["cuda"], out["cpu"]
    assert xd.device.type == "cuda"
    assert kd == kc if dtype != np.float32 else abs(kd - kc) <= 8
    assert np.linalg.norm(dense.astype(np.complex128) @ xd.cpu().numpy() - b) <= 10 * rtol * np.linalg.norm(b)


@pytest.mark.cuda
def test_cuda_gmres_operator_stays_on_the_card(cuda):
    dense = general(24, 40)
    Dt = torch.from_numpy(dense).to(cuda)
    x, it, _rn = tt.make_gmres_operator(lambda v: Dt @ v, maxit=200, restart=10)(rhs(24, 40), rtol=1e-10)
    assert x.device == cuda and it > 0
    np.testing.assert_allclose(x.cpu().numpy(), np.linalg.solve(dense, rhs(24, 40)), atol=1e-6)
