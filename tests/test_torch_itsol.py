"""The iterative-solver framework of the PyTorch port (solvers/itsol.py,
solvers/options.py) against the JAX package's: the option registry and its
table, the CG and GMRES RCI steppers driven by hand and through the forward
interfaces, their statuses, rinfo, monitoring, interrupts and the option
lock. The cases mirror tests/test_itsol.py and tests/test_rci_monitoring.py
one by one, on the same operands made from seeds with numpy (m <= 64).

Tolerances (utils/tolerances.py): the two packages run the same steps in
the same order, their sums in another order, so the job sequences and
rinfo[30] (iterations) are equal, x agrees within expected_precision of the
dtype on max |a - b| / max(|b|, 1), rinfo[1] (||b||) likewise, and
rinfo[0] (||r||, which ends near rounding) within expected_precision times
max(||b||, 1). A converged x also solves the dense system to the JAX
tests' own bounds.
"""

import io

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.solvers import RINFO_ITER, RINFO_RES_NORM, RINFO_RHS_NORM
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
CPU = torch.device("cpu")


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


# ---------------------------------------------------------------------------
# operands (the generators of tests/test_itsol.py and test_rci_monitoring.py)
# ---------------------------------------------------------------------------


def spd(seed, m, cut=1.2):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((m, m))
    B[np.abs(B) < cut] = 0
    return B @ B.T + m * np.eye(m)


def general(seed, m):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, m))
    dense[np.abs(dense) < 1.0] = 0
    np.fill_diagonal(dense, m / 2.0)
    return dense


def complex_general(seed, m):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    dense[np.abs(dense) < 1.2] = 0
    np.fill_diagonal(dense, m)
    return dense


def complex_symmetric(seed, m):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((m, m))
    dense = (B @ B.T + m * np.eye(m)).astype(np.complex128)
    dense += 1j * 0.01 * (np.ones((m, m)) + np.eye(m))
    return (dense + dense.T) / 2


def indefinite(_seed, m):
    dense = -np.eye(m) * m
    dense[0, 1] = dense[1, 0] = 1.0
    return dense


OPERANDS = {"spd": spd, "general": general, "cgeneral": complex_general, "csym": complex_symmetric,
            "indefinite": indefinite}


def csr(dense):
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    return ptr, np.nonzero(dense)[1].astype(np.int32), dense[dense != 0]


def rhs(seed, m, dtype):
    rng = np.random.default_rng(seed + 100)
    b = rng.standard_normal(m)
    if np.issubdtype(dtype, np.complexfloating):
        b = b + 1j * rng.standard_normal(m)
    return b.astype(dtype)


def handles(ast, dense, dtype):
    ptr, ind, val = csr(dense)
    m = dense.shape[0]
    val = val.astype(dtype)
    return ast.create_csr(m, m, ptr, ind, val), tt.create_csr(m, m, ptr, ind, val, device="cpu")


def init(lib, dtype, opts):
    h = lib.itsol_init(dtype) if lib is not tt else tt.itsol_init(dtype, device="cpu")
    for k, v in opts.items():
        lib.itsol_option_set(h, k, v)
    return h


def assert_rinfo(rt, rj, dtype):
    tol = expected_precision(np.dtype(dtype))
    assert rt[RINFO_ITER] == rj[RINFO_ITER]
    assert near_error(rt[RINFO_RHS_NORM], rj[RINFO_RHS_NORM]) <= tol
    assert abs(rt[RINFO_RES_NORM] - rj[RINFO_RES_NORM]) <= tol * max(rj[RINFO_RHS_NORM], 1.0)


# ---------------------------------------------------------------------------
# the forward interface (tests/test_itsol.py, test_rci_monitoring.py)
# ---------------------------------------------------------------------------

GM = {"iterative method": "GMRES"}
#: case -> (operand, seed, m, dtype, options, user preconditioner, status, the JAX test's bound on x)
FORWARD = {
    "cg_forward": ("spd", 1, 25, np.float64, {}, None, "success", 1e-6),
    "pcg_sgs": ("spd", 2, 40, np.float64, {"cg preconditioner": "SGS"}, None, "success", 1e-6),
    "cg_user_jacobi": ("spd", 3, 30, np.float64, {"cg preconditioner": "User"}, "jacobi", "success", 1e-6),
    "cg_maxit": ("spd", 4, 30, np.float64, {"cg iteration limit": 2}, None, "maxit", None),
    "cg_f32": ("spd", 5, 15, np.float32, {}, None, "success", 1e-3),
    "cg_complex_symmetric": ("csym", 6, 16, np.complex128, {}, None, "success", 1e-6),
    "cg_complex_user_jacobi": ("csym", 7, 16, np.complex128, {"cg preconditioner": "User"}, "jacobi", "success",
                               1e-6),
    "gmres_forward": ("general", 8, 30, np.float64, dict(GM, **{"gmres rel tolerance": 1e-10}), None, "success",
                      1e-6),
    "gmres_ilu0": ("general", 9, 40, np.float64,
                   dict(GM, **{"gmres rel tolerance": 1e-10, "gmres preconditioner": "ILU0"}), None, "success", 1e-6),
    "gmres_restart5": ("general", 10, 50, np.float64,
                       dict(GM, **{"gmres restart iterations": 5, "gmres rel tolerance": 1e-10}), None, "success",
                       1e-5),
    "gmres_restart_accounting": ("general", 11, 50, np.float64,
                                 dict(GM, **{"gmres restart iterations": 5, "gmres rel tolerance": 1e-12}), None,
                                 "success", 1e-8),
    "gmres_user_jacobi": ("general", 12, 24, np.float64,
                          dict(GM, **{"gmres rel tolerance": 1e-10, "gmres preconditioner": "User"}), "jacobi",
                          "success", 1e-6),
    "gmres_maxit": ("general", 13, 48, np.float64,
                    dict(GM, **{"gmres restart iterations": 5, "gmres iteration limit": 7,
                                "gmres rel tolerance": 1e-14}), None, "maxit", None),
    "gmres_f32_ilu0": ("general", 14, 40, np.float32, dict(GM, **{"gmres preconditioner": "ILU0"}), None, "success",
                       1e-3),
    "gmres_complex": ("cgeneral", 15, 20, np.complex128, dict(GM, **{"gmres rel tolerance": 1e-12}), None,
                      "success", 1e-7),
    "gmres_complex64": ("cgeneral", 16, 20, np.complex64, GM, None, "success", 1e-3),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_matches_jax(ast, case):
    op, seed, m, dtype, opts, user, status, x_tol = FORWARD[case]
    dense = OPERANDS[op](seed, m).astype(dtype)
    J, T = handles(ast, dense, dtype)
    b = rhs(seed, m, dtype)
    d = np.diag(dense).copy()
    jac = {None: None, "jacobi": lambda u: np.asarray(u) / d}[user]
    xj, rj, sj = ast.itsol_solve(init(ast, dtype, opts), m, J, ast.MatrixDescriptor(), b, precond=jac)
    ht = init(tt, dtype, opts)
    tjac = None if user is None else (lambda u: u / torch.from_numpy(d))
    xt, rt, st = tt.itsol_solve(ht, m, T, GEN, torch.from_numpy(b), precond=tjac)
    assert sj.name == st.name == status
    assert xt.device == CPU and xt.dtype == T.dtype and not ht.solving()
    assert_rinfo(rt, rj, dtype)
    assert near_error(xt.numpy(), np.asarray(xj)) <= expected_precision(np.dtype(dtype))
    if x_tol is not None:
        np.testing.assert_allclose(xt.numpy(), np.linalg.solve(dense.astype(np.complex128), b), atol=x_tol)
    if case == "gmres_restart_accounting":
        assert rt[RINFO_ITER] >= 5  # more than one cycle at this tolerance
    if case == "gmres_maxit":
        assert rt[RINFO_ITER] == 10  # whole cycles: maxit passes at a cycle's end


def test_pcg_sgs_converges_fewer_iters():
    dense = spd(2, 40)
    T = tt.create_csr(40, 40, *csr(dense), device="cpu")
    b = torch.from_numpy(rhs(2, 40, np.float64))
    _x1, r1, _s1 = tt.itsol_solve(init(tt, np.float64, {}), 40, T, GEN, b)
    _x2, r2, s2 = tt.itsol_solve(init(tt, np.float64, {"cg preconditioner": "SGS"}), 40, T, GEN, b)
    assert s2 == tt.Status.success and r2[RINFO_ITER] <= r1[RINFO_ITER]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gmres_ilu0_no_more_iterations(dtype):
    dense = (general if dtype == np.float64 else complex_general)(9, 40).astype(dtype)
    T = tt.create_csr(40, 40, *csr(dense), device="cpu")
    b = torch.from_numpy(rhs(9, 40, dtype))
    _x0, r0, _s0 = tt.itsol_solve(init(tt, dtype, GM), 40, T, GEN, b)
    _x, r, s = tt.itsol_solve(init(tt, dtype, dict(GM, **{"gmres preconditioner": "ILU0"})), 40, T, GEN, b)
    assert s == tt.Status.success and r[RINFO_ITER] <= r0[RINFO_ITER]


@pytest.mark.parametrize("precond, option", [("SGS", "cg preconditioner"), ("ILU0", "gmres preconditioner")])
def test_complex_matrix_preconditioners_match_jax(ast, precond, option):
    """Complex handles with the SGS or ILU0 option (tests/test_itsol.py:241,
    :258 with a preconditioner): the JAX package's x, rinfo and status
    within the f64 model tolerance; the solve ends and the options unlock."""
    dense = complex_symmetric(6, 16)
    m = 16
    J, T = handles(ast, dense, np.complex128)
    opts = {option: precond} if option.startswith("cg") else dict(GM, **{option: precond})
    b = rhs(6, m, np.complex128)
    hj, ht = init(ast, np.complex128, opts), init(tt, np.complex128, opts)
    xj, rj, sj = ast.itsol_solve(hj, m, J, ast.MatrixDescriptor(), b)
    xt, rt, st = tt.itsol_solve(ht, m, T, GEN, torch.from_numpy(b))
    assert int(st) == int(sj) == int(tt.Status.success)
    assert_rinfo(rt, rj, np.complex128)
    assert near_error(xt.numpy(), np.asarray(xj)) <= expected_precision(torch.float64)
    np.testing.assert_allclose(dense @ xt.numpy(), b, atol=1e-6)
    assert not ht.solving()
    tt.itsol_option_set(ht, option, "None")  # unlocked


def test_monitoring_user_stop(ast):
    """monitoring gets a numpy array and rinfo at every check; nonzero
    asks for user_stop (tests/test_itsol.py test_monitoring_user_stop)."""
    dense = spd(17, 25)
    J, T = handles(ast, dense, np.float64)
    b = rhs(17, 25, np.float64)
    seen = {"jax": [], "torch": []}

    def monitor(key):
        def fn(u, rinfo):
            assert isinstance(u, np.ndarray) and u.shape == (25,)
            seen[key].append(int(rinfo[RINFO_ITER]))
            return 1 if len(seen[key]) >= 3 else 0

        return fn

    xj, rj, sj = ast.itsol_solve(ast.itsol_init(np.float64), 25, J, ast.MatrixDescriptor(), b, monitoring=monitor("jax"))
    xt, rt, st = tt.itsol_solve(init(tt, np.float64, {}), 25, T, GEN, torch.from_numpy(b), monitoring=monitor("torch"))
    assert sj == ast.Status.user_stop and st == tt.Status.user_stop
    assert seen["jax"] == seen["torch"] == [0, 1, 2]
    assert near_error(xt.numpy(), np.asarray(xj)) <= expected_precision(torch.float64)


@pytest.mark.parametrize("method", ["CG", "GMRES"])
def test_user_precond_none_requests_user_stop(ast, method):
    """A User preconditioner that returns None asks for user_stop."""
    dense = spd(18, 20)
    J, T = handles(ast, dense, np.float64)
    b = rhs(18, 20, np.float64)
    opt = "cg preconditioner" if method == "CG" else "gmres preconditioner"
    opts = {"iterative method": method, opt: "User"}
    xj, rj, sj = ast.itsol_solve(init(ast, np.float64, opts), 20, J, ast.MatrixDescriptor(), b, precond=lambda u: None)
    ht = init(tt, np.float64, opts)
    xt, rt, st = tt.itsol_solve(ht, 20, T, GEN, torch.from_numpy(b), precond=lambda u: None)
    assert sj.name == st.name == "user_stop" and not ht.solving()
    assert_rinfo(rt, rj, np.float64)
    tt.itsol_option_set(ht, opt, "None")  # the options unlocked in finally


def test_update_values_drops_ilu_state():
    """update_values drops the ILU0 factors: a second ILU0-GMRES solve
    factors the new values (x halves when A doubles)."""
    dense = general(19, 40)
    ptr, ind, val = csr(dense)
    T = tt.create_csr(40, 40, ptr, ind, val, device="cpu")
    b = torch.from_numpy(rhs(19, 40, np.float64))
    opts = dict(GM, **{"gmres preconditioner": "ILU0", "gmres rel tolerance": 1e-12})
    x1, _r1, s1 = tt.itsol_solve(init(tt, np.float64, opts), 40, T, GEN, b)
    st1 = T.ilu_state
    tt.update_values(T, 2.0 * val)
    assert T.ilu_state is None
    x2, _r2, s2 = tt.itsol_solve(init(tt, np.float64, opts), 40, T, GEN, b)
    assert s1 == s2 == tt.Status.success and T.ilu_state is not st1
    np.testing.assert_allclose(x2.numpy(), 0.5 * x1.numpy(), atol=1e-9)
    np.testing.assert_allclose(2.0 * dense @ x2.numpy(), b.numpy(), atol=1e-9)


def test_itsol_solve_takes_the_device_of_a():
    """A handle names cuda:0 unless told otherwise; itsol_solve runs on
    A's device whatever the handle's."""
    h = tt.itsol_init(np.float64)
    assert h.device == torch.device("cuda", 0) and h.dtype == torch.float64
    dense = spd(20, 12)
    T = tt.create_csr(12, 12, *csr(dense), device="cpu")
    x, _r, s = tt.itsol_solve(h, 12, T, GEN, rhs(20, 12, np.float64))
    assert s == tt.Status.success and x.device == CPU
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, rhs(20, 12, np.float64)), atol=1e-6)


# ---------------------------------------------------------------------------
# the RCI steppers driven by hand
# ---------------------------------------------------------------------------


def drive(rci, matvec, precond=None, monitor=None, max_bounces=100000):
    """Drive a stepper; return the jobs it asked for, in order, and whether
    the monitor interrupted it."""
    jobs = []
    job, u = rci.step()
    while job != 0 and len(jobs) < max_bounces:  # 0: RciJob.stop
        jobs.append(int(job))
        if job == 2:  # mv
            job, u = rci.step(matvec(u))
        elif job == 3:  # precond
            job, u = rci.step(precond(u) if precond else u)
        else:  # stopping_criterion
            if monitor is not None and monitor(u):
                return jobs, True
            job, u = rci.step()
    return jobs, False


#: case -> (operand, seed, m, options, user preconditioner, interrupt at this bounce)
RCI = {
    "cg_manual": ("spd", 21, 20, {}, None, None),
    "cg_monitor_every_iteration": ("spd", 22, 30, {"iterative method": "CG"}, None, None),
    "cg_jacobi": ("spd", 23, 24, {"cg preconditioner": "User"}, "jacobi", None),
    "gmres_user_jacobi": ("general", 24, 24, dict(GM, **{"gmres rel tolerance": 1e-10, "gmres preconditioner": "User"}),
                          "jacobi", None),
    "gmres_monitor_restart8": ("general", 25, 40, dict(GM, **{"gmres restart iterations": 8}), None, None),
    "gmres_interrupt": ("general", 26, 60, dict(GM, **{"gmres restart iterations": 4, "gmres rel tolerance": 1e-14}),
                        None, 2),
}


@pytest.mark.parametrize("case", sorted(RCI))
def test_rci_drive_matches_jax(ast, case):
    """The same job sequence and monitored rinfo in both packages; one mv
    a CG iteration plus the initial residual; a GMRES cycle-end residual
    history that ends lowest; an interrupted x that improved on zero."""
    op, seed, m, opts, user, stop_at = RCI[case]
    dense = OPERANDS[op](seed, m)
    b = rhs(seed, m, np.float64)
    d = np.diag(dense)
    runs = {}
    for lib in (ast, tt):
        h = init(lib, np.float64, opts)
        lib.itsol_rci_input(h, m, b if lib is ast else torch.from_numpy(b))
        rci = lib.itsol_rci_solve(h)
        history = []

        def monitor(_u):
            history.append((float(h.rinfo[RINFO_RES_NORM]), int(h.rinfo[RINFO_ITER])))
            return stop_at is not None and len(history) >= stop_at

        jobs, interrupted = drive(rci, lambda u: dense @ np.asarray(u), (lambda u: np.asarray(u) / d) if user else None,
                                  monitor)
        runs[lib is tt] = (jobs, interrupted, history, np.asarray(rci.x), h.rinfo.copy())
    (jj, ij, hj, xj, rj), (jt, it, ht, xt, rt) = runs[False], runs[True]
    assert jt == jj and it == ij == (stop_at is not None)
    assert [k for _r, k in ht] == [k for _r, k in hj]
    np.testing.assert_allclose([r for r, _k in ht], [r for r, _k in hj], atol=expected_precision(torch.float64) * max(
        rj[RINFO_RHS_NORM], 1.0))
    assert_rinfo(rt, rj, np.float64)
    assert near_error(xt, xj) <= expected_precision(torch.float64)
    if stop_at is not None:
        assert np.linalg.norm(dense @ xt - b) < np.linalg.norm(b)  # progress was made
        return
    np.testing.assert_allclose(dense @ xt, b, atol=1e-6)
    if case.startswith("cg"):
        assert jt.count(2) == int(rt[RINFO_ITER]) + 1
        assert len(ht) >= 2 and [k for _r, k in ht] == sorted(k for _r, k in ht)
    else:
        assert ht[-1][0] <= ht[0][0] + 1e-12
        assert rt[RINFO_RHS_NORM] == pytest.approx(np.linalg.norm(b))


def test_rci_interrupt_state(ast):
    """A user may stop driving the loop after the first job: the state stays
    consistent (tests/test_itsol.py test_rci_interrupt)."""
    dense = spd(27, 20)
    for lib in (ast, tt):
        h = init(lib, np.float64, {})
        lib.itsol_rci_input(h, 20, np.ones(20))
        rci = lib.itsol_rci_solve(h)
        job, u = rci.step()
        assert job == lib.RciJob.mv and rci.task == "init_res"
        np.testing.assert_array_equal(np.asarray(u), np.zeros(20))
    x = torch.from_numpy(dense @ np.ones(20))
    job, u = rci.step(x)
    assert job == tt.RciJob.stopping_criterion and torch.equal(u, rci.r)


@pytest.mark.parametrize("method", ["CG", "GMRES"])
def test_rci_reuses_handle_after_interrupt(ast, method):
    """After an abandoned RCI solve, a fresh forward solve on the handle
    works (test_rci_monitoring.py), and matches the JAX package."""
    dense = general(28, 24) if method == "GMRES" else spd(28, 24)
    J, T = handles(ast, dense, np.float64)
    b = rhs(28, 24, np.float64)
    out = {}
    for lib, A, bb in ((ast, J, b), (tt, T, torch.from_numpy(b))):
        h = init(lib, np.float64, {"iterative method": method})
        lib.itsol_rci_input(h, 24, bb)
        rci = lib.itsol_rci_solve(h)
        job, u = rci.step()
        rci.step(dense @ np.asarray(u))  # one bounce, then abandon
        h.rci = None
        out[lib is tt] = lib.itsol_solve(h, 24, A, lib.MatrixDescriptor(), bb)
    (xj, rj, sj), (xt, rt, st) = out[False], out[True]
    assert sj.name == st.name == "success"
    assert_rinfo(rt, rj, np.float64)
    np.testing.assert_allclose(dense @ xt.numpy(), b, atol=1e-6)


def test_rci_option_lock_during_solve(ast):
    """Options lock once the stepper starts; invalid_operation mid-solve."""
    for lib in (ast, tt):
        h = init(lib, np.float64, GM)
        lib.itsol_rci_input(h, 16, np.ones(16))
        rci = lib.itsol_rci_solve(h)
        rci.step()
        with pytest.raises(lib.AoclSparseError) as e:
            lib.itsol_option_set(h, "gmres restart iterations", 3)
        assert e.value.status == lib.Status.invalid_operation
        h.rci = None
        with pytest.raises(lib.AoclSparseError) as e:  # the option itself stays locked until a forward solve ends
            lib.itsol_option_set(h, "gmres restart iterations", 3)
        assert e.value.status == lib.Status.invalid_operation
        h.options.unlock_all()
        lib.itsol_option_set(h, "gmres restart iterations", 3)


# ---------------------------------------------------------------------------
# options and errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64", "complex128"])
def test_option_table_text_matches_jax(ast, dtype):
    """The table prints the same text, character for character, for a numpy
    and a torch dtype, before and after options are set."""
    hj = ast.itsol_init(np.dtype(dtype))
    for ht in (tt.itsol_init(np.dtype(dtype), device="cpu"), tt.itsol_init(getattr(torch, dtype), device="cpu")):
        assert ht.options.print_options() == hj.options.print_options()
    for h, lib in ((hj, ast), (ht, tt)):
        for k, v in (("Iterative Method", "GM RES"), ("gmres rel tolerance", 1e-9), ("cg iteration limit", 7),
                     ("cg preconditioner", "SymGS")):
            lib.itsol_option_set(h, k, v)
    buf_j, buf_t = io.StringIO(), io.StringIO()
    assert tt.itsol_handle_prn_options(ht, file=buf_t) == ast.itsol_handle_prn_options(hj, file=buf_j)
    assert buf_t.getvalue() == buf_j.getvalue() and "iterative method = gm res" in buf_t.getvalue()
    assert ht.options.get("cg iteration limit") == 7 and ht.options.get_string("iterative method") == "gm res"


#: option -> value, for the invalid_value cases
BAD_OPTIONS = {
    "no such option": 1,
    "cg iteration limit": 0,
    "gmres restart iterations": -1,
    "cg rel tolerance": -1e-3,
    "iterative method": "banana",
    "gmres preconditioner": "SGS",
    "cg preconditioner": "ILU0",
}


@pytest.mark.parametrize("name", sorted(BAD_OPTIONS))
def test_option_errors_match_jax(ast, name):
    for lib in (ast, tt):
        h = init(lib, np.float64, {})
        with pytest.raises(lib.AoclSparseError) as e:
            lib.itsol_option_set(h, name, BAD_OPTIONS[name])
        assert e.value.status == lib.Status.invalid_value
    lib.itsol_option_set(h, "CG  Iteration LIMIT", 9)  # names are case- and space-insensitive
    assert h.options.get("cg iteration limit") == 9


def _errors(lib, dev):
    """The failing calls of the interfaces, each with the status both
    packages give."""
    m = 12
    dense = spd(29, m)
    ptr, ind, val = csr(dense)
    kw = {"device": dev} if lib is tt else {}
    A = lib.create_csr(m, m, ptr, ind, val, **kw)
    R = lib.create_csr(m, m + 1, ptr, ind, val, **kw)
    bad = np.ones(m)
    bad[3] = np.nan
    D = lib.MatrixDescriptor()

    def handle(**opts):
        return init(lib, np.float64, opts)

    return {
        "rci_input_size": (lambda: lib.itsol_rci_input(handle(), m, np.ones(m + 1)), "invalid_size"),
        "rci_solve_before_input": (lambda: lib.itsol_rci_solve(handle()), "invalid_value"),
        "solve_null_matrix": (lambda: lib.itsol_solve(handle(), m, None, D, np.ones(m)), "invalid_pointer"),
        "solve_null_descr": (lambda: lib.itsol_solve(handle(), m, A, None, np.ones(m)), "invalid_pointer"),
        "solve_shape": (lambda: lib.itsol_solve(handle(), m, R, D, np.ones(m)), "invalid_size"),
        "solve_b_size": (lambda: lib.itsol_solve(handle(), m, A, D, np.ones(m - 1)), "invalid_size"),
        "user_without_callable": (lambda: lib.itsol_solve(handle(**{"cg preconditioner": "User"}), m, A, D, np.ones(m)),
                                  "invalid_value"),
        "cg_nan_b": (lambda: lib.itsol_solve(handle(), m, A, D, bad), "invalid_value"),
        "gmres_nan_b": (lambda: lib.itsol_solve(handle(**GM), m, A, D, bad), "invalid_value"),
        "gmres_zero_tolerances": (lambda: lib.itsol_solve(
            handle(**GM, **{"gmres rel tolerance": 0, "gmres abs tolerance": 0}), m, A, D, np.ones(m)),
            "invalid_value"),
        "cg_not_spd": (lambda: lib.itsol_solve(handle(), 10, lib.create_csr(10, 10, *csr(indefinite(0, 10)), **kw), D,
                                               np.random.default_rng(0).standard_normal(10)), "numerical_error"),
        "operator_null_matvec": (lambda: lib.itsol_solve_operator(handle(), m, None, np.ones(m)), "invalid_pointer"),
        "operator_sgs": (lambda: lib.itsol_solve_operator(handle(**{"cg preconditioner": "SGS"}), m,
                                                          lambda v: v, np.ones(m)), "invalid_value"),
        "operator_ilu0": (lambda: lib.itsol_solve_operator(handle(**GM, **{"gmres preconditioner": "ILU0"}), m,
                                                           lambda v: v, np.ones(m)), "invalid_value"),
        "operator_user_without_callable": (lambda: lib.itsol_solve_operator(
            handle(**{"cg preconditioner": "User"}), m, lambda v: v, np.ones(m)), "invalid_value"),
    }


@pytest.mark.parametrize("case", sorted(_errors(tt, "cpu")))
def test_interface_errors_match_jax(ast, case):
    for lib in (ast, tt):
        call, status = _errors(lib, "cpu")[case]
        with pytest.raises(lib.AoclSparseError) as e:
            call()
        assert e.value.status.name == status, lib.__name__


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cg_forward", "pcg_sgs", "gmres_ilu0", "gmres_complex", "gmres_f32_ilu0"])
def test_cuda_forward_matches_cpu(cuda, case):
    """The forward interface on the card: the same status and iterations as
    on the CPU, x within the dtype's model tolerance."""
    op, seed, m, dtype, opts, _user, status, _x_tol = FORWARD[case]
    dense = OPERANDS[op](seed, m).astype(dtype)
    ptr, ind, val = csr(dense)
    b = torch.from_numpy(rhs(seed, m, dtype))
    out = {}
    for dev in (cuda, CPU):
        A = tt.create_csr(m, m, ptr, ind, val, device=dev)
        h = tt.itsol_init(dtype, device=dev)
        for k, v in opts.items():
            tt.itsol_option_set(h, k, v)
        out[dev.type] = tt.itsol_solve(h, m, A, GEN, b.to(dev))
    (xd, rd, sd), (xc, rc, sc) = out["cuda"], out["cpu"]
    assert sd.name == sc.name == status and xd.device.type == "cuda"
    assert rd[RINFO_ITER] == rc[RINFO_ITER]
    assert near_error(xd.cpu().numpy(), xc.numpy()) <= expected_precision(np.dtype(dtype))


@pytest.mark.cuda
def test_cuda_rci_drive_on_the_card(cuda):
    """An RCI stepper on the handle's device: its vectors stay on the card."""
    dense = general(24, 24)
    A = tt.create_csr(24, 24, *csr(dense), device=cuda)
    h = tt.itsol_init(np.float64, device=cuda)
    for k, v in dict(GM, **{"gmres rel tolerance": 1e-10}).items():
        tt.itsol_option_set(h, k, v)
    b = rhs(24, 24, np.float64)
    tt.itsol_rci_input(h, 24, b)
    rci = tt.itsol_rci_solve(h)
    jobs, _ = drive(rci, lambda u: tt.mv(1.0, A, GEN, tt.Operation.none, u, 0.0))
    assert rci.x.device.type == "cuda" and jobs.count(2) >= 2
    np.testing.assert_allclose(dense @ rci.x.cpu().numpy(), b, atol=1e-8)
