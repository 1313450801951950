"""SymGS (symgs, symgs_mv) and SOR (sorv) of the PyTorch port against
aoclsparse_tpu.

Operand: the 12^3 27-point stencil (26 on the diagonal, -1 for each
neighbour) with its values perturbed by uniform noise in [-0.2, 0.2]
(seed 0), so that it is not symmetric and the L and U views of the
splitting differ; a 24^3 stencil case runs the sweep over dwin forms. Both
packages run in float64; results are held to expected_precision(float64)
of utils/tolerances.py on max |a - b| / max(|b|, 1) (the same products,
summed in another order, and inverted diagonal blocks against the JAX
package's substitution on the CPU).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.planner.triangular import trsv_form_for
from aoclsparse_tpu_torch.solvers.symgs import lu_view_selection
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

TOL64 = expected_precision(torch.float64)


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


def _stencil(nx, seed=0):
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
    rows = np.repeat(i, valid.sum(1))
    val = np.where(cols == rows, 26.0, -1.0) + np.random.default_rng(seed).uniform(-0.2, 0.2, cols.size)
    return ptr, cols.astype(np.int32), val


@pytest.fixture(scope="module")
def pair(ast):
    ptr, ind, val = _stencil(12)
    m = len(ptr) - 1
    return ast.create_csr(m, m, ptr, ind, val), tt.create_csr(m, m, ptr, ind, val, device="cpu"), m


# every case of lu_view_selection, and the triangular quick exit
VIEWS = [
    ("general", "lower"),
    ("symmetric", "lower"),
    ("symmetric", "upper"),
    ("hermitian", "lower"),
    ("hermitian", "upper"),
    ("triangular", "upper"),
]


def _descr(lib, mtype, fill):
    return lib.MatrixDescriptor(type=getattr(lib.MatrixType, mtype), fill_mode=getattr(lib.FillMode, fill))


@pytest.mark.parametrize("mtype,fill", VIEWS)
@pytest.mark.parametrize("trans", ["none", "transpose"])
def test_symgs_and_symgs_mv_match_jax(ast, pair, mtype, fill, trans):
    """symgs and symgs_mv over every lu_view_selection case, the cached-form
    path (no kid) and the composed path (kids 0, 1, 2: the blocked, level
    and host solves) against the JAX package's default sweep."""
    J, T, m = pair
    rng = np.random.default_rng(1)
    b, x0 = rng.standard_normal(m), rng.standard_normal(m)
    xj, yj = ast.symgs_mv(getattr(ast.Operation, trans), J, _descr(ast, mtype, fill), 1.3, b, x0)
    xj1 = ast.symgs(getattr(ast.Operation, trans), J, _descr(ast, mtype, fill), 1.3, b, x0)
    assert near_error(np.asarray(xj1), np.asarray(xj)) <= TOL64
    for kid in (None, 0, 1, 2):
        xt, yt = tt.symgs_mv(getattr(tt.Operation, trans), T, _descr(tt, mtype, fill), 1.3, torch.from_numpy(b),
                             torch.from_numpy(x0), kid=kid)
        assert near_error(xt.numpy(), np.asarray(xj)) <= TOL64, kid
        assert near_error(yt.cpu().numpy(), np.asarray(yj)) <= TOL64, kid
        xs = tt.symgs(getattr(tt.Operation, trans), T, _descr(tt, mtype, fill), 1.3, torch.from_numpy(b),
                      torch.from_numpy(x0), kid=kid)
        assert near_error(xs.numpy(), np.asarray(xj)) <= TOL64, kid


def test_lu_view_selection_matches_jax(ast):
    """Which stored triangle feeds the L and U views, and with which op,
    for every matrix type, fill and trans (symgs.hpp:150-190)."""
    from aoclsparse_tpu.solvers.symgs import lu_view_selection as jax_views

    for mtype in ("general", "symmetric", "hermitian"):
        for fill in ("lower", "upper"):
            for trans in ("none", "transpose", "conjugate_transpose"):
                got = lu_view_selection(getattr(tt.MatrixType, mtype), _descr(tt, mtype, fill),
                                        getattr(tt.Operation, trans))
                want = jax_views(getattr(ast.MatrixType, mtype), _descr(ast, mtype, fill),
                                 getattr(ast.Operation, trans))
                assert [int(v) for v in got] == [int(v) for v in want]


def test_symgs_on_dwin_forms_against_a_scipy_sweep():
    """One sweep on the 24^3 stencil (its triangles take dwin forms): the
    symgs_ref steps in float64 scipy, x0 = 0 and alpha = 1."""
    ptr, ind, val = _stencil(24, seed=2)
    m = len(ptr) - 1
    S = sp.csr_matrix((val, ind, ptr), shape=(m, m))
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    b = np.random.default_rng(3).standard_normal(m)
    x0 = np.random.default_rng(4).standard_normal(m)
    x, y = tt.symgs_mv(tt.Operation.none, T, tt.MatrixDescriptor(), 0.5, torch.from_numpy(b), torch.from_numpy(x0))
    tri = lambda f: tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=f)
    assert trsv_form_for(T.plan, tri(tt.FillMode.lower), tt.Operation.none).kind == "dwin"
    Ls, Us, D = sp.tril(S, -1), sp.triu(S, 1), sp.diags(S.diagonal())
    x1 = spla.spsolve_triangular((Ls + D).tocsr(), b - 0.5 * (Us @ x0), lower=True)
    want = spla.spsolve_triangular((Us + D).tocsr(), b - Ls @ x1, lower=False)
    assert near_error(x.numpy(), want) <= TOL64
    assert near_error(y.numpy(), S @ want) <= TOL64


def test_symgs_statuses_match_jax(ast, pair):
    """The reference's not_implemented cases (a unit diagonal, general with
    conjugate_transpose) and the argument statuses, as in the JAX package."""
    J, T, m = pair
    b = np.ones(m)
    cases = [
        (dict(trans="none", descr=("general", "lower", "unit"), b=b), tt.Status.not_implemented),
        (dict(trans="conjugate_transpose", descr=("general", "lower", "non_unit"), b=b), tt.Status.not_implemented),
        (dict(trans="none", descr=("general", "lower", "non_unit"), b=np.ones(m - 1)), tt.Status.invalid_size),
        (dict(trans="none", descr=("general", "lower", "non_unit"), b=None), tt.Status.invalid_pointer),
    ]
    for kw, status in cases:
        got = []
        for lib, A, arr in ((ast, J, lambda v: v), (tt, T, lambda v: None if v is None else torch.from_numpy(v))):
            mt, fm, dg = kw["descr"]
            d = lib.MatrixDescriptor(type=getattr(lib.MatrixType, mt), fill_mode=getattr(lib.FillMode, fm),
                                     diag_type=getattr(lib.DiagType, dg))
            with pytest.raises(lib.AoclSparseError) as e:
                lib.symgs(getattr(lib.Operation, kw["trans"]), A, d, 1.0, arr(kw["b"]))
            got.append(int(e.value.status))
        assert got == [int(status)] * 2, kw
    R = tt.create_csr(2, 3, np.array([0, 1, 2]), np.array([0, 1], np.int32), np.ones(2), device="cpu")
    with pytest.raises(tt.AoclSparseError) as e:
        tt.symgs(tt.Operation.none, R, tt.MatrixDescriptor(), 1.0, torch.ones(2, dtype=torch.float64))
    assert e.value.status == tt.Status.invalid_size


@pytest.mark.parametrize("omega,alpha", [(1.2, 0.7), (0.8, 0.0), (1.0, 1.0)])
def test_sorv_matches_jax_and_scipy(ast, pair, omega, alpha):
    """One forward SOR sweep against the JAX package and a float64 scipy
    sweep: (D + omega L) x1 = omega b - (omega U + (omega - 1) D) x0."""
    J, T, m = pair
    rng = np.random.default_rng(5)
    x, b = rng.standard_normal(m), rng.standard_normal(m)
    want = np.asarray(ast.sorv(ast.SorType.forward, ast.MatrixDescriptor(), J, omega, alpha, x, b))
    got = tt.sorv(tt.SorType.forward, tt.MatrixDescriptor(), T, omega, alpha, torch.from_numpy(x), torch.from_numpy(b))
    assert near_error(got.numpy(), want) <= TOL64
    S = sp.csr_matrix((T.plan.clean.val.numpy(), T.plan.clean.ind, T.plan.clean.ptr), shape=(m, m))
    L, U, D = sp.tril(S, -1), sp.triu(S, 1), sp.diags(S.diagonal())
    x0 = alpha * x
    ref = spla.spsolve_triangular((D + omega * L).tocsr(), omega * b - (omega * U + (omega - 1) * D) @ x0, lower=True)
    assert near_error(got.numpy(), ref) <= TOL64


def test_sorv_statuses_and_divergences(ast, pair):
    """The reference's not_implemented cases (backward and symmetric
    sweeps, a non-general descriptor) and a missing diagonal, as in the JAX
    package. Complex SOR, with complex omega and alpha: both packages run
    it (the reference stubs it), with the same x within the f64 model
    tolerance."""
    J, T, m = pair
    x = b = np.ones(m)
    for sor, descr in ((ast.SorType.backward, "general"), (ast.SorType.symmetric, "general"),
                       (ast.SorType.forward, "symmetric")):
        for lib, A, arr in ((ast, J, np.asarray), (tt, T, torch.from_numpy)):
            with pytest.raises(lib.AoclSparseError) as e:
                lib.sorv(lib.SorType(int(sor)), lib.MatrixDescriptor(type=getattr(lib.MatrixType, descr)), A, 1.1, 1.0,
                         arr(x), arr(b))
            assert e.value.status == lib.Status.not_implemented
    ptr = np.array([0, 1, 2, 3])
    ind = np.array([0, 0, 2], np.int32)  # row 1 has no diagonal
    for lib, A in ((ast, ast.create_csr(3, 3, ptr, ind, np.ones(3))),
                   (tt, tt.create_csr(3, 3, ptr, ind, np.ones(3), device="cpu"))):
        arr = np.ones(3) if lib is ast else torch.ones(3, dtype=torch.float64)
        with pytest.raises(lib.AoclSparseError) as e:
            lib.sorv(lib.SorType.forward, lib.MatrixDescriptor(), A, 1.1, 1.0, arr, arr)
        assert e.value.status == lib.Status.invalid_value
    zptr, zind = np.array([0, 1, 3, 5]), np.array([0, 0, 1, 1, 2], np.int32)
    zval = np.array([2.0 + 1j, -0.5j, 3.0, 0.25 + 0.5j, 4.0 - 1j])
    zx, zb = np.array([1.0, 1j, -1.0 + 0.5j]), np.array([0.5j, 2.0, 1.0 - 1j])
    want = ast.sorv(ast.SorType.forward, ast.MatrixDescriptor(), ast.create_csr(3, 3, zptr, zind, zval), 1.1 + 0.2j,
                    0.7 - 0.1j, zx, zb)
    got = tt.sorv(tt.SorType.forward, tt.MatrixDescriptor(), tt.create_csr(3, 3, zptr, zind, zval, device="cpu"),
                  1.1 + 0.2j, 0.7 - 0.1j, torch.from_numpy(zx), torch.from_numpy(zb))
    assert got.dtype == torch.complex128
    assert near_error(got.numpy(), np.asarray(want)) <= TOL64


def test_symgs_and_sorv_hints(ast, pair):
    """set_symgs_hint and set_sorv_hint are exported, register a hint and
    validate like the JAX package's (nop = 0 needs a kid)."""
    _J, T, _m = pair
    for name in ("symgs", "symgs_mv", "sorv", "set_symgs_hint", "set_sorv_hint"):
        assert callable(getattr(tt, name)) and callable(getattr(ast, name))
    n0 = len(T.hints)
    tt.set_symgs_hint(T, tt.Operation.none, tt.MatrixDescriptor(), nop=10)
    tt.set_sorv_hint(T, tt.Operation.none, tt.MatrixDescriptor(), nop=0, kid=0)
    assert [h.action for h in T.hints[:2]] == ["sorv", "symgs"] and len(T.hints) == n0 + 2
    tt.optimize(T)
    for setter in (tt.set_symgs_hint, tt.set_sorv_hint):
        with pytest.raises(tt.AoclSparseError) as e:
            setter(T, tt.Operation.none, tt.MatrixDescriptor(), nop=0)
        assert e.value.status == tt.Status.invalid_value


@pytest.mark.parametrize("grid", ["stencil24", "laplace128"])
def test_symgs_and_sorv_on_dwin_operands_match_jax(ast, grid):
    """symgs_mv and sorv on the operands whose triangles take dwin forms in
    both packages (the 24^3 stencil with perturbed values, the 128^2
    5-point Laplacian) against the JAX package."""
    if grid == "stencil24":
        ptr, ind, val = _stencil(24, seed=5)
    else:
        T1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(128, 128))
        S = (sp.kron(sp.eye(128), T1) + sp.kron(T1, sp.eye(128))).tocsr()
        S.sort_indices()
        ptr, ind, val = S.indptr, S.indices.astype(np.int32), S.data
    m = len(ptr) - 1
    J, T = ast.create_csr(m, m, ptr, ind, val), tt.create_csr(m, m, ptr, ind, val, device="cpu")
    rng = np.random.default_rng(6)
    b, x0 = rng.standard_normal(m), rng.standard_normal(m)
    xj, yj = ast.symgs_mv(ast.Operation.none, J, ast.MatrixDescriptor(), 0.8, b, x0)
    xt, yt = tt.symgs_mv(tt.Operation.none, T, tt.MatrixDescriptor(), 0.8, torch.from_numpy(b), torch.from_numpy(x0))
    assert trsv_form_for(T.plan, tt.MatrixDescriptor(type=tt.MatrixType.triangular), tt.Operation.none).kind == "dwin"
    assert near_error(xt.numpy(), np.asarray(xj)) <= TOL64
    assert near_error(yt.numpy(), np.asarray(yj)) <= TOL64
    want = np.asarray(ast.sorv(ast.SorType.forward, ast.MatrixDescriptor(), J, 1.3, 0.5, x0, b))
    got = tt.sorv(tt.SorType.forward, tt.MatrixDescriptor(), T, 1.3, 0.5, torch.from_numpy(x0), torch.from_numpy(b))
    assert near_error(got.numpy(), want) <= TOL64
