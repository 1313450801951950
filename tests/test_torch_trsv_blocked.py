"""The ``dwin`` and ``gather`` blocked solves of the PyTorch port against
aoclsparse_tpu, and the sv KIDs 1 and 2 beside them.

Operands, made with numpy from seeds: the 27-point stencil (26 on the
diagonal, -1 for each neighbour, HPCG's matrix) on 12^3 and 24^3 grids, the
5-point Laplacian on a 128^2 grid, and the lower triangle of a scatter
operand (m = 8192, the diagonal 4.0 plus 8 uniform random columns a row,
seed 23). The JAX package builds ``dwin`` forms for the first three (nb =
64 on the CPU) and ``gather`` for the last; the port builds its own forms
(nb = 128) of the same kinds.

The port solves with its inverted diagonal blocks (the chain kernel's
plain version on the CPU); the JAX package on the CPU substitutes. They
differ by rounding: float64 results are held to
expected_precision(float64) of utils/tolerances.py (about 2.1e-8) on
max |a - b| / max(|b|, 1); the triangles are diagonally dominant, so the
inverted blocks add no growth beyond that model. The host engine (kid 2)
is held to scipy's substitution by the same model.

The cuda-marked tests hold the chain kernel to its plain version on the
card.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import interop
from aoclsparse_tpu_torch.kernels.trsv_blocked import (
    chunk_cols,
    trsv_dwin,
    trsv_dwin_plain,
    trsv_gather,
    trsv_gather_plain,
)
from aoclsparse_tpu_torch.planner import triangular as ttri
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

# the module: the package attribute ops.level2.trsv is the function
trsv_mod = importlib.import_module("aoclsparse_tpu_torch.ops.level2.trsv")
TOL64 = expected_precision(torch.float64)
NONE, TRANS = tt.Operation.none, tt.Operation.transpose


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
    rows = np.repeat(i, valid.sum(1))
    return ptr, cols.astype(np.int32), np.where(cols == rows, 26.0, -1.0)


def laplacian_2d(nx):
    """The 5-point Laplacian on an nx^2 grid: (ptr, ind, val f64)."""
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    S = (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


def scatter_operand(m=8192, per_row=8, seed=23):
    """The diagonal (4.0) plus `per_row` uniform random columns a row with
    standard normal values: (ptr, ind, val f64)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), per_row)
    cols = rng.integers(0, m, rows.size)
    d = np.arange(m)
    S = sp.csr_matrix((np.r_[rng.standard_normal(rows.size), np.full(m, 4.0)], (np.r_[rows, d], np.r_[cols, d])),
                      shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


OPERANDS = {
    "stencil12": lambda: stencil27(12),
    "stencil24": lambda: stencil27(24),
    "laplace128": lambda: laplacian_2d(128),
    "scatter": scatter_operand,
}
_cache = {}


def _pair(ast, name):
    """(J, T, S): the JAX and port handles and the scipy matrix, cached."""
    if name not in _cache:
        ptr, ind, val = OPERANDS[name]()
        m = len(ptr) - 1
        _cache[name] = (ast.create_csr(m, m, ptr, ind, val), tt.create_csr(m, m, ptr, ind, val, device="cpu"),
                        sp.csr_matrix((val, ind, ptr), shape=(m, m)))
    return _cache[name]


def _tri(lib, fill):
    return lib.MatrixDescriptor(type=lib.MatrixType.triangular, fill_mode=lib.FillMode(int(fill)))


def _jax_form_arrays(ast, J, fill, op):
    """The JAX form's arrays: of the handle's triangle, or with op "ilu" of
    its ILU0 factor (L unit lower, U reversed)."""
    from aoclsparse_tpu.planner.plan import get_plan
    from aoclsparse_tpu.planner.triangular import trsv_form_for

    if op == "ilu":
        st = ast.ilu0_factorize(J)
        f = st.l_form if fill == tt.FillMode.lower else st.u_form
    else:
        f = trsv_form_for(get_plan(J), _tri(ast, fill), ast.Operation(int(op)))
    arrays = dict(D=np.asarray(f.D), Lval=np.asarray(f.Lval), nb=f.nb, nblk=f.nblk, m=f.m, WL=f.WL,
                  reversed_=f.reversed_, unit_diag=f.unit_diag, kind=f.kind)
    if f.kind == "dwin":
        arrays["dwin_offs"] = np.asarray(f.dwin_offs)
    if f.kind == "gather":
        arrays["Lind"] = np.asarray(f.Lind)
    return arrays


# (operand, fill, op or "ilu" for the ILU0 factor, the JAX package's kind)
CARRIED = [
    ("stencil12", tt.FillMode.lower, "ilu", "dwin"),
    ("stencil12", tt.FillMode.upper, "ilu", "dwin"),
    ("stencil24", tt.FillMode.lower, "ilu", "dwin"),
    ("stencil12", tt.FillMode.lower, NONE, "dwin"),
    ("stencil24", tt.FillMode.upper, NONE, "dwin"),
    ("stencil24", tt.FillMode.lower, TRANS, "dwin"),
    ("scatter", tt.FillMode.lower, NONE, "gather"),
]


@pytest.mark.parametrize("name,fill,op,kind", CARRIED)
def test_plain_versions_on_forms_carried_from_jax(ast, name, fill, op, kind):
    """interop.trsv_form_from_jax carries the JAX form (kind, Lind,
    dwin_offs, WL; of a triangle or an ILU0 factor) across; the plain dwin /
    gather versions, with inv=True
    (the kernel's contract) and inv=False (substitution, the JAX package's
    CPU branch), match the JAX solve on those very arrays, 1-D and K = 5."""
    from aoclsparse_tpu.kernels.xla.trsv import trsv_blocked, trsv_blocked_dwin

    J, _T, _S = _pair(ast, name)
    arrays = _jax_form_arrays(ast, J, fill, op)
    assert arrays["kind"] == kind
    form = interop.trsv_form_from_jax(arrays, device="cpu")
    assert form.kind == kind and form.m_pad == arrays["nblk"] * arrays["nb"]
    rng = np.random.default_rng(3)
    for shape in ((form.m_pad,), (form.m_pad, 5)):
        b = rng.standard_normal(shape)
        if kind == "dwin":
            want = np.asarray(trsv_blocked_dwin(arrays["D"], arrays["Lval"], b, form.nb, form.m_pad, form.WL,
                                                form.dwin_offs, False))
            got = [trsv_dwin_plain(form.D, form.Lval, torch.from_numpy(b), form.nb, form.WL, form.dwin_offs, inv=False),
                   trsv_dwin(*form.operands(), form.offsets(), torch.from_numpy(b), form.nb, form.WL)]
        else:
            want = np.asarray(trsv_blocked(arrays["D"], arrays["Lind"], arrays["Lval"], b, form.nb, form.m_pad))
            got = [trsv_gather_plain(form.D, form.Lind, form.Lval, torch.from_numpy(b), form.nb, inv=False),
                   trsv_gather(form.operands()[0], form.Lind, form.Lval, torch.from_numpy(b), form.nb)]
        for g in got:
            assert near_error(g.numpy(), want) <= TOL64
        # and through the form's own solve (the rhs in block order)
        assert near_error(form.solve(torch.from_numpy(b)).numpy(), want) <= TOL64


# (operand, fill, op, the port's kind)
SOLVES = [
    ("stencil24", tt.FillMode.lower, NONE, "dwin"),
    ("stencil24", tt.FillMode.upper, NONE, "dwin"),
    ("stencil24", tt.FillMode.upper, TRANS, "dwin"),
    ("laplace128", tt.FillMode.lower, NONE, "dwin"),
    ("scatter", tt.FillMode.lower, NONE, "gather"),
    ("scatter", tt.FillMode.upper, TRANS, "gather"),
]


@pytest.mark.parametrize("name,fill,op,kind", SOLVES)
def test_trsv_trsm_kids_match_jax_and_scipy(ast, name, fill, op, kind):
    """trsv (1-D) and trsm (K = 5, alpha = 2) through the port's own form
    (kid 0), the level engine (kid 1) and the host engine (kid 2, a CPU
    tensor) against the JAX package's default solve and scipy's
    substitution."""
    J, T, S = _pair(ast, name)
    m = S.shape[0]
    tri = (sp.tril(S) if fill == tt.FillMode.lower else sp.triu(S)).tocsr()
    if op == TRANS:
        tri = tri.T.tocsr()
    assert ttri.trsv_form_for(T.plan or tt.optimize(T), _tri(tt, fill), op).kind == kind
    rng = np.random.default_rng(11)
    b, B = rng.standard_normal(m), rng.standard_normal((m, 5))
    want = np.asarray(ast.trsv(1.0, J, _tri(ast, fill), ast.Operation(int(op)), b))
    want_m = np.asarray(ast.trsm(2.0, J, _tri(ast, fill), ast.Operation(int(op)), B))
    assert near_error(spla.spsolve_triangular(tri, b, lower=tri.nnz == sp.tril(tri).nnz), want) <= TOL64
    for kid in (None, 0, 1, 2):
        x = tt.trsv(1.0, T, _tri(tt, fill), op, torch.from_numpy(b), kid=kid)
        X = tt.trsm(2.0, T, _tri(tt, fill), op, torch.from_numpy(B), kid=kid)
        assert x.device.type == "cpu" and X.shape == (m, 5)
        assert near_error(x.numpy(), want) <= TOL64, kid
        assert near_error(X.numpy(), want_m) <= TOL64, kid


@pytest.mark.parametrize("name", ["stencil24", "laplace128"])
def test_ilu0_and_smoother_match_jax(ast, name):
    """ilu0_factorize builds dwin forms for both factors; ilu_smoother
    (1-D and K = 5; kid 0 and 1) matches the JAX package's, and kid 2 (the
    host substitution, a CPU tensor) matches scipy on the port's own
    factors."""
    J, T, S = _pair(ast, name)
    m = S.shape[0]
    st = tt.ilu0_factorize(T)
    assert (st.l_form.kind, st.u_form.kind) == ("dwin", "dwin")
    assert near_error(st.lu.numpy(), np.asarray(ast.ilu0_factorize(J).lu)) <= TOL64
    rng = np.random.default_rng(12)
    b, B = rng.standard_normal(m), rng.standard_normal((m, 5))
    want = np.asarray(ast.ilu_smoother(J, ast.MatrixDescriptor(), b))
    lu = st.lu.numpy()
    rows = np.repeat(np.arange(m), np.diff(S.indptr))
    low = S.indices < rows
    Lf = sp.csr_matrix((np.r_[lu[low], np.ones(m)], (np.r_[rows[low], np.arange(m)], np.r_[S.indices[low], np.arange(m)])),
                       shape=(m, m))
    Uf = sp.csr_matrix((lu[~low], (rows[~low], S.indices[~low])), shape=(m, m))
    oracle = spla.spsolve_triangular(Uf, spla.spsolve_triangular(Lf, b, lower=True), lower=False)
    assert near_error(oracle, want) <= TOL64
    for kid in (None, 0, 1, 2):
        x = tt.ilu_smoother(T, tt.MatrixDescriptor(), torch.from_numpy(b), kid=kid)
        assert near_error(x.numpy(), want) <= TOL64, kid
    want_m = np.stack([np.asarray(ast.ilu_smoother(J, ast.MatrixDescriptor(), B[:, j])) for j in (0, 4)], axis=1)
    for kid in (None, 1, 2):
        X = tt.ilu_smoother(T, tt.MatrixDescriptor(), torch.from_numpy(B), kid=kid)
        assert near_error(X.numpy()[:, [0, 4]], want_m) <= TOL64, kid


def test_ilu0_pcg_on_the_laplacian_matches_jax(ast):
    """ILU0-PCG on the 128^2 Laplacian over the dwin factors, b = ones and
    rtol = 1e-5: the JAX package takes 66 iterations, the port within 2 of
    them, to the same solution within the solve's tolerance."""
    J, T, S = _pair(ast, "laplace128")
    b = np.ones(S.shape[0])
    xj, kj, _ = ast.pcg_solve(J, b, rtol=1e-5, precond="ilu0")
    xt, kt, _ = tt.pcg_solve(T, torch.from_numpy(b), rtol=1e-5, precond="ilu0")
    assert kj == 66 and abs(kt - kj) <= 2
    assert np.linalg.norm(S @ xt.numpy() - b) <= 1.01e-5 * np.linalg.norm(b)
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= 1e-3 * np.linalg.norm(np.asarray(xj))


def test_pcg_ilu0_and_sgs_on_the_stencil(ast):
    """pcg_solve(precond="ilu0" | "sgs") on the 24^3 stencil over dwin
    forms, against the JAX package's iteration counts (within 2) and the
    true residual."""
    J, T, S = _pair(ast, "stencil24")
    b = np.random.default_rng(14).standard_normal(S.shape[0])
    for pre in ("ilu0", "sgs"):
        _xj, kj, _ = ast.pcg_solve(J, b, rtol=1e-6, precond=pre)
        xt, kt, _ = tt.pcg_solve(T, torch.from_numpy(b), rtol=1e-6, precond=pre)
        assert abs(kt - kj) <= 2, pre
        assert np.linalg.norm(S @ xt.numpy() - b) <= 1.01e-6 * np.linalg.norm(b)


def _deep_triangle(m=5000, seed=19):
    """A lower triangle with a full subdiagonal (a DAG m levels deep) and
    two random entries left of it a row: (ptr, ind, val f64)."""
    rng = np.random.default_rng(seed)
    i = np.arange(1, m)
    far = np.concatenate([rng.integers(0, np.maximum(i - 1, 1)) for _ in range(2)])
    rows = np.r_[np.arange(m), i, np.tile(i, 2)]
    cols = np.r_[np.arange(m), i - 1, far]
    vals = np.r_[np.full(m, 4.0), np.full(m - 1, -0.5), 0.3 * rng.standard_normal(2 * (m - 1))]
    S = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


def test_deep_refused_triangle_raises_memory_error_not_the_host_escape(ast, monkeypatch):
    """A deliberate divergence (ROADMAP.md queue 3): where the blocked form
    is refused (the padded-ELL cap lowered to 1 KB) and the DAG is deeper
    than the level engine's reach (5000 levels > 4096), the JAX package
    silently solves on its host engine; the port raises memory_error and
    names kid=2, whose CPU result equals the JAX package's. Within reach
    (the port's limit raised), the port takes the level engine."""
    monkeypatch.setenv("AOCLSPARSE_TPU_TRSV_WIN_CAP", "1e3")
    ptr, ind, val = _deep_triangle()
    m = len(ptr) - 1
    J, T = ast.create_csr(m, m, ptr, ind, val), tt.create_csr(m, m, ptr, ind, val, device="cpu")
    lo = _tri(tt, tt.FillMode.lower)
    b = np.random.default_rng(15).standard_normal(m)
    want = np.asarray(ast.trsv(1.0, J, _tri(ast, tt.FillMode.lower), ast.Operation.none, b))
    assert near_error(want, spla.spsolve_triangular(sp.csr_matrix((val, ind, ptr)), b, lower=True)) <= TOL64
    with pytest.raises(tt.AoclSparseError) as e:
        ttri.trsv_form_for(tt.optimize(T), lo, NONE)
    assert e.value.status == tt.Status.memory_error
    with pytest.raises(tt.AoclSparseError) as e:
        tt.trsv(1.0, T, lo, NONE, torch.from_numpy(b))
    assert e.value.status == tt.Status.memory_error and "kid=2" in str(e.value)
    x = tt.trsv(1.0, T, lo, NONE, torch.from_numpy(b), kid=2)
    assert x.device.type == "cpu" and near_error(x.numpy(), want) <= TOL64
    # an explicit kid=0 keeps the refusal
    with pytest.raises(tt.AoclSparseError) as e:
        tt.trsv(1.0, T, lo, NONE, torch.from_numpy(b), kid=0)
    assert e.value.status == tt.Status.memory_error
    monkeypatch.setattr(trsv_mod, "LEVEL_MAX_NLEV", 8192)
    assert near_error(tt.trsv(1.0, T, lo, NONE, torch.from_numpy(b)).numpy(), want) <= TOL64


def test_refused_ilu_factor_takes_the_level_sweeps(ast, monkeypatch):
    """Where both factor forms are refused (a scatter operand, m = 2048,
    whose window is the whole triangle, with the padded-ELL cap lowered to
    1 KB), ilu0_factorize keeps None forms and the default apply (and
    ILU0-PCG) runs the level sweeps, as in the JAX package (its factor
    and its refusal are the same; the sweeps are held to scipy's
    substitution on that factor); past 8192
    levels the port raises memory_error naming kid=2 (the JAX package takes
    its host substitution)."""
    from aoclsparse_tpu_torch.solvers import ilu as ilu_mod

    monkeypatch.setenv("AOCLSPARSE_TPU_TRSV_WIN_CAP", "1e3")
    ptr, ind, val = scatter_operand(2048, per_row=3, seed=29)
    m = len(ptr) - 1
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    J = ast.create_csr(m, m, ptr, ind, val)
    st = tt.ilu0_factorize(T)
    assert st.l_form is None and st.u_form is None
    jst = ast.ilu0_factorize(J)
    assert jst.l_form is None and near_error(st.lu.numpy(), np.asarray(jst.lu)) <= TOL64
    b = np.random.default_rng(16).standard_normal(m)
    S = sp.csr_matrix((st.lu.numpy(), ind, ptr), shape=(m, m))
    want = spla.spsolve_triangular(sp.triu(S).tocsr(), spla.spsolve_triangular(
        (sp.tril(S, -1) + sp.eye(m)).tocsr(), b, lower=True), lower=False)
    assert near_error(tt.ilu_smoother(T, tt.MatrixDescriptor(), torch.from_numpy(b)).numpy(), want) <= TOL64
    z = ilu_mod.ilu_apply(st, torch.from_numpy(b))
    assert near_error(z.numpy(), want) <= TOL64
    monkeypatch.setattr(ilu_mod, "LEVEL_MAX_NLEV", 8)
    with pytest.raises(tt.AoclSparseError) as e:
        tt.ilu_smoother(T, tt.MatrixDescriptor(), torch.from_numpy(b))
    assert e.value.status == tt.Status.memory_error and "kid=2" in str(e.value)
    assert near_error(tt.ilu_smoother(T, tt.MatrixDescriptor(), torch.from_numpy(b), kid=2).numpy(), want) <= TOL64


def test_chunk_cols_and_wrapper_checks():
    """The kernel's column chunks, and the wrappers' operand checks."""
    assert [chunk_cols(k) for k in (1, 2, 3, 4, 16)] == [1, 2, 2, 4, 4]
    dinvT = torch.eye(8, dtype=torch.float64).expand(2, 8, 8).contiguous()
    Dv = torch.zeros(2, 1, 8, dtype=torch.float64)
    offs = torch.tensor([3], dtype=torch.int32)
    b = torch.ones(16, dtype=torch.float64)
    assert torch.equal(trsv_dwin(dinvT, Dv, offs, b, 8, 8), b)
    for bad, status in (
        (lambda: trsv_dwin(dinvT.float(), Dv, offs, b, 8, 8), tt.Status.wrong_type),
        (lambda: trsv_dwin(dinvT, Dv, offs.long(), b, 8, 8), tt.Status.wrong_type),
        (lambda: trsv_dwin(dinvT, Dv, offs, b[:8], 8, 8), tt.Status.invalid_size),
        (lambda: trsv_gather(dinvT, torch.zeros(2, 8, 3, dtype=torch.int32), torch.zeros(2, 8, 2, dtype=torch.float64),
                             b, 8), tt.Status.invalid_size),
    ):
        with pytest.raises(tt.AoclSparseError) as e:
            bad()
        assert e.value.status == status


def _card_forms(dev, dtype):
    """Small dwin and gather forms on the card: the 10^3 and 12^3 stencils'
    triangles at nb = 32 (dwin), the scatter operand's at nb = 64 and 200
    (gather, the last block ragged: m = 3001)."""
    out = []
    for nx in (10, 12):
        ptr, ind, val = stencil27(nx)
        m = len(ptr) - 1
        A = tt.create_csr(m, m, ptr, ind, val.astype(dtype), device=dev)
        for fill in (tt.FillMode.lower, tt.FillMode.upper):
            out.append(ttri.trsv_form_for(tt.optimize(A), _tri(tt, fill), NONE, nb=32))
    ptr, ind, val = scatter_operand(3001)
    A = tt.create_csr(3001, 3001, ptr, ind, val.astype(dtype), device=dev)
    for nb in (64, 200):
        out.append(ttri.trsv_form_for(tt.optimize(A), _tri(tt, tt.FillMode.lower), NONE, nb=nb))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_kernel_matches_plain(cuda, dtype):
    """The chain kernel against its plain version on small dwin and gather
    forms, K in {1, 3, 16}, within the dtype's model tolerance (the same
    products summed in another order), and the same bits on a second call."""
    from aoclsparse_tpu_torch.kernels import trsv_blocked as tb

    for form in _card_forms(cuda, dtype):
        assert form.kind in ("dwin", "gather")
        dinvT, left = form.operands()
        for K in (1, 3, 16):
            B = torch.from_numpy(np.random.default_rng(K).standard_normal((form.m_pad, K))).to(cuda, dinvT.dtype)
            b = B[:, 0].contiguous() if K == 1 else B
            counter = tb.trsv_dwin.launches if form.kind == "dwin" else tb.trsv_gather.launches
            name = "f32" if dtype == np.float32 else "f64"
            c0 = counter[name]
            if form.kind == "dwin":
                got = trsv_dwin(dinvT, left, form.offsets(), b, form.nb, form.WL)
                again = trsv_dwin(dinvT, left, form.offsets(), b, form.nb, form.WL)
                want = trsv_dwin_plain(dinvT.transpose(1, 2), left, b, form.nb, form.WL, form.dwin_offs)
            else:
                got = trsv_gather(dinvT, form.Lind, left, b, form.nb)
                again = trsv_gather(dinvT, form.Lind, left, b, form.nb)
                want = trsv_gather_plain(dinvT.transpose(1, 2), form.Lind, left, b, form.nb)
            torch.cuda.synchronize()
            assert counter[name] - c0 == 2
            assert torch.equal(got, again)
            assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= expected_precision(dinvT.dtype)


@pytest.mark.cuda
def test_cuda_trsv_and_pcg_on_the_stencil(cuda):
    """trsv (the default and kids 0, 1, 2) and ILU0-/SGS-PCG on the 24^3
    stencil on the card: kid=0 through the chain kernel, the default and
    kid=1 through the level kernel (the gate picks it: 162 levels against
    216 chain blocks)."""
    from aoclsparse_tpu_torch.kernels import trsv_blocked as tb
    from aoclsparse_tpu_torch.kernels.trsv_level import trsv_level

    ptr, ind, val = stencil27(24)
    m = len(ptr) - 1
    S = sp.csr_matrix((val, ind, ptr), shape=(m, m))
    A = tt.create_csr(m, m, ptr, ind, val, device=cuda)
    b = np.random.default_rng(17).standard_normal(m)
    bd = torch.from_numpy(b).to(cuda)
    lo = _tri(tt, tt.FillMode.lower)
    c0, l0 = tb.trsv_dwin.launches["f64"], trsv_level.launches["f64"]
    want = spla.spsolve_triangular(sp.tril(S).tocsr(), b, lower=True)
    for kid in (None, 0, 1, 2):
        assert near_error(tt.trsv(1.0, A, lo, NONE, bd, kid=kid).cpu().numpy(), want) <= TOL64
    assert tb.trsv_dwin.launches["f64"] - c0 == 1 and trsv_level.launches["f64"] - l0 == 2
    for pre in ("ilu0", "sgs"):
        x, _k, _r = tt.pcg_solve(A, bd, rtol=1e-8, precond=pre)
        assert np.linalg.norm(S @ x.cpu().numpy() - b) <= 1.01e-8 * np.linalg.norm(b)


@pytest.mark.cuda
def test_cuda_nonfinite_rhs_divergence(cuda):
    """A deliberate divergence (ROADMAP.md queue 3), as in the window
    solves: the kernel reads only dinvT's upper triangle, so an Inf in row
    q of a block's right-hand side leaves the block's rows r < q as a
    triangular solve gives them (finite), where the plain version's dense
    product, like the JAX scan's, gives NaN there (0 * Inf)."""
    ptr, ind, val = stencil27(10)
    m = len(ptr) - 1
    A = tt.create_csr(m, m, ptr, ind, val.astype(np.float32), device=cuda)
    form = ttri.trsv_form_for(tt.optimize(A), _tri(tt, tt.FillMode.lower), NONE, nb=32)
    assert form.kind == "dwin"
    dinvT, left = form.operands()
    b = torch.ones(form.m_pad, dtype=torch.float32, device=cuda)
    b[5] = float("inf")
    got = trsv_dwin(dinvT, left, form.offsets(), b, form.nb, form.WL).cpu()
    want = trsv_dwin_plain(dinvT.transpose(1, 2), left, b, form.nb, form.WL, form.dwin_offs).cpu()
    assert torch.isfinite(got[:5]).all() and torch.isnan(want[:5]).all()
    ok = torch.ones(form.m_pad, dtype=torch.float32, device=cuda)
    ref = trsv_dwin(dinvT, left, form.offsets(), ok, form.nb, form.WL).cpu()
    assert torch.equal(got[:5], ref[:5])
