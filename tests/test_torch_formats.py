"""Storage formats of the PyTorch port against the JAX package: every
create_* / export_* / convert_* entry point, copy, order_mat, set_value,
update_values, TCSR, the auxiliary introspection, and mv on the native
ELL, DIA and BSR handles (KIDs 1, 4, 3) and on the CSR forms a KID pins
(6, the diag form; 10, sliced ELL; 11, the host engine), in base 0 and 1,
float64 and complex128.

Operands are made from a seed with numpy and fed to both packages.
Structure (pointers, indices) must be equal; values are moved, never
summed, so they must be equal too, except where a product is computed:
there utils/tolerances.py's expected_precision(dtype) on
max |a - b| / max(|b|, 1) holds, both sides summing the same products in
another order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import interop
from aoclsparse_tpu_torch.core.formats import BSR, DIA, ELL, nnz_of
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
CPU = "cpu"


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


def _sparse(seed, m, n, density=0.15, dtype=np.float64):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, density=density, format="csr", random_state=rng, dtype=np.float64)
    S.sort_indices()
    data = S.data.astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        data = data + 1j * rng.standard_normal(data.size)
    return sp.csr_matrix((data, S.indices, S.indptr), shape=(m, n))


def _tol(dtype):
    return expected_precision(torch.float32 if dtype in (np.float32, np.complex64) else torch.float64)


def _assert_export_equal(got, want):
    """Two export tuples (m, n, nnz, p, i, v): equal structure and values."""
    assert tuple(got[:3]) == tuple(int(v) for v in want[:3])
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _jdescr(ast, base):
    return ast.MatrixDescriptor(base=ast.IndexBase(int(base)))


BASES = [tt.IndexBase.zero, tt.IndexBase.one]
DTYPES = [np.float64, np.complex128]


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_create_coo_and_exports_match_jax(ast, base, dtype):
    S = _sparse(1, 40, 33, dtype=dtype).tocoo()
    rng = np.random.default_rng(2)
    order = rng.permutation(S.nnz)  # unsorted COO input
    b = int(base)
    r, c, v = S.row[order] + b, S.col[order] + b, S.data[order]
    J = ast.create_coo(40, 33, r, c, v, base=ast.IndexBase(b))
    T = tt.create_coo(40, 33, r, c, v, base=base, device=CPU)
    assert T.input_format == tt.FormatType.coo and T.nnz == J.nnz
    for exp in ("export_csr", "export_csc", "export_coo"):
        _assert_export_equal(getattr(tt, exp)(T), getattr(ast, exp)(J))
    x = rng.standard_normal(33).astype(dtype)
    want = np.asarray(ast.mv(1.0, J, _jdescr(ast, b), ast.Operation.none, x, 0.0))
    got = tt.mv(1.0, T, tt.MatrixDescriptor(base=base), NONE, torch.from_numpy(x), 0.0)
    assert near_error(got.numpy(), want) <= _tol(dtype)


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_create_csc_matches_jax(ast, base, dtype):
    S = _sparse(3, 30, 41, dtype=dtype).tocsc()
    S.sort_indices()
    b = int(base)
    J = ast.create_csc(30, 41, S.indptr + b, S.indices + b, S.data, base=ast.IndexBase(b))
    T = tt.create_csc(30, 41, S.indptr + b, S.indices + b, S.data, base=base, device=CPU)
    for exp in ("export_csr", "export_csc", "export_coo"):
        _assert_export_equal(getattr(tt, exp)(T), getattr(ast, exp)(J))
    for exp in ("export_csr", "export_csc"):  # the other base asked for
        _assert_export_equal(getattr(tt, exp)(T, base=tt.IndexBase(1 - b)),
                             getattr(ast, exp)(J, base=ast.IndexBase(1 - b)))


@pytest.mark.parametrize("base", BASES)
def test_create_bsr_ell_dia_match_jax(ast, base):
    rng = np.random.default_rng(4)
    b = int(base)
    # BSR: 5 x 4 block grid of 3 x 3 blocks
    S = _sparse(5, 5, 4, density=0.5)
    nnzb = S.nnz
    bval = rng.standard_normal((nnzb, 3, 3))
    J = ast.create_bsr(5, 4, 3, S.indptr + b, S.indices + b, bval, base=ast.IndexBase(b))
    T = tt.create_bsr(5, 4, 3, S.indptr + b, S.indices + b, bval, base=base, device=CPU)
    assert T.shape == (15, 12) and T.nnz == J.nnz == nnzb * 9
    _assert_export_equal(tt.export_csr(T), ast.export_csr(J))
    # ELL (m, width), -1 padding
    m, w = 20, 4
    ind = np.full((m, w), -1)
    val = np.zeros((m, w))
    for i in range(m):
        k = rng.integers(0, w + 1)
        ind[i, :k] = np.sort(rng.choice(17, k, replace=False))
        val[i, :k] = rng.standard_normal(k)
    indb = np.where(ind >= 0, ind + b, -1)
    J = ast.create_ell(m, 17, w, indb, val, base=ast.IndexBase(b))
    T = tt.create_ell(m, 17, w, indb, val, base=base, device=CPU)
    assert T.nnz == J.nnz
    _assert_export_equal(tt.export_csr(T), ast.export_csr(J))
    # DIA (ndiag, m), the offsets carry no base
    dist = np.array([-3, 0, 2])
    dval = rng.standard_normal((3, 12)) * (rng.random((3, 12)) < 0.7)
    J = ast.create_dia(12, 14, dist, dval, base=ast.IndexBase(b))
    T = tt.create_dia(12, 14, dist, dval, base=base, device=CPU)
    assert T.nnz == J.nnz
    _assert_export_equal(tt.export_csr(T), ast.export_csr(J))
    _assert_export_equal(tt.export_coo(T), ast.export_coo(J))


def _split_tcsr(dense):
    """TCSR arrays of a dense matrix with a full diagonal: L = strictly
    lower then the diagonal, U = the diagonal then strictly upper."""
    m = dense.shape[0]
    pL, iL, vL, pU, iU, vU = [0], [], [], [0], [], []
    for i in range(m):
        low = list(np.nonzero(dense[i, :i])[0])
        up = list(i + 1 + np.nonzero(dense[i, i + 1:])[0])
        iL += low + [i]
        vL += [dense[i, j] for j in low] + [dense[i, i]]
        pL.append(len(iL))
        iU += [i] + up
        vU += [dense[i, i]] + [dense[i, j] for j in up]
        pU.append(len(iU))
    return (len(iL) + len(iU) - m, np.array(pL), np.array(pU), np.array(iL), np.array(iU), np.array(vL),
            np.array(vU))


@pytest.fixture
def tri_dense():
    rng = np.random.default_rng(6)
    d = rng.standard_normal((24, 24))
    d[np.abs(d) < 0.8] = 0
    np.fill_diagonal(d, 3.0 + rng.random(24))
    return d


@pytest.mark.parametrize("base", BASES)
def test_create_tcsr_matches_jax(ast, tri_dense, base):
    nnz, pL, pU, iL, iU, vL, vU = _split_tcsr(tri_dense)
    b = int(base)
    args = (24, 24, nnz, pL + b, pU + b, iL + b, iU + b, vL, vU)
    J = ast.create_tcsr(*args, base=ast.IndexBase(b))
    T = tt.create_tcsr(*args, base=base, device=CPU)
    assert T.nnz == J.nnz == nnz and T.fulldiag
    _assert_export_equal(tt.export_csr(T), ast.export_csr(J))
    x = np.random.default_rng(7).standard_normal(24)
    want = np.asarray(ast.mv(1.0, J, _jdescr(ast, b), ast.Operation.none, x, 0.0))
    got = tt.mv(1.0, T, tt.MatrixDescriptor(base=base), NONE, torch.from_numpy(x), 0.0)
    assert near_error(got.numpy(), want) <= _tol(np.float64)
    with pytest.raises(tt.AoclSparseError) as e:
        tt.update_values(T, np.zeros(nnz))
    assert e.value.status == tt.Status.not_implemented


def _status(fn):
    try:
        fn()
    except Exception as e:  # both packages' AoclSparseError carry .status
        return int(e.status)
    return None


def test_create_error_statuses_match_jax(ast, tri_dense):
    nnz, pL, pU, iL, iU, vL, vU = _split_tcsr(tri_dense)
    iL_bad, iU_bad = iL.copy(), iU.copy()
    iL_bad[0] = 23
    iU_bad[-1] = 27
    row = int(np.argmax(np.diff(pL) >= 2))
    iL_sw, vL_sw = iL.copy(), vL.copy()
    a, b = pL[row + 1] - 1, pL[row + 1] - 2
    iL_sw[[a, b]], vL_sw[[a, b]] = iL_sw[[b, a]], vL_sw[[b, a]]
    r, c, v = np.array([0, 1, 2]), np.array([0, 1, 2]), np.ones(3)
    cases = [
        ("tcsr", (24, 25, nnz, pL, pU, iL, iU, vL, vU)),  # not square
        ("tcsr", (24, 24, nnz + 1, pL, pU, iL, iU, vL, vU)),  # nnz
        ("tcsr", (24, 24, nnz, pL, pU, iL_bad, iU, vL, vU)),  # upper entry in L
        ("tcsr", (24, 24, nnz, pL, pU, iL, iU_bad, vL, vU)),  # out of range
        ("tcsr", (24, 24, nnz, pL, pU, iL_sw, iU, vL_sw, vU)),  # diagonal not last in L
        ("tcsr", (24, 24, nnz, None, pU, iL, iU, vL, vU)),  # null
        ("coo", (3, 3, r, np.array([0, 1, 3]), v)),  # column out of range
        ("coo", (3, 3, np.array([-1, 1, 2]), c, v)),  # row below base
        ("coo", (3, 3, r, c, np.ones(2))),  # length mismatch
        ("coo", (-1, 3, r, c, v)),  # negative size
        ("bsr", (2, 2, 0, np.array([0, 1, 1]), np.array([0]), np.ones(1))),  # block_dim 0
        ("bsr", (2, 2, 2, np.array([0, 1, 1]), np.array([0]), np.ones(3))),  # block values
        ("csc", (3, 3, np.array([0, 1, 2, 3]), np.array([0, 1, 5]), v)),  # row out of range
        ("csc", (3, 3, np.array([1, 1, 2, 3]), c, v)),  # ptr[0] != base
        ("csr", (3, 3, np.array([0, 1, 2]), c, v)),  # ptr length
    ]
    for kind, args in cases:
        sj = _status(lambda: getattr(ast, f"create_{kind}")(*args))
        st = _status(lambda: getattr(tt, f"create_{kind}")(*args, device=CPU))
        assert sj is not None and st == sj, (kind, st, sj)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "bsr", "ell", "dia"])
@pytest.mark.parametrize("op", [tt.Operation.none, tt.Operation.transpose, tt.Operation.conjugate_transpose])
def test_convert_format_matches_jax(ast, fmt, op):
    S = _sparse(8, 26, 21, dtype=np.complex128)
    J = ast.create_csr(26, 21, S.indptr, S.indices, S.data)
    T = tt.create_csr(26, 21, S.indptr, S.indices, S.data, device=CPU)
    kw = {"block_dim": 4} if fmt == "bsr" else {}
    JF = ast.convert_format(J, ast.FormatType[fmt], ast.Operation(int(op)), **kw)
    TF = tt.convert_format(T, tt.FormatType[fmt], op, **kw)
    assert TF.input_format == tt.FormatType[fmt] and TF.shape == JF.shape and TF.device.type == "cpu"
    _assert_export_equal(tt.export_csr(TF), ast.export_csr(JF))
    fields = {"bsr": ("ptr", "ind", "val"), "dia": ("dist", "val"), "ell": ("ind", "val")}.get(fmt, ())
    for key in fields:
        np.testing.assert_array_equal(getattr(TF.data, key).numpy(), np.asarray(getattr(JF.data, key)))


def test_convert_csr_bsr_and_bad_formats_match_jax(ast):
    S = _sparse(9, 19, 23)
    J = ast.create_csr(19, 23, S.indptr, S.indices, S.data)
    T = tt.create_csr(19, 23, S.indptr, S.indices, S.data, device=CPU)
    _assert_export_equal(tt.export_csr(tt.convert_csr(T, tt.Operation.transpose)),
                         ast.export_csr(ast.convert_csr(J, ast.Operation.transpose)))
    TB, JB = tt.convert_bsr(T, 3), ast.convert_bsr(J, 3)
    assert TB.data.nnzb == JB.data.nnzb and TB.shape == JB.shape
    for fn_t, fn_j in (
        (lambda: tt.convert_bsr(T, 0), lambda: ast.convert_bsr(J, 0)),
        (lambda: tt.convert_format(T, 99), lambda: ast.convert_format(J, 99)),
        (lambda: tt.convert_format(T, tt.FormatType.tcsr), lambda: ast.convert_format(J, ast.FormatType.tcsr)),
        (lambda: tt.convert_csr(None), lambda: ast.convert_csr(None)),
    ):
        assert _status(fn_t) == _status(fn_j) is not None


def test_copy_order_mat_set_value_match_jax(ast):
    rng = np.random.default_rng(10)
    S = _sparse(11, 30, 30)
    perm = np.concatenate([rng.permutation(np.arange(S.indptr[i], S.indptr[i + 1])) for i in range(30)])
    ind, val = S.indices[perm], S.data[perm]  # columns unsorted within rows
    J = ast.create_csr(30, 30, S.indptr, ind, val)
    T = tt.create_csr(30, 30, S.indptr, ind, val, device=CPU)
    assert T.sort == tt.MatrixSort.unsorted
    Tc, Jc = tt.copy(T), ast.copy(J)
    tt.order_mat(T)
    ast.order_mat(J)
    assert T.sort == tt.MatrixSort.fully_sorted
    _assert_export_equal(tt.export_csr(T), ast.export_csr(J))
    _assert_export_equal(tt.export_csr(Tc), ast.export_csr(Jc))  # the copy kept its order
    x = rng.standard_normal(30)
    tt.mv(1.0, T, GEN, NONE, torch.from_numpy(x), 0.0)  # plan it before the point update
    r, c = 5, int(S.indices[S.indptr[5]])
    tt.set_value(T, r, c, 42.0)
    ast.set_value(J, r, c, 42.0)
    _assert_export_equal(tt.export_csr(T), ast.export_csr(J))
    want = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0))
    assert near_error(tt.mv(1.0, T, GEN, NONE, torch.from_numpy(x), 0.0).numpy(), want) <= _tol(np.float64)
    _assert_export_equal(tt.export_csr(Tc), ast.export_csr(Jc))  # copies are independent
    assert _status(lambda: tt.set_value(T, 0, 29 if 29 not in S.indices[:S.indptr[1]] else 28, 1.0)) == \
        int(tt.Status.invalid_index_value)
    C = tt.create_coo(3, 3, [0, 1], [1, 2], [1.0, 2.0], device=CPU)
    Cj = ast.create_coo(3, 3, [0, 1], [1, 2], [1.0, 2.0])
    assert _status(lambda: tt.order_mat(C)) == _status(lambda: ast.order_mat(Cj)) == int(tt.Status.not_implemented)
    for name in ("copy", "order_mat", "export_csr", "export_coo", "export_csc", "update_values"):
        args = (None,) if name not in ("update_values",) else (None, np.ones(2))
        assert _status(lambda: getattr(tt, name)(*args)) == _status(lambda: getattr(ast, name)(*args))


@pytest.mark.parametrize("fmt", ["coo", "csc", "ell", "bsr"])
def test_update_values_on_a_planned_handle_matches_jax(ast, fmt):
    """update_values on a non-CSR handle whose plan exists (a transposed mv
    plans it through CSR): the plan takes the new values in its CSR order."""
    S = _sparse(12, 24, 24)
    J = ast.convert_format(ast.create_csr(24, 24, S.indptr, S.indices, S.data), ast.FormatType[fmt],
                           **({"block_dim": 4} if fmt == "bsr" else {}))
    T = tt.convert_format(tt.create_csr(24, 24, S.indptr, S.indices, S.data, device=CPU), tt.FormatType[fmt],
                          **({"block_dim": 4} if fmt == "bsr" else {}))
    x = np.random.default_rng(13).standard_normal(24)
    TR = tt.Operation.transpose
    tt.mv(1.0, T, GEN, TR, torch.from_numpy(x), 0.0)
    assert T.plan is not None
    nv = np.random.default_rng(14).standard_normal(T.data.val.numel())
    ast.update_values(J, nv)
    tt.update_values(T, nv)
    want = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.transpose, x, 0.0))
    assert near_error(tt.mv(1.0, T, GEN, TR, torch.from_numpy(x), 0.0).numpy(), want) <= _tol(np.float64)
    want = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0))
    assert near_error(tt.mv(1.0, T, GEN, NONE, torch.from_numpy(x), 0.0).numpy(), want) <= _tol(np.float64)


def _native_pair(ast, fmt, S, **kw):
    m, n = S.shape
    J = ast.convert_format(ast.create_csr(m, n, S.indptr, S.indices, S.data), ast.FormatType[fmt], **kw)
    T = tt.convert_format(tt.create_csr(m, n, S.indptr, S.indices, S.data, device=CPU), tt.FormatType[fmt], **kw)
    return J, T


@pytest.mark.parametrize("fmt,kid,kw", [("ell", None, {}), ("ell", 1, {}), ("dia", None, {}), ("dia", 4, {}),
                                        ("bsr", None, {"block_dim": 3}), ("bsr", 3, {"block_dim": 3}),
                                        ("bsr", None, {"block_dim": 4})])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_mv_native_handles_match_jax(ast, fmt, kid, kw, dtype):
    """ELL, DIA and BSR handles run their own rows (KIDs 1, 4, 3) on the
    general, untransposed operation; 25 x 22 is no multiple of the blocks."""
    S = _sparse(15, 25, 22, density=0.2, dtype=dtype)
    J, T = _native_pair(ast, fmt, S, **kw)
    rng = np.random.default_rng(16)
    x = rng.standard_normal(22).astype(dtype)
    y = rng.standard_normal(25).astype(dtype)
    want = np.asarray(ast.mv(2.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.5, y, kid=kid))
    got = tt.mv(2.0, T, GEN, NONE, torch.from_numpy(x), 0.5, torch.from_numpy(y), kid=kid)
    assert T.plan is None  # the native row, not the planner
    assert near_error(got.numpy(), want) <= _tol(dtype)
    # the transpose plans through CSR
    xt = rng.standard_normal(25).astype(dtype)
    want = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.transpose, xt, 0.0))
    got = tt.mv(1.0, T, GEN, tt.Operation.transpose, torch.from_numpy(xt), 0.0)
    assert near_error(got.numpy(), want) <= _tol(dtype)


@pytest.mark.parametrize("fmt,kid", [("ell", 4), ("dia", 3), ("bsr", 1), ("bsr", 11), ("dia", 5)])
def test_native_handle_kid_statuses_match_jax(ast, fmt, kid):
    S = _sparse(17, 12, 12, density=0.3)
    J, T = _native_pair(ast, fmt, S, **({"block_dim": 3} if fmt == "bsr" else {}))
    x = np.ones(12)
    sj = _status(lambda: ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0, kid=kid))
    st = _status(lambda: tt.mv(1.0, T, GEN, NONE, torch.from_numpy(x), 0.0, kid=kid))
    assert st == sj == int(tt.Status.invalid_kid)


def _stencil(m, offs, seed):
    rng = np.random.default_rng(seed)
    r, c = [], []
    for o in offs:
        i = np.arange(max(0, -o), min(m, m - o))
        r.append(i)
        c.append(i + o)
    r, c = np.concatenate(r), np.concatenate(c)
    S = sp.csr_matrix((rng.standard_normal(r.size), (r, c)), shape=(m, m))
    S.sort_indices()
    return S


@pytest.mark.parametrize("kid", [6, 10, 11])
@pytest.mark.parametrize("op", [tt.Operation.none, tt.Operation.transpose])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_mv_pinned_csr_forms_match_jax(ast, kid, op, dtype):
    """KID 6 (diag form), 10 (sliced ELL) and 11 (the host engine, whose
    result is a CPU tensor) on a CSR handle, against the JAX package's."""
    S = _stencil(301, (-40, -3, 0, 1, 7, 90), 18)
    S = sp.csr_matrix((S.data.astype(dtype), S.indices, S.indptr), shape=S.shape)
    J = ast.create_csr(301, 301, S.indptr, S.indices, S.data)
    T = tt.create_csr(301, 301, S.indptr, S.indices, S.data, device=CPU)
    rng = np.random.default_rng(19)
    x = rng.standard_normal(301).astype(dtype)
    y = rng.standard_normal(301).astype(dtype)
    want = np.asarray(ast.mv(1.5, J, ast.MatrixDescriptor(), ast.Operation(int(op)), x, -2.0, y, kid=kid))
    got = tt.mv(1.5, T, GEN, op, torch.from_numpy(x), -2.0, torch.from_numpy(y), kid=kid)
    assert got.device.type == "cpu"
    assert near_error(got.numpy(), want) <= _tol(dtype)
    kind = {6: "diag", 10: "sell", 11: "host"}[kid]
    assert T.plan.exec_forms[(GEN.type, GEN.fill_mode, GEN.diag_type, op, kind)].kind == kind


def test_host_engine_quick_exits_update_and_dotmv_match_jax(ast):
    S = _sparse(20, 50, 40)
    J = ast.create_csr(50, 40, S.indptr, S.indices, S.data)
    T = tt.create_csr(50, 40, S.indptr, S.indices, S.data, device=CPU)
    JD, JN = ast.MatrixDescriptor(), ast.Operation.none
    x = np.random.default_rng(21).standard_normal(40)
    y = np.random.default_rng(22).standard_normal(50)
    for alpha, beta in ((0.0, 2.0), (1.0, 0.0), (2.0, 1.0)):
        want = np.asarray(ast.mv(alpha, J, JD, JN, x, beta, y, kid=11))
        got = tt.mv(alpha, T, GEN, NONE, torch.from_numpy(x), beta, torch.from_numpy(y), kid=11)
        assert near_error(got.numpy(), want) <= _tol(np.float64)
    nv = np.random.default_rng(23).standard_normal(S.nnz)
    ast.update_values(J, nv)
    tt.update_values(T, nv)
    want = np.asarray(ast.mv(1.0, J, JD, JN, x, 0.0, kid=11))
    assert near_error(tt.mv(1.0, T, GEN, NONE, torch.from_numpy(x), 0.0, kid=11).numpy(), want) <= _tol(np.float64)
    Q = tt.create_csr(40, 40, S[:40].indptr, S[:40].indices, S[:40].data, device=CPU)
    Qj = ast.create_csr(40, 40, S[:40].indptr, S[:40].indices, S[:40].data)
    wy, wd = ast.dotmv(1.0, Qj, JD, JN, x, 0.0, kid=11)
    gy, gd = tt.dotmv(1.0, Q, GEN, NONE, torch.from_numpy(x), 0.0, kid=11)
    assert near_error(gy.numpy(), np.asarray(wy)) <= _tol(np.float64)
    assert abs(float(gd) - float(wd)) <= _tol(np.float64) * max(1.0, abs(float(wd)))
    for args in ((np.ones(41), 0.0, None), (x, 1.0, np.ones(49))):
        sj = _status(lambda: ast.mv(1.0, J, JD, JN, args[0], args[1], args[2], kid=11))
        st = _status(lambda: tt.mv(1.0, T, GEN, NONE, torch.from_numpy(args[0]), args[1],
                                   None if args[2] is None else torch.from_numpy(args[2]), kid=11))
        assert st == sj == int(tt.Status.invalid_size)


def test_nnz_of_interop_and_aux(ast):
    S = _sparse(24, 18, 18, density=0.3)
    for fmt, kw in (("bsr", {"block_dim": 4}), ("dia", {}), ("ell", {})):
        J = ast.convert_format(ast.create_csr(18, 18, S.indptr, S.indices, S.data), ast.FormatType[fmt], **kw)
        fields = {"bsr": ("ptr", "ind", "val", "block_dim"), "dia": ("dist", "val"), "ell": ("ind", "val", "width")}
        arrays = {k: np.asarray(getattr(J.data, k)) for k in fields[fmt]}
        arrays["shape"] = J.shape
        T = interop.matrix_from_jax_format(fmt, arrays, device=CPU)
        assert nnz_of(T.data) == J.nnz
        assert isinstance(T.data, {"bsr": BSR, "dia": DIA, "ell": ELL}[fmt])
        _assert_export_equal(tt.export_csr(T), ast.export_csr(J))
    J = ast.create_csr(18, 18, S.indptr, S.indices, S.data)
    _m, _n, _z, r, c, v = ast.export_coo(J)
    _assert_export_equal(tt.export_csr(interop.coo_from_jax_arrays(18, 18, r, c, v, device=CPU)), ast.export_csr(J))
    _m, _n, _z, p, i, v = ast.export_csc(J)
    _assert_export_equal(tt.export_csr(interop.csc_from_jax_arrays(18, 18, p, i, v, device=CPU)), ast.export_csr(J))
    info = tt.debug_get()
    assert info["version"] == tt.get_version() and info["platform"] in ("cpu", "cuda")
    assert tt.is_tpu_build() is False
    assert _status(lambda: tt.enable_instructions("avx9")) == _status(lambda: ast.enable_instructions("avx9"))


def test_enable_instructions_generic_takes_the_gather_forms():
    S = _stencil(400, (-2, -1, 0, 1, 2), 25)
    try:
        tt.enable_instructions("generic")
        T = tt.create_csr(400, 400, S.indptr, S.indices, S.data, device=CPU)
        assert tt.optimize(T).exec_form_for(GEN, NONE).kind == "ell"
    finally:
        tt.enable_instructions(None)
    T = tt.create_csr(400, 400, S.indptr, S.indices, S.data, device=CPU)
    assert tt.optimize(T).exec_form_for(GEN, NONE).kind == "bandt"
