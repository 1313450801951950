"""Format-direct SpMV routines of the PyTorch port (csrmv, ellmv, elltmv,
ellthybmv, diamv, bsrmv, blkcsrmv) and the hint setters set_mv_hint_kid,
set_dotmv_hint and set_2m_hint, against the JAX package.

The same raw arrays (made from a seed with numpy; layouts from the JAX
package's converters) go to both packages' routines, in base 0 and 1,
float32, float64 and complex128, with their validation statuses.
Tolerance: utils/tolerances.py's expected_precision(dtype) on
max |a - b| / max(|b|, 1), both sides summing the same products in
another order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

NONE = tt.Operation.none


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


def _sparse(seed, m, n, density=0.2, dtype=np.float64):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, density=density, format="csr", random_state=rng)
    S.sort_indices()
    data = S.data.astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        data = data + 1j * rng.standard_normal(data.size)
    return sp.csr_matrix((data, S.indices, S.indptr), shape=(m, n))


def _tol(dtype):
    return expected_precision(torch.float32 if dtype in (np.float32, np.complex64) else torch.float64)


def _descrs(ast, mt=0, fill=0, diag=0, base=0):
    return (tt.MatrixDescriptor(type=tt.MatrixType(mt), fill_mode=tt.FillMode(fill), diag_type=tt.DiagType(diag),
                                base=tt.IndexBase(base)),
            ast.MatrixDescriptor(type=ast.MatrixType(mt), fill_mode=ast.FillMode(fill),
                                 diag_type=ast.DiagType(diag), base=ast.IndexBase(base)))


def _vec(seed, n, dtype):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    return v.astype(dtype)


def _both(ast, name, targs, jargs, dtype, **kw):
    got = getattr(tt, name)(*targs, **kw)
    want = np.asarray(getattr(ast, name)(*jargs, **kw))
    assert got.device.type == "cpu"
    assert near_error(got.numpy(), want) <= _tol(dtype)
    return got


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("op", [111, 112, 113])
@pytest.mark.parametrize("base", [0, 1])
def test_csrmv_general_matches_jax(ast, dtype, op, base):
    m, n = 41, 33
    S = _sparse(1, m, n, dtype=dtype)
    d, jd = _descrs(ast, base=base)
    x = _vec(2, n if op == 111 else m, dtype)
    y = _vec(3, m if op == 111 else n, dtype)
    args = (S.nnz, S.data, S.indices + base, S.indptr + base)
    _both(ast, "csrmv", (tt.Operation(op), 1.5, m, n, *args, d, torch.from_numpy(x), -0.5, torch.from_numpy(y)),
          (ast.Operation(op), 1.5, m, n, *args, jd, x, -0.5, y), dtype)


@pytest.mark.parametrize("fill", [0, 1])
@pytest.mark.parametrize("diag", [0, 1, 2])
@pytest.mark.parametrize("op", [111, 113])
def test_csrmv_symmetric_matches_jax(ast, fill, diag, op):
    S = _sparse(4, 30, 30, density=0.3, dtype=np.complex128)
    d, jd = _descrs(ast, mt=1, fill=fill, diag=diag)
    x = _vec(5, 30, np.complex128)
    args = (30, 30, S.nnz, S.data, S.indices, S.indptr)
    _both(ast, "csrmv", (tt.Operation(op), 1.0, *args, d, torch.from_numpy(x), 0.0),
          (ast.Operation(op), 1.0, *args, jd, x, 0.0), np.complex128)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("base", [0, 1])
def test_ell_dia_bsr_mv_match_jax(ast, dtype, base):
    from aoclsparse_tpu.convert.conversions import csr_to_bsr, csr_to_dia, csr_to_ell
    from aoclsparse_tpu.core.formats import CSR as JCSR

    m, n = 37, 29
    S = _sparse(6, m, n, dtype=dtype)
    A = JCSR(S.indptr, S.indices, S.data, shape=(m, n))
    d, jd = _descrs(ast, base=base)
    x, y = _vec(7, n, dtype), _vec(8, m, dtype)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    E = csr_to_ell(A)
    ind = np.where(np.asarray(E.ind) >= 0, np.asarray(E.ind) + base, -1)
    val = np.asarray(E.val)
    _both(ast, "ellmv", (NONE, 2.0, m, n, S.nnz, val, ind, E.width, d, tx, 0.5, ty),
          (ast.Operation.none, 2.0, m, n, S.nnz, val, ind, E.width, jd, x, 0.5, y), dtype)
    indT = np.where(ind.T >= 0, ind.T, base).copy()  # slot-major, padding on a valid column
    _both(ast, "elltmv", (NONE, 1.0, m, n, S.nnz, val.T.copy(), indT, E.width, d, tx, 0.0),
          (ast.Operation.none, 1.0, m, n, S.nnz, val.T.copy(), indT, E.width, jd, x, 0.0), dtype)
    D = csr_to_dia(A)
    dargs = (m, n, S.nnz, np.asarray(D.val), np.asarray(D.dist), D.ndiag)
    _both(ast, "diamv", (NONE, 1.0, *dargs, d, tx, 0.0), (ast.Operation.none, 1.0, *dargs, jd, x, 0.0), dtype)
    for bs in (3, 4):
        B = csr_to_bsr(A, bs)
        bargs = (B.mb, -(-n // bs), bs, np.asarray(B.val), np.asarray(B.ind) + base, np.asarray(B.ptr) + base)
        _both(ast, "bsrmv", (NONE, 1.0, *bargs, d, tx, 0.0), (ast.Operation.none, 1.0, *bargs, jd, x, 0.0), dtype)


@pytest.mark.parametrize("base", [0, 1])
def test_ellthybmv_matches_jax(ast, base):
    m, n = 29, 31
    S = _sparse(9, m, n, density=0.25)
    ptr, cols, val = S.indptr, S.indices, S.data
    em, ew = tt.csr2ellthyb_width(m, S.nnz, ptr)
    lens = np.diff(ptr)
    heavy = np.nonzero(lens > ew)[0].astype(np.int64)
    wv = np.zeros((ew, m))
    wi = np.zeros((ew, m), np.int64)
    for i in range(m):
        k = min(ew, lens[i])
        wv[:k, i] = val[ptr[i]:ptr[i] + k]
        wi[:k, i] = cols[ptr[i]:ptr[i] + k]
    d, jd = _descrs(ast, base=base)
    x, y0 = _vec(10, n, np.float64), _vec(11, m, np.float64)
    args = (m, n, S.nnz, wv.reshape(-1), wi.reshape(-1) + base, ew, em, val, ptr + base, cols + base, None, heavy)
    got = _both(ast, "ellthybmv", (NONE, 1.0, *args, d, torch.from_numpy(x), 3.0, torch.from_numpy(y0)),
                (ast.Operation.none, 1.0, *args, jd, x, 3.0, y0), np.float64)
    assert near_error(got.numpy(), S @ x + 3.0 * y0) <= _tol(np.float64)


@pytest.mark.parametrize("nrb", [1, 2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_blkcsrmv_matches_jax(ast, nrb, dtype):
    m, n = 22, 19  # n no multiple of 8: the edge block clamps to n - 8
    S = _sparse(12, m, n, density=0.3, dtype=dtype)
    bptr, bcol, bval, masks = ast.csr2blkcsr(m, n, S.nnz, S.indptr, S.indices, S.data, nrb)
    d, jd = _descrs(ast)
    x = _vec(13, n, dtype)
    args = (m, n, S.nnz, masks, np.asarray(bval), bcol, bptr)
    got = _both(ast, "blkcsrmv", (NONE, 1.0, *args, d, torch.from_numpy(x), 0.0),
                (ast.Operation.none, 1.0, *args, jd, x, 0.0), dtype, nRowsblk=nrb)
    assert near_error(got.numpy(), S @ x) <= _tol(dtype)


def _status(fn):
    try:
        fn()
    except Exception as e:  # both packages' AoclSparseError carry .status
        return int(e.status)
    return None


def test_validation_statuses_match_jax(ast):
    m, n = 20, 18
    S = _sparse(14, m, n)
    x = np.ones(n)
    d, jd = _descrs(ast)
    dsym, jdsym = _descrs(ast, mt=1)
    dtri, jdtri = _descrs(ast, mt=3)
    dlow, jdlow = _descrs(ast, mt=3, fill=0)
    E = np.full((m, 3), -1)
    Ev = np.zeros((m, 3))
    csr = (S.nnz, S.data, S.indices, S.indptr)

    def pair(name, targs, jargs, **kw):
        return (lambda: getattr(tt, name)(*targs, **kw), lambda: getattr(ast, name)(*jargs, **kw))

    t = torch.from_numpy
    cases = [
        pair("csrmv", (NONE, 1.0, m, n + 1, *csr, dsym, t(np.ones(n + 1)), 0.0),
             (ast.Operation.none, 1.0, m, n + 1, *csr, jdsym, np.ones(n + 1), 0.0)),
        pair("csrmv", (NONE, 1.0, m, n, *csr, dtri, t(x), 0.0), (ast.Operation.none, 1.0, m, n, *csr, jdtri, x, 0.0)),
        pair("csrmv", (NONE, 1.0, m, n, S.nnz, None, S.indices, S.indptr, d, t(x), 0.0),
             (ast.Operation.none, 1.0, m, n, S.nnz, None, S.indices, S.indptr, jd, x, 0.0)),
        pair("csrmv", (NONE, 1.0, m, n, S.nnz, S.data, S.indices, S.indptr[:-1], d, t(x), 0.0),
             (ast.Operation.none, 1.0, m, n, S.nnz, S.data, S.indices, S.indptr[:-1], jd, x, 0.0)),
        pair("csrmv", (NONE, 1.0, m, n, *csr, d, t(np.ones(n - 2)), 0.0),
             (ast.Operation.none, 1.0, m, n, *csr, jd, np.ones(n - 2), 0.0)),
        pair("csrmv", (NONE, 1.0, m, n, -1, S.data, S.indices, S.indptr, d, t(x), 0.0),
             (ast.Operation.none, 1.0, m, n, -1, S.data, S.indices, S.indptr, jd, x, 0.0)),
        pair("csrmv", (NONE, 1.0, m, n, *csr, d, None, 0.0), (ast.Operation.none, 1.0, m, n, *csr, jd, None, 0.0)),
        pair("ellmv", (tt.Operation.transpose, 1.0, m, n, 0, Ev, E, 3, d, t(x), 0.0),
             (ast.Operation.transpose, 1.0, m, n, 0, Ev, E, 3, jd, x, 0.0)),
        pair("ellmv", (NONE, 1.0, m, n, 0, Ev, E, 3, dlow, t(x), 0.0),
             (ast.Operation.none, 1.0, m, n, 0, Ev, E, 3, jdlow, x, 0.0)),
        pair("ellmv", (NONE, 1.0, m, n, 0, None, E, 3, d, t(x), 0.0),
             (ast.Operation.none, 1.0, m, n, 0, None, E, 3, jd, x, 0.0)),
        pair("diamv", (NONE, 1.0, m, n, 0, np.zeros((2, m)), np.array([0, 1]), 3, d, t(x), 0.0),
             (ast.Operation.none, 1.0, m, n, 0, np.zeros((2, m)), np.array([0, 1]), 3, jd, x, 0.0)),
        pair("bsrmv", (NONE, 1.0, 2, 2, 0, np.zeros(0), np.zeros(0), np.zeros(3), d, t(x), 0.0),
             (ast.Operation.none, 1.0, 2, 2, 0, np.zeros(0), np.zeros(0), np.zeros(3), jd, x, 0.0)),
        pair("bsrmv", (NONE, 1.0, 2, 2, 2, np.zeros(0), np.zeros(0), np.zeros(2), d, t(x[:4]), 0.0),
             (ast.Operation.none, 1.0, 2, 2, 2, np.zeros(0), np.zeros(0), np.zeros(2), jd, x[:4], 0.0)),
        pair("blkcsrmv", (NONE, 1.0, m, n, 0, np.zeros(3, np.uint8), np.zeros(0), np.zeros(1), np.array([0, 1]),
                          d, t(x), 0.0),
             (ast.Operation.none, 1.0, m, n, 0, np.zeros(3, np.uint8), np.zeros(0), np.zeros(1), np.array([0, 1]),
              jd, x, 0.0), nRowsblk=2),
        pair("blkcsrmv", (NONE, 1.0, m, n, 0, np.zeros(3, np.uint8), np.zeros(0), np.zeros(1), np.array([0, 1]),
                          d, t(x), 0.0),
             (ast.Operation.none, 1.0, m, n, 0, np.zeros(3, np.uint8), np.zeros(0), np.zeros(1), np.array([0, 1]),
              jd, x, 0.0), nRowsblk=3),
    ]
    for tfn, jfn in cases:
        st, sj = _status(tfn), _status(jfn)
        assert st == sj and sj is not None, (st, sj)


def test_hint_setters_match_jax(ast):
    S = _sparse(15, 40, 40, density=0.1)
    J = ast.create_csr(40, 40, S.indptr, S.indices, S.data)
    T = tt.create_csr(40, 40, S.indptr, S.indices, S.data, device="cpu")
    d, jd = _descrs(ast)
    d1, jd1 = _descrs(ast, base=1)
    tt.set_mv_hint_kid(T, NONE, d, 1000, 5)
    tt.set_dotmv_hint(T, NONE, d, nop=10)
    tt.set_2m_hint(T, NONE, d, nop=3)
    assert [(h.action, h.kid, h.nop) for h in T.hints] == [("2m", None, 3), ("dotmv", None, 10), ("mv", 5, 1000)]
    plan = tt.optimize(T)
    assert all(h.done for h in T.hints)
    # the hint's kid is stored, not acted on: the default form is planned
    assert [k[-1] for k in plan.exec_forms] == [None]
    x = np.random.default_rng(16).standard_normal(40)
    want = np.asarray(ast.mv(1.0, J, jd, ast.Operation.none, x, 0.0, kid=5))
    got = tt.mv(1.0, T, d, NONE, torch.from_numpy(x), 0.0, kid=5)
    assert near_error(got.numpy(), want) <= _tol(np.float64)
    for name, args, kw in (("set_mv_hint_kid", (NONE, d1, 10, 5), {}), ("set_dotmv_hint", (NONE, d), {"nop": -1}),
                           ("set_2m_hint", (NONE, d), {"nop": 0}), ("set_mv_hint_kid", (NONE, d, 0, 5), {})):
        jargs = tuple(jd1 if a is d1 else jd if a is d else ast.Operation.none if a is NONE else a for a in args)
        st = _status(lambda: getattr(tt, name)(T, *args, **kw))
        sj = _status(lambda: getattr(ast, name)(J, *jargs, **kw))
        assert st == sj, (name, st, sj)
    assert _status(lambda: tt.set_2m_hint(None, NONE, d)) == _status(lambda: ast.set_2m_hint(None, ast.Operation.none, jd))
