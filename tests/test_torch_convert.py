"""Conversions of the PyTorch port (convert/conversions.py) against the JAX
package's module of that name: the format transforms on format objects and
the sizing queries of the reference's two-phase API, in float64 and
complex128, on operands made from a seed with numpy.

Conversions move values and never sum them, except coo_to_csr's duplicate
merge and csr_to_dense's accumulation: those are held at
utils/tolerances.py's expected_precision(float64); everything else must be
equal.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from aoclsparse_tpu_torch import AoclSparseError, Operation, Status
from aoclsparse_tpu_torch.convert import conversions as tc
from aoclsparse_tpu_torch.core.formats import COO, CSR, TCSR
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

TOL = expected_precision(torch.float64)


@pytest.fixture(scope="module")
def jc():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.convert import conversions
    from aoclsparse_tpu.core import formats

    return conversions, formats


def _sparse(seed, m, n, density=0.2, dtype=np.float64):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, density=density, format="csr", random_state=rng)
    S.sort_indices()
    data = S.data.astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        data = data + 1j * rng.standard_normal(data.size)
    return sp.csr_matrix((data, S.indices, S.indptr), shape=(m, n))


def _pair(jc, S):
    _cv, jf = jc
    m, n = S.shape
    T = CSR(torch.from_numpy(S.indptr.astype(np.int32)), torch.from_numpy(S.indices.astype(np.int32)),
            torch.from_numpy(S.data), shape=(m, n))
    return jf.CSR(S.indptr.astype(np.int32), S.indices.astype(np.int32), S.data, shape=(m, n)), T


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t), np.asarray(j))


def _eq_csr(T, J):
    assert tuple(T.shape) == tuple(J.shape)
    for k in ("ptr", "ind", "val"):
        _eq(getattr(T, k), getattr(J, k))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("op", [Operation.none, Operation.transpose, Operation.conjugate_transpose])
def test_transpose_and_operation_match_jax(jc, dtype, op):
    cv, _jf = jc
    J, T = _pair(jc, _sparse(1, 31, 27, dtype=dtype))
    import aoclsparse_tpu

    _eq_csr(tc.csr_apply_operation(T, op), cv.csr_apply_operation(J, aoclsparse_tpu.Operation(int(op))))
    _eq_csr(tc.csr_transpose(T, conj=True), cv.csr_transpose(J, conj=True))


def test_sort_and_coo_with_duplicates_match_jax(jc):
    cv, jf = jc
    rng = np.random.default_rng(2)
    S = _sparse(3, 25, 25)
    perm = np.concatenate([rng.permutation(np.arange(S.indptr[i], S.indptr[i + 1])) for i in range(25)])
    J = jf.CSR(S.indptr.astype(np.int32), S.indices[perm].astype(np.int32), S.data[perm], shape=(25, 25))
    T = CSR(torch.from_numpy(S.indptr.astype(np.int32)), torch.from_numpy(S.indices[perm].astype(np.int32)),
            torch.from_numpy(S.data[perm]), shape=(25, 25))
    _eq_csr(tc.sort_csr(T), cv.sort_csr(J))
    r = rng.integers(0, 20, 120)
    c = rng.integers(0, 15, 120)
    v = rng.standard_normal(120)
    Jc = jf.COO(r.astype(np.int32), c.astype(np.int32), v, shape=(20, 15))
    Tc = COO(torch.from_numpy(r.astype(np.int32)), torch.from_numpy(c.astype(np.int32)), torch.from_numpy(v),
             shape=(20, 15))
    for dup in (False, True):
        want, got = cv.coo_to_csr(Jc, sum_duplicates=dup), tc.coo_to_csr(Tc, sum_duplicates=dup)
        _eq(got.ptr, want.ptr)
        _eq(got.ind, want.ind)
        assert near_error(got.val.numpy(), np.asarray(want.val)) <= TOL


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_padded_and_blocked_formats_match_jax(jc, dtype):
    cv, _jf = jc
    J, T = _pair(jc, _sparse(4, 37, 29, dtype=dtype))
    for width in (None, 40):
        E, Ej = tc.csr_to_ell(T, width), cv.csr_to_ell(J, width)
        assert E.width == Ej.width
        _eq(E.ind, Ej.ind)
        _eq(E.val, Ej.val)
    for width in (None, 2, 8):
        (E, R), (Ej, Rj) = tc.csr_to_ellhyb(T, width), cv.csr_to_ellhyb(J, width)
        _eq(E.ind, Ej.ind)
        _eq(E.val, Ej.val)
        _eq_csr(R, Rj)
    D, Dj = tc.csr_to_dia(T), cv.csr_to_dia(J)
    _eq(D.dist, Dj.dist)
    _eq(D.val, Dj.val)
    for bs in (1, 2, 3, 4, 8):
        B, Bj = tc.csr_to_bsr(T, bs), cv.csr_to_bsr(J, bs)
        assert B.block_dim == Bj.block_dim and B.shape == Bj.shape
        for k in ("ptr", "ind", "val"):
            _eq(getattr(B, k), getattr(Bj, k))
        _eq_csr(tc.bsr_to_csr(B), cv.bsr_to_csr(Bj))
    L, Lj = tc.csr_to_sell(T), cv.csr_to_sell(J)
    for k in ("slice_ptr", "slice_width", "ind", "val"):
        _eq(getattr(L, k), getattr(Lj, k))
    for fn in ("to_csc", "to_coo"):
        a, b = getattr(tc, fn)(T), getattr(cv, fn)(J)
        for k in ("ptr", "ind", "row", "col", "val"):
            if hasattr(b, k):
                _eq(getattr(a, k), getattr(b, k))
    for data_t, data_j in ((E, Ej), (D, Dj), (B, Bj), (tc.to_csc(T), cv.to_csc(J)), (tc.to_coo(T), cv.to_coo(J))):
        _eq_csr(tc.to_csr(data_t), cv.to_csr(data_j))


def test_dia_cap_tcsr_and_dense_match_jax(jc):
    cv, jf = jc
    J, T = _pair(jc, _sparse(5, 30, 30))
    with pytest.raises(AoclSparseError) as e:
        tc.csr_to_dia(T, max_diags=3)
    assert e.value.status == Status.invalid_size
    for order in ("row", "column"):
        got = tc.csr_to_dense(T, order=order)
        assert near_error(got.numpy(), np.asarray(cv.csr_to_dense(J, order=order))) <= TOL
    dense = tc.csr_to_dense(T).numpy()
    dense[np.abs(dense) < 0.3] = 0.0
    _eq_csr(tc.dense_to_csr(dense, tol=0.1, device="cpu"), cv.dense_to_csr(dense, tol=0.1))
    _eq_csr(tc.dense_to_csr(torch.from_numpy(dense)), cv.dense_to_csr(dense))
    # TCSR: L = strictly lower + diagonal, U = diagonal + strictly upper
    d = dense.copy()
    np.fill_diagonal(d, 5.0)
    pL, iL, vL, pU, iU, vU = [0], [], [], [0], [], []
    for i in range(30):
        lo, up = list(np.nonzero(d[i, :i])[0]), list(i + 1 + np.nonzero(d[i, i + 1:])[0])
        iL += lo + [i]
        vL += [d[i, j] for j in lo + [i]]
        iU += [i] + up
        vU += [d[i, j] for j in [i] + up]
        pL.append(len(iL))
        pU.append(len(iU))
    arrs = [np.array(a, np.int32) for a in (pL, iL)] + [np.array(vL)] + [np.array(a, np.int32) for a in (pU, iU)] + \
        [np.array(vU)]
    Tt = TCSR(*[torch.from_numpy(a) for a in arrs], shape=(30, 30))
    Jt = jf.TCSR(*arrs, shape=(30, 30))
    _eq_csr(tc.tcsr_to_csr(Tt), cv.tcsr_to_csr(Jt))


def test_sizing_queries_match_jax(jc):
    cv, _jf = jc
    S = _sparse(6, 40, 33, density=0.25)
    ptr, ind = S.indptr, S.indices
    assert tc.csr2ell_width(40, S.nnz, ptr) == cv.csr2ell_width(40, S.nnz, ptr)
    assert tc.csr2ellthyb_width(40, S.nnz, ptr) == cv.csr2ellthyb_width(40, S.nnz, ptr)
    assert tc.csr2ellthyb_width(0, 0, None) == cv.csr2ellthyb_width(0, 0, None) == (0, 0)
    assert tc.csr2dia_ndiag(40, 33, S.nnz, ptr, ind) == cv.csr2dia_ndiag(40, 33, S.nnz, ptr, ind)
    for bs in (1, 3, 5):
        (bp, bn), (bpj, bnj) = tc.csr2bsr_nnz(40, 33, ptr, ind, bs), cv.csr2bsr_nnz(40, 33, ptr, ind, bs)
        _eq(bp, bpj)
        assert bn == bnj
    for call in (
        lambda mod: mod.csr2ell_width(0, 0, None),
        lambda mod: mod.csr2ell_width(-1, 0, ptr),
        lambda mod: mod.csr2ellthyb_width(-1, 0, ptr),
        lambda mod: mod.csr2dia_ndiag(40, 33, S.nnz, None, ind),
        lambda mod: mod.csr2bsr_nnz(40, 33, ptr, ind, 0),
        lambda mod: mod.csr2blkcsr(4, 4, 3, ptr, ind, S.data, 2),
        lambda mod: mod.csr2blkcsr(40, 33, S.nnz, ptr, ind, S.data, 3),
        lambda mod: mod.csr2blkcsr(40, 33, S.nnz, None, ind, S.data, 2),
    ):
        statuses = []
        for mod in (tc, cv):
            try:
                call(mod)
                statuses.append(None)
            except Exception as e:  # both packages' AoclSparseError carry .status
                statuses.append(int(e.status))
        assert statuses[0] == statuses[1] is not None


def _blocky(seed, m, n):
    """Rows in pairs sharing dense 8-column runs: worth block compression."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, n))
    for r0 in range(0, m, 4):
        for c0 in rng.choice(n - 8, 4, replace=False):
            d[r0:r0 + 4, c0:c0 + 8] = rng.standard_normal((min(4, m - r0), 8)) * (rng.random((min(4, m - r0), 8)) < 0.9)
    return sp.csr_matrix(d)


@pytest.mark.parametrize("nrb", [1, 2, 4])
def test_blkcsr_matches_jax(jc, nrb):
    cv, _jf = jc
    for S in (_sparse(7, 22, 19, density=0.3), _blocky(8, 64, 96)):
        S.sort_indices()
        m, n = S.shape
        got = tc.csr2blkcsr(m, n, S.nnz, S.indptr, S.indices, S.data, nrb, device="cpu")
        want = cv.csr2blkcsr(m, n, S.nnz, S.indptr, S.indices, S.data, nrb)
        for g, w in zip(got, want):
            _eq(g, w)
        assert tc.opt_blksize(m, S.nnz, S.indptr, S.indices) == cv.opt_blksize(m, S.nnz, S.indptr, S.indices)
    assert tc.opt_blksize(0, 0, None, None) == (0, 0)


def test_blkcsr_numpy_version_matches_the_host_library():
    """native.blkcsr_build/_count against their numpy version (the plain
    version used when the library cannot be built): equal outputs."""
    from aoclsparse_tpu_torch import native

    for S, nrb in ((_sparse(9, 30, 41, density=0.2), 2), (_blocky(10, 48, 64), 4), (_sparse(11, 17, 9), 1)):
        S.sort_indices()
        m, n = S.shape
        ptr, ind = S.indptr.astype(np.int64), S.indices.astype(np.int64)
        for got, want in zip(native.blkcsr_build(m, n, ptr, ind, nrb), native._blkcsr_numpy(m, n, ptr, ind, nrb, True)):
            _eq(got, want)
        assert native.blkcsr_count(m, n, ptr, ind, nrb) == native._blkcsr_numpy(m, n, ptr, ind, nrb, False)
