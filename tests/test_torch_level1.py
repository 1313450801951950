"""Level-1 sparse-vector ops of the PyTorch port against the JAX package:
axpyi, doti, dotci, dotui, gthr, gthrz, gthrs, roti, sctr and sctrs in
float32, float64, complex64 and complex128 (the complex dots complex only,
roti real only), their `kid` checks and their error statuses.

The same values and indices (made from a seed with numpy, the sparse
indices distinct) go to both packages. Gathers and scatters move values:
equal. axpyi and roti do one multiply-add a value (equal up to rounding of
one operation) and the dots sum: utils/tolerances.py's
expected_precision(dtype) on max |a - b| / max(|b|, 1).
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


def _vecs(dtype, n=200, nnz=37, seed=0):
    rng = np.random.default_rng(seed)

    def v(size):
        a = rng.standard_normal(size)
        if np.issubdtype(dtype, np.complexfloating):
            a = a + 1j * rng.standard_normal(size)
        return a.astype(dtype)

    return v(nnz), rng.choice(n, nnz, replace=False).astype(np.int32), v(n)


def _tol(dtype):
    return expected_precision(torch.float32 if dtype in (np.float32, np.complex64) else torch.float64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", DTYPES)
def test_axpyi_gthr_sctr_match_jax(ast, dtype):
    x, ind, y = _vecs(dtype)
    a = dtype(1.75) if not np.issubdtype(dtype, np.complexfloating) else dtype(1.5 - 0.5j)
    got = tt.axpyi(a, _t(x), _t(ind), _t(y))
    assert near_error(got.numpy(), np.asarray(ast.axpyi(a, x, ind, y))) <= _tol(dtype)
    np.testing.assert_array_equal(tt.gthr(_t(y), _t(ind)).numpy(), np.asarray(ast.gthr(y, ind)))
    gx, gy = tt.gthrz(_t(y), _t(ind))
    wx, wy = ast.gthrz(y, ind)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    np.testing.assert_array_equal(tt.sctr(_t(x), _t(ind), _t(y)).numpy(), np.asarray(ast.sctr(x, ind, y)))
    for stride, nnz in ((3, None), (5, 17)):
        np.testing.assert_array_equal(tt.gthrs(_t(y), stride, nnz).numpy(), np.asarray(ast.gthrs(y, stride, nnz)))
    np.testing.assert_array_equal(tt.sctrs(_t(x), 4, _t(y)).numpy(), np.asarray(ast.sctrs(x, 4, y)))
    yt = _t(y)
    tt.axpyi(a, _t(x), _t(ind), yt)
    np.testing.assert_array_equal(yt.numpy(), y)  # arguments are left alone


@pytest.mark.parametrize("dtype", DTYPES)
def test_dots_match_jax(ast, dtype):
    x, ind, y = _vecs(dtype, seed=1)
    got = tt.doti(_t(x), _t(ind), _t(y))
    assert got.dim() == 0
    assert near_error(got.numpy(), np.asarray(ast.doti(x, ind, y))) <= _tol(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        for op in ("dotci", "dotui"):
            got = getattr(tt, op)(_t(x), _t(ind), _t(y))
            assert near_error(got.numpy(), np.asarray(getattr(ast, op)(x, ind, y))) <= _tol(dtype)
    else:
        for op in ("dotci", "dotui"):
            with pytest.raises(tt.AoclSparseError) as e:
                getattr(tt, op)(_t(x), _t(ind), _t(y))
            assert e.value.status == tt.Status.wrong_type


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_roti_matches_jax(ast, dtype):
    x, ind, y = _vecs(dtype, seed=2)
    gx, gy = tt.roti(_t(x), _t(ind), _t(y), 0.6, 0.8)
    wx, wy = ast.roti(x, ind, y, 0.6, 0.8)
    assert near_error(gx.numpy(), np.asarray(wx)) <= _tol(dtype)
    assert near_error(gy.numpy(), np.asarray(wy)) <= _tol(dtype)


def test_empty_sparse_vectors_and_array_likes_match_jax(ast):
    e_x, e_i, y = np.zeros(0), np.zeros(0, np.int32), np.arange(6.0)
    np.testing.assert_array_equal(tt.axpyi(2.0, e_x, e_i, y, device="cpu").numpy(), np.asarray(ast.axpyi(2.0, e_x, e_i, y)))
    assert float(tt.doti(e_x, e_i, y, device="cpu")) == float(ast.doti(e_x, e_i, y)) == 0.0
    gx, gy = tt.roti(e_x, e_i, y, 0.6, 0.8, device="cpu")
    assert gx.numel() == 0 and np.array_equal(gy.numpy(), y)
    got = tt.sctr(np.array([7.0, 8.0]), np.array([1, 4]), y, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ast.sctr(np.array([7.0, 8.0]), np.array([1, 4]), y)))


def _status(fn):
    try:
        fn()
    except Exception as e:  # both packages' AoclSparseError carry .status
        return int(e.status)
    return None


def test_error_statuses_and_kids_match_jax(ast):
    x, ind, y = _vecs(np.float64, n=20, nnz=5, seed=3)
    bad_ind = ind.copy()
    bad_ind[0] = 25
    neg_ind = ind.copy()
    neg_ind[1] = -1
    cx = x.astype(np.complex128)
    cases = [
        ("axpyi", (1.0, x, bad_ind, y), {}),
        ("axpyi", (1.0, x, neg_ind, y), {}),
        ("axpyi", (1.0, x[:4], ind, y), {}),
        ("axpyi", (1.0, x, ind, None), {}),
        ("axpyi", (1.0, None, ind, y), {}),
        ("axpyi", (1.0, x, ind, y), {"kid": 1}),
        ("doti", (x, bad_ind, y), {}),
        ("doti", (x, ind, y), {"kid": 0}),
        ("dotci", (x, ind, y), {}),
        ("dotui", (cx, ind, y), {"kid": 3}),
        ("gthr", (y, bad_ind), {}),
        ("gthr", (None, ind), {}),
        ("gthrz", (y, neg_ind), {}),
        ("gthrs", (y, 0), {}),
        ("gthrs", (y, 3, 8), {}),
        ("gthrs", (None, 2), {}),
        ("roti", (cx, ind, y.astype(np.complex128), 0.6, 0.8), {}),
        ("roti", (x, bad_ind, y, 0.6, 0.8), {}),
        ("sctr", (x, bad_ind, y), {}),
        ("sctr", (x, ind, None), {}),
        ("sctrs", (x, 5, y), {}),
        ("sctrs", (x, -1, y), {}),
        ("sctrs", (x, 2, y), {"kid": 2}),
    ]
    for op, args, kw in cases:
        sj = _status(lambda: getattr(ast, op)(*args, **kw))
        st = _status(lambda: getattr(tt, op)(*args, **kw, device="cpu"))
        assert st == sj, (op, kw, st, sj)
