"""Multi-RHS triangular solve (`trsm`) and the 2-D `ilu_smoother` of the
PyTorch port against aoclsparse_tpu.

Both packages build a ``win`` form of the same triangle. The port solves
all right-hand sides at once with its inverted diagonal blocks (the
multi-RHS window solve's plain version on the CPU); the JAX package on the
CPU with its substitution scan. So the two differ by rounding only: within
expected_precision(dtype) of utils/tolerances.py on max |a - b| / max(|b|, 1)
(float64 also within 1e-10, as the single-RHS tests hold it).
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels.trsv_win import trsm_win, trsv_win
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

M = 1100  # a multiple of no block size


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


def _operand(seed=0, m=M, halfw=9, far=12, dtype=np.float64):
    """A nonsymmetric band plus a few far entries, with a dominant diagonal:
    (ptr, ind, val, dense)."""
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


@pytest.fixture(scope="module")
def pairs(ast):
    out = {}
    for dt in (np.float64, np.float32):
        ptr, ind, val, dense = _operand(dtype=dt)
        out[dt] = (ast.create_csr(M, M, ptr, ind, val), tt.create_csr(M, M, ptr, ind, val, device="cpu"), dense)
    return out


def _descrs(ast, fill, diag):
    t = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=fill, diag_type=diag)
    j = ast.MatrixDescriptor(
        type=ast.MatrixType.triangular, fill_mode=ast.FillMode(int(fill)), diag_type=ast.DiagType(int(diag))
    )
    return t, j


def _tol(dtype):
    return expected_precision(torch.float64 if dtype == np.float64 else torch.float32)


@pytest.mark.parametrize("K", [1, 3, 16])
@pytest.mark.parametrize("diag", [tt.DiagType.unit, tt.DiagType.non_unit])
@pytest.mark.parametrize("fill", [tt.FillMode.lower, tt.FillMode.upper])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_trsm_matches_jax(ast, pairs, dtype, fill, diag, K):
    J, T, _dense = pairs[dtype]
    dt, dj = _descrs(ast, fill, diag)
    B = np.random.default_rng(int(fill) * 4 + int(diag) * 2 + K).standard_normal((M, K)).astype(dtype)
    want = np.asarray(ast.trsm(0.5, J, dj, ast.Operation.none, B))
    launches = (dict(trsv_win.launches), dict(trsm_win.launches))
    got = tt.trsm(0.5, T, dt, tt.Operation.none, torch.from_numpy(B))
    assert (dict(trsv_win.launches), dict(trsm_win.launches)) == launches  # CPU: plain versions only
    assert got.shape == (M, K) and got.dtype == torch.from_numpy(B).dtype
    assert near_error(got.numpy(), want) <= _tol(dtype)
    if dtype == np.float64:
        assert near_error(got.numpy(), want) <= 1e-10


@pytest.mark.parametrize("order", [tt.Order.row, tt.Order.column])
@pytest.mark.parametrize("op", [tt.Operation.none, tt.Operation.transpose])
def test_trsm_order_and_op_match_jax(ast, pairs, op, order):
    J, T, dense = pairs[np.float64]
    dt, dj = _descrs(ast, tt.FillMode.lower, tt.DiagType.non_unit)
    B = np.random.default_rng(5).standard_normal((M, 7))
    Bin = np.ascontiguousarray(B.T) if order == tt.Order.column else B
    want = np.asarray(ast.trsm(2.0, J, dj, ast.Operation(int(op)), Bin, order=ast.Order(int(order))))
    got = tt.trsm(2.0, T, dt, op, torch.from_numpy(Bin), order=order)
    assert got.shape == want.shape
    assert near_error(got.numpy(), want) <= 1e-10
    X = got.numpy().T if order == tt.Order.column else got.numpy()
    tri = np.tril(dense)
    np.testing.assert_allclose((tri if op == tt.Operation.none else tri.T) @ X, 2.0 * B, atol=1e-10)


def test_trsm_errors(pairs):
    _J, T, _dense = pairs[np.float64]
    L = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)

    def status(*args, **kw):
        with pytest.raises(tt.AoclSparseError) as e:
            tt.trsm(*args, **kw)
        return e.value.status

    B = torch.zeros(M, 2, dtype=torch.float64)
    # kids 1 (level engine) and 2 (host engine) are ported; 3 is no sv kid
    assert status(1.0, T, L, tt.Operation.none, B, kid=3) == tt.Status.invalid_kid
    assert status(1.0, T, L, tt.Operation.none, B[:-1]) == tt.Status.invalid_size
    assert status(1.0, T, L, tt.Operation.none, B[:, 0]) == tt.Status.invalid_size
    assert status(1.0, T, tt.MatrixDescriptor(), tt.Operation.none, B) == tt.Status.invalid_value
    assert status(1.0, None, L, tt.Operation.none, B) == tt.Status.invalid_pointer
    assert status(1.0, T, L, tt.Operation.none, B.to(torch.complex128)) == tt.Status.wrong_type


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ilu_smoother_2d_matches_jax(ast, dtype, K):
    ptr, ind, val, _dense = _operand(seed=3, m=900, far=0, dtype=dtype)
    J = ast.create_csr(900, 900, ptr, ind, val)
    T = tt.create_csr(900, 900, ptr, ind, val, device="cpu")
    B = np.random.default_rng(K).standard_normal((900, K)).astype(dtype)
    want = np.asarray(ast.ilu_smoother(J, ast.MatrixDescriptor(), B))
    got = tt.ilu_smoother(T, tt.MatrixDescriptor(), torch.from_numpy(B))
    assert got.shape == (900, K)
    assert near_error(got.numpy(), want) <= _tol(dtype)
    # each column equals the single-RHS apply
    one = tt.ilu_smoother(T, tt.MatrixDescriptor(), torch.from_numpy(np.ascontiguousarray(B[:, -1])))
    assert near_error(got[:, -1].numpy(), one.numpy()) <= _tol(dtype)


def test_update_values_flows_into_trsm(pairs):
    ptr, ind, val, dense = _operand(seed=8)
    T = tt.create_csr(M, M, ptr, ind, val, device="cpu")
    U = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.upper)
    B = np.random.default_rng(9).standard_normal((M, 5))
    tt.trsm(1.0, T, U, tt.Operation.none, torch.from_numpy(B))
    tt.update_values(T, val * 2.0)
    X = tt.trsm(1.0, T, U, tt.Operation.none, torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(np.triu(2.0 * dense) @ X, B, atol=1e-10)
