"""SpMM (`mm`) of the PyTorch port against aoclsparse_tpu.mm.

The same CSR and dense B (made from a seed with numpy) go through both
packages' `mm` for every ported KID (0-5 and 7), both orders, op none and
transpose, the alpha/beta epilogue, the restricted memory policy and a
value update. The JAX package runs its Pallas kernels (KIDs 4, 5, 7) in
interpret mode on the CPU; the port runs the kernels' plain versions.

Tolerance: utils/tolerances.py's model, expected_precision(operand dtype)
on max |a - b| / max(|b|, 1): both sides sum the same products in another
order. The mixed mode (bf16 operands, f32 accumulation) is held against
the JAX package's mixed mode at the f32 bound (both round the same values
to bf16) and against a float64 product within the docs/precision.md bound
|c - c*| <= 2^-8 * sum_j |a_ij b_j| + nnz_row * eps_f32 * |c*| per element.
That bound counts one bf16 rounding (relative 2^-8) per product, which is
KID 7's (bf16 diagonals, f32 B). KID 5 and KID 3 round B to bf16 as well,
as the JAX package does, so their product term counts two roundings; KID 3
also returns its product rounded to bf16 (the JAX package's bwdg output
dtype is its band's), one more 2^-8 * |c*|.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE, TRANS = tt.Operation.none, tt.Operation.transpose
M = 600
KIDS = [None, 0, 1, 2, 3, 4, 5, 7]


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


def _operand(seed=0, m=M, halfw=6, far=8, dtype=np.float64):
    """A band of half-width `halfw` (80 % filled) plus `far` entries far off
    it, so the band forms peel a spill: scipy CSR."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 2 * halfw + 1)
    c = r + np.tile(np.arange(-halfw, halfw + 1), m)
    keep = (c >= 0) & (c < m) & (rng.random(r.size) < 0.8)
    r, c = r[keep], c[keep]
    fr = rng.integers(0, m, far)
    fc = (fr + rng.integers(m // 4, m // 2, far)) % m
    S = sp.csr_matrix((rng.standard_normal(r.size + far), (np.r_[r, fr], np.r_[c, fc])), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return sp.csr_matrix((S.data.astype(dtype), S.indices, S.indptr), shape=S.shape)


def _pair(ast, S, device="cpu"):
    m, n = S.shape
    J = ast.create_csr(m, n, S.indptr, S.indices, S.data)
    T = tt.create_csr(m, n, S.indptr, S.indices, S.data, device=device)
    return J, T


@pytest.fixture(scope="module")
def pairs(ast):
    return {dt: (*_pair(ast, _operand(dtype=dt)), _operand(dtype=dt)) for dt in (np.float64, np.float32)}


def _jax_mm(ast, *args, **kw):
    """The JAX package's mm with its f32 products at full precision: an XLA
    CPU build may run f32 dots of DEFAULT precision through bf16 passes,
    which the port's f32 arithmetic is not held to."""
    import jax

    with jax.default_matmul_precision("highest"):
        return np.asarray(ast.mm(*args, **kw))


def _tol(dtype):
    return expected_precision(torch.float64 if dtype == np.float64 else torch.float32)


def _B(seed, rows, k, dtype):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(dtype)


@pytest.mark.parametrize("kid", KIDS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mm_matches_jax(ast, pairs, dtype, kid):
    if kid == 5 and dtype == np.float64:
        pytest.skip("the block-window kernel has f32 and bf16 instances only")
    J, T, S = pairs[dtype]
    B = _B(1, M, 6, dtype)
    want = _jax_mm(ast, 1.0, J, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0, kid=kid)
    got = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=kid)
    assert got.shape == (M, 6) and got.dtype == torch.from_numpy(B).dtype
    assert near_error(got.numpy(), S.astype(np.float64) @ B.astype(np.float64)) <= _tol(dtype)
    assert near_error(got.numpy(), want) <= _tol(dtype)


@pytest.mark.parametrize("kid", [None, 4, 7])
@pytest.mark.parametrize("order", [tt.Order.row, tt.Order.column])
@pytest.mark.parametrize("op", [NONE, TRANS])
def test_mm_order_op_epilogue_match_jax(ast, pairs, op, order, kid):
    J, T, _S = pairs[np.float64]
    B = _B(2, M, 5, np.float64)
    C = _B(3, M, 5, np.float64)
    if order == tt.Order.column:
        B, C = np.ascontiguousarray(B.T), np.ascontiguousarray(C.T)
    want = _jax_mm(ast, 1.5, J, ast.MatrixDescriptor(), ast.Operation(int(op)), B, -0.5, C,
                   order=ast.Order(int(order)), kid=kid)
    got = tt.mm(1.5, T, GEN, op, torch.from_numpy(B), -0.5, torch.from_numpy(C), order=order, kid=kid)
    assert got.shape == want.shape
    assert near_error(got.numpy(), want) <= _tol(np.float64)


def test_beta_zero_never_reads_c_and_quick_exits(ast, pairs):
    J, T, S = pairs[np.float64]
    B = _B(4, M, 3, np.float64)
    Cnan = np.full((M, 3), np.nan)
    got = tt.mm(2.0, T, GEN, NONE, torch.from_numpy(B), 0.0, torch.from_numpy(Cnan))
    assert np.all(np.isfinite(got.numpy()))
    assert near_error(got.numpy(), 2.0 * (S @ B)) <= _tol(np.float64)
    # alpha == 0: C scaled by beta, A never touched
    got = tt.mm(0.0, T, GEN, NONE, torch.from_numpy(B), 3.0, torch.from_numpy(B))
    np.testing.assert_array_equal(got.numpy(), 3.0 * B)
    Z = tt.create_csr(M, M, np.zeros(M + 1, np.int64), np.zeros(0, np.int32), np.zeros(0), device="cpu")
    Zj = ast.create_csr(M, M, np.zeros(M + 1, np.int64), np.zeros(0, np.int32), np.zeros(0))
    want = _jax_mm(ast, 1.0, Zj, ast.MatrixDescriptor(), ast.Operation.none, B, 0.5, B)
    np.testing.assert_array_equal(tt.mm(1.0, Z, GEN, NONE, torch.from_numpy(B), 0.5, torch.from_numpy(B)).numpy(), want)


def test_restricted_policy_takes_segsum_and_matches_jax(ast):
    S = _operand(seed=5)
    J, T = _pair(ast, S)
    ast.set_memory_hint(J, ast.MemoryPolicy.restricted)
    tt.set_memory_hint(T, tt.MemoryPolicy.restricted)
    B = _B(6, M, 4, np.float64)
    want = _jax_mm(ast, 1.0, J, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0)
    got = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0)
    assert [k[-1] for k in T.plan.exec_forms] == ["segsum"]
    assert near_error(got.numpy(), want) <= _tol(np.float64)
    # mv under the same policy takes (and shares) the gather form too
    y = tt.mv(1.0, T, GEN, NONE, torch.from_numpy(B[:, 0]), 0.0)
    assert [k[-1] for k in T.plan.exec_forms] == ["segsum"]
    assert near_error(y.numpy(), want[:, 0]) <= _tol(np.float64)


@pytest.mark.parametrize("kid", [None, 3, 5, 7, 1, 2])
def test_update_values_flows_into_mm(ast, kid):
    S = _operand(seed=7, dtype=np.float32)
    J, T = _pair(ast, S)
    B = _B(8, M, 4, np.float32)
    tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=kid)  # plan and cache the forms
    new = np.random.default_rng(9).standard_normal(S.nnz).astype(np.float32)
    ast.update_values(J, new)
    tt.update_values(T, new)
    want = _jax_mm(ast, 1.0, J, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0, kid=kid)
    got = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=kid)
    assert near_error(got.numpy(), want) <= _tol(np.float32)


@pytest.mark.parametrize("kid", [5, 7, 3])
def test_mixed_mode_matches_jax_and_documented_bound(ast, pairs, monkeypatch, kid):
    J, T, S = pairs[np.float32]
    B = _B(10, M, 8, np.float32)
    monkeypatch.setenv("AOCLSPARSE_TPU_MIXED_PRECISION", "1")
    want = _jax_mm(ast, 1.0, J, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0, kid=kid)
    monkeypatch.delenv("AOCLSPARSE_TPU_MIXED_PRECISION")
    tt.set_precision_mode(T, "mixed")
    try:
        got = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=kid).numpy()
    finally:
        tt.set_precision_mode(T, "full")
    assert near_error(got, want) <= expected_precision(torch.float32)
    S64, B64 = S.astype(np.float64), B.astype(np.float64)
    ref = S64 @ B64
    roundings = 1 if kid == 7 else 2
    bound = roundings * 2.0**-8 * (abs(S64) @ np.abs(B64)) + np.diff(S.indptr)[:, None] * 2.0**-23 * np.abs(ref)
    if kid == 3:
        bound += 2.0**-8 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= bound)
    # the full mode is far tighter than the mixed one
    full = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=kid).numpy()
    assert np.max(np.abs(full - ref)) < np.max(np.abs(got - ref))


def test_default_form_rederived_for_hopper():
    """Band operands take bandtm (bf16 too: the band kernel's bf16
    instance), wide-span stencils diag, scattered ones a gather form,
    complex ones a gather form (no kernel instance)."""
    T = tt.create_csr(M, M, *_csr(_operand(seed=11)), device="cpu")
    tt.set_mm_hint(T, NONE, GEN, nop=100)
    plan = tt.optimize(T)
    assert [k[-1] for k in plan.exec_forms] == ["bandtm"]
    Sb = _operand(seed=11)
    Tb = tt.create_csr(M, M, Sb.indptr, Sb.indices, torch.from_numpy(Sb.data).to(torch.bfloat16), device="cpu")
    assert tt.mm(1.0, Tb, GEN, NONE, torch.ones(M, 2, dtype=torch.bfloat16), 0.0).dtype == torch.bfloat16
    assert [k[-1] for k in Tb.plan.exec_forms] == ["bandtm"]
    nx = 24  # 27-point stencil: a span of 2 (nx^2 + nx + 1) rows, past any band tile
    Sd = _stencil27(nx)
    D = tt.create_csr(nx**3, nx**3, *_csr(Sd), device="cpu")
    tt.mm(1.0, D, GEN, NONE, torch.ones(nx**3, 2, dtype=torch.float64), 0.0)
    assert [k[-1] for k in D.plan.exec_forms] == ["diag"]
    rng = np.random.default_rng(12)
    cols = np.sort(rng.integers(0, M, (M, 3)), axis=1).reshape(-1).astype(np.int32)
    R = tt.create_csr(M, M, np.arange(M + 1) * 3, cols, rng.standard_normal(3 * M), device="cpu")
    tt.mm(1.0, R, GEN, NONE, torch.ones(M, 2, dtype=torch.float64), 0.0)
    assert [k[-1] for k in R.plan.exec_forms] == ["ell"]
    Sc = _operand(seed=11)
    Zc = tt.create_csr(M, M, Sc.indptr, Sc.indices, Sc.data.astype(np.complex128), device="cpu")
    out = tt.mm(1.0, Zc, GEN, NONE, torch.ones(M, 2, dtype=torch.complex128), 0.0)
    assert [k[-1] for k in Zc.plan.exec_forms] == ["ell"]
    np.testing.assert_allclose(out.numpy(), Sc @ np.ones((M, 2)), rtol=1e-12, atol=1e-12)


def _csr(S):
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


def _stencil27(nx):
    """The 27-point stencil of an nx^3 grid: 26 on the diagonal, -1 for each
    neighbour (the HPCG operand)."""
    g = np.arange(nx)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = (0 <= z + dz) & (z + dz < nx) & (0 <= y + dy) & (y + dy < nx) & (0 <= x + dx) & (x + dx < nx)
                i = (z * nx + y) * nx + x
                rows.append(i[ok])
                cols.append(i[ok] + (dz * nx + dy) * nx + dx)
    r, c = np.concatenate(rows), np.concatenate(cols)
    S = sp.csr_matrix((np.where(r == c, 26.0, -1.0), (r, c)), shape=(nx**3, nx**3))
    S.sort_indices()
    return S


def test_mm_on_stencil_matches_jax_diag(ast):
    S = _stencil27(8)
    J, T = _pair(ast, S)
    B = _B(13, 512, 5, np.float64)
    want = _jax_mm(ast, 1.0, J, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0, kid=7)
    got = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0)
    assert near_error(got.numpy(), want) <= _tol(np.float64)


def test_error_statuses(ast, pairs):
    _J, T, _S = pairs[np.float64]
    B = torch.from_numpy(_B(14, M, 2, np.float64))

    def status(*args, **kw):
        with pytest.raises(tt.AoclSparseError) as e:
            tt.mm(*args, **kw)
        return e.value.status

    # KID 6's gate fails on complex values (no band kernel instance): the
    # gather rebuild has no KID 6 row, as in the JAX package
    Sc = _operand(seed=11)
    Zc = tt.create_csr(M, M, Sc.indptr, Sc.indices, Sc.data.astype(np.complex128), device="cpu")
    assert status(1.0, Zc, GEN, NONE, B.to(torch.complex128), 0.0, kid=6) == tt.Status.invalid_kid
    assert status(1.0, T, GEN, NONE, B, 0.0, kid=9) == tt.Status.invalid_kid
    assert status(1.0, T, GEN, NONE, B[:-1], 0.0) == tt.Status.invalid_size
    assert status(1.0, T, GEN, NONE, B[:, 0], 0.0) == tt.Status.invalid_size
    assert status(1.0, T, GEN, NONE, B, 1.0, B[:, :1]) == tt.Status.invalid_size
    assert status(1.0, None, GEN, NONE, B, 0.0) == tt.Status.invalid_pointer
    assert status(1.0, T, GEN, NONE, B.to(torch.complex128), 0.0) == tt.Status.wrong_type
    Sw = _operand(seed=15, halfw=80, far=0, dtype=np.float32)  # W = 168 > 129
    W = tt.create_csr(M, M, *_csr(Sw), device="cpu")
    assert status(1.0, W, GEN, NONE, B.float(), 0.0, kid=5) == tt.Status.invalid_kid
