"""The SpGEMM family of the PyTorch port against aoclsparse_tpu.

The same CSR operands (made from a seed with numpy) go through both
packages' sp2m across operations and descriptors, the nnz_count / finalize
stages and a value refresh, csr2m, spmm, sp2md, spmmd, syrk, syrkd, sypr
(one-shot and two-stage), syprd and add, in float64, float32 and complex,
and through the host numeric engine. Both packages run their expansion or
host engines here: the band engine attaches only on the card or when forced
(tests/test_torch_spgemm_band.py). The structure must be equal; values are
held to utils/tolerances.py's model, expected_precision(dtype) on
max |a - b| / max(|b|, 1), at scale 1 for products summed in another order
and scale 10 for the triple products, which round their intermediate.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE, TRANS, CTRANS = tt.Operation.none, tt.Operation.transpose, tt.Operation.conjugate_transpose


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


@pytest.fixture(autouse=True)
def _default_engines(monkeypatch):
    for k in ("AOCLSPARSE_TPU_FORCE_BANDGEMM", "AOCLSPARSE_TPU_NO_BANDGEMM", "AOCLSPARSE_TPU_SPGEMM_HOST",
              "AOCLSPARSE_TPU_SPGEMM_DEVICE", "AOCLSPARSE_TPU_LAZY_SPGEMM"):
        monkeypatch.delenv(k, raising=False)


def _csr(seed, m, n, dtype=np.float64, density=0.25, diag=False):
    """A random scipy CSR of `dtype` (complex: both parts random)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    if diag:
        mask[np.arange(min(m, n)), np.arange(min(m, n))] = True
    vals = rng.standard_normal((m, n))
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.standard_normal((m, n))
    S = sp.csr_matrix(np.where(mask, vals, 0).astype(dtype))
    S.sort_indices()
    return S


def _pair(ast, S):
    m, n = S.shape
    J = ast.create_csr(m, n, S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data)
    T = tt.create_csr(m, n, S.indptr, S.indices, S.data, device="cpu")
    return J, T


def _tol(dtype, scale=1.0):
    return expected_precision(torch.float32 if np.dtype(dtype) in (np.float32, np.complex64) else torch.float64, scale)


def _same_csr(ast, J, T, dtype, scale=1.0):
    """Equal structure, values within the model tolerance."""
    _, _, _, jp, ji, jv = ast.export_csr(J)
    _, _, _, tp, ti, tv = tt.export_csr(T)
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(jp))
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    assert near_error(tv, np.asarray(jv)) <= _tol(dtype, scale)


def _dense(h):
    m, n, _nnz, p, i, v = tt.export_csr(h)
    return sp.csr_matrix((v, i, p), shape=(m, n)).toarray()


OPS = [(NONE, NONE), (TRANS, NONE), (NONE, TRANS), (CTRANS, NONE)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
@pytest.mark.parametrize("opA,opB", OPS)
def test_sp2m_ops_match_jax(ast, dtype, opA, opB):
    mA, k, nB = 23, 17, 19
    SA = _csr(1, mA, k, dtype) if opA == NONE else _csr(1, k, mA, dtype)
    SB = _csr(2, k, nB, dtype) if opB == NONE else _csr(2, nB, k, dtype)
    (JA, TA), (JB, TB) = _pair(ast, SA), _pair(ast, SB)
    J = ast.sp2m(ast.Operation(int(opA)), ast.MatrixDescriptor(), JA, ast.Operation(int(opB)),
                 ast.MatrixDescriptor(), JB)
    T = tt.sp2m(opA, GEN, TA, opB, GEN, TB)
    assert T.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype and T.device == torch.device("cpu")
    _same_csr(ast, J, T, dtype)
    opd = {NONE: lambda d: d, TRANS: lambda d: d.T, CTRANS: lambda d: d.conj().T}
    want = opd[opA](SA.toarray()) @ opd[opB](SB.toarray())
    assert near_error(_dense(T), want) <= _tol(dtype)


@pytest.mark.parametrize("mtype,fill", [(tt.MatrixType.symmetric, tt.FillMode.lower),
                                        (tt.MatrixType.triangular, tt.FillMode.upper),
                                        (tt.MatrixType.hermitian, tt.FillMode.upper)])
def test_sp2m_descriptors_match_jax(ast, mtype, fill):
    dtype = np.complex128 if mtype == tt.MatrixType.hermitian else np.float64
    (JA, TA), (JB, TB) = _pair(ast, _csr(3, 14, 14, dtype, diag=True)), _pair(ast, _csr(4, 14, 9, dtype))
    jd = ast.MatrixDescriptor(type=ast.MatrixType(int(mtype)), fill_mode=ast.FillMode(int(fill)))
    J = ast.sp2m(ast.Operation.none, jd, JA, ast.Operation.none, ast.MatrixDescriptor(), JB)
    T = tt.sp2m(NONE, tt.MatrixDescriptor(type=mtype, fill_mode=fill), TA, NONE, GEN, TB)
    _same_csr(ast, J, T, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sp2m_two_stage_and_refinalize_match_jax(ast, dtype):
    SA, SB = _csr(5, 20, 13, dtype), _csr(6, 13, 22, dtype)
    (JA, TA), (JB, TB) = _pair(ast, SA), _pair(ast, SB)
    jg, jn = ast.MatrixDescriptor(), ast.Operation.none
    J = ast.sp2m(jn, jg, JA, jn, jg, JB, ast.Request.nnz_count)
    T = tt.sp2m(NONE, GEN, TA, NONE, GEN, TB, tt.Request.nnz_count)
    assert T.nnz == J.nnz == int(((np.abs(SA.toarray()) @ np.abs(SB.toarray())) != 0).sum())
    assert not np.any(tt.export_csr(T)[5])
    J = ast.sp2m(jn, jg, JA, jn, jg, JB, ast.Request.finalize, J)
    T2 = tt.sp2m(NONE, GEN, TA, NONE, GEN, TB, tt.Request.finalize, T)
    assert T2 is T
    _same_csr(ast, J, T, dtype)
    ast.update_values(JA, 2.0 * SA.data)
    tt.update_values(TA, 2.0 * SA.data)
    J = ast.sp2m(jn, jg, JA, jn, jg, JB, ast.Request.finalize, J)
    tt.sp2m(NONE, GEN, TA, NONE, GEN, TB, tt.Request.finalize, T)
    _same_csr(ast, J, T, dtype)
    assert near_error(_dense(T), 2.0 * SA.toarray() @ SB.toarray()) <= _tol(dtype)


def test_finalize_needs_a_planned_product():
    A = tt.create_csr(2, 2, [0, 1, 2], [0, 1], np.ones(2), device="cpu")
    with pytest.raises(tt.AoclSparseError) as e:
        tt.sp2m(NONE, GEN, A, NONE, GEN, A, tt.Request.finalize, None)
    assert e.value.status == tt.Status.invalid_value


def test_csr2m_spmm_and_dim_mismatch(ast, monkeypatch):
    (JA, TA), (JB, TB) = _pair(ast, _csr(7, 12, 10)), _pair(ast, _csr(8, 10, 15))
    jn, jg = ast.Operation.none, ast.MatrixDescriptor()
    _same_csr(ast, ast.csr2m(jn, jg, JA, jn, jg, JB), tt.csr2m(NONE, GEN, TA, NONE, GEN, TB), np.float64)
    _same_csr(ast, ast.spmm(JA, JB), tt.spmm(TA, TB), np.float64)
    _same_csr(ast, ast.spmm(JA, JA, ast.Operation.transpose), tt.spmm(TA, TA, TRANS), np.float64)
    for force in ("0", "1"):  # the band-first symbolic stage checks too
        monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", force)
        for call in (lambda: tt.sp2m(NONE, GEN, TA, NONE, GEN, TA), lambda: tt.spmmd(TB, TB)):
            with pytest.raises(tt.AoclSparseError) as e:
                call()
            assert e.value.status == tt.Status.invalid_size
    with pytest.raises(tt.AoclSparseError) as e:
        tt.spmm(None, TB)
    assert e.value.status == tt.Status.invalid_pointer


@pytest.mark.parametrize("order", [tt.Order.row, tt.Order.column])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sp2md_spmmd_match_jax(ast, dtype, order):
    SA, SB = _csr(9, 11, 8, dtype), _csr(10, 8, 13, dtype)
    (JA, TA), (JB, TB) = _pair(ast, SA), _pair(ast, SB)
    C0 = np.random.default_rng(11).standard_normal((11, 13)).astype(dtype)
    Cin = C0.T.copy() if order == tt.Order.column else C0
    jn, jg, jo = ast.Operation.none, ast.MatrixDescriptor(), ast.Order(int(order))
    want = np.asarray(ast.sp2md(jn, jg, JA, jn, jg, JB, 1.5, -0.5, Cin, jo))
    got = tt.sp2md(NONE, GEN, TA, NONE, GEN, TB, 1.5, -0.5, Cin, order)
    assert near_error(got.numpy(), want) <= _tol(dtype)
    # beta == 0 does not read C: NaN there stays out
    nan_c = np.full_like(Cin, np.nan)
    got0 = tt.sp2md(NONE, GEN, TA, NONE, GEN, TB, 2.0, 0.0, nan_c, order).numpy()
    assert np.all(np.isfinite(got0))
    want_d = SA.toarray() @ SB.toarray()
    assert near_error(got0, 2.0 * (want_d.T if order == tt.Order.column else want_d)) <= _tol(dtype)
    assert near_error(tt.spmmd(TA, TB).numpy(), np.asarray(ast.spmmd(JA, JB))) <= _tol(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
@pytest.mark.parametrize("op", [NONE, TRANS])
def test_syrk_syrkd_match_jax(ast, dtype, op):
    S = _csr(12, 16, 11, dtype)
    J, T = _pair(ast, S)
    jop = ast.Operation(int(op))
    if np.issubdtype(dtype, np.complexfloating) and op == TRANS:
        for call in (lambda: tt.syrk(op, T), lambda: tt.syrkd(op, T, 1.0)):
            with pytest.raises(tt.AoclSparseError) as e:
                call()
            assert e.value.status == tt.Status.not_implemented
        return
    _same_csr(ast, ast.syrk(jop, J), tt.syrk(op, T), dtype)
    m = 16 if op == NONE else 11
    C0 = np.random.default_rng(13).standard_normal((m, m)).astype(dtype)
    want = np.asarray(ast.syrkd(jop, J, 2.0, 0.5, C0))
    got = tt.syrkd(op, T, 2.0, 0.5, C0).numpy()
    assert near_error(got, want) <= _tol(dtype)
    np.testing.assert_array_equal(np.tril(got, -1), np.tril(C0, -1))  # the lower triangle passes through


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("op", [NONE, TRANS, CTRANS])
def test_sypr_syprd_match_jax(ast, dtype, op):
    cplx = np.issubdtype(dtype, np.complexfloating)
    SA = _csr(14, 13, 9, dtype) if op == NONE else _csr(14, 9, 13, dtype)
    SB = _csr(15, 9, 9, dtype, diag=True)
    (JA, TA), (JB, TB) = _pair(ast, SA), _pair(ast, SB)
    mt = tt.MatrixType.hermitian if cplx else tt.MatrixType.symmetric
    jd = ast.MatrixDescriptor(type=ast.MatrixType(int(mt)), fill_mode=ast.FillMode.upper)
    td = tt.MatrixDescriptor(type=mt, fill_mode=tt.FillMode.upper)
    jop = ast.Operation(int(op))
    Bd = np.random.default_rng(16).standard_normal((9, 9)).astype(dtype)
    Bd = (Bd + Bd.conj().T) / 2
    if cplx and op == TRANS:
        for call in (lambda: tt.sypr(op, TA, td, TB), lambda: tt.syprd(op, TA, Bd, 1.0)):
            with pytest.raises(tt.AoclSparseError) as e:
                call()
            assert e.value.status == tt.Status.not_implemented
        return
    _same_csr(ast, ast.sypr(jop, JA, jd, JB), tt.sypr(op, TA, td, TB), dtype, scale=10)
    want = np.asarray(ast.syprd(jop, JA, Bd, 1.5, 0.0))
    got = tt.syprd(op, TA, Bd, 1.5, 0.0).numpy()
    assert near_error(np.triu(got), np.triu(want)) <= _tol(dtype, 10)
    C0 = np.random.default_rng(17).standard_normal(got.shape).astype(dtype)
    want = np.asarray(ast.syprd(jop, JA, Bd, 1.5, -0.5, C0, ast.Order.column))
    got = tt.syprd(op, TA, Bd, 1.5, -0.5, C0, tt.Order.column).numpy()
    assert near_error(np.triu(got.T), np.triu(want.T)) <= _tol(dtype, 10)


def test_sypr_two_stage_and_descriptor_checks(ast):
    SA, SB = _csr(18, 12, 8), _csr(19, 8, 8, diag=True)
    (JA, TA), (JB, TB) = _pair(ast, SA), _pair(ast, SB)
    jd = ast.MatrixDescriptor(type=ast.MatrixType.symmetric, fill_mode=ast.FillMode.upper)
    td = tt.MatrixDescriptor(type=tt.MatrixType.symmetric, fill_mode=tt.FillMode.upper)
    J = ast.sypr(ast.Operation.none, JA, jd, JB, ast.Request.nnz_count)
    T = tt.sypr(NONE, TA, td, TB, tt.Request.nnz_count)
    assert T.nnz == J.nnz and not np.any(tt.export_csr(T)[5])
    ast.update_values(JA, 3.0 * SA.data)
    tt.update_values(TA, 3.0 * SA.data)
    J = ast.sypr(ast.Operation.none, JA, jd, JB, ast.Request.finalize, J)
    T = tt.sypr(NONE, TA, td, TB, tt.Request.finalize, T)
    _same_csr(ast, J, T, np.float64, scale=10)
    with pytest.raises(tt.AoclSparseError) as e:
        tt.sypr(NONE, TA, GEN, TB)
    assert e.value.status == tt.Status.invalid_value


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("op", [NONE, TRANS])
def test_add_matches_jax(ast, dtype, op):
    SA = _csr(20, 10, 14, dtype) if op == NONE else _csr(20, 14, 10, dtype)
    SB = _csr(21, 10, 14, dtype)
    (JA, TA), (JB, TB) = _pair(ast, SA), _pair(ast, SB)
    _same_csr(ast, ast.add(ast.Operation(int(op)), 1.5, JA, JB), tt.add(op, 1.5, TA, TB), dtype)
    with pytest.raises(tt.AoclSparseError) as e:
        tt.add(NONE if op == TRANS else TRANS, 1.0, TA, TB)
    assert e.value.status == tt.Status.invalid_size


@pytest.mark.parametrize("engine", ["AOCLSPARSE_TPU_SPGEMM_HOST", "AOCLSPARSE_TPU_SPGEMM_DEVICE"])
def test_host_and_device_engines_match_jax(ast, monkeypatch, engine):
    """Complex products on the host numeric engine (forced) and the device
    expansion engine (forced past the host engine's size gate), syrk's
    conjugated flow included, against the JAX package's host engine."""
    S = _csr(22, 96, 96, np.complex128, density=0.08)
    J, T = _pair(ast, S)
    monkeypatch.setenv(engine, "1")
    monkeypatch.setenv("AOCLSPARSE_TPU_SPGEMM_HOST", "1")  # the JAX side's engine in both cases
    jC, jS = ast.spmm(J, J), ast.syrk(ast.Operation.none, J)
    if engine == "AOCLSPARSE_TPU_SPGEMM_DEVICE":
        monkeypatch.delenv("AOCLSPARSE_TPU_SPGEMM_HOST")
    _same_csr(ast, jC, tt.spmm(T, T), np.complex128)
    _same_csr(ast, jS, tt.syrk(NONE, T), np.complex128)
    d = S.toarray()
    assert near_error(_dense(tt.spmm(T, T)), d @ d) <= _tol(np.complex128)


def test_large_product_takes_the_host_engine(monkeypatch):
    """Past 2^17 products without a band plan, the native host engine is the
    default for operands on the CPU (spgemm.py:447-455): the plan's triples
    are never uploaded."""
    from aoclsparse_tpu_torch import native

    S = _csr(23, 400, 400, density=0.05)
    T = tt.create_csr(400, 400, S.indptr, S.indices, S.data, device="cpu")
    C = tt.spmm(T, T)
    plan = C._spgemm_plan
    assert plan.band is None and plan.P > (1 << 17) and native.available()
    assert getattr(plan, "_dev_trip", None) is None
    assert near_error(_dense(C), S.toarray() @ S.toarray()) <= _tol(np.float64)
    monkeypatch.setenv("AOCLSPARSE_TPU_SPGEMM_DEVICE", "1")
    C = tt.spmm(T, T)
    assert C._spgemm_plan._dev_trip is not None
    assert near_error(_dense(C), S.toarray() @ S.toarray()) <= _tol(np.float64)


def test_card_operands_keep_the_device_engine(monkeypatch):
    """The host engine's size gate holds only for operands on the CPU:
    operands on the card stay on the device expansion engine unless the host
    engine is pinned. The gate reads the operands' device, so it is held here
    without a card."""
    from aoclsparse_tpu_torch.ops.level3.spgemm import _host_default

    S = _csr(23, 400, 400, density=0.05)
    T = tt.create_csr(400, 400, S.indptr, S.indices, S.data, device="cpu")
    plan = tt.spmm(T, T)._spgemm_plan
    assert plan.P > (1 << 17)
    assert _host_default(plan, torch.device("cpu"))
    assert not _host_default(plan, torch.device("cuda"))
    monkeypatch.setenv("AOCLSPARSE_TPU_SPGEMM_DEVICE", "1")
    assert not _host_default(plan, torch.device("cpu"))
