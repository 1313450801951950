"""mv of the PyTorch port against aoclsparse_tpu.mv.

The JAX side runs its band kernels through `kid=8` (pallas_spmv_band_t) and
`kid=12` (pallas_spmv_band_v) in interpret mode on the CPU; the port runs
the same KIDs through its band form, whose CPU side is the kernel's plain
version. Operands are made from a seed with numpy and fed to both.

Tolerance: utils/tolerances.py's model, expected_precision(dtype) on
max |a - b| / max(|b|, 1): both sides sum the same products in another
order. Under set_precision_mode(A, "mixed") both round the band to bf16
identically and accumulate in f32, so the f32 bound holds there too.
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()


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


def _operand(seed=0, m=1200, n=1100, halfw=6, n_far=10, dtype=np.float64):
    """Band (> 4096 nnz, so the planner peels the far entries into a spill)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 2 * halfw + 1)
    c = r + np.tile(np.arange(-halfw, halfw + 1), m)
    keep = (c >= 0) & (c < n) & (rng.random(r.size) < 0.7)
    r, c = r[keep], c[keep]
    fr = rng.integers(0, m, n_far)
    fc = rng.integers(0, n, n_far)
    r, c = np.r_[r, fr], np.r_[c, fc]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    keep = np.r_[True, (r[1:] != r[:-1]) | (c[1:] != c[:-1])]
    r, c = r[keep], c[keep]
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, r + 1, 1)
    v = rng.standard_normal(r.size).astype(dtype)
    return m, n, np.cumsum(ptr), c.astype(np.int32), v


def _pair(ast, m, n, ptr, ind, val):
    return ast.create_csr(m, n, ptr, ind, val), tt.create_csr(m, n, ptr, ind, val, device="cpu")


def _tol(dtype):
    return expected_precision(torch.float64 if dtype == np.float64 else torch.float32)


def _jop(ast, op):
    return ast.Operation(int(op))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kid", [8, 12, None])
@pytest.mark.parametrize("op", [tt.Operation.none, tt.Operation.transpose])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (1.5, -0.5), (-2.0, 1.0)])
def test_mv_matches_jax(ast, dtype, kid, op, alpha, beta):
    m, n, ptr, ind, val = _operand(dtype=dtype)
    J, T = _pair(ast, m, n, ptr, ind, val)
    rng = np.random.default_rng(1)
    nx, ny = (n, m) if op == tt.Operation.none else (m, n)
    x = rng.standard_normal(nx).astype(dtype)
    y = rng.standard_normal(ny).astype(dtype)
    want = np.asarray(ast.mv(alpha, J, ast.MatrixDescriptor(), _jop(ast, op), x, beta, y, kid=kid))
    got = tt.mv(alpha, T, GEN, op, torch.from_numpy(x), beta, torch.from_numpy(y), kid=kid)
    assert got.dtype == torch.from_numpy(x).dtype
    assert near_error(got.numpy(), want) <= _tol(dtype)
    form = T.plan.exec_forms[(GEN.type, GEN.fill_mode, GEN.diag_type, op, "bandt" if kid else None)]
    assert form.kind == "bandt" and form.has_spill


def test_beta_zero_does_not_read_y(ast):
    m, n, ptr, ind, val = _operand(seed=2)
    J, T = _pair(ast, m, n, ptr, ind, val)
    x = np.random.default_rng(3).standard_normal(n)
    y = np.full(m, np.nan)
    want = np.asarray(ast.mv(2.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0, y, kid=12))
    got = tt.mv(2.0, T, GEN, tt.Operation.none, torch.from_numpy(x), 0.0, torch.from_numpy(y), kid=12)
    assert np.all(np.isfinite(got.numpy()))
    assert near_error(got.numpy(), want) <= _tol(np.float64)


def test_quick_exits_match_jax(ast):
    m, n = 30, 20
    ptr = np.zeros(m + 1, np.int64)
    J, T = _pair(ast, m, n, ptr, np.zeros(0, np.int32), np.zeros(0))
    x = np.ones(n)
    y = np.arange(m, dtype=np.float64)
    JD, JN = ast.MatrixDescriptor(), ast.Operation.none
    for alpha, beta in ((1.0, 0.0), (1.0, 2.0), (np.nan, 1.0)):
        want = np.asarray(ast.mv(alpha, J, JD, JN, x, beta, y))
        got = tt.mv(alpha, T, GEN, tt.Operation.none, torch.from_numpy(x), beta, torch.from_numpy(y))
        np.testing.assert_array_equal(got.numpy(), want)
    # alpha == 0 on a non-empty matrix: y is scaled, A is never touched
    m, n, ptr, ind, val = _operand(seed=4)
    J, T = _pair(ast, m, n, ptr, ind, val)
    y = np.random.default_rng(5).standard_normal(m)
    want = np.asarray(ast.mv(0.0, J, JD, JN, np.ones(n), 3.0, y))
    got = tt.mv(0.0, T, GEN, tt.Operation.none, torch.ones(n, dtype=torch.float64), 3.0, torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)
    assert T.plan is None


def test_mixed_precision_matches_jax(ast):
    m, n, ptr, ind, val = _operand(seed=6, dtype=np.float32)
    J, T = _pair(ast, m, n, ptr, ind, val)
    ast.set_precision_mode(J, "mixed")
    tt.set_precision_mode(T, "mixed")
    x = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    want = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0, kid=12))
    got = tt.mv(1.0, T, GEN, tt.Operation.none, torch.from_numpy(x), 0.0, kid=12)
    assert near_error(got.numpy(), want) <= _tol(np.float32)
    form = T.plan.exec_forms[(GEN.type, GEN.fill_mode, GEN.diag_type, tt.Operation.none, "bandt")]
    assert form._bwd_val_bf16 is not None  # the cached bf16 band served it
    full = tt.mv(1.0, T, GEN, tt.Operation.none, torch.from_numpy(x), 0.0, kid=8)
    assert not torch.equal(full, got)  # KID 8 keeps the f32 band


@pytest.mark.parametrize("env", ["1", "0"])
@pytest.mark.parametrize("mode", ["mixed", "full"])
def test_mixed_precision_switch_matches_jax(ast, monkeypatch, env, mode):
    """AOCLSPARSE_TPU_MIXED_PRECISION decides over the handle's mode in both
    directions, in mv (the port's default band form, KID 12; the JAX package
    is asked for KID 12, its CPU default being a gather form) and in mm (KID 7, the
    bf16 diagonals), as the JAX package reads it. At "0" a "mixed" handle
    runs in full precision; at "1" a "full" one in mixed. The two results
    differ by far more than the f32 bound, so each must follow the switch."""
    m, n, ptr, ind, val = _operand(seed=17, dtype=np.float32)
    J, T = _pair(ast, m, n, ptr, ind, val)
    ast.set_precision_mode(J, mode)
    tt.set_precision_mode(T, mode)
    monkeypatch.setenv("AOCLSPARSE_TPU_MIXED_PRECISION", env)
    rng = np.random.default_rng(18)
    x = rng.standard_normal(n).astype(np.float32)
    JD, JN = ast.MatrixDescriptor(), ast.Operation.none
    want = np.asarray(ast.mv(1.0, J, JD, JN, x, 0.0, kid=12))
    got = tt.mv(1.0, T, GEN, tt.Operation.none, torch.from_numpy(x), 0.0)
    assert T.plan.exec_form_for(GEN, tt.Operation.none).kind == "bandt"  # KID 12, the port's default
    assert near_error(got.numpy(), want) <= _tol(np.float32)
    B = rng.standard_normal((n, 3)).astype(np.float32)
    import jax

    with jax.default_matmul_precision("highest"):
        want = np.asarray(ast.mm(1.0, J, JD, JN, B, 0.0, kid=7))
    got = tt.mm(1.0, T, GEN, tt.Operation.none, torch.from_numpy(B), 0.0, kid=7)
    assert near_error(got.numpy(), want) <= _tol(np.float32)
    # the switch really moved the result: the other setting is far off
    monkeypatch.setenv("AOCLSPARSE_TPU_MIXED_PRECISION", "0" if env == "1" else "1")
    other = tt.mm(1.0, T, GEN, tt.Operation.none, torch.from_numpy(B), 0.0, kid=7)
    assert near_error(other.numpy(), want) > 10 * _tol(np.float32)


def test_update_values_then_mv_matches_jax(ast):
    m, n, ptr, ind, val = _operand(seed=8)
    J, T = _pair(ast, m, n, ptr, ind, val)
    x = np.random.default_rng(9).standard_normal(n)
    JD, JN = ast.MatrixDescriptor(), ast.Operation.none
    for kid in (12, 8):
        ast.mv(1.0, J, JD, JN, x, 0.0, kid=kid)
        tt.mv(1.0, T, GEN, tt.Operation.none, torch.from_numpy(x), 0.0, kid=kid)
    new = np.random.default_rng(10).standard_normal(val.size)
    ast.update_values(J, new)
    tt.update_values(T, new)
    for kid in (12, 8, 0):
        want = np.asarray(ast.mv(1.0, J, JD, JN, x, 0.0, kid=kid))
        got = tt.mv(1.0, T, GEN, tt.Operation.none, torch.from_numpy(x), 0.0, kid=kid)
        assert near_error(got.numpy(), want) <= _tol(np.float64)


def test_dotmv_matches_jax(ast):
    m, n, ptr, ind, val = _operand(seed=11, m=900, n=900)
    J, T = _pair(ast, m, n, ptr, ind, val)
    x = np.random.default_rng(12).standard_normal(n)
    wy, wd = ast.dotmv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0)
    gy, gd = tt.dotmv(1.0, T, GEN, tt.Operation.none, torch.from_numpy(x), 0.0)
    assert near_error(gy.numpy(), np.asarray(wy)) <= _tol(np.float64)
    assert abs(float(gd) - float(wd)) <= _tol(np.float64) * max(abs(float(wd)), 1.0)


def _status(fn):
    try:
        fn()
    except Exception as e:  # both packages' AoclSparseError carry .status
        return int(e.status)
    return None


def test_error_statuses_match_jax(ast):
    m, n, ptr, ind, val = _operand(seed=13, m=200, n=200)
    bad_base = ptr + 1
    bad_col = ind.copy()
    bad_col[5] = n + 3
    bad_ptr = ptr.copy()
    bad_ptr[3], bad_ptr[4] = bad_ptr[4], bad_ptr[3] - 1
    for p, i in ((bad_base, ind), (ptr, bad_col), (bad_ptr, ind), (ptr[:-1], ind)):
        sj = _status(lambda: ast.create_csr(m, n, p, i, val))
        st = _status(lambda: tt.create_csr(m, n, p, i, val, device="cpu"))
        assert sj is not None and st == sj
    J, T = _pair(ast, m, n, ptr, ind, val)
    JD, JN = ast.MatrixDescriptor(), ast.Operation.none
    N = tt.Operation.none
    x = np.ones(n)
    cases = [
        (lambda: ast.mv(1.0, J, JD, JN, np.ones(n + 1), 0.0),
         lambda: tt.mv(1.0, T, GEN, N, torch.ones(n + 1, dtype=torch.float64), 0.0)),
        (lambda: ast.mv(1.0, J, JD, JN, x, 1.0, np.ones(m - 1)),
         lambda: tt.mv(1.0, T, GEN, N, torch.from_numpy(x), 1.0, torch.ones(m - 1, dtype=torch.float64))),
        (lambda: ast.mv(1.0, J, JD, JN, x, 0.0, kid=99),
         lambda: tt.mv(1.0, T, GEN, N, torch.from_numpy(x), 0.0, kid=99)),
        (lambda: ast.mv(1.0, J, JD, JN, x.astype(np.complex128), 0.0),
         lambda: tt.mv(1.0, T, GEN, N, torch.from_numpy(x.astype(np.complex128)), 0.0)),
        (lambda: ast.mv(1.0, J, ast.MatrixDescriptor(base=ast.IndexBase.one), JN, x, 0.0),
         lambda: tt.mv(1.0, T, tt.MatrixDescriptor(base=tt.IndexBase.one), N, torch.from_numpy(x), 0.0)),
        (lambda: ast.set_mv_hint(J, JN, JD, nop=-1),
         lambda: tt.set_mv_hint(T, N, GEN, nop=-1)),
    ]
    for jfn, tfn in cases:
        sj, st = _status(jfn), _status(tfn)
        assert st == sj, (st, sj)
    # KID 13 serves float64 operands only
    J32, T32 = _pair(ast, m, n, ptr, ind, val.astype(np.float32))
    x32 = x.astype(np.float32)
    sj = _status(lambda: ast.mv(1.0, J32, JD, JN, x32, 0.0, kid=13))
    st = _status(lambda: tt.mv(1.0, T32, GEN, N, torch.from_numpy(x32), 0.0, kid=13))
    assert st == sj == int(tt.Status.invalid_kid)


def test_ported_slice_boundaries():
    """The KIDs a CSR handle's mv cannot pin are refused as in the JAX
    package (the whole-matrix route, the native BSR and DIA rows), a device
    mismatch is invalid_value, and the host engine (kid=11) answers on the
    CPU."""
    m, n, ptr, ind, val = _operand(seed=14, m=100, n=100)
    T = tt.create_csr(m, n, ptr, ind, val, device="cpu")
    x = torch.ones(n, dtype=torch.float64)
    for kid in (14, 3, 4):  # the route: the planner's only; bsr, dia: native handles only
        with pytest.raises(tt.AoclSparseError) as e:
            tt.mv(1.0, T, GEN, tt.Operation.none, x, 0.0, kid=kid)
        assert e.value.status == tt.Status.invalid_kid
    with pytest.raises(tt.AoclSparseError) as e:
        tt.mv(1.0, T, GEN, tt.Operation.none, torch.ones(n, dtype=torch.float64, device="meta"), 0.0)
    assert e.value.status == tt.Status.invalid_value
    y = tt.mv(1.0, T, GEN, tt.Operation.none, x, 0.0, kid=11)
    assert y.device.type == "cpu"
    assert near_error(y.numpy(), tt.mv(1.0, T, GEN, tt.Operation.none, x, 0.0, kid=0).numpy()) <= _tol(np.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_mv_matches_cpu_port(cuda, dtype):
    m, n, ptr, ind, val = _operand(seed=15, dtype=dtype)
    D = tt.create_csr(m, n, ptr, ind, val, device=cuda)
    C = tt.create_csr(m, n, ptr, ind, val, device="cpu")
    x = np.random.default_rng(16).standard_normal(n).astype(dtype)
    before = sum(band_spmv.launches.values())
    for kid in (None, 8, 12):
        got = tt.mv(1.5, D, GEN, tt.Operation.none, torch.from_numpy(x).to(cuda), 0.0, kid=kid)
        want = tt.mv(1.5, C, GEN, tt.Operation.none, torch.from_numpy(x), 0.0, kid=kid)
        assert got.device.type == "cuda"
        assert near_error(got.cpu().numpy(), want.numpy()) <= _tol(dtype)
    assert sum(band_spmv.launches.values()) == before + 3
