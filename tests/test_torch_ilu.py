"""ILU(0) of the PyTorch port against aoclsparse_tpu's.

The factorization runs the same C++ source in both packages (the port
compiles its own byte-equal copy of the JAX package's host_kernels.cpp with
the same flags), so the factored values are compared bit for bit. The apply (two window solves)
holds the JAX package's substitution scan to 1e-10 relative in float64, on
max |a - b| / max(|b|, 1).
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import native
from aoclsparse_tpu_torch.solvers import ilu as tilu

GEN = tt.MatrixDescriptor()


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


def _operand(seed=0, m=1300, halfw=7, dtype=np.float64):
    """Nonsymmetric band with a few far entries and a dominant diagonal:
    (ptr, ind, val)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 2 * halfw + 1)
    c = r + np.tile(np.arange(-halfw, halfw + 1), m)
    keep = (c >= 0) & (c < m) & ((rng.random(r.size) < 0.7) | (r == c))
    r, c = r[keep], c[keep]
    reach = min(150, m // 2)
    fr = rng.integers(0, m - reach, 10)
    r, c = np.r_[r, fr, fr + reach], np.r_[c, fr + reach, fr]
    dense = np.zeros((m, m))
    dense[r, c] = rng.standard_normal(r.size)
    dense[np.arange(m), np.arange(m)] = np.abs(dense).sum(1) + 1.0
    nz = dense != 0
    ptr = np.r_[0, np.cumsum(nz.sum(1))].astype(np.int64)
    return ptr, np.nonzero(nz)[1].astype(np.int32), dense[nz].astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_factor_bit_equal_to_jax(ast, dtype):
    assert native.available()
    ptr, ind, val = _operand(dtype=dtype)
    m = len(ptr) - 1
    J = ast.create_csr(m, m, ptr, ind, val)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    from aoclsparse_tpu.solvers.ilu import ilu0_factorize as jfactor

    want = np.asarray(jfactor(J).lu)
    st = tilu.ilu0_factorize(T)
    assert st.lu.dtype == torch.from_numpy(val).dtype
    np.testing.assert_array_equal(st.lu.numpy(), want)
    assert tilu.ilu0_factorize(T) is st  # cached on the handle


def test_ilu0_factorize_is_exported_as_in_jax(ast):
    """The package exports ilu0_factorize, as aoclsparse_tpu does, and it is
    the solver module's function."""
    assert callable(ast.ilu0_factorize)
    assert tt.ilu0_factorize is tilu.ilu0_factorize
    ptr, ind, val = _operand(dtype=np.float64)
    m = len(ptr) - 1
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    assert tt.ilu0_factorize(T) is T.ilu_state


def test_host_source_is_the_ports_own_byte_equal_copy():
    """The port builds from its own copy (nothing under aoclsparse_tpu/ is
    read at run time), and the copy equals the JAX package's source."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert native.HOST_SOURCE == root / "aoclsparse_tpu_torch" / "native" / "src" / "host_kernels.cpp"
    jax_src = root / "aoclsparse_tpu" / "native" / "src" / "host_kernels.cpp"
    assert native.HOST_SOURCE.read_bytes() == jax_src.read_bytes()


def test_native_factor_matches_numpy_version():
    ptr, ind, val = _operand(seed=1, m=400)
    lu_n, diag_n = native.ilu0_factor(400, ptr, ind, val)
    lu_p, diag_p = native._ilu0_numpy(400, ptr, ind, val)
    np.testing.assert_array_equal(diag_n, diag_p)
    np.testing.assert_allclose(lu_n, lu_p, rtol=1e-13, atol=1e-13)


def test_factor_statuses_match_jax(ast):
    # row 2 stores no diagonal -> invalid_value
    ptr = np.array([0, 2, 4, 5], np.int64)
    ind = np.array([0, 1, 0, 1, 1], np.int32)
    val = np.array([4.0, 1.0, 1.0, 3.0, 2.0])
    # U[1, 1] = 6 - 3 * 2 = 0, and row 2 eliminates with it -> numerical_error
    zptr = np.array([0, 2, 4, 6], np.int64)
    zind = np.array([0, 1, 0, 1, 1, 2], np.int32)
    zval = np.array([1.0, 2.0, 3.0, 6.0, 1.0, 1.0])
    for p, i, v, m, status in ((ptr, ind, val, 3, tt.Status.invalid_value), (zptr, zind, zval, 3, None)):
        J = ast.create_csr(m, m, p, i, v)
        T = tt.create_csr(m, m, p, i, v, device="cpu")
        with pytest.raises(Exception) as ej:
            ast.ilu_smoother(J, ast.MatrixDescriptor(), np.ones(m))
        with pytest.raises(tt.AoclSparseError) as et:
            tt.ilu_smoother(T, GEN, torch.ones(m, dtype=torch.float64))
        assert int(et.value.status) == int(ej.value.status)
        if status is not None:
            assert et.value.status == status
    assert et.value.status == tt.Status.numerical_error


def test_smoother_matches_jax(ast):
    ptr, ind, val = _operand(seed=2)
    m = len(ptr) - 1
    J = ast.create_csr(m, m, ptr, ind, val)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    b = np.random.default_rng(3).standard_normal(m)
    want = np.asarray(ast.ilu_smoother(J, ast.MatrixDescriptor(), b))
    got = tt.ilu_smoother(T, GEN, torch.from_numpy(b), kid=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    # the apply solves L (U x) = b with the port's own factors
    st = T.ilu_state
    assert st.l_form.unit_diag and not st.l_form.reversed_
    assert st.u_form.reversed_ and not st.u_form.unit_diag
    lu = st.lu.numpy()
    rows = np.repeat(np.arange(m), np.diff(ptr))
    L = np.zeros((m, m))
    U = np.zeros((m, m))
    low = ind < rows
    L[rows[low], ind[low]] = lu[low]
    L[np.arange(m), np.arange(m)] = 1.0
    U[rows[~low], ind[~low]] = lu[~low]
    assert np.abs(L @ (U @ got.numpy()) - b).max() <= 1e-10


def test_numpy_forms_equal_native_forms(monkeypatch):
    """ilu0_factorize builds its forms natively, else in numpy: the two
    routes give the same operands."""
    ptr, ind, val = _operand(seed=4)
    m = len(ptr) - 1
    Tn = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    st_n = tilu.ilu0_factorize(Tn)
    assert st_n.l_form._src_space == st_n.u_form._src_space == "clean"
    monkeypatch.setattr(native, "trsv_win_build", lambda *a, **k: None)
    Tp = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    st_p = tilu.ilu0_factorize(Tp)
    assert st_p.l_form._src_space == st_p.u_form._src_space == "eff"
    for slot in ("l_form", "u_form"):
        fn, fp = getattr(st_n, slot), getattr(st_p, slot)
        assert (fn.nb, fn.nblk, fn.WL, fn.reversed_, fn.unit_diag) == (fp.nb, fp.nblk, fp.WL, fp.reversed_, fp.unit_diag)
        np.testing.assert_array_equal(fn.D.numpy(), fp.D.numpy())
        np.testing.assert_array_equal(fn.Lval.numpy(), fp.Lval.numpy())


def test_update_values_drops_the_factors():
    ptr, ind, val = _operand(seed=5, m=300)
    T = tt.create_csr(300, 300, ptr, ind, val, device="cpu")
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(300))
    x1 = tt.ilu_smoother(T, GEN, b)
    tt.update_values(T, val * 2.0)
    assert T.ilu_state is None
    x2 = tt.ilu_smoother(T, GEN, b)
    np.testing.assert_allclose(x2.numpy(), x1.numpy() / 2.0, rtol=1e-12, atol=1e-14)
    tt.destroy(T)
    assert T.ilu_state is None and T.plan is None


def test_smoother_argument_statuses():
    ptr, ind, val = _operand(seed=7, m=100)
    T = tt.create_csr(100, 100, ptr, ind, val, device="cpu")
    b = torch.ones(100, dtype=torch.float64)
    cases = [
        (dict(b=b, kid=-1), tt.Status.invalid_kid),  # kids 1 (levels) and 2 (host) are ported
        (dict(b=b, kid=3), tt.Status.invalid_kid),
        (dict(b=b, op=tt.Operation.transpose), tt.Status.not_implemented),
        (dict(b=torch.ones(99, 2, dtype=torch.float64)), tt.Status.invalid_size),
        (dict(b=torch.ones(100, 2, 2, dtype=torch.float64)), tt.Status.invalid_size),
        (dict(b=torch.ones(99, dtype=torch.float64)), tt.Status.invalid_size),
        (dict(b=None), tt.Status.invalid_pointer),
    ]
    for kw, status in cases:
        with pytest.raises(tt.AoclSparseError) as e:
            tt.ilu_smoother(T, GEN, **kw)
        assert e.value.status == status, kw
    # a 2-D b is the multi-RHS apply: column by column the 1-D one
    X = tt.ilu_smoother(T, GEN, torch.ones(100, 2, dtype=torch.float64))
    np.testing.assert_allclose(X[:, 1].numpy(), tt.ilu_smoother(T, GEN, b).numpy(), rtol=1e-12, atol=1e-12)
