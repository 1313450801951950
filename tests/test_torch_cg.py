"""CG of the PyTorch port against aoclsparse_tpu.pcg_solve, and the slice
end to end: create_csr -> set_mv_hint -> optimize -> mv -> pcg_solve.

The port iterates on its band form (the kernel's plain version on the CPU);
the JAX package on its own default form. In float64 the two runs differ by
rounding only, so iteration counts agree within 1 and x agrees to rtol
1e-10 (far above f64 rounding, far below the solve's 1e-12 target's effect
on x for these well-conditioned operands). mv in the slice test holds the
f64 model tolerance of utils/tolerances.py.
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


def _spd_band(seed=0, m=600, halfw=8, shift=1.0, dtype=np.float64):
    """Symmetric band with a Gershgorin diagonal shift (SPD). Complex
    dtypes give a complex-symmetric operand (the reference CG's unconjugated
    semantics)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), halfw)
    c = r + np.tile(np.arange(1, halfw + 1), m)
    keep = (c < m) & (rng.random(r.size) < 0.8)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(r.size)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(r.size)
    rows = np.r_[r, c, np.arange(m)]
    cols = np.r_[c, r, np.arange(m)]
    absum = np.bincount(r, np.abs(v), m) + np.bincount(c, np.abs(v), m)
    vals = np.r_[v, v, absum + shift].astype(dtype)
    order = np.lexsort((cols, rows))
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    return m, np.cumsum(ptr), cols[order].astype(np.int32), vals[order]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_pcg_matches_jax(ast, dtype):
    """float64 runs the 2-reduction real branch, complex128 the general one."""
    m, ptr, ind, val = _spd_band(dtype=dtype)
    b = np.random.default_rng(1).standard_normal(m).astype(dtype)
    J = ast.create_csr(m, m, ptr, ind, val)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    xj, kj, rj = ast.pcg_solve(J, b, rtol=1e-12)
    xt, kt, rt = tt.pcg_solve(T, torch.from_numpy(b), rtol=1e-12)
    assert abs(kt - kj) <= 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    assert rt <= 1e-12 * np.linalg.norm(b)
    form = T.plan.exec_form_for(GEN, tt.Operation.none)
    assert form.kind == ("bandt" if dtype == np.float64 else "segsum")


def test_pcg_maxit_and_x0_match_jax(ast):
    m, ptr, ind, val = _spd_band(seed=2, shift=0.05)
    b = np.random.default_rng(3).standard_normal(m)
    x0 = np.random.default_rng(4).standard_normal(m)
    J = ast.create_csr(m, m, ptr, ind, val)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    xj, kj, rj = ast.pcg_solve(J, b, x0=x0, rtol=0.0, maxit=7)
    xt, kt, rt = tt.pcg_solve(T, torch.from_numpy(b), x0=torch.from_numpy(x0), rtol=0.0, maxit=7)
    assert kt == kj == 7
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    assert abs(rt - rj) <= 1e-10 * rj


def test_slice_end_to_end_matches_jax(ast):
    m, ptr, ind, val = _spd_band(seed=5, m=1500, halfw=6)
    x = np.random.default_rng(6).standard_normal(m)
    J = ast.create_csr(m, m, ptr, ind, val)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    ast.set_mv_hint(J, ast.Operation.none, ast.MatrixDescriptor(), nop=1000)
    tt.set_mv_hint(T, tt.Operation.none, GEN, nop=1000)
    ast.optimize(J)
    plan = tt.optimize(T)
    assert [f.kind for f in plan.exec_forms.values()] == ["bandt"]
    yj = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0))
    yt = tt.mv(1.0, T, GEN, tt.Operation.none, torch.from_numpy(x), 0.0)
    assert near_error(yt.numpy(), yj) <= expected_precision(torch.float64)
    xj, kj, _ = ast.pcg_solve(J, yj, rtol=1e-12)
    xt, kt, _ = tt.pcg_solve(T, yt, rtol=1e-12)
    assert abs(kt - kj) <= 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(xt.numpy(), x, rtol=1e-8, atol=1e-9)


def test_pcg_errors():
    m, ptr, ind, val = _spd_band(m=50)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    # ilu0 and sgs are ported for every dtype (tests/test_torch_pcg_precond.py,
    # tests/test_torch_gmres.py for complex); a float16 operand has no
    # triangular solve
    Z = tt.create_csr(m, m, ptr, ind, torch.from_numpy(val).to(torch.float16), device="cpu")
    for A, precond, status in ((Z, "ilu0", tt.Status.not_implemented), (Z, "sgs", tt.Status.not_implemented),
                               (T, "jacobi", tt.Status.invalid_value)):
        with pytest.raises(tt.AoclSparseError) as e:
            tt.pcg_solve(A, torch.ones(m, dtype=A.dtype), precond=precond)
        assert e.value.status == status
    with pytest.raises(tt.AoclSparseError) as e:
        tt.pcg_solve(T, torch.ones(m + 1, dtype=torch.float64))
    assert e.value.status == tt.Status.invalid_size
    R = tt.create_csr(3, 4, np.array([0, 1, 2, 3]), np.array([0, 1, 2], np.int32), np.ones(3), device="cpu")
    with pytest.raises(tt.AoclSparseError) as e:
        tt.pcg_solve(R, torch.ones(3, dtype=torch.float64))
    assert e.value.status == tt.Status.invalid_size


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_pcg_one_launch_per_iteration(cuda, dtype):
    m, ptr, ind, val = _spd_band(seed=7, m=5000, dtype=dtype)
    b = np.random.default_rng(8).standard_normal(m).astype(dtype)
    D = tt.create_csr(m, m, ptr, ind, val, device=cuda)
    C = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    inst = "f64" if dtype == np.float64 else "f32"
    rtol = 1e-10 if dtype == np.float64 else 1e-5
    n0 = band_spmv.launches[inst]
    xd, kd, _ = tt.pcg_solve(D, torch.from_numpy(b).to(cuda), rtol=rtol)
    assert band_spmv.launches[inst] - n0 == kd + 1  # + the initial residual
    xc, kc, _ = tt.pcg_solve(C, torch.from_numpy(b), rtol=rtol)
    assert abs(kd - kc) <= 1
    tol = 1e-8 if dtype == np.float64 else 1e-3
    np.testing.assert_allclose(xd.cpu().numpy(), xc.numpy(), rtol=tol, atol=tol)
