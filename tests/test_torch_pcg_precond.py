"""Preconditioned CG of the PyTorch port against aoclsparse_tpu.pcg_solve,
and the second slice end to end: create_csr -> hints -> optimize -> trsv
-> ilu_smoother -> pcg_solve(precond="ilu0").

The port applies its preconditioners with the window solve (the kernel's
plain version on the CPU) over inverted diagonal blocks; the JAX package
on the CPU with its substitution scan. In float64 the two runs differ by
rounding only, so iteration counts agree within 1 and x to rtol 1e-10
(the tests/test_torch_cg.py pattern).
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv
from aoclsparse_tpu_torch.kernels.trsv_win import solve_launches, trsv_win
from aoclsparse_tpu_torch.planner.triangular import trsv_form_for
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


def _spd_band(seed=0, m=1500, halfw=8, shift=0.05, dtype=np.float64):
    """Symmetric band with a small Gershgorin diagonal shift: SPD, and
    conditioned so that preconditioning matters."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), halfw)
    c = r + np.tile(np.arange(1, halfw + 1), m)
    keep = (c < m) & (rng.random(r.size) < 0.8)
    r, c = r[keep], c[keep]
    v = -np.abs(rng.standard_normal(r.size))
    rows = np.r_[r, c, np.arange(m)]
    cols = np.r_[c, r, np.arange(m)]
    absum = np.bincount(r, np.abs(v), m) + np.bincount(c, np.abs(v), m)
    vals = np.r_[v, v, absum + shift].astype(dtype)
    order = np.lexsort((cols, rows))
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    return m, np.cumsum(ptr), cols[order].astype(np.int32), vals[order]


@pytest.mark.parametrize("precond", ["ilu0", "sgs"])
def test_pcg_precond_matches_jax(ast, precond):
    m, ptr, ind, val = _spd_band()
    b = np.random.default_rng(1).standard_normal(m)
    J = ast.create_csr(m, m, ptr, ind, val)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    xj, kj, rj = ast.pcg_solve(J, b, rtol=1e-12, maxit=1000, precond=precond)
    xt, kt, rt = tt.pcg_solve(T, torch.from_numpy(b), rtol=1e-12, maxit=1000, precond=precond)
    assert abs(kt - kj) <= 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    assert rt <= 1e-12 * np.linalg.norm(b)


def test_pcg_precond_fixed_length_matches_jax(ast):
    """rtol=0 runs exactly maxit preconditioned iterations, from an x0."""
    m, ptr, ind, val = _spd_band(seed=2, m=900)
    b = np.random.default_rng(3).standard_normal(m)
    x0 = np.random.default_rng(4).standard_normal(m)
    J = ast.create_csr(m, m, ptr, ind, val)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    for precond in ("ilu0", "sgs"):
        xj, kj, rj = ast.pcg_solve(J, b, x0=x0, rtol=0.0, maxit=6, precond=precond)
        xt, kt, rt = tt.pcg_solve(T, torch.from_numpy(b), x0=torch.from_numpy(x0), rtol=0.0, maxit=6,
                                  precond=precond)
        assert kt == kj == 6
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
        assert abs(rt - rj) <= 1e-9 * rj


def test_ilu0_takes_fewer_iterations():
    """tests/test_fused_solvers.py:63 on the port."""
    m, ptr, ind, val = _spd_band(seed=5)
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(m))
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    _, it_plain, _ = tt.pcg_solve(T, b, rtol=1e-8, maxit=2000)
    _, it_ilu, _ = tt.pcg_solve(T, b, rtol=1e-8, maxit=2000, precond="ilu0")
    _, it_sgs, _ = tt.pcg_solve(T, b, rtol=1e-8, maxit=2000, precond="sgs")
    assert it_ilu < it_plain and it_sgs < it_plain


def test_slice_end_to_end_matches_jax(ast):
    m, ptr, ind, val = _spd_band(seed=7, m=2100, halfw=6)
    x = np.random.default_rng(8).standard_normal(m)
    J = ast.create_csr(m, m, ptr, ind, val)
    T = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    lower = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
    jlower = ast.MatrixDescriptor(type=ast.MatrixType.triangular, fill_mode=ast.FillMode.lower)
    for mod, A, d, gen in ((ast, J, jlower, ast.MatrixDescriptor()), (tt, T, lower, GEN)):
        mod.set_mv_hint(A, mod.Operation.none, gen, nop=1000)
        mod.set_sv_hint(A, mod.Operation.none, d, nop=1000)
        mod.set_lu_smoother_hint(A, mod.Operation.none, gen, nop=1000)
        mod.optimize(A)
    assert all(h.done for h in T.hints)
    yj = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0))
    yt = tt.mv(1.0, T, GEN, tt.Operation.none, torch.from_numpy(x), 0.0)
    assert near_error(yt.numpy(), yj) <= expected_precision(torch.float64)
    zj = np.asarray(ast.trsv(1.0, J, jlower, ast.Operation.none, yj))
    zt = tt.trsv(1.0, T, lower, tt.Operation.none, yt)
    assert near_error(zt.numpy(), zj) <= 1e-10
    sj = np.asarray(ast.ilu_smoother(J, ast.MatrixDescriptor(), yj))
    st = tt.ilu_smoother(T, GEN, yt)
    assert near_error(st.numpy(), sj) <= 1e-10
    xj, kj, _ = ast.pcg_solve(J, yj, rtol=1e-12, precond="ilu0")
    xt, kt, _ = tt.pcg_solve(T, yt, rtol=1e-12, precond="ilu0")
    assert abs(kt - kj) <= 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(xt.numpy(), x, rtol=1e-7, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_pcg_ilu0_launch_counts(cuda, dtype):
    """ILU0-PCG on the card: one band launch per iteration plus the initial
    residual, two window solves per iteration (each its passes' launches,
    kernels/trsv_win.py solve_launches); SGS adds one band launch (its
    strict-lower mv) per iteration."""
    m, ptr, ind, val = _spd_band(seed=9, m=5000, dtype=dtype)
    b = np.random.default_rng(10).standard_normal(m).astype(dtype)
    D = tt.create_csr(m, m, ptr, ind, val, device=cuda)
    C = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    name = "f64" if dtype == np.float64 else "f32"
    rtol = 1e-10 if dtype == np.float64 else 1e-5
    tol = 1e-8 if dtype == np.float64 else 1e-3
    for precond, band_per_iter in (("ilu0", 1), ("sgs", 2)):
        tt.pcg_solve(D, torch.from_numpy(b).to(cuda), rtol=rtol, maxit=1, precond=precond)  # set-up
        n_band, n_sv = band_spmv.launches[name], trsv_win.launches[name]
        xd, kd, _ = tt.pcg_solve(D, torch.from_numpy(b).to(cuda), rtol=rtol, maxit=2000, precond=precond)
        assert band_spmv.launches[name] - n_band == band_per_iter * kd + 1
        if precond == "ilu0":
            forms = (D.ilu_state.l_form, D.ilu_state.u_form)
        else:
            forms = [trsv_form_for(D.plan, tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=f),
                                   tt.Operation.none) for f in (tt.FillMode.lower, tt.FillMode.upper)]
        per_apply = sum(solve_launches(f.nblk, f.nb, f.WL) for f in forms)
        assert trsv_win.launches[name] - n_sv == per_apply * kd
        xc, kc, _ = tt.pcg_solve(C, torch.from_numpy(b), rtol=rtol, maxit=2000, precond=precond)
        assert abs(kd - kc) <= 1
        np.testing.assert_allclose(xd.cpu().numpy(), xc.numpy(), rtol=tol, atol=tol)
