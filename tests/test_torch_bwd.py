"""The ``bwd`` group-window form (mv KID 5) of the PyTorch port against the
JAX package.

- The kernel's plain version (the CPU side of kernels/spmv_bwd.py) runs on
  the JAX planner's own bwd form arrays, carried across with
  `bwd_form_from_jax`, against `pallas_spmv_bwd(..., interpret=True)` called
  as tests/test_pallas.py calls it (a window left of column 0 and an odd m
  among the cases), and against the XLA `spmv_bwd` row with its spill, in
  full and mixed precision.
- The port's planner builds the JAX form's geometry (W, base8, padL, n_pad,
  the window start and the spill) and band.
- mv(kid=5) in both packages, f32, f64 and complex128 (the dtype rule: no
  kernel instance, the plain formulation), and a failed bandt build ends on
  bwd in both.
- On the card (marked cuda, skipped elsewhere) the kernel against its
  plain version.

Tolerances: utils/tolerances.py's model, expected_precision(accumulation
dtype) on max |a - b| / max(|b|, 1), for the same products summed in
another order. The mixed mode is held two ways: the port against the
float64 product of the bf16-rounded band with x at the f32 bound (what the
kernel computes), and the port against the JAX package's XLA mixed row per
element within 2 * 2^-8 * sum_j |a_ij x_j| + nnz_row * eps_f32 * |y| (the
XLA row also rounds x to bf16 and returns its band product rounded to bf16:
one 2^-8 relative rounding each, docs/precision.md's model).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import interop
from aoclsparse_tpu_torch.kernels.spmv_bwd import spmv_bwd, spmv_bwd_any, spmv_bwd_plain
from aoclsparse_tpu_torch.ops.level2.mv import _run_exec_form
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
TOL32 = expected_precision(torch.float32)
TOL64 = expected_precision(torch.float64)


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


def _banded(seed, m, half_bw, row_nnz, n_far=0, dtype=np.float32):
    """Band of `row_nnz` random columns within +-half_bw a row, plus n_far
    far entries (which the planners peel past 4096 entries): scipy CSR."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), row_nnz)
    c = np.clip(r + rng.integers(-half_bw, half_bw + 1, r.size), 0, m - 1)
    fr = rng.integers(0, m, n_far)
    fc = (fr + rng.integers(m // 4, m // 2, n_far)) % m
    S = sp.csr_matrix((rng.standard_normal(r.size + n_far), (np.r_[r, fr], np.r_[c, fc])), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return sp.csr_matrix((S.data.astype(dtype), S.indices, S.indptr), shape=S.shape)


def _pair(ast, S):
    m, n = S.shape
    return ast.create_csr(m, n, S.indptr, S.indices, S.data), tt.create_csr(m, n, S.indptr, S.indices, S.data,
                                                                             device="cpu")


def _jax_bwd_arrays(ast, J):
    from aoclsparse_tpu.planner.plan import get_plan

    f = get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="bwd")
    arrays = {k: (None if getattr(f, k) is None else np.asarray(getattr(f, k)))
              for k in ("bwd_val", "sp_val", "sp_ind", "sp_rows")}
    arrays.update({k: getattr(f, k) for k in ("bwd_W", "bwd_base8", "bwd_padL", "bwd_n_pad", "bwd_rel", "m", "n")})
    return f, arrays


# (seed, m, half_bw, row_nnz): the first three are tests/test_pallas.py's
# shapes, the third's window reaches left of column 0; 201 and 333 are odd
PALLAS_CASES = [(1, 256, 8, 5, 64), (2, 200, 12, 5, 64), (3, 160, 20, 6, 64), (4, 201, 9, 5, 64),
                (5, 333, 30, 7, 128)]


@pytest.mark.parametrize("seed,m,half_bw,row_nnz,TM", PALLAS_CASES)
def test_plain_matches_pallas_bwd(ast, seed, m, half_bw, row_nnz, TM):
    import jax.numpy as jnp
    from aoclsparse_tpu.kernels.pallas.spmv import pallas_spmv_bwd

    S = _banded(seed, m, half_bw, row_nnz)
    J, _T = _pair(ast, S)
    f, arrays = _jax_bwd_arrays(ast, J)
    x = np.random.default_rng(seed + 100).standard_normal(m).astype(np.float32)
    xp = jnp.pad(jnp.asarray(x), (f.bwd_padL, f.bwd_n_pad - f.bwd_padL - m))
    want = np.asarray(pallas_spmv_bwd(f.bwd_val, xp, f.bwd_W, f.bwd_base8, f.bwd_n_pad, TM=TM, interpret=True))[:m]
    form = interop.bwd_form_from_jax(arrays, device="cpu")
    got = spmv_bwd_plain(form.bwd_val, torch.from_numpy(x), form.bwd_base8, form.bwd_padL, m)
    assert near_error(got.numpy(), want) <= TOL32
    assert near_error(got.numpy(), S.astype(np.float64) @ x.astype(np.float64)) <= TOL32
    if seed == 3:
        assert f.bwd_padL > 0  # the window starts left of column 0


def test_plain_matches_loop_definition():
    """The contract as a loop, independent of both packages, with a spill,
    base8 > 0, padL > 0 and m off a multiple of 8."""
    rng = np.random.default_rng(7)
    nblk, W, base8, padL, m, n = 6, 24, 2, 5, 45, 50
    win = rng.standard_normal((nblk, 8, W))
    x = rng.standard_normal(n)
    sp_rows = np.sort(rng.integers(0, m, 9))
    sp_ind = rng.integers(0, n, 9)
    sp_val = rng.standard_normal(9)
    want = np.zeros(m)
    for i in range(m):
        b, r = divmod(i, 8)
        for t in range(W):
            k = 8 * (b + base8) + t - padL
            if 0 <= k < n:
                want[i] += win[b, r, t] * x[k]
    np.add.at(want, sp_rows, sp_val * x[sp_ind])
    got = spmv_bwd(torch.from_numpy(win), torch.from_numpy(x), base8, padL, m, torch.from_numpy(sp_val),
                   torch.from_numpy(sp_ind), torch.from_numpy(sp_rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def _jax_form_mv(ast, J, x, mixed):
    """The JAX package's KID 5 dispatch on its bwd form: XLA spmv_bwd plus
    the spill (ops/level2/mv.py:173-197 there)."""
    from aoclsparse_tpu.ops.level2.mv import _run_exec_form as jrun
    from aoclsparse_tpu.planner.plan import get_plan

    f = get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="bwd")
    f.precision_mode = "mixed" if mixed else "full"
    return np.asarray(jrun(f, x, 5))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_matches_xla_bwd_with_spill(ast, dtype):
    import jax.numpy as jnp

    S = _banded(11, 1500, 24, 6, n_far=12, dtype=dtype)
    J, _T = _pair(ast, S)
    _f, arrays = _jax_bwd_arrays(ast, J)
    assert arrays["sp_ind"] is not None and arrays["sp_ind"].size  # the peel spilled
    x = np.random.default_rng(12).standard_normal(1500).astype(dtype)
    want = _jax_form_mv(ast, J, jnp.asarray(x), mixed=False)
    form = interop.bwd_form_from_jax(arrays, device="cpu")
    got = _run_exec_form(form, torch.from_numpy(x), 5)
    tol = TOL64 if dtype == np.float64 else TOL32
    assert near_error(got.numpy(), want) <= tol
    assert near_error(got.numpy(), S.astype(np.float64) @ x.astype(np.float64)) <= tol


def test_mixed_matches_xla_bwd_and_bf16_product(ast):
    import jax.numpy as jnp

    S = _banded(13, 1500, 24, 6, n_far=12)
    J, _T = _pair(ast, S)
    _f, arrays = _jax_bwd_arrays(ast, J)
    x = np.random.default_rng(14).standard_normal(1500).astype(np.float32)
    want = _jax_form_mv(ast, J, jnp.asarray(x), mixed=True)
    form = interop.bwd_form_from_jax(arrays, device="cpu")
    form.precision_mode = "mixed"
    got = _run_exec_form(form, torch.from_numpy(x), 5).numpy().astype(np.float64)
    S64, x64 = S.astype(np.float64), x.astype(np.float64)
    # what the kernel computes: the bf16 band (the spill stays f32) times x
    band = set(zip(*np.nonzero(sp.coo_matrix(S)))) - set(zip(arrays["sp_rows"], arrays["sp_ind"]))
    Sb = S64.tolil()
    for i, j in band:
        Sb[i, j] = float(torch.tensor(S[i, j], dtype=torch.float32).to(torch.bfloat16))
    assert near_error(got, Sb.tocsr() @ x64) <= TOL32
    ref = S64 @ x64
    bound = 2 * 2.0**-8 * (abs(S64) @ np.abs(x64)) + np.diff(S.indptr) * 2.0**-23 * np.abs(ref)
    assert np.all(np.abs(got - want) <= bound)
    full = _run_exec_form(interop.bwd_form_from_jax(arrays, device="cpu"), torch.from_numpy(x), 5).numpy()
    assert np.max(np.abs(full - ref)) < np.max(np.abs(got - ref))  # the mixed band really rounded


def test_planner_builds_the_jax_geometry(ast):
    S = _banded(15, 1500, 24, 6, n_far=12)
    J, T = _pair(ast, S)
    f, arrays = _jax_bwd_arrays(ast, J)
    form = tplan.get_plan(T).exec_form_for(GEN, NONE, kind="bwd")
    assert form.kind == "bwd" and form.bwd_G == 8
    for key in ("bwd_W", "bwd_base8", "bwd_padL", "bwd_n_pad", "bwd_rel"):
        assert getattr(form, key) == arrays[key], key
    np.testing.assert_array_equal(form.sp_rows.numpy(), arrays["sp_rows"])
    np.testing.assert_array_equal(form.sp_ind.numpy(), arrays["sp_ind"])
    np.testing.assert_array_equal(form.sp_val.numpy(), arrays["sp_val"])
    np.testing.assert_array_equal(form.bwd_val.numpy(), arrays["bwd_val"])
    gptr = form.sp_gptr.numpy()
    assert gptr[0] == 0 and gptr[-1] == form.sp_ind.shape[0]
    assert np.all(gptr[form.sp_rows.numpy() // 8] <= np.arange(form.sp_ind.shape[0]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_mv_kid5_matches_jax(ast, dtype):
    S = _banded(16, 1200, 16, 5, n_far=8, dtype=np.float64)
    rng = np.random.default_rng(17)
    data = S.data.astype(dtype)
    if dtype == np.complex128:
        data = data + 1j * rng.standard_normal(data.size)
    S = sp.csr_matrix((data, S.indices, S.indptr), shape=S.shape)
    J, T = _pair(ast, S)
    x = rng.standard_normal(1200).astype(dtype)
    y = rng.standard_normal(1200).astype(dtype)
    want = np.asarray(ast.mv(1.5, J, ast.MatrixDescriptor(), ast.Operation.none, x, -0.5, y, kid=5))
    got = tt.mv(1.5, T, GEN, NONE, torch.from_numpy(x), -0.5, torch.from_numpy(y), kid=5)
    tol = TOL32 if dtype == np.float32 else TOL64
    assert near_error(got.numpy(), want) <= tol
    assert T.plan.exec_form_for(GEN, NONE, kind="bwd").kind == "bwd"


def test_complex_takes_the_plain_formulation_by_dtype():
    """The dtype rule of spmv_bwd_any: complex operands never reach the
    kernel wrapper, whose instances are real (it raises wrong_type)."""
    rng = np.random.default_rng(18)
    win = torch.from_numpy(rng.standard_normal((4, 8, 16)) + 1j * rng.standard_normal((4, 8, 16)))
    x = torch.from_numpy(rng.standard_normal(40) + 0j)
    before = dict(spmv_bwd.launches)
    got = spmv_bwd_any(win, x, 1, 3, 30)
    np.testing.assert_allclose(got.numpy(), spmv_bwd_plain(win, x, 1, 3, 30).numpy())
    assert spmv_bwd.launches == before
    with pytest.raises(tt.AoclSparseError) as e:
        spmv_bwd(win, x, 1, 3, 30)
    assert e.value.status == tt.Status.wrong_type


def test_failed_bandt_build_ends_on_bwd(ast):
    """A row window wider than BANDT_MAX_W: both planners' bandt build
    fails and the form becomes bwd, whose product matches."""
    m = 2048
    S = _banded(19, m, 700, 4)
    J, T = _pair(ast, S)
    from aoclsparse_tpu.ops.level2.mv import _run_exec_form as jrun
    from aoclsparse_tpu.planner.plan import get_plan

    jf = get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="bandt")
    form = tplan.get_plan(T).exec_form_for(GEN, NONE, kind="bandt")
    assert jf.kind == form.kind == "bwd"
    assert form.bwd_W == jf.bwd_W
    x = np.random.default_rng(20).standard_normal(m).astype(np.float32)
    want = np.asarray(jrun(jf, x, None))
    got = _run_exec_form(form, torch.from_numpy(x), None)
    assert near_error(got.numpy(), want) <= TOL32


def test_wrapper_rejects_bad_operands():
    win = torch.zeros(3, 8, 16)
    for args, status in (
        ((win, torch.zeros(20, dtype=torch.float64), 0, 0, 24), tt.Status.wrong_type),
        ((torch.zeros(3, 4, 16), torch.zeros(20), 0, 0, 12), tt.Status.invalid_size),
        ((win, torch.zeros(20), 0, 0, 25), tt.Status.invalid_size),
        ((win, torch.zeros(20), 0, -1, 24), tt.Status.invalid_value),
        ((win, torch.zeros(40)[::2], 0, 0, 24), tt.Status.invalid_value),
    ):
        with pytest.raises(tt.AoclSparseError) as e:
            spmv_bwd(*args)
        assert e.value.status == status


@pytest.mark.cuda
@pytest.mark.parametrize("inst", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("m,half_bw,n_far", [(4099, 40, 30), (262144, 64, 0), (4097, 0, 0)])
def test_cuda_kernel_matches_plain(cuda, inst, m, half_bw, n_far):
    """The kernel against its plain version, on a W = 8 form too (half_bw
    0: the diagonal); a second call gives the same bits."""
    dt = np.float64 if inst == "f64" else np.float32
    S = _banded(21, m, half_bw, 8, n_far=n_far, dtype=dt)
    T = tt.create_csr(m, m, S.indptr, S.indices, S.data, device=cuda)
    form = tplan.get_plan(T).exec_form_for(GEN, NONE, kind="bwd")
    if half_bw == 0:
        assert form.bwd_W == 8
    band = form.bwd_val.to(torch.bfloat16) if inst == "bf16" else form.bwd_val
    x = torch.from_numpy(np.random.default_rng(22).standard_normal(m).astype(dt)).to(cuda)
    args = (form.bwd_base8, form.bwd_padL, m, form.sp_val, form.sp_ind, form.sp_rows)
    before = spmv_bwd.launches[inst]
    got = spmv_bwd(band, x, *args, form.sp_gptr)
    torch.cuda.synchronize()
    assert spmv_bwd.launches[inst] == before + 1
    want = spmv_bwd_plain(band, x, *args)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= (TOL64 if inst == "f64" else TOL32)
    assert torch.equal(spmv_bwd(band, x, *args, form.sp_gptr), got)


@pytest.mark.cuda
def test_cuda_mv_kid5_one_launch(cuda):
    S = _banded(23, 3001, 30, 7, n_far=20)
    D = tt.create_csr(3001, 3001, S.indptr, S.indices, S.data, device=cuda)
    x = np.random.default_rng(24).standard_normal(3001).astype(np.float32)
    before = spmv_bwd.launches["f32"]
    got = tt.mv(1.0, D, GEN, NONE, torch.from_numpy(x).to(cuda), 0.0, kid=5)
    assert spmv_bwd.launches["f32"] == before + 1
    assert near_error(got.cpu().numpy(), S.astype(np.float64) @ x.astype(np.float64)) <= TOL32
