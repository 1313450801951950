"""Block-window band SpMV of the PyTorch port against the JAX package's
`pallas_spmv_band_mxu` (run in interpret mode), and `ExecForm.band_mxu_dt`
on a bandt form against the JAX form's.

The windows are the same array in both packages (`band_mxu_blocks`, built
from the same band made from a seed with numpy). The CUDA kernel is held
against the plain version on the card (marked `cuda`, skipped elsewhere).

Tolerance: utils/tolerances.py's model, expected_precision(float32) on
max |a - b| / max(|b|, 1). Both sides sum the same products in another
order; the bf16 instance rounds the windows and x to bf16 on both sides
(round to nearest even) and sums their exact products in float32.
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import AoclSparseError, Status
from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv_plain
from aoclsparse_tpu_torch.kernels.spmm_band import band_mxu_blocks
from aoclsparse_tpu_torch.kernels.spmv_mxu import spmv_band_mxu, spmv_band_mxu_plain
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

TOL = expected_precision(torch.float32)


@pytest.fixture(scope="module")
def jax_pallas():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.kernels.pallas import spmv

    return spmv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def _band(seed, W, m, n):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((W, m)).astype(np.float32), rng.standard_normal(n).astype(np.float32)


def _windows(vt, W, bf16):
    dt = band_mxu_blocks(torch.from_numpy(vt).t(), W)
    return dt.to(torch.bfloat16) if bf16 else dt


# m = 640 fills its blocks, m = 700 leaves the last one ragged
@pytest.mark.parametrize("W", [32, 129])
@pytest.mark.parametrize("m,n,start,padL", [(640, 640, 0, 16), (700, 690, 9, 0), (700, 700, 3, 40)])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_matches_pallas_band_mxu(jax_pallas, W, m, n, start, padL, bf16):
    import jax.numpy as jnp

    vt, x = _band(W * m + start, W, m, n)
    dt_np = jax_pallas.band_mxu_blocks(vt, W)
    dt = _windows(vt, W, bf16)
    np.testing.assert_array_equal(_windows(vt, W, False).numpy(), dt_np)
    dt_j = jnp.asarray(dt_np, jnp.bfloat16 if bf16 else jnp.float32)
    xe = jnp.asarray(np.pad(x, (padL, 0)))
    want = np.asarray(jax_pallas.pallas_spmv_band_mxu(dt_j, xe, start, TM=256, interpret=True))[:m]
    got = spmv_band_mxu(dt, torch.from_numpy(x), start, padL, m, W)
    assert got.dtype == torch.float32 and got.shape == (m,)
    assert near_error(got.numpy(), want) <= TOL


@pytest.mark.parametrize("W", [8, 64, 129])
def test_plain_matches_band_contract(W):
    """The windows' product in f32 equals the (W, m) band's."""
    m, n, start, padL = 900, 880, 4, 11
    vt, x = _band(W + 1, W, m, n)
    want = band_spmv_plain(torch.from_numpy(vt), torch.from_numpy(x), start, padL)
    got = spmv_band_mxu_plain(_windows(vt, W, False), torch.from_numpy(x), start, padL, m)
    assert near_error(got.numpy(), want.numpy()) <= TOL


def _form_operand(m=1800, seed=2):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 23)
    cols = rows + np.tile(np.arange(-11, 12), m)
    keep = (cols >= 0) & (cols < m)
    rows, cols = rows[keep], cols[keep]
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    return m, np.cumsum(ptr), cols.astype(np.int32), rng.standard_normal(rows.size).astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True])
def test_band_mxu_dt_on_bandt_form_equals_jax(jax_pallas, bf16):
    """A bandt form's block windows (its (W, m) band transposed first), in
    f32 and bf16, equal the JAX bandt form's, and feed both kernels to the
    same product."""
    import jax.numpy as jnp

    import aoclsparse_tpu as ast

    m, ptr, ind, val = _form_operand()
    J = ast.create_csr(m, m, ptr, ind, val)
    jform = ast.planner.plan.get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="bandt")
    A = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    form = tt.optimize(A).exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="bandt")
    assert form.kind == jform.kind == "bandt" and form.bwd_W == jform.bwd_W
    want = np.asarray(jform.band_mxu_dt(bf16=bf16).astype(jnp.float32))
    dt = form.band_mxu_dt(bf16=bf16)
    assert dt.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(dt.float().numpy(), want)
    assert form.band_mxu_dt(bf16=bf16) is dt
    x = np.random.default_rng(4).standard_normal(m).astype(np.float32)
    xe = jnp.asarray(np.pad(x, (form.bwd_padL, 0)))
    y_j = np.asarray(jax_pallas.pallas_spmv_band_mxu(jform.band_mxu_dt(bf16=bf16), xe, form.bandt_start, TM=256,
                                                     interpret=True))[:m]
    y = spmv_band_mxu(dt, torch.from_numpy(x), form.bandt_start, form.bwd_padL, m, form.bwd_W)
    assert near_error(y.numpy(), y_j) <= TOL


def test_band_mxu_dt_bandt_equals_bandtm_and_refreshes():
    m, ptr, ind, val = _form_operand(m=1000, seed=3)
    A = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    plan = tt.optimize(A)
    ft = plan.exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="bandt")
    fm = plan.exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="bandtm")
    dt = ft.band_mxu_dt()
    assert torch.equal(dt, fm.band_mxu_dt())
    tt.update_values(A, 3.0 * val)
    ft2 = A.plan.exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="bandt")
    assert torch.equal(ft2.band_mxu_dt(), 3.0 * dt)


def test_band_mxu_dt_rejects_wide_and_other_forms():
    m = 600
    rows = np.repeat(np.arange(m), 3)
    cols = np.clip(rows + np.tile(np.array([-100, 0, 100]), m), 0, m - 1)
    key = np.unique(rows * m + cols)
    r, c = key // m, key % m
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, r + 1, 1)
    A = tt.create_csr(m, m, np.cumsum(ptr), c.astype(np.int32), np.ones(r.size, np.float32), device="cpu")
    form = tt.optimize(A).exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="bandt")
    assert form.bwd_W > 129
    with pytest.raises(AoclSparseError) as e:
        form.band_mxu_dt()
    assert e.value.status == Status.invalid_kid
    seg = A.plan.exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="segsum")
    with pytest.raises(AoclSparseError) as e:
        seg.band_mxu_dt()
    assert e.value.status == Status.invalid_kid


def test_wrapper_rejects_bad_operands():
    dt = torch.zeros(3, 256, 128)
    x = torch.zeros(384)
    with pytest.raises(AoclSparseError) as e:
        spmv_band_mxu(dt.double(), x, 0, 0, 384, 129)
    assert e.value.status == Status.wrong_type
    with pytest.raises(AoclSparseError) as e:
        spmv_band_mxu(dt, x.double(), 0, 0, 384, 129)
    assert e.value.status == Status.wrong_type
    with pytest.raises(AoclSparseError) as e:
        spmv_band_mxu(torch.zeros(3, 128, 256), x, 0, 0, 384, 129)
    assert e.value.status == Status.invalid_size
    with pytest.raises(AoclSparseError) as e:
        spmv_band_mxu(dt, x, 0, 0, 385, 129)
    assert e.value.status == Status.invalid_size
    with pytest.raises(AoclSparseError) as e:
        spmv_band_mxu(dt, x, 0, -2, 384, 129)
    assert e.value.status == Status.invalid_value
    with pytest.raises(AoclSparseError) as e:
        spmv_band_mxu(dt, x.to("meta"), 0, 0, 384, 129)
    assert e.value.status == Status.invalid_value
    with pytest.raises(AoclSparseError) as e:
        spmv_band_mxu(dt, torch.zeros(768)[::2], 0, 0, 384, 129)
    assert e.value.status == Status.invalid_value
    with pytest.raises(AoclSparseError) as e:
        band_mxu_blocks(torch.zeros(300, 130), 130)
    assert e.value.status == Status.invalid_size
    assert spmv_band_mxu(dt, x, 0, 0, 0, 129).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n,W,start,padL", [(700, 690, 129, 9, 0), (4099, 4099, 32, 3, 19),
                                              (262144, 262144, 128, 0, 64), (1001, 1010, 1, 4, 7)])
def test_cuda_kernel_matches_plain(cuda, bf16, m, n, W, start, padL):
    """The kernel over the windows' band width, and over W = 256 (a caller
    with no band width), against the plain full-window product; a second
    call gives the same bits."""
    vt, x = _band(m + W, W, m, n)
    dt = _windows(vt, W, bf16).to(cuda)
    x_d = torch.from_numpy(x).to(cuda)
    inst = "bf16" if bf16 else "f32"
    before = spmv_band_mxu.launches[inst]
    got = spmv_band_mxu(dt, x_d, start, padL, m, W)
    torch.cuda.synchronize()
    assert spmv_band_mxu.launches[inst] == before + 1
    want = spmv_band_mxu_plain(dt, x_d, start, padL, m)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= TOL
    full = spmv_band_mxu(dt, x_d, start, padL, m, 256)
    assert near_error(full.cpu().numpy(), want.cpu().numpy()) <= TOL
    assert torch.equal(spmv_band_mxu(dt, x_d, start, padL, m, W), got)
