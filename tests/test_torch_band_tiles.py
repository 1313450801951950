"""Tile-major band SpMV of the PyTorch port against the JAX package's
tile-major band kernels.

The port's plain version (the CPU side of kernels/band_tiles.py) is held
against `pallas_spmv_band_vc` and `pallas_spmv_band_vd` run in interpret
mode on `band_vert_layout_tiles` of identical bands made from a seed with
numpy; the port takes its own tile-major layout (`band_tiles`) of the same
band, and `interop.band_from_jax_tiles` carries the JAX layout back. The
slice as a whole: create_csr -> set_mv_hint -> optimize -> the bandt form's
`bandt_tiles`, `band_mxu_dt` and the peel spill, in both packages. The CUDA
kernels are held against the plain version on the card (marked `cuda`,
skipped elsewhere).

Tolerance: utils/tolerances.py's model, expected_precision(float32) on
max |a - b| / max(|b|, 1): the two sides sum the same products (a bf16 band
rounded identically by both packages, x float32) in another order.
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import AoclSparseError, Status, interop
from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv_plain
from aoclsparse_tpu_torch.kernels.band_tiles import (
    band_spmv_tiles,
    band_spmv_tiles_dbuf,
    band_spmv_tiles_plain,
    band_tiles,
    spmv_bandt_tiles,
)
from aoclsparse_tpu_torch.kernels.spmv_mxu import spmv_bandmxu
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

TOL = expected_precision(torch.float32)
TM = 128

# m=700 and m=1001 are multiples of no tile; start > 0 and padL > 0 move the
# x window both ways, and x shorter than the window exercises the zero fill
CASES = [
    # (m, n, W, start, padL)
    (700, 700, 32, 0, 16),
    (700, 760, 32, 24, 0),
    (1001, 990, 24, 5, 3),
]


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


def _port_band(vt, band):
    t = torch.from_numpy(vt)
    return t.to(torch.bfloat16) if band == "bf16" else t


def _jax_band(vt, band):
    import jax.numpy as jnp

    v = jnp.asarray(vt)
    return v.astype(jnp.bfloat16) if band == "bf16" else v


@pytest.mark.parametrize("m,n,W,start,padL", CASES)
@pytest.mark.parametrize("band", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["vc", "vd"])
def test_plain_tiles_match_pallas(jax_pallas, m, n, W, start, padL, band, variant):
    """#6 (vc, one grid step a tile) and #7 (vd, the band double-buffered
    by manual DMA) against the port's plain version on its own layout."""
    import jax.numpy as jnp

    vt, x = _band(m + W + start, W, m, n)
    vt3_j = jax_pallas.band_vert_layout_tiles(_jax_band(vt, band), TM)
    xe = jnp.asarray(np.pad(x, (padL, 0)))
    kern = jax_pallas.pallas_spmv_band_vc if variant == "vc" else jax_pallas.pallas_spmv_band_vd
    want = np.asarray(kern(vt3_j, xe, W, start, TM=TM, interpret=True))
    assert want.shape == (-(-m // TM) * TM,)
    vt3 = band_tiles(_port_band(vt, band), TM)
    wrapper = band_spmv_tiles if variant == "vc" else band_spmv_tiles_dbuf
    got = wrapper(vt3, torch.from_numpy(x), start, padL, m)
    assert got.dtype == torch.float32 and got.shape == (m,)
    assert near_error(got.numpy(), want[:m]) <= TOL


@pytest.mark.parametrize("m,W", [(700, 32), (1001, 24), (128, 128)])
@pytest.mark.parametrize("band", ["f32", "bf16"])
def test_band_tiles_equal_jax_layout_carried_back(jax_pallas, m, W, band):
    """band_tiles of a band equals band_tiles of the band carried back from
    the JAX package's tile-major layout, value for value."""
    vt, _x = _band(m * W, W, m, 1)
    vt3_j = np.asarray(jax_pallas.band_vert_layout_tiles(_jax_band(vt, band), TM))
    back = interop.band_from_jax_tiles(vt3_j, W, TM, m=m, device="cpu")
    assert back.shape == (W, m)
    assert torch.equal(back, _port_band(vt, band))
    assert torch.equal(band_tiles(back, TM), band_tiles(_port_band(vt, band), TM))
    full = interop.band_from_jax_tiles(vt3_j, W, TM, device="cpu")
    assert full.shape == (W, -(-m // TM) * TM) and not full[:, m:].any()


@pytest.mark.parametrize("m,n,W,start,padL", CASES)
def test_plain_tiles_match_plain_band(m, n, W, start, padL):
    """The tile-major product equals the (W, m) band kernel's contract."""
    vt, x = _band(7 * m + W, W, m, n)
    want = band_spmv_plain(torch.from_numpy(vt), torch.from_numpy(x), start, padL)
    for tm in (W, 64, 256, 1024):
        got = band_spmv_tiles_plain(band_tiles(torch.from_numpy(vt), tm), torch.from_numpy(x), start, padL, m)
        assert near_error(got.numpy(), want.numpy()) <= TOL


def test_plain_tiles_match_loop_definition():
    """The contract written as a loop, independent of both packages."""
    vt, x = _band(9, 12, 300, 280)
    start, padL = 3, 5
    want = np.zeros(300)
    for j in range(12):
        k = np.arange(300) + start + j - padL
        ok = (k >= 0) & (k < 280)
        want[ok] += vt[j, ok].astype(np.float64) * x[k[ok]]
    got = band_spmv_tiles_plain(band_tiles(torch.from_numpy(vt), 64), torch.from_numpy(x), start, padL, 300)
    assert near_error(got.numpy(), want) <= TOL


def _operand(m=3001, seed=5):
    """An odd-m band (half-width 20) plus far outliers the planner peels."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 41)
    cols = rows + np.tile(np.arange(-20, 21), m)
    keep = (cols >= 0) & (cols < m) & (rng.random(rows.size) < 0.6)
    far_r = rng.integers(0, m, 30)
    r = np.r_[rows[keep], far_r]
    c = np.r_[cols[keep], (far_r + rng.integers(300, 900, 30)) % m]
    key = np.unique(r * m + c)
    r, c = key // m, key % m
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, r + 1, 1)
    return m, np.cumsum(ptr), c.astype(np.int32), rng.standard_normal(r.size), rng.standard_normal(m)


def test_measurement_path_matches_jax(jax_pallas):
    """The slice's path in both packages: create_csr -> set_mv_hint ->
    optimize -> the bandt form; its tile-major band through #6 and #7 and
    its block windows through #5, each plus the peel spill, against the
    JAX package's kernels on its own form, and against float64 A x."""
    import jax.numpy as jnp

    import aoclsparse_tpu as ast

    m, ptr, ind, val, x = _operand()
    val32, x32 = val.astype(np.float32), x.astype(np.float32)
    dense = np.zeros((m, m))
    dense[np.repeat(np.arange(m), np.diff(ptr)), ind] = val32
    ref = dense @ x32.astype(np.float64)

    J = ast.create_csr(m, m, ptr, ind, val32)
    ast.set_mv_hint(J, ast.Operation.none, ast.MatrixDescriptor(), nop=1000)
    jform = ast.optimize(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="bandt")
    A = tt.create_csr(m, m, ptr, ind, val32, device="cpu")
    tt.set_mv_hint(A, tt.Operation.none, tt.MatrixDescriptor(), nop=1000)
    form = tt.optimize(A).exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="bandt")
    assert form.kind == "bandt" and form.has_spill and form.bwd_W == jform.bwd_W <= 129
    assert (form.bandt_start, form.bwd_padL) == (jform.bandt_start, jform.bwd_padL)
    np.testing.assert_array_equal(form.bwd_val.numpy(), np.asarray(jform.bwd_val))

    W, start, padL = form.bwd_W, form.bandt_start, form.bwd_padL
    spill = (form.sp_val, form.sp_ind, form.sp_rows)
    xe = jnp.asarray(np.pad(x32, (padL, 0)))
    jspill = np.zeros(m)
    np.add.at(jspill, np.asarray(jform.sp_rows), np.asarray(jform.sp_val) * x32[np.asarray(jform.sp_ind)])
    xt = torch.from_numpy(x32)
    vt3_j = jax_pallas.band_vert_layout_tiles(jform.bwd_val, TM)
    for dbuf, kern in ((False, jax_pallas.pallas_spmv_band_vc), (True, jax_pallas.pallas_spmv_band_vd)):
        want = np.asarray(kern(vt3_j, xe, W, start, TM=TM, interpret=True))[:m] + jspill
        got = spmv_bandt_tiles(form.bandt_tiles(TM), xt, *spill, start, padL, m, dbuf=dbuf)
        assert near_error(got.numpy(), want) <= TOL
        assert near_error(got.numpy(), ref) <= TOL
    want = np.asarray(jax_pallas.pallas_spmv_band_mxu(jform.band_mxu_dt(), xe, start, TM=256, interpret=True))[:m]
    got = spmv_bandmxu(form.band_mxu_dt(), xt, *spill, start, padL, m, W)
    assert near_error(got.numpy(), want + jspill) <= TOL
    assert near_error(got.numpy(), ref) <= TOL


def test_bandt_tiles_cached_and_dropped_by_refresh():
    m, ptr, ind, val, x = _operand(m=1500, seed=8)
    A = tt.create_csr(m, m, ptr, ind, val.astype(np.float32), device="cpu")
    form = tt.optimize(A).exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="bandt")
    t1, t1b = form.bandt_tiles(256), form.bandt_tiles(256, bf16=True)
    assert form.bandt_tiles(256) is t1 and form.bandt_tiles(256, bf16=True) is t1b
    assert t1b.dtype == torch.bfloat16 and torch.equal(t1b, band_tiles(form.bwd_val.to(torch.bfloat16), 256))
    assert form.bandt_tiles(64) is not t1 and form.bandt_tiles(64).shape == (-(-m // 64), form.bwd_W, 64)
    tt.update_values(A, 2.0 * val.astype(np.float32))
    form2 = A.plan.exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="bandt")
    assert torch.equal(form2.bandt_tiles(256), band_tiles(form2.bwd_val, 256))
    assert torch.equal(form2.bandt_tiles(256), 2.0 * t1)
    tm = A.plan.exec_form_for(tt.MatrixDescriptor(), tt.Operation.none, kind="bandtm")
    with pytest.raises(AoclSparseError) as e:
        tm.bandt_tiles(256)
    assert e.value.status == Status.invalid_kid


def test_wrappers_reject_bad_operands():
    vt3 = band_tiles(torch.zeros(8, 100), 64)
    x = torch.zeros(100)
    for fn in (band_spmv_tiles, band_spmv_tiles_dbuf):
        with pytest.raises(AoclSparseError) as e:
            fn(vt3.double(), x.double(), 0, 0, 100)
        assert e.value.status == Status.wrong_type
        with pytest.raises(AoclSparseError) as e:
            fn(vt3, x.double(), 0, 0, 100)
        assert e.value.status == Status.wrong_type
        with pytest.raises(AoclSparseError) as e:
            fn(band_tiles(torch.zeros(80, 100), 64), x, 0, 0, 100)  # W > TM
        assert e.value.status == Status.invalid_size
        with pytest.raises(AoclSparseError) as e:
            fn(vt3, x, 0, 0, 129)  # m past the tiles
        assert e.value.status == Status.invalid_size
        with pytest.raises(AoclSparseError) as e:
            fn(vt3, x, -1, 0, 100)
        assert e.value.status == Status.invalid_value
        with pytest.raises(AoclSparseError) as e:
            fn(vt3, torch.zeros(200)[::2], 0, 0, 100)
        assert e.value.status == Status.invalid_value
        with pytest.raises(AoclSparseError) as e:
            fn(vt3, x.to("meta"), 0, 0, 100)
        assert e.value.status == Status.invalid_value
        assert fn(vt3, x, 0, 0, 0).shape == (0,)
    with pytest.raises(AoclSparseError) as e:
        band_spmv_tiles_dbuf(band_tiles(torch.zeros(8, 100), 60), x, 0, 0, 100)  # TM off 8
    assert e.value.status == Status.invalid_size
    with pytest.raises(AoclSparseError) as e:
        band_spmv_tiles_dbuf(band_tiles(torch.zeros(8, 5000), 4096), torch.zeros(5000), 0, 0, 5000)
    assert e.value.status == Status.invalid_size
    with pytest.raises(AoclSparseError) as e:
        band_tiles(torch.zeros(8, 100), 0)
    assert e.value.status == Status.invalid_size


@pytest.mark.cuda
@pytest.mark.parametrize("band", ["f32", "bf16"])
@pytest.mark.parametrize("dbuf", [False, True])
@pytest.mark.parametrize("m,n,W,start,padL,tm", [c + (TM,) for c in CASES] + [(262144, 262144, 128, 0, 64, 256),
                                                                             (4099, 4099, 136, 7, 19, 256)])
def test_cuda_kernels_match_plain(cuda, band, dbuf, m, n, W, start, padL, tm):
    vt, x = _band(m + W, W, m, n)
    vt3 = band_tiles(_port_band(vt, band).to(cuda), tm)
    x_d = torch.from_numpy(x).to(cuda)
    wrapper = band_spmv_tiles_dbuf if dbuf else band_spmv_tiles
    before = dict(wrapper.launches)
    got = wrapper(vt3, x_d, start, padL, m)
    torch.cuda.synchronize()
    assert wrapper.launches[band] == before[band] + 1
    want = band_spmv_tiles_plain(vt3, x_d, start, padL, m)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= TOL
