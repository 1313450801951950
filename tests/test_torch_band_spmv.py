"""Band SpMV of the PyTorch port against the JAX package's band kernels.

The port's plain band version (the CPU side of kernels/band_spmv.py) is held
against `pallas_spmv_band_t` and `pallas_spmv_band_v` run in interpret mode,
on identical bands made from a seed with numpy. The CUDA kernel is held
against the plain version on the card (marked `cuda`, skipped elsewhere).

Tolerance: utils/tolerances.py's model, expected_precision(accumulation
dtype) on max |a - b| / max(|b|, 1). The two sides sum the same products in
another order; a bf16 band is rounded identically (round-to-nearest-even)
by both packages before the f32 accumulation, so bf16 holds the f32 bound.
"""

import numpy as np
import pytest
import torch

from aoclsparse_tpu_torch.kernels.band_spmv import (
    band_spmv,
    band_spmv_plain,
    spmv_bandt,
)
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

CPU = torch.device("cpu")


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


def _band(seed, W, m, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((W, m)).astype(dtype), rng.standard_normal(n).astype(dtype)


def _tol(dtype) -> float:
    return expected_precision(torch.float64 if dtype == np.float64 else torch.float32)


# m=700 and m=1001 are multiples of no tile; start > 0 and padL > 0 move the
# x window both ways, and x shorter than the window exercises the zero fill
CASES = [
    # (m, n, W, start, padL)
    (700, 700, 32, 0, 16),
    (700, 760, 32, 24, 0),
    (1001, 990, 24, 5, 3),
]


@pytest.mark.parametrize("m,n,W,start,padL", CASES)
@pytest.mark.parametrize("band", ["f32", "bf16", "f64"])
def test_plain_band_matches_pallas_band_t(jax_pallas, m, n, W, start, padL, band):
    import jax.numpy as jnp

    dt = np.float64 if band == "f64" else np.float32
    vt, x = _band(m + W + start, W, m, n, dt)
    vt_j = jnp.asarray(vt).astype(jnp.bfloat16) if band == "bf16" else jnp.asarray(vt)
    xe = jnp.asarray(np.pad(x, (padL, 0)))
    want = np.asarray(jax_pallas.pallas_spmv_band_t(vt_j, xe, W, start, TM=128, interpret=True))
    vt_t = torch.from_numpy(vt).to(torch.bfloat16) if band == "bf16" else torch.from_numpy(vt)
    got = band_spmv(vt_t, torch.from_numpy(x), start, padL)
    assert got.dtype == (torch.float64 if band == "f64" else torch.float32)
    assert near_error(got.numpy(), want) <= _tol(dt)


@pytest.mark.parametrize("m,n,W,start,padL", CASES)
@pytest.mark.parametrize("band", ["f32", "bf16"])
def test_plain_band_matches_pallas_band_v(jax_pallas, m, n, W, start, padL, band):
    """The vertical-layout kernel (mv KID 12) on its TPU layout; the port
    takes the plain (W, m) band. bf16 is the mixed-precision path."""
    import jax.numpy as jnp

    vt, x = _band(2 * m + W, W, m, n)
    TM = 128
    vt_j = jnp.asarray(vt)
    if band == "bf16":
        vt_j = vt_j.astype(jnp.bfloat16)
    vt4 = jax_pallas.band_vert_layout(vt_j, TM)
    xe = jnp.asarray(np.pad(x, (padL, 0)))
    want = np.asarray(
        jax_pallas.pallas_spmv_band_v(vt4, xe, W, start, TM=TM, interpret=True)
    )[:m]
    vt_t = torch.from_numpy(vt)
    if band == "bf16":
        vt_t = vt_t.to(torch.bfloat16)
    got = band_spmv(vt_t, torch.from_numpy(x), start, padL)
    assert near_error(got.numpy(), want) <= _tol(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_bandt_with_spill_matches_jax_wrapper(jax_pallas, dtype):
    """The full dispatch: band kernel + peel spill, against the JAX
    package's `spmv_bandt` wrapper on the same form."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    m, W, start, padL = 517, 16, 2, 7
    vt, x = _band(4, W, m, m, dtype)
    sp_rows = np.sort(rng.integers(0, m, 40))
    sp_ind = rng.integers(0, m, 40)
    sp_val = rng.standard_normal(40).astype(dtype)
    want = np.asarray(
        jax_pallas.spmv_bandt(
            jnp.asarray(vt), jnp.asarray(x), jnp.asarray(sp_val),
            jnp.asarray(sp_ind, jnp.int32), jnp.asarray(sp_rows, jnp.int32),
            W=W, padL=padL, start=start, TM=128, interpret=True, has_spill=True,
        )
    )
    got = spmv_bandt(
        torch.from_numpy(vt), torch.from_numpy(x), torch.from_numpy(sp_val),
        torch.from_numpy(sp_ind), torch.from_numpy(sp_rows), start=start, padL=padL,
    )
    assert near_error(got.numpy(), want) <= _tol(dtype)


def test_plain_band_matches_loop_definition():
    """The contract written as a loop, independent of both packages."""
    vt, x = _band(9, 12, 300, 280, np.float64)
    start, padL = 3, 5
    want = np.zeros(300)
    for j in range(12):
        k = np.arange(300) + start + j - padL
        ok = (k >= 0) & (k < 280)
        want[ok] += vt[j, ok] * x[k[ok]]
    got = band_spmv_plain(torch.from_numpy(vt), torch.from_numpy(x), start, padL)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def test_wrapper_rejects_bad_operands():
    from aoclsparse_tpu_torch import AoclSparseError, Status

    vt = torch.zeros(8, 10)
    with pytest.raises(AoclSparseError) as e:
        band_spmv(vt, torch.zeros(10, dtype=torch.float64), 0, 0)
    assert e.value.status == Status.wrong_type
    with pytest.raises(AoclSparseError) as e:
        band_spmv(vt, torch.zeros(20)[::2], 0, 0)
    assert e.value.status == Status.invalid_value
    with pytest.raises(AoclSparseError) as e:
        band_spmv(vt, torch.zeros(10), -1, 0)
    assert e.value.status == Status.invalid_value
    assert band_spmv(torch.zeros(8, 0), torch.zeros(4), 0, 0).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("band", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("m,n,W,start,padL", CASES + [(262144, 262144, 128, 0, 64)])
def test_cuda_kernel_matches_plain(cuda, band, m, n, W, start, padL):
    dt = np.float64 if band == "f64" else np.float32
    vt, x = _band(m + W, W, m, n, dt)
    vt_d = torch.from_numpy(vt).to(cuda)
    if band == "bf16":
        vt_d = vt_d.to(torch.bfloat16)
    x_d = torch.from_numpy(x).to(cuda)
    before = dict(band_spmv.launches)
    got = band_spmv(vt_d, x_d, start, padL)
    torch.cuda.synchronize()
    assert band_spmv.launches[band] == before[band] + 1
    want = band_spmv_plain(vt_d, x_d, start, padL)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= _tol(dt)
