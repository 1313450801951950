"""Window solve of the PyTorch port against the JAX package's solve kernels.

The port's plain version (the CPU side of kernels/trsv_win.py) is held
against `pallas_trsv_win_inv8` and `pallas_trsv_win_inv` run in interpret
mode, and against the XLA `trsv_blocked_win_inv` in float64 (which also
takes WL > nb), on identical operands made from a seed with numpy. The CUDA
kernels (passes over dinvT and the card operands P = lwT @ dinvT and F) are held against the
plain version on the card (marked `cuda`, skipped elsewhere).

Tolerance: utils/tolerances.py's model, expected_precision(dtype) on
max |a - b| / max(|b|, 1): the same products summed in another order. The
operands keep every block's map a contraction plus the identity, so the
chained blocks do not amplify rounding.
"""

import numpy as np
import pytest
import torch

from aoclsparse_tpu_torch import AoclSparseError, Status
from aoclsparse_tpu_torch.kernels.trsv_win import (
    MAX_NB,
    solve_launches,
    trsv_win,
    trsv_win_plain,
    win_solve_operands,
)
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error


@pytest.fixture(scope="module")
def jax_trsv():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.kernels.pallas import trsv as pallas_trsv
    from aoclsparse_tpu.kernels.xla import trsv as xla_trsv

    return pallas_trsv, xla_trsv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def _operands(seed, nblk, nb, WL, dtype=np.float32):
    """dinvT = I + small lower-triangular noise (transposed), lwT small."""
    rng = np.random.default_rng(seed)
    dinv = np.eye(nb) + np.tril(rng.standard_normal((nblk, nb, nb))) * (0.3 / nb)
    dinvT = np.ascontiguousarray(np.swapaxes(dinv, 1, 2)).astype(dtype)
    lwT = (rng.standard_normal((nblk, WL, nb)) * (0.3 / WL)).astype(dtype)
    b = rng.standard_normal(nblk * nb).astype(dtype)
    return dinvT, lwT, b


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("nblk", [8, 16])
@pytest.mark.parametrize("WL", [8, 64, 128])
@pytest.mark.parametrize("kernel", ["pallas_trsv_win_inv8", "pallas_trsv_win_inv"])
def test_plain_matches_pallas(jax_trsv, kernel, WL, nblk):
    import jax.numpy as jnp

    nb = 128
    dinvT, lwT, b = _operands(WL + nblk, nblk, nb, WL)
    fn = getattr(jax_trsv[0], kernel)
    want = np.asarray(fn(jnp.asarray(dinvT), jnp.asarray(lwT), jnp.asarray(b), nb, WL, interpret=True))
    got = trsv_win(*_t(dinvT, lwT, b), nb, WL)
    assert got.dtype == torch.float32 and got.shape == (nblk * nb,)
    assert near_error(got.numpy(), want) <= expected_precision(torch.float32)


@pytest.mark.parametrize("nblk,nb,WL", [(7, 16, 8), (9, 16, 40), (5, 32, 32), (6, 8, 64)])
def test_plain_f64_matches_xla_win_inv(jax_trsv, nblk, nb, WL):
    """float64, including windows that reach back over several blocks."""
    import jax.numpy as jnp

    dinvT, lwT, b = _operands(nb * WL + nblk, nblk, nb, WL, np.float64)
    dinv = np.swapaxes(dinvT, 1, 2)
    lwin = np.swapaxes(lwT, 1, 2)
    want = np.asarray(
        jax_trsv[1].trsv_blocked_win_inv(jnp.asarray(dinv), jnp.asarray(lwin), jnp.asarray(b), nb, nblk * nb, WL)
    )
    got = trsv_win(*_t(dinvT, lwT, b), nb, WL)
    assert near_error(got.numpy(), want) <= 1e-12


def test_plain_matches_loop_definition():
    """The contract written out row by row, independent of both packages:
    x[blk0 + c] = sum_r (b[blk0 + r] - sum_t x[blk0 - WL + t] lwT[k, t, r]) dinvT[k, r, c]."""
    nblk, nb, WL = 6, 8, 20
    dinvT, lwT, b = _operands(3, nblk, nb, WL, np.float64)
    x = np.zeros(nblk * nb)
    for k in range(nblk):
        blk0 = k * nb
        w = np.array([x[blk0 - WL + t] if blk0 - WL + t >= 0 else 0.0 for t in range(WL)])
        x[blk0 : blk0 + nb] = (b[blk0 : blk0 + nb] - w @ lwT[k]) @ dinvT[k]
    got = trsv_win_plain(*_t(dinvT, lwT, b), nb, WL)
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-13, atol=1e-13)


def test_wrapper_rejects_bad_operands():
    dinvT, lwT, b = _t(*_operands(0, 3, 8, 8))

    def status(*args):
        with pytest.raises(AoclSparseError) as e:
            trsv_win(*args)
        return e.value.status

    assert status(dinvT.double(), lwT, b, 8, 8) == Status.wrong_type
    assert status(dinvT.half(), lwT.half(), b.half(), 8, 8) == Status.wrong_type
    assert status(dinvT, lwT, b[:-1], 8, 8) == Status.invalid_size
    assert status(dinvT, lwT, b, 8, 16) == Status.invalid_size
    assert status(dinvT[:, :, :4], lwT, b, 8, 8) == Status.invalid_size
    assert status(dinvT.transpose(1, 2), lwT, b, 8, 8) == Status.invalid_value
    big = MAX_NB + 32
    assert status(torch.zeros(1, big, big), torch.zeros(1, 8, big), torch.zeros(big), big, 8) == Status.invalid_size
    wide = 60000  # (WL + nb) * 4 bytes > one block's shared memory
    assert status(torch.zeros(1, 8, 8), torch.zeros(1, wide, 8), torch.zeros(8), 8, wide) == Status.invalid_size
    assert trsv_win(torch.zeros(0, 8, 8), torch.zeros(0, 8, 8), torch.zeros(0), 8, 8).shape == (0,)


# odd nblk; WL < nb, WL = nb, WL > nb (several blocks back); nb not a
# multiple of 32; the ILU0 factors' shape at the bench size; and the
# planner's widest window (dynamic shared memory above 48 KB in f64)
CUDA_CASES = [
    # (nblk, nb, WL)
    (13, 128, 64),
    (9, 128, 128),
    (11, 64, 200),
    (5, 100, 8),
    (1024, 256, 64),
    (67, 128, 8192),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nblk,nb,WL", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda, dtype, nblk, nb, WL):
    dinvT, lwT, b = _t(*_operands(nblk + WL, nblk, nb, WL, dtype), device=cuda)
    ops = win_solve_operands(dinvT, lwT, nb, WL)
    name = "f64" if dtype == np.float64 else "f32"
    before = trsv_win.launches[name]
    got = trsv_win(dinvT, lwT, b, nb, WL, ops)
    torch.cuda.synchronize()
    # pass A, the chain (grouped: pass L, the group chain, the fix-up) and,
    # where a block has rows outside the chain's, pass C
    assert trsv_win.launches[name] == before + solve_launches(nblk, nb, WL)
    assert torch.equal(trsv_win(dinvT, lwT, b, nb, WL, ops), got)
    want = trsv_win_plain(dinvT, lwT, b, nb, WL)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= expected_precision(tdt)
    with pytest.raises(AoclSparseError) as e:
        trsv_win(dinvT, lwT, b, nb, WL)  # the card's passes read ops
    assert e.value.status == Status.invalid_value
