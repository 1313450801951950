"""The SpMM and multi-RHS solve kernels of the PyTorch port against the JAX
package's Pallas kernels.

Each kernel's plain version (the CPU side of kernels/spmm_band.py,
kernels/spmm_diag.py and kernels/trsv_win.py) is held against the Pallas
kernel it replaces, run in interpret mode on identical operands made from a
seed with numpy: `pallas_spmm_band_t`, `pallas_spmm_band_mxu`,
`pallas_spmm_diag` and `pallas_trsm_win_inv`. The CUDA kernels are held
against the plain versions on the card (marked `cuda`, skipped elsewhere).

Tolerance: utils/tolerances.py's model, expected_precision(accumulation
dtype) on max |a - b| / max(|b|, 1): the two sides sum the same products in
another order. bf16 operands are rounded identically (round to nearest
even) by both packages before the f32 accumulation, so they hold the f32
bound too.
"""

import numpy as np
import pytest
import torch

from aoclsparse_tpu_torch import AoclSparseError, Status
from aoclsparse_tpu_torch.kernels.spmm_band import (
    band_max_w,
    band_mxu_blocks,
    spmm_band,
    spmm_band_mxu,
    spmm_band_mxu_plain,
    spmm_band_plain,
)
from aoclsparse_tpu_torch.kernels.spmm_diag import spmm_diag, spmm_diag_plain
from aoclsparse_tpu_torch.kernels.trsv_win import (
    solve_launches,
    trsm_chunk,
    trsm_win,
    trsm_win_plain,
    win_solve_operands,
)
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

F32 = expected_precision(torch.float32)
F64 = expected_precision(torch.float64)


@pytest.fixture(scope="module")
def pallas():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.kernels.pallas import spmv, trsv

    return spmv, trsv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def _band(seed, m, W, n, K, dtype=np.float32):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((m, W)).astype(dtype)
    return v, rng.standard_normal((n, K)).astype(dtype)


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


# m a multiple of no tile; start > 0 and padL > 0 move the window both ways;
# n shorter than the window exercises the zero fill
BAND_CASES = [
    # (m, n, W, start, padL)
    (300, 300, 16, 0, 8),
    (301, 330, 24, 5, 0),
    (257, 250, 40, 3, 11),
]


@pytest.mark.parametrize("m,n,W,start,padL", BAND_CASES)
def test_band_plain_matches_pallas(pallas, m, n, W, start, padL):
    import jax.numpy as jnp

    v, B = _band(m + W, m, W, n, 128)
    Be = jnp.asarray(np.pad(B, ((padL, 0), (0, 0))))
    want = np.asarray(pallas[0].pallas_spmm_band_t(jnp.asarray(v), Be, W, start, TM=64, interpret=True))
    got = spmm_band(*_t(v, B), start, padL)
    assert got.shape == (m, 128) and got.dtype == torch.float32
    assert near_error(got.numpy(), want) <= F32


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,start,padL,K", [(300, 0, 8, 128), (520, 4, 2, 128)])
def test_mxu_plain_matches_pallas(pallas, m, start, padL, K, bf16):
    import jax.numpy as jnp

    W = 24
    v, B = _band(m, m, W, m, K)
    dt_np = pallas[0].band_mxu_blocks(np.ascontiguousarray(v.T), W)
    dt = band_mxu_blocks(torch.from_numpy(v), W)
    np.testing.assert_array_equal(dt.numpy(), dt_np)
    dt_j = jnp.asarray(dt_np, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    Be = jnp.asarray(np.pad(B, ((padL, 0), (0, 0))))
    want = np.asarray(pallas[0].pallas_spmm_band_mxu(dt_j, Be, start, TM=128, interpret=True))[:m]
    got = spmm_band_mxu(dt.to(torch.bfloat16) if bf16 else dt, torch.from_numpy(B), start, padL, m)
    assert got.shape == (m, K) and got.dtype == torch.float32
    assert near_error(got.numpy(), want) <= F32


def _diag_operand(seed, m, n, offs, K, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dv = np.zeros((len(offs), m), dtype)
    for d, off in enumerate(offs):
        i = np.arange(max(0, -off), min(m, n - off))
        dv[d, i] = rng.standard_normal(i.size)
    return dv, rng.standard_normal((n, K)).astype(dtype)


DIAG_CASES = [
    # (m, n, offsets, K): both signs, unaligned; odd m; ragged K
    (900, 900, (-517, -130, -7, -1, 0, 1, 3, 37, 515), 8),
    (701, 650, (-40, -1, 0, 2, 61), 13),
]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n,offs,K", DIAG_CASES)
def test_diag_plain_matches_pallas(pallas, m, n, offs, K, bf16):
    import jax.numpy as jnp

    dv, B = _diag_operand(m + K, m, n, offs, K)
    L = max(0, -min(offs))
    n_pad = max(L + n, L + max(offs) + m)
    tile = pallas[0].diagmm_tiles(max(offs) - min(offs), -(-K // 8) * 8, -(-len(offs) // 8) * 8)
    dv_j = jnp.asarray(dv, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    want = np.asarray(
        pallas[0].pallas_spmm_diag(dv_j, jnp.asarray(B), offs, m, L, n_pad, TMl=tile[0], interpret=True)
    )
    dv_t = torch.from_numpy(dv)
    got = spmm_diag(dv_t.to(torch.bfloat16) if bf16 else dv_t, torch.tensor(offs), torch.from_numpy(B))
    assert got.shape == (m, K) and got.dtype == torch.float32
    assert near_error(got.numpy(), want) <= F32


def _trsm_operands(seed, nblk, nb, WL, K, dtype=np.float32):
    """dinvT = I + small lower-triangular noise (transposed), lwT small: every
    block's map a contraction plus the identity."""
    rng = np.random.default_rng(seed)
    dinv = np.eye(nb) + np.tril(rng.standard_normal((nblk, nb, nb))) * (0.3 / nb)
    dinvT = np.ascontiguousarray(np.swapaxes(dinv, 1, 2)).astype(dtype)
    lwT = (rng.standard_normal((nblk, WL, nb)) * (0.3 / WL)).astype(dtype)
    return dinvT, lwT, rng.standard_normal((nblk * nb, K)).astype(dtype)


@pytest.mark.parametrize("WL,K", [(8, 8), (64, 16), (128, 24)])
def test_trsm_plain_matches_pallas(pallas, WL, K):
    import jax.numpy as jnp

    nblk, nb = 5, 128
    dinvT, lwT, B = _trsm_operands(WL + K, nblk, nb, WL, K)
    Bt = np.ascontiguousarray(B.reshape(nblk, nb, K).swapaxes(1, 2))
    Xt = pallas[1].pallas_trsm_win_inv(
        jnp.asarray(dinvT), jnp.asarray(lwT), jnp.asarray(Bt), nb, WL, interpret=True
    )
    want = np.asarray(Xt).swapaxes(1, 2).reshape(nblk * nb, K)
    got = trsm_win(*_t(dinvT, lwT, B), nb, WL)
    assert got.shape == (nblk * nb, K) and got.dtype == torch.float32
    assert near_error(got.numpy(), want) <= F32


def test_plain_versions_match_loop_definitions():
    """Each contract written as a loop, independent of both packages."""
    m, n, W, K, start, padL = 90, 85, 6, 5, 2, 4
    v, B = _band(1, m, W, n, K, np.float64)
    want = np.zeros((m, K))
    for i in range(m):
        for j in range(W):
            r = start + i + j - padL
            if 0 <= r < n:
                want[i] += v[i, j] * B[r]
    np.testing.assert_allclose(spmm_band_plain(*_t(v, B), start, padL).numpy(), want, rtol=1e-13, atol=1e-13)

    vt = torch.from_numpy(v.astype(np.float32))
    dt = band_mxu_blocks(vt, W)
    got = spmm_band_mxu_plain(dt, torch.from_numpy(B.astype(np.float32)), start, padL, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    offs = (-3, 0, 4)
    dv, B2 = _diag_operand(2, m, n, offs, K, np.float64)
    want = np.zeros((m, K))
    for d, off in enumerate(offs):
        for i in range(m):
            if 0 <= i + off < n:
                want[i] += dv[d, i] * B2[i + off]
    got = spmm_diag_plain(*_t(dv), torch.tensor(offs), torch.from_numpy(B2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)

    nblk, nb, WL = 6, 8, 20
    dinvT, lwT, B3 = _trsm_operands(3, nblk, nb, WL, 3, np.float64)
    X = np.zeros_like(B3)
    for k in range(nblk):
        blk0 = k * nb
        w = np.stack([X[blk0 - WL + t] if blk0 - WL + t >= 0 else np.zeros(3) for t in range(WL)])
        X[blk0 : blk0 + nb] = dinvT[k].T @ (B3[blk0 : blk0 + nb] - lwT[k].T @ w)
    np.testing.assert_allclose(trsm_win_plain(*_t(dinvT, lwT, B3), nb, WL).numpy(), X, rtol=1e-13, atol=1e-13)


def test_wrappers_reject_bad_operands():
    def status(fn, *args):
        with pytest.raises(AoclSparseError) as e:
            fn(*args)
        return e.value.status

    v, B = torch.zeros(10, 8), torch.zeros(12, 4)
    assert status(spmm_band, v, B.double(), 0, 0) == Status.wrong_type
    assert status(spmm_band, v.half(), B.half(), 0, 0) == Status.wrong_type
    assert status(spmm_band, v, B[:, ::2], 0, 0) == Status.invalid_value
    assert status(spmm_band, v, B, -1, 0) == Status.invalid_value
    assert status(spmm_band, torch.zeros(4, band_max_w(torch.float64) + 8).double(), B.double(), 0, 0) == (
        Status.invalid_size
    )
    assert status(spmm_band_mxu, torch.zeros(1, 256, 64), B, 0, 0, 100) == Status.invalid_size
    assert status(spmm_band_mxu, torch.zeros(1, 256, 128), B, 0, 0, 200) == Status.invalid_size
    assert status(spmm_band_mxu, torch.zeros(1, 256, 128).double(), B.double(), 0, 0, 100) == Status.wrong_type
    assert status(band_mxu_blocks, torch.zeros(10, 136), 136) == Status.invalid_size
    assert status(spmm_diag, torch.zeros(2, 10), torch.tensor([0, 1], dtype=torch.int32), B) == Status.wrong_type
    assert status(spmm_diag, torch.zeros(2, 10), torch.tensor([0]), B) == Status.invalid_size
    dinvT, lwT = torch.zeros(2, 8, 8), torch.zeros(2, 8, 8)
    assert status(trsm_win, dinvT, lwT, torch.zeros(16), 8, 8) == Status.invalid_size
    assert status(trsm_win, dinvT, lwT, torch.zeros(15, 3), 8, 8) == Status.invalid_size
    assert status(trsm_win, dinvT, lwT, torch.zeros(16, 3).double(), 8, 8) == Status.wrong_type
    assert status(trsm_win, torch.zeros(1, 520, 520), torch.zeros(1, 8, 520), torch.zeros(520, 2), 520, 8) == (
        Status.invalid_size
    )
    wide = 60000  # (WL + nb) values > one block's shared memory even at one column
    assert status(trsm_win, torch.zeros(1, 8, 8), torch.zeros(1, wide, 8), torch.zeros(8, 2), 8, wide) == (
        Status.invalid_size
    )
    assert spmm_band(torch.zeros(0, 8), B, 0, 0).shape == (0, 4)
    assert spmm_diag(torch.zeros(0, 5), torch.zeros(0, dtype=torch.int64), torch.zeros(5, 3)).abs().sum() == 0


def test_trsm_chunk_fits_shared_memory():
    assert trsm_chunk(16, 256, 64, 4) == 16
    assert trsm_chunk(300, 256, 64, 8) == 16
    assert trsm_chunk(3, 256, 64, 4) == 4
    assert trsm_chunk(1, 256, 64, 4) == 1
    assert trsm_chunk(16, 512, 64, 4) == 16
    # 8320 rows of 1 value fit in f64; of 4 values (2 columns padded by a vector) they do not
    assert trsm_chunk(16, 128, 8192, 8) == 1
    # the chain takes at most 2 of a chunk's columns a CTA: its window rows
    # of 3 values (98,304 bytes) fit beside its stages, pass A's 128 rows of 12
    assert trsm_chunk(5, 128, 8192, 4) == 8
    assert trsm_chunk(16, 8, 60000, 4) == 0


# ---- on the card: each kernel against its plain version ---------------------


def _check_launch(counts, name, fn):
    before = counts[name]
    got = fn()
    torch.cuda.synchronize()
    assert counts[name] == before + 1
    return got


# W = "cap" is band_max_w of the dtype (400 f32, 184 f64); W = 1; K = 1, 7
# and 300 (several column chunks); m = 90 below one 128-row tile
CUDA_BAND_CASES = [c + (64,) for c in BAND_CASES] + [
    (4099, 4000, 184, 7, 90, 7),
    (262144, 262144, 128, 0, 64, 64),
    (300, 300, 1, 0, 0, 1),
    (1000, 1000, 1, 3, 2, 300),
    (5000, 5000, "cap", 0, 200, 64),
    (2000, 2100, "cap", 9, 13, 7),
    (90, 100, 33, 2, 5, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,W,start,padL,K", CUDA_BAND_CASES)
def test_cuda_band_matches_plain(cuda, dtype, m, n, W, start, padL, K):
    """Against the plain version, and the same bits on a second call."""
    if W == "cap":
        W = band_max_w(torch.from_numpy(np.zeros(0, dtype)).dtype)
    v, B = _t(*_band(m + W, m, W, n, K, dtype), device=cuda)
    name = "f64" if dtype == np.float64 else "f32"
    got = _check_launch(spmm_band.launches, name, lambda: spmm_band(v, B, start, padL))
    want = spmm_band_plain(v, B, start, padL)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= (F64 if name == "f64" else F32)
    assert torch.equal(spmm_band(v, B, start, padL), got)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,start,padL,K", [(300, 0, 8, 64), (1001, 4, 70, 9), (262144, 0, 64, 64)])
def test_cuda_mxu_matches_plain(cuda, bf16, m, start, padL, K):
    v, B = _t(*_band(m, m, 128, m, K), device=cuda)
    dt = band_mxu_blocks(v, 128)
    if bf16:
        dt = dt.to(torch.bfloat16)
    name = "bf16" if bf16 else "f32"
    got = _check_launch(spmm_band_mxu.launches, name, lambda: spmm_band_mxu(dt, B, start, padL, m))
    want = spmm_band_mxu_plain(dt, B, start, padL, m)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= F32


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,m,start,padL,K", [(1, 300, 0, 8, 64), (64, 1001, 4, 70, 9), (128, 645, 11, 70, 24),
                                              (129, 513, 0, 64, 70), (128, 262144, 0, 64, 64)])
def test_cuda_mxu_band_width_matches_plain(cuda, bf16, W, m, start, padL, K):
    """The block-window kernel told the windows' band width W: it reads and
    multiplies only the window rows that meet a warp's bands (W = 1, 64,
    128, 129; K off a multiple of 4 takes its 4-byte B copies), and W = 256
    gives the same result."""
    v, B = _t(*_band(m + W, m, W, m, K), device=cuda)
    dt = band_mxu_blocks(v, W)
    if bf16:
        dt = dt.to(torch.bfloat16)
    name = "bf16" if bf16 else "f32"
    got = _check_launch(spmm_band_mxu.launches, name, lambda: spmm_band_mxu(dt, B, start, padL, m, W))
    want = spmm_band_mxu_plain(dt, B, start, padL, m)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= F32
    assert torch.equal(spmm_band_mxu(dt, B, start, padL, m, W), got)
    assert near_error(spmm_band_mxu(dt, B, start, padL, m, 256).cpu().numpy(), want.cpu().numpy()) <= F32


STENCIL12 = tuple((dz * 12 + dy) * 12 + dx for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
# the 12^3 27-point stencil (odd m, K = 1 and 13); 192 diagonals; a lone
# far diagonal; offsets past +-n; K = 300 (several column chunks)
CUDA_DIAG_CASES = DIAG_CASES + [
    (20000, 20000, (-10101, -101, -100, -99, -1, 0, 1, 99, 100, 101, 10101), 64),
    (1728, 1728, STENCIL12, 13),
    (1727, 1728, STENCIL12, 1),
    (5000, 5000, tuple(range(-96, 96)), 64),
    (2000, 2000, (-1, 0, 1, 1900), 300),
    (1999, 1500, (-3000, -1, 0, 5, 2500), 7),
]


@pytest.mark.cuda
@pytest.mark.parametrize("inst", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("m,n,offs,K", CUDA_DIAG_CASES)
def test_cuda_diag_matches_plain(cuda, inst, m, n, offs, K):
    """Against the plain version, and the same bits on a second call (with
    the static offsets the diag form passes)."""
    dt = np.float64 if inst == "f64" else np.float32
    dv, B = _t(*_diag_operand(m, m, n, offs, K, dt), device=cuda)
    if inst == "bf16":
        dv = dv.to(torch.bfloat16)
    od = torch.tensor(offs, device=cuda)
    got = _check_launch(spmm_diag.launches, inst, lambda: spmm_diag(dv, od, B))
    want = spmm_diag_plain(dv, od, B)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= (F64 if inst == "f64" else F32)
    assert torch.equal(spmm_diag(dv, od, B, offs_static=offs), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "nblk,nb,WL,K",
    [(13, 128, 64, 16), (11, 64, 200, 300), (5, 100, 8, 3), (7, 128, 8192, 5), (64, 256, 64, 16), (4, 512, 40, 9)],
)
def test_cuda_trsm_matches_plain(cuda, dtype, nblk, nb, WL, K):
    dinvT, lwT, B = _t(*_trsm_operands(nblk + WL + K, nblk, nb, WL, K, dtype), device=cuda)
    ops = win_solve_operands(dinvT, lwT, nb, WL)
    name = "f64" if dtype == np.float64 else "f32"
    before = trsm_win.launches[name]
    got = trsm_win(dinvT, lwT, B, nb, WL, ops)
    torch.cuda.synchronize()
    # pass A, the chain (grouped: pass L, the group chain, the fix-up) and,
    # where a block has rows outside the chain's, pass C
    assert trsm_win.launches[name] == before + solve_launches(nblk, nb, WL)
    assert torch.equal(trsm_win(dinvT, lwT, B, nb, WL, ops), got)
    want = trsm_win_plain(dinvT, lwT, B, nb, WL)
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= (F64 if name == "f64" else F32)
