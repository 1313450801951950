"""Plan-time construction of the spill-route engine (planner/spill_route.py)
against the JAX package's, and the striped whole-matrix route against scipy.

The operand arrays of a SpillRoute (select and accumulate tiles, the route's
outer masks and packed subnetworks) equal the JAX planner's array for
array. Applies run the kernels' plain versions here; the JAX side runs its
Pallas kernels in interpret mode.

The striped route's apply differs from the JAX package's on purpose: each
stripe adds into its own rows of one zero vector, so 1024-row blocks with no
entries between or after the stripes keep their place. Its test is held
against a float64 scipy CSR product, not against JAX.

Tolerance: the accumulate sums each row in another order than the JAX
package's one-hot contraction, so utils/tolerances.py's f32 model,
expected_precision(float32) on max |a - b| / max(|b|, 1).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from aoclsparse_tpu_torch.planner.spill_route import (
    build_spill_route,
    build_striped_route,
    spill_route_apply,
    striped_route_apply,
)
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

F32 = expected_precision(torch.float32)
ARRAYS = ("sel_idx", "sel_val", "sel_blk", "acc_idx", "acc_blk", "acc_cid", "masks", "masks_packed")
STATICS = ("k", "n", "nxblk", "nyblk", "n_sel_tiles", "n_acc_tiles", "m_pad")


@pytest.fixture(scope="module")
def jsr():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.planner import spill_route

    return spill_route


def _triplets(seed, m_pad, P, n_x=None, rows_from=0):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(rows_from, m_pad, P))
    return rows, rng.integers(0, n_x or m_pad, P), rng.standard_normal(P).astype(np.float32)


def _assert_same_route(port, jax_sr):
    for key in STATICS:
        assert getattr(port, key) == getattr(jax_sr, key), key
    for key in ARRAYS:
        a, b = getattr(port, key), getattr(jax_sr, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b), err_msg=key)


# (m_pad, P, n_x, rows_from): square spill; ragged x with untouched leading y
# blocks; more than 2^13 slots (k = 14 and up)
CASES = [(8192, 3000, None, 0), (6000, 2500, 5003, 2100), (40000, 9000, 50000, 0)]


@pytest.mark.parametrize("case", CASES)
def test_build_spill_route_equals_jax(jsr, case):
    m_pad, P, n_x, rows_from = case
    rows, cols, vals = _triplets(10, m_pad, P, n_x, rows_from)
    port = build_spill_route(rows, cols, torch.from_numpy(vals), m_pad, n_pad_x=n_x)
    _assert_same_route(port, jsr.build_spill_route(rows, cols, vals, m_pad, n_pad_x=n_x))
    # the derived first-chunk map agrees with the monotone block list
    blk = port.acc_blk.numpy()
    np.testing.assert_array_equal(port.acc_start.numpy(), np.searchsorted(blk, np.arange(port.nyblk + 1)))


@pytest.mark.parametrize("case", CASES[:2])
def test_spill_route_apply_and_refresh_match_jax(jsr, case):
    m_pad, P, n_x, rows_from = case
    rows, cols, vals = _triplets(11, m_pad, P, n_x, rows_from)
    rng = np.random.default_rng(12)
    xp = rng.standard_normal(n_x or m_pad).astype(np.float32)
    yp = rng.standard_normal(m_pad).astype(np.float32)
    port = build_spill_route(rows, cols, torch.from_numpy(vals), m_pad, n_pad_x=n_x)
    jax_sr = jsr.build_spill_route(rows, cols, vals, m_pad, n_pad_x=n_x)
    for scale in (1.0, -2.0):
        if scale != 1.0:  # update_values: the values rescatter through the slot map
            port.refresh(torch.from_numpy(vals * scale))
            jax_sr.refresh(vals * scale)
            _assert_same_route(port, jax_sr)
        got = spill_route_apply(torch.from_numpy(xp), torch.from_numpy(yp), port).numpy()
        want = np.asarray(jsr.spill_route_apply(xp, yp, jax_sr.ops(), jax_sr.statics(), interpret=True))
        ref = yp.astype(np.float64)
        np.add.at(ref, rows, scale * vals.astype(np.float64) * xp.astype(np.float64)[cols])
        assert near_error(got, want) <= F32
        assert near_error(got, ref) <= F32


def _blocky_operand(seed, m=9000, n=7000):
    """Entries confined to the 1024-row blocks 1, 2, 4 and 6 (blocks 0, 3
    and 5 empty), then empty rows from 7168 on: (scipy CSR f32 values)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(b * 1024, (b + 1) * 1024, 1500) for b in (1, 2, 4, 6)])
    cols = rng.integers(0, n, rows.size)
    S = sp.csr_matrix((rng.standard_normal(rows.size).astype(np.float32), (rows, cols)), shape=(m, n))
    S.sum_duplicates()
    S.sort_indices()
    return S


def _striped(S, **kw):
    m, n = S.shape
    rows = np.repeat(np.arange(m), np.diff(S.indptr))
    return build_striped_route(rows, S.indices.astype(np.int64), torch.from_numpy(S.data),
                               m_pad=-(-m // 1024) * 1024, n_pad_x=-(-n // 1024) * 1024, **kw)


@pytest.mark.parametrize("target_slots", [1024, 2048, 1 << 19])
def test_striped_route_keeps_empty_blocks_in_place(target_slots):
    """Stripes over blocks with empty neighbours and a trailing empty tail:
    every row lands where it belongs (held against float64 scipy)."""
    S = _blocky_operand(20)
    route = _striped(S, target_slots=target_slots, threads=2)
    assert route.row_hi[-1] < S.shape[0]  # an empty tail after the last stripe
    if target_slots < 1 << 19:  # stripes with an empty block between them
        assert any(lo > hi for hi, lo in zip(route.row_hi, route.row_lo[1:]))
    x = np.random.default_rng(21).standard_normal(S.shape[1]).astype(np.float32)
    got = striped_route_apply(torch.from_numpy(x), route)[: S.shape[0]].numpy()
    ref = S.astype(np.float64) @ x.astype(np.float64)
    assert near_error(got, ref) <= F32
    # update_values: every stripe refreshes from its range of the values
    route.refresh(torch.from_numpy(S.data * 3.0))
    got = striped_route_apply(torch.from_numpy(x), route)[: S.shape[0]].numpy()
    assert near_error(got, 3.0 * ref) <= F32


def test_striped_route_stripes_equal_jax(jsr):
    """The stripes themselves are built as the JAX package builds them."""
    S = _blocky_operand(22)
    route = _striped(S, target_slots=2048, threads=1)
    m, n = S.shape
    rows = np.repeat(np.arange(m), np.diff(S.indptr))
    jr = jsr.build_striped_route(rows, S.indices.astype(np.int64), S.data, m_pad=-(-m // 1024) * 1024,
                                 n_pad_x=-(-n // 1024) * 1024, target_slots=2048, threads=1)
    assert route.row_lo == jr.row_lo and route.row_hi == jr.row_hi and route.m == jr.m
    assert [(int(a[0]), int(a[-1]) + 1) for a in jr._val_src] == route._val_src
    for port, jax_sr in zip(route.stripes, jr.stripes):
        _assert_same_route(port, jax_sr)
