"""The spill-route engine's kernels of the PyTorch port against the JAX
package's Pallas kernels.

Each kernel's plain version (the CPU side of kernels/spill_route.py and
kernels/benes.py) is held against the Pallas kernel it replaces, run in
interpret mode on the JAX planner's own operands (carried across as numpy by
interop.spill_route_from_jax): `pallas_oh_select`, `pallas_oh_accum` and
`pallas_benes_apply`. The CUDA kernels are held against the plain versions
on the card (marked `cuda`, skipped elsewhere).

Tolerances:
- the route moves values and does no arithmetic: bit-equal everywhere;
- the select is one f32 multiply a slot (the Pallas kernel pins HIGHEST
  precision so its one-hot pick is exact): bit-equal;
- the accumulate sums a row's contributions in another order than the
  one-hot contraction (on the card, a segmented scan of each run of equal
  rows): utils/tolerances.py's f32 model, expected_precision(float32) on
  max |a - b| / max(|b|, 1).
"""

import dataclasses

import numpy as np
import pytest
import torch

from aoclsparse_tpu_torch import native
from aoclsparse_tpu_torch.interop import spill_route_from_jax
from aoclsparse_tpu_torch.kernels import route as troute
from aoclsparse_tpu_torch.kernels.benes import benes_apply, benes_apply_plain, benes_route, benes_route_plain, route_passes
from aoclsparse_tpu_torch.kernels.spill_route import oh_accum, oh_accum_plain, oh_select, oh_select_plain
from aoclsparse_tpu_torch.planner.spill_route import build_spill_route, spill_route_apply
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

F32 = expected_precision(torch.float32)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu import native as jnative
    from aoclsparse_tpu.kernels.pallas import route_fused, spill_route
    from aoclsparse_tpu.kernels.xla import route
    from aoclsparse_tpu.planner import spill_route as jsr

    return dict(native=jnative, route_fused=route_fused, pallas=spill_route, route=route, planner=jsr)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def _jax_route_arrays(sr) -> dict:
    """A JAX SpillRoute's fields as numpy (None and ints kept)."""
    out = {}
    for f in dataclasses.fields(sr):
        v = getattr(sr, f.name)
        out[f.name] = v if v is None or isinstance(v, (int, np.dtype)) else np.asarray(v)
    return out


def _triplets(seed, m_pad, P, n_x=None, rows_from=0):
    """Random (rows, cols, vals f32) of P entries: rows in [rows_from, m_pad),
    cols in [0, n_x)."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(rows_from, m_pad, P))
    cols = rng.integers(0, n_x or m_pad, P)
    return rows, cols, rng.standard_normal(P).astype(np.float32)


# (m_pad, P, n_x, rows_from): a ragged x end (n_x not a multiple of 1024),
# untouched leading y blocks, a several-chunk x block
ROUTE_CASES = [(8192, 3000, None, 0), (6000, 2500, 5003, 2100), (4096, 6000, 1500, 0)]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_select_plain_matches_pallas(jx, case):
    m_pad, P, n_x, rows_from = case
    rows, cols, vals = _triplets(1, m_pad, P, n_x, rows_from)
    jsr = jx["planner"].build_spill_route(rows, cols, vals, m_pad, n_pad_x=n_x)
    sr = spill_route_from_jax(_jax_route_arrays(jsr), device="cpu")
    n = n_x or m_pad
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    x3 = np.pad(x, (0, jsr.nxblk * 1024 - n)).reshape(jsr.nxblk, 8, 128)
    want = np.asarray(jx["pallas"].pallas_oh_select(x3, jsr.sel_idx, jsr.sel_val, jsr.sel_blk, interpret=True))
    got = oh_select(torch.from_numpy(x), sr.sel_idx, sr.sel_val, sr.sel_blk, n_out=sr.n)
    np.testing.assert_array_equal(got[: want.size].numpy(), want.reshape(-1))
    assert not got[want.size :].any()  # the route's padding slots


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_accum_plain_matches_pallas(jx, case):
    m_pad, P, n_x, rows_from = case
    rows, cols, vals = _triplets(3, m_pad, P, n_x, rows_from)
    jsr = jx["planner"].build_spill_route(rows, cols, vals, m_pad, n_pad_x=n_x)
    sr = spill_route_from_jax(_jax_route_arrays(jsr), device="cpu")
    rng = np.random.default_rng(4)
    contrib = rng.standard_normal(jsr.n).astype(np.float32)
    y = rng.standard_normal(m_pad).astype(np.float32)
    ctiles = np.concatenate(
        [contrib[: jsr.n_acc_tiles * 1024].reshape(-1, 8, 128), np.zeros((1, 8, 128), np.float32)]
    )
    y3 = np.pad(y, (0, jsr.nyblk * 1024 - m_pad)).reshape(jsr.nyblk, 8, 128)
    want = np.asarray(
        jx["pallas"].pallas_oh_accum(ctiles, jsr.acc_idx, jsr.acc_blk, jsr.acc_cid, y3, interpret=True)
    ).reshape(-1)[:m_pad]
    got = oh_accum(torch.from_numpy(contrib), sr.acc_idx, sr.acc_cid, sr.acc_start, sr.n_acc_tiles,
                   torch.from_numpy(y))
    assert near_error(got.numpy(), want) <= F32


@pytest.mark.parametrize("k", [7, 8, 10])
def test_benes_plain_matches_pallas(jx, k):
    rng = np.random.default_rng(k)
    n = 1 << k
    src = rng.permutation(n)
    packed = troute.pack_masks(native.benes_plan(k, src))
    v = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jx["route_fused"].pallas_benes_apply(v, packed, k, interpret=True))
    got = benes_route(torch.from_numpy(v), torch.from_numpy(packed), k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), v[src])


@pytest.mark.parametrize("k", [1, 2, 5, 7, 10])
def test_benes_routes_random_permutations(k):
    """The C++ plan and the numpy plan each route out[j] = in[src[j]], through
    the stage loop and through apply_route's split."""
    rng = np.random.default_rng(100 + k)
    n = 1 << k
    src = rng.permutation(n)
    v = torch.arange(n, dtype=torch.float32)
    for masks in (native.benes_plan(k, src), native._benes_numpy(k, src.astype(np.int64),
                                                                    np.empty((2 * k - 1, n), np.uint8))):
        np.testing.assert_array_equal(troute.apply_benes(v, torch.from_numpy(masks), k).numpy(), src)
        outer, packed = troute.plan_route_arrays(k, masks)
        t = (lambda a: None if a is None else torch.from_numpy(a))
        np.testing.assert_array_equal(troute.apply_route(v, t(outer), t(packed), k).numpy(), src)


def test_host_plans_equal_jax(jx):
    """rcm_permutation and benes_plan come from the same C++ in both
    packages: the same outputs; the numpy plain versions agree with them."""
    rng = np.random.default_rng(5)
    m, half = 3000, 12
    rows = np.repeat(np.arange(m), 2 * half + 1)
    cols = rows + rng.integers(-half, half + 1, rows.size)
    ok = (cols >= 0) & (cols < m)
    p = rng.permutation(m)
    r2, c2 = p[rows[ok]], p[cols[ok]]
    order = np.lexsort((c2, r2))
    r2, c2 = r2[order], c2[order]
    ptr = np.cumsum(np.r_[0, np.bincount(r2, minlength=m)])
    perm, bw = native.rcm_permutation(m, ptr, c2)
    jperm, jbw = jx["native"].rcm_permutation(m, ptr, c2)
    np.testing.assert_array_equal(perm, jperm)
    assert bw == jbw <= 6 * half
    nperm, nbw = native._rcm_numpy(m, ptr, c2)
    jnperm, jnbw = jx["native"]._rcm_numpy(m, ptr, c2)
    np.testing.assert_array_equal(nperm, jnperm)
    assert nbw == jnbw <= 6 * half
    for k in (6, 9):
        src = rng.permutation(1 << k)
        np.testing.assert_array_equal(native.benes_plan(k, src), jx["native"].benes_plan(k, src))
        empty = np.empty((2 * k - 1, 1 << k), np.uint8)
        np.testing.assert_array_equal(
            native._benes_numpy(k, src.astype(np.int64), empty.copy()),
            jx["native"]._benes_numpy(k, src.astype(np.int64), empty.copy()),
        )


@pytest.mark.parametrize("k", [8, 9])
def test_route_split_beyond_fused_cap(jx, monkeypatch, k):
    """With the fused cap lowered to 7 in both packages, a k > 7 route splits
    into outer stages and 2^(k-7) packed subnetworks: the same arrays as
    JAX's, and the same routed values as JAX's staged apply."""
    monkeypatch.setattr(jx["route_fused"], "FUSED_MAX_K", 7)
    monkeypatch.setattr(troute, "FUSED_MAX_K", 7)
    rng = np.random.default_rng(200 + k)
    n = 1 << k
    src = rng.permutation(n)
    masks = native.benes_plan(k, src)
    outer, packed = troute.plan_route_arrays(k, masks)
    jouter, jpacked = jx["route"].plan_route_arrays(k, masks)
    np.testing.assert_array_equal(outer, jouter)
    np.testing.assert_array_equal(packed, jpacked)
    assert packed.shape[0] == 1 << (k - 7)
    np.testing.assert_array_equal(troute.route_masks(torch.from_numpy(outer), torch.from_numpy(packed), k).numpy(),
                                  masks)
    v = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jx["route"].apply_route(v, jouter, jpacked, k, interpret=True))
    got = troute.apply_route(torch.from_numpy(v), torch.from_numpy(outer), torch.from_numpy(packed), k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), v[src])


def test_wrappers_refuse_bad_operands():
    from aoclsparse_tpu_torch import AoclSparseError, Status

    v = torch.zeros(256)
    with pytest.raises(AoclSparseError) as e:
        benes_route(v, torch.zeros((1, 256), dtype=torch.uint8), 8)  # 15 stages need 2 packed rows
    assert e.value.status == Status.invalid_size
    with pytest.raises(AoclSparseError) as e:
        benes_route(v.double(), torch.zeros((2, 256), dtype=torch.uint8), 8)
    assert e.value.status == Status.wrong_type
    with pytest.raises(AoclSparseError) as e:
        oh_select(v, torch.zeros((1, 8, 128), dtype=torch.int64), torch.zeros((1, 8, 128)),
                  torch.zeros(1, dtype=torch.int32))
    assert e.value.status == Status.wrong_type


# -- on the card: each kernel against its plain version -----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROUTE_CASES)
def test_cuda_select_and_accum_match_plain(cuda, case):
    m_pad, P, n_x, rows_from = case
    rows, cols, vals = _triplets(6, m_pad, P, n_x, rows_from)
    sr = build_spill_route(rows, cols, torch.from_numpy(vals).to(cuda), m_pad, n_pad_x=n_x)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(n_x or m_pad).astype(np.float32)).to(cuda)
    got = oh_select(x, sr.sel_idx, sr.sel_val, sr.sel_blk, n_out=sr.n)
    want = oh_select_plain(x, sr.sel_idx, sr.sel_val, sr.sel_blk, sr.n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    y = torch.from_numpy(np.random.default_rng(8).standard_normal(m_pad).astype(np.float32)).to(cuda)
    contrib = torch.from_numpy(np.random.default_rng(9).standard_normal(sr.n).astype(np.float32)).to(cuda)
    got = oh_accum(contrib, sr.acc_idx, sr.acc_cid, sr.acc_start, sr.n_acc_tiles, y)
    want = oh_accum_plain(contrib, sr.acc_idx, sr.acc_cid, sr.acc_start, sr.n_acc_tiles, y)
    torch.cuda.synchronize()
    assert near_error(got.cpu().numpy(), want.cpu().numpy()) <= F32
    # the whole engine against float64 numpy
    out = spill_route_apply(x, y, sr)
    ref = y.double().cpu().numpy().copy()
    np.add.at(ref, rows, vals.astype(np.float64) * x.double().cpu().numpy()[cols])
    assert near_error(out.cpu().numpy(), ref) <= F32


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 12, 13, 16, 20])
def test_cuda_benes_matches_plain(cuda, k):
    """k <= 13: one tile pass; k > 13: passes A and C around it (three
    launches); in place too; and a split plan through the same entry."""
    rng = np.random.default_rng(300 + k)
    n = 1 << k
    src = rng.permutation(n)
    masks = native.benes_plan(k, src)
    packed = torch.from_numpy(troute.pack_masks(masks)).to(cuda)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    c0 = benes_route.launches["f32"]
    got = benes_route(v, packed, k)
    want = benes_route_plain(v, packed, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), v.cpu()[torch.from_numpy(src)])
    assert benes_route.launches["f32"] - c0 == len(route_passes(k)) == (1 if k <= 13 else 3)
    # in place
    w = v.clone()
    benes_route(w, packed, k, out=w)
    assert torch.equal(w, want)
    # the same permutation split as a k > FUSED_MAX_K plan: outer stages and
    # two packed subnetworks, in one entry
    if k >= 8:
        d = 1
        outer = np.concatenate([masks[:d], masks[2 * k - 1 - d :]])
        mid = masks[d : 2 * k - 1 - d]
        sub = np.stack([troute.pack_masks(mid[:, h * (n >> d) : (h + 1) * (n >> d)]) for h in range(2)])
        o, p = torch.from_numpy(outer).to(cuda), torch.from_numpy(sub).to(cuda)
        assert torch.equal(benes_apply(v, o, p, k), benes_apply_plain(v, o, p, k))


@pytest.mark.cuda
def test_cuda_route_split_matches_plain(cuda, monkeypatch):
    monkeypatch.setattr(troute, "FUSED_MAX_K", 13)
    k = 15
    rng = np.random.default_rng(400)
    src = rng.permutation(1 << k)
    outer, packed = troute.plan_route_arrays(k, native.benes_plan(k, src))
    v = torch.from_numpy(rng.standard_normal(1 << k).astype(np.float32))
    got = troute.apply_route(v.to(cuda), torch.from_numpy(outer).to(cuda), torch.from_numpy(packed).to(cuda), k)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), v[torch.from_numpy(src)])
