"""The Hopper designs of the block-window SpMV (csrc/spmv_mxu.cu) and the
group-window SpMV (csrc/spmv_bwd.cu), emulated on the CPU.

- `_emulate_mxu` walks the block windows as the kernel does: each warp owns
  32 rows s0 <= s < s0 + 32 of a block and visits only the window rows
  c in [s0, min(256, s0 + 31 + W)); a lane holds V = 16 / itemsize
  consecutive rows of one window row (one 16-byte load), the warp's V lane
  groups take c = s0 + g (mod V), a lane loads only where one of its rows
  meets row c's band, and each value joins its own row's sum only inside
  0 <= c - s < W. Each lane group sums in increasing c; the groups meet
  pairwise, as the kernel's shuffle butterfly adds them. It must match
  `spmv_band_mxu_plain` (the full-window product) and the JAX package's
  `pallas_spmv_band_mxu(..., interpret=True)`, use every parallelogram value
  once and load no 16-byte vector that holds none.
- The windows of both packages are zero outside 0 <= c - s < W, the
  precondition of that walk.
- The deliberate divergence: where x is not finite at a column that only a
  window's stored zero triangle meets, the JAX kernel (and the full-window
  plain version) give NaN (0 * Inf); the walk never reads that column and
  gives the band product's finite value.
- `_emulate_bwd` runs the group-window kernel's lane map: lane l serves row
  l // 4 of the group and vectors j = l % 4, j + 4, ... of its row (V = 4
  f32, 8 bf16, 2 f64 values a vector); the four lane sums meet as
  (s0 + s1) + (s2 + s3); the group's spill entries are split over the 32
  lanes into 8 per-row sums and a butterfly. It must match `spmv_bwd_plain`
  and `pallas_spmv_bwd(..., interpret=True)` on forms carried across with
  `interop.bwd_form_from_jax`, for W in {8, 136, 264} and all three
  instances.
- The wrappers' band-width checks: `spmv_band_mxu` takes W in [1, 256],
  `spmv_bwd` a W that is a multiple of 8 (the planner's rounding).

Tolerances: utils/tolerances.py's model, expected_precision(accumulation
dtype) on max |a - b| / max(|b|, 1): the same products summed in another
order (the bf16 instances: the same bf16 band values, and for the block
windows x rounded to bf16 on both sides, summed in float32).

The kernels themselves run in the `cuda`-marked tests of
tests/test_torch_spmv_mxu.py and tests/test_torch_bwd.py (skipped without a
card).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import AoclSparseError, Status, interop
from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv_plain
from aoclsparse_tpu_torch.kernels.spmm_band import band_mxu_blocks
from aoclsparse_tpu_torch.kernels.spmv_bwd import G, spill_group_ptr, spmv_bwd, spmv_bwd_plain
from aoclsparse_tpu_torch.kernels.spmv_mxu import spmv_band_mxu, spmv_band_mxu_plain
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

F32 = expected_precision(torch.float32)
F64 = expected_precision(torch.float64)
GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none


@pytest.fixture(scope="module")
def jax_spmv():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.kernels.pallas import spmv

    return spmv


# ---------------------------------------------------------------- #5 ----


def _x_window(x, nblk, start, padL, bf16):
    """(nblk, 256) float32: xw[k, c] = x[start + 128k + c - padL], zero
    outside [0, n), rounded to bf16 for a bf16 dt (the kernel's staged x)."""
    k = start - padL + 128 * torch.arange(nblk)[:, None] + torch.arange(256)[None, :]
    inside = (k >= 0) & (k < x.shape[0])
    xw = torch.where(inside, x.float()[k.clamp(0, max(x.shape[0] - 1, 0))], torch.zeros(()))
    return xw.to(torch.bfloat16).float() if bf16 else xw


def _emulate_mxu(dt, x, start, padL, m, W):
    """(y, uses, empty_loads): the kernel's walk over the windows in its sum
    order (see the module note); uses[k, c, s] counts the products of value
    dt[k, c, s]; empty_loads counts 16-byte loads holding no band value."""
    nblk = dt.shape[0]
    V = 16 // dt.element_size()
    L = 32 // V
    d = dt.float()
    xw = _x_window(x, nblk, start, padL, dt.dtype == torch.bfloat16)
    y = torch.zeros(nblk * 128)
    uses = torch.zeros(nblk, 256, 128, dtype=torch.int32)
    empty = 0
    for s0 in range(0, 128, 32):
        cend = min(256, s0 + 31 + W)
        steps = -(-(cend - s0) // V)
        part = torch.zeros(nblk, V, L, V)  # [block, lane group, lane of the row, value]
        for g in range(V):
            for r in range(L):
                sl = s0 + r * V
                for i in range(steps):
                    c = s0 + g + V * i
                    if c >= cend or not 0 <= c - sl < W + V - 1:
                        continue  # the lane loads nothing
                    band = [0 <= c - sl - v < W for v in range(V)]
                    empty += not any(band)
                    for v in range(V):
                        if band[v]:
                            part[:, g, r, v] += d[:, c, sl + v] * xw[:, c]
                            uses[:, c, sl + v] += 1
        while part.shape[1] > 1:  # the butterfly over lane groups: adjacent pairs
            part = part[:, 0::2] + part[:, 1::2]
        y.view(nblk, 128)[:, s0:s0 + 32] = part[:, 0].reshape(nblk, 32)
    return y[:m], uses, empty


def _band(seed, W, m, n):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((W, m)).astype(np.float32), rng.standard_normal(n).astype(np.float32)


def _windows(vt, W, bf16=False):
    dt = band_mxu_blocks(torch.from_numpy(vt).t(), W)
    return dt.to(torch.bfloat16) if bf16 else dt


MXU_CASES = [(1, 301, 300, 5, 2), (8, 333, 340, 7, 13), (64, 517, 530, 3, 64), (128, 645, 640, 11, 70),
             (129, 387, 390, 1, 129)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,m,n,start,padL", MXU_CASES)
def test_mxu_walk_matches_plain(W, m, n, start, padL, bf16):
    """odd m (a ragged last block), start > 0 and padL > 0"""
    vt, x = _band(W * 7 + m, W, m, n)
    dt = _windows(vt, W, bf16)
    xt = torch.from_numpy(x)
    got, uses, empty = _emulate_mxu(dt, xt, start, padL, m, W)
    assert near_error(got.numpy(), spmv_band_mxu_plain(dt, xt, start, padL, m).numpy()) <= F32
    c = torch.arange(256)[:, None]
    s = torch.arange(128)[None, :]
    para = ((c - s >= 0) & (c - s < W)).to(torch.int32)
    assert torch.equal(uses, para.expand_as(uses))  # every band value once, nothing else
    assert empty == 0


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,m,n,start,padL", MXU_CASES)
def test_mxu_walk_matches_pallas(jax_spmv, W, m, n, start, padL, bf16):
    import jax.numpy as jnp

    vt, x = _band(W * 7 + m, W, m, n)
    dt = _windows(vt, W, bf16)
    dt_j = jnp.asarray(jax_spmv.band_mxu_blocks(vt, W), jnp.bfloat16 if bf16 else jnp.float32)
    want = np.asarray(jax_spmv.pallas_spmv_band_mxu(dt_j, jnp.asarray(np.pad(x, (padL, 0))), start, TM=256,
                                                    interpret=True))[:m]
    got, _uses, _empty = _emulate_mxu(dt, torch.from_numpy(x), start, padL, m, W)
    assert near_error(got.numpy(), want) <= F32


def test_mxu_walk_w256_skips_only_the_lower_triangle():
    """A caller with no band width passes W = 256: the walk still sums the
    same product and never reads c < s."""
    W, m, n = 40, 300, 310
    vt, x = _band(3, W, m, n)
    dt = _windows(vt, W)
    xt = torch.from_numpy(x)
    got, uses, _empty = _emulate_mxu(dt, xt, 2, 9, m, 256)
    assert near_error(got.numpy(), spmv_band_mxu_plain(dt, xt, 2, 9, m).numpy()) <= F32
    c = torch.arange(256)[:, None]
    s = torch.arange(128)[None, :]
    assert torch.equal(uses, (c >= s).to(torch.int32).expand_as(uses))


@pytest.mark.parametrize("W", [1, 8, 64, 128, 129])
def test_windows_zero_outside_the_parallelogram(jax_spmv, W):
    m = 333
    vt, _x = _band(W, W, m, m)
    c = np.arange(256)[:, None]
    s = np.arange(128)[None, :]
    outside = ~((c - s >= 0) & (c - s < W))
    for dt in (_windows(vt, W).numpy(), jax_spmv.band_mxu_blocks(vt, W)):
        assert dt.shape == (3, 256, 128)
        assert not np.any(dt[:, outside])
        assert np.count_nonzero(dt) == np.count_nonzero(vt)


def test_mxu_non_finite_x_only_the_zero_triangle_meets(jax_spmv):
    """Deliberate divergence (ROADMAP queue 3): x holds Inf and NaN at
    columns that no row's band meets but block 0's window does. The JAX
    kernel and the full-window plain version give NaN there; the walk gives
    the band product."""
    import jax.numpy as jnp

    W, m, n, start, padL = 8, 128, 300, 0, 0
    vt, x = _band(5, W, m, n)
    x[200], x[250] = np.inf, np.nan  # band columns end at 128 + 8 - 1
    dt = _windows(vt, W)
    xt = torch.from_numpy(x)
    want = np.asarray(jax_spmv.pallas_spmv_band_mxu(jnp.asarray(dt.numpy()), jnp.asarray(x), start, TM=256,
                                                    interpret=True))[:m]
    assert np.all(np.isnan(want))
    assert torch.all(torch.isnan(spmv_band_mxu_plain(dt, xt, start, padL, m)))
    got, _uses, _empty = _emulate_mxu(dt, xt, start, padL, m, W)
    assert torch.all(torch.isfinite(got))
    assert near_error(got.numpy(), band_spmv_plain(torch.from_numpy(vt), xt, start, padL).numpy()) <= F32


@pytest.mark.parametrize("W", [0, 257, -1])
def test_mxu_wrapper_rejects_band_width(W):
    dt, x = torch.zeros(2, 256, 128), torch.zeros(256)
    with pytest.raises(AoclSparseError) as e:
        spmv_band_mxu(dt, x, 0, 0, 256, W)
    assert e.value.status == Status.invalid_size


@pytest.mark.parametrize("W", [1, 129, 256])
def test_mxu_wrapper_takes_band_width(W):
    vt, x = _band(W, min(W, 129), 256, 256)
    dt, xt = _windows(vt, min(W, 129)), torch.from_numpy(x)
    assert torch.equal(spmv_band_mxu(dt, xt, 0, 0, 256, W), spmv_band_mxu_plain(dt, xt, 0, 0, 256))


# ---------------------------------------------------------------- #4 ----


def _emulate_bwd(win, x, base8, padL, m, sp_val=None, sp_ind=None, sp_rows=None):
    """The group-window kernel's lane map and sum order (module note)."""
    nblk, _g, W = win.shape
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    V = 16 // win.element_size()
    band = win.to(acc_t).reshape(nblk, G, W // V, V)
    k = G * (torch.arange(nblk)[:, None] + base8) + torch.arange(W)[None, :] - padL
    xw = torch.where((k >= 0) & (k < x.shape[0]), x.to(acc_t)[k.clamp(0, x.shape[0] - 1)], torch.zeros((), dtype=acc_t))
    xw = xw.reshape(nblk, 1, W // V, V)
    lanes = torch.zeros(nblk, G, 4, dtype=acc_t)  # [group, row, lane of the row]
    for q in range(W // V):
        for v in range(V):
            lanes[:, :, q % 4] += band[:, :, q, v] * xw[:, :, q, v]
    rows = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
    if sp_ind is not None and sp_ind.shape[0]:
        gptr = spill_group_ptr(sp_rows.numpy(), nblk)
        for b in np.nonzero(gptr[1:] > gptr[:-1])[0]:
            part = torch.zeros(32, G, dtype=acc_t)  # [lane, row]
            for e in range(int(gptr[b]), int(gptr[b + 1])):
                part[(e - int(gptr[b])) % 32, int(sp_rows[e]) - G * b] += (sp_val[e] * x[sp_ind[e]]).to(acc_t)
            lane = torch.arange(32)
            for off in (16, 8, 4, 2, 1):
                part = part + part[lane ^ off]
            rows[b] += part[0]
    return rows.reshape(-1)[:m]


def _band_matrix(m, h, row_nnz, n_far, seed, dtype):
    """Random entries within +-h of the diagonal, the window's corners
    (rows 8i at offset -h, rows 8i + 7 at +h) so that W = 2h + 8 exactly,
    and n_far far entries for the peel spill: scipy CSR."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), row_nnz)
    c = r + rng.integers(-h, h + 1, r.size)
    lo = np.arange(0, m, 8)
    hi = np.arange(7, m, 8)
    fr = rng.integers(0, m, n_far)
    rows = np.r_[r, lo, hi, fr]
    cols = np.r_[c, lo - h, hi + h, (fr + rng.integers(m // 4, m // 2, n_far)) % m]
    keep = (cols >= 0) & (cols < m)
    S = sp.csr_matrix((rng.standard_normal(keep.sum()), (rows[keep], cols[keep])), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return sp.csr_matrix((S.data.astype(dtype), S.indices, S.indptr), shape=S.shape)


# (W, m, half-bandwidth, entries a row, far entries): past 4096 entries both
# planners peel the far entries into the spill; m odd
BWD_CASES = [(8, 4105, 0, 1, 6), (136, 1001, 64, 9, 12), (264, 1203, 128, 8, 12)]


def _forms(jax_spmv, W, m, h, row_nnz, n_far, dtype, bf16):
    """The JAX planner's bwd form (its arrays), the port's copy of it, the
    band the kernel instance reads and x."""
    import aoclsparse_tpu as ast
    from aoclsparse_tpu.planner.plan import get_plan

    S = _band_matrix(m, h, row_nnz, n_far, W + m, dtype)
    J = ast.create_csr(m, m, S.indptr, S.indices, S.data)
    f = get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="bwd")
    arrays = {k: (None if getattr(f, k) is None else np.asarray(getattr(f, k)))
              for k in ("bwd_val", "sp_val", "sp_ind", "sp_rows")}
    arrays.update({k: getattr(f, k) for k in ("bwd_W", "bwd_base8", "bwd_padL", "bwd_n_pad", "m", "n")})
    assert f.bwd_W == W and arrays["sp_ind"] is not None and arrays["sp_ind"].size > 0
    form = interop.bwd_form_from_jax(arrays, device="cpu")
    band = form.bwd_val.to(torch.bfloat16) if bf16 else form.bwd_val
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(m).astype(dtype))
    return f, form, band, x


INSTANCES = [("f32", np.float32, False), ("bf16", np.float32, True), ("f64", np.float64, False)]


@pytest.mark.parametrize("inst,dtype,bf16", INSTANCES)
@pytest.mark.parametrize("W,m,h,row_nnz,n_far", BWD_CASES)
def test_bwd_lane_map_matches_plain_with_spill(jax_spmv, W, m, h, row_nnz, n_far, inst, dtype, bf16):
    _f, form, band, x = _forms(jax_spmv, W, m, h, row_nnz, n_far, dtype, bf16)
    args = (form.bwd_base8, form.bwd_padL, m, form.sp_val, form.sp_ind, form.sp_rows)
    got = _emulate_bwd(band, x, *args)
    want = spmv_bwd_plain(band, x, *args)
    assert got.dtype == want.dtype
    assert near_error(got.numpy(), want.numpy()) <= (F64 if inst == "f64" else F32)


@pytest.mark.parametrize("inst,dtype,bf16", INSTANCES)
@pytest.mark.parametrize("W,m,h,row_nnz,n_far", BWD_CASES)
def test_bwd_lane_map_matches_pallas(jax_spmv, W, m, h, row_nnz, n_far, inst, dtype, bf16):
    """The band part against the TPU kernel in interpret mode, on the same
    (bf16-rounded, for bf16) band values."""
    import jax.numpy as jnp

    f, form, band, x = _forms(jax_spmv, W, m, h, row_nnz, n_far, dtype, bf16)
    wide = band.float() if bf16 else band
    xp = np.pad(x.numpy(), (f.bwd_padL, f.bwd_n_pad - f.bwd_padL - m))
    want = np.asarray(jax_spmv.pallas_spmv_bwd(jnp.asarray(wide.numpy()), jnp.asarray(xp), f.bwd_W, f.bwd_base8,
                                               f.bwd_n_pad, TM=256, interpret=True))[:m]
    got = _emulate_bwd(band, x, form.bwd_base8, form.bwd_padL, m)
    assert near_error(got.numpy(), want) <= (F64 if inst == "f64" else F32)


@pytest.mark.parametrize("W", [136, 8])
def test_bwd_lane_map_on_the_port_planner_form(W):
    """The port's own planner form, no JAX needed: the same lane map against
    the plain version, the spill's group pointer from the form."""
    m, h = (1001, 64) if W == 136 else (4105, 0)
    S = _band_matrix(m, h, 9 if W == 136 else 1, 12 if W == 136 else 6, 3, np.float32)
    T = tt.create_csr(m, m, S.indptr, S.indices, S.data, device="cpu")
    form = tplan.get_plan(T).exec_form_for(GEN, NONE, kind="bwd")
    assert form.bwd_W == W and form.has_spill
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(m).astype(np.float32))
    args = (form.bwd_base8, form.bwd_padL, m, form.sp_val, form.sp_ind, form.sp_rows)
    got = _emulate_bwd(form.bwd_val, x, *args)
    assert near_error(got.numpy(), spmv_bwd_plain(form.bwd_val, x, *args).numpy()) <= F32
    assert near_error(got.numpy(), S.astype(np.float64) @ x.numpy().astype(np.float64)) <= F32


@pytest.mark.parametrize("W", [4, 12, 137])
def test_bwd_wrapper_rejects_band_width_off_a_multiple_of_8(W):
    win, x = torch.zeros(3, G, W), torch.zeros(40 + W)
    with pytest.raises(AoclSparseError) as e:
        spmv_bwd(win, x, 1, 3, 24)
    assert e.value.status == Status.invalid_size


def test_bwd_wrapper_takes_band_width_multiple_of_8():
    rng = np.random.default_rng(9)
    win, x = torch.from_numpy(rng.standard_normal((3, G, 16))), torch.from_numpy(rng.standard_normal(40))
    assert torch.equal(spmv_bwd(win, x, 1, 3, 24), spmv_bwd_plain(win, x, 1, 3, 24))
