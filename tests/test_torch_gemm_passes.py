"""The Hopper designs of the block-window SpMM (#9, csrc/spmm_band.cu
spmm_band_mxu) and the band GEMM (#18, csrc/band_gemm.cu), emulated on the
CPU.

- `_emulate_mxu_mm` walks a block's window rows as the kernel does
  (kernels/spmm_band.py `mxu_walk`): the f32 instance takes 32-row warps
  over window rows c in [s0, min(256, s0 + 31 + W)), one FMA a window row
  in increasing c; the bf16 instance 16-row halves over the 16-deep steps
  that meet [s, min(256, s + 15 + W)), a bf16 product of B rounded to bf16
  accumulated in f32. It must match `spmm_band_mxu_plain` (the full
  256-deep window product) and the JAX package's
  `pallas_spmm_band_mxu(..., interpret=True)` at W in {1, 8, 64, 128} and m
  off a multiple of 128, and its walk must cover every parallelogram value
  once.
- `_emulate_gemm` runs the band GEMM's schedule: 64 x 128 CTA tiles of each
  C_g, the meeting streams' slabs in chunks of 32 zero-filled slab rows,
  steps of 8, and a warp (32 x 32 of the tile) that runs a step only if its
  A fragment (32 x 8) and its B fragment (8 x 32) both hold a nonzero. It
  must match `band_gemm_plain` and `pallas_band_gemm(..., interpret=True)`
  on plans with d0 > 0 and d0 < 0 (streams out of range), m off G, one
  stream and five; write every C element; and count the same taken and
  visited steps as `band_gemm_steps`, which chip_smoke.py reports.
- The deliberate divergences (ROADMAP queue 3): where B holds Inf at rows
  that only stored zeros meet (#9: window rows past every warp's walk;
  #18: a B chunk whose A chunk is all zero), the plain versions and the JAX
  kernels give NaN (0 * Inf) and the emulated kernels the finite product.
- The wrapper's band width: `spmm_band_mxu` takes W in [1, 256], and
  mm(kid=5) passes the form's W and still matches the JAX mm(kid=5).

Tolerances: utils/tolerances.py's model, expected_precision(accumulation
dtype) on max |a - b| / max(|b|, 1): the same products summed in another
order (the bf16 instance: the same bf16 windows and B rounded to bf16 on
both sides, summed in f32).

The kernels themselves run in the `cuda`-marked tests of
tests/test_torch_spmm_kernels.py and tests/test_torch_spgemm_band.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import AoclSparseError, Status, interop
from aoclsparse_tpu_torch.kernels.band_gemm import band_gemm_plain, band_gemm_steps
from aoclsparse_tpu_torch.kernels.spgemm_band import build_band_gemm_plan
from aoclsparse_tpu_torch.kernels.spmm_band import (
    band_mxu_blocks,
    mxu_walk,
    spmm_band_mxu,
    spmm_band_mxu_plain,
    spmm_band_plain,
)
from aoclsparse_tpu_torch.ops.level3.spgemm import _effective, _symbolic
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

F32 = expected_precision(torch.float32)
F64 = expected_precision(torch.float64)
GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none


@pytest.fixture(scope="module")
def jax_mods():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu
    from aoclsparse_tpu.kernels.pallas import spgemm, spmv

    return aoclsparse_tpu, spmv, spgemm


# ---------------------------------------------------------------- #9 ----


def _b_window(B, nblk, start, padL, bf16):
    """(nblk, 256, K) float32: Bw[k, c] = B[start + 128k + c - padL], zero
    outside [0, n), rounded to bf16 for a bf16 dt (the kernel's staged B)."""
    n = B.shape[0]
    r = start - padL + 128 * torch.arange(nblk)[:, None] + torch.arange(256)[None, :]
    inside = ((r >= 0) & (r < n))[..., None]
    Bw = torch.where(inside, B.float()[r.clamp(0, n - 1)], torch.zeros(()))
    return Bw.to(torch.bfloat16).float() if bf16 else Bw


def _emulate_mxu_mm(dt, B, start, padL, m, W):
    """(C, uses): the kernel's walk (module note); uses[c, s] counts the
    window values of one block that enter a product."""
    nblk, K = dt.shape[0], B.shape[1]
    bf16 = dt.dtype == torch.bfloat16
    d = dt.float()
    Bw = _b_window(B, nblk, start, padL, bf16)
    C = torch.zeros(nblk, 128, K)
    uses = torch.zeros(256, 128, dtype=torch.int32)
    for r_lo, r_hi, c_lo, c_hi in mxu_walk(W, bf16):
        if bf16:
            for c in range(c_lo, c_hi, 16):
                C[:, r_lo:r_hi] += d[:, c:c + 16, r_lo:r_hi].transpose(1, 2) @ Bw[:, c:c + 16]
        else:
            for c in range(c_lo, c_hi):
                C[:, r_lo:r_hi] += d[:, c, r_lo:r_hi, None] * Bw[:, c, None, :]
        uses[c_lo:c_hi, r_lo:r_hi] += 1
    return C.reshape(nblk * 128, K)[:m], uses


def _band(seed, m, W, n, K):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, W)).astype(np.float32), rng.standard_normal((n, K)).astype(np.float32)


# (W, m, n, start, padL, K): m off a multiple of 128, start > 0 and padL > 0
MXU_CASES = [(1, 301, 300, 5, 2, 9), (8, 333, 340, 7, 13, 16), (64, 517, 530, 3, 64, 9), (128, 645, 640, 11, 70, 24)]


def _parallelogram(W):
    c = torch.arange(256)[:, None]
    s = torch.arange(128)[None, :]
    return (c - s >= 0) & (c - s < W)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,m,n,start,padL,K", MXU_CASES)
def test_mxu_mm_walk_matches_plain(W, m, n, start, padL, K, bf16):
    v, B = _band(W + m, m, W, n, K)
    dt = band_mxu_blocks(torch.from_numpy(v), W)
    dt = dt.to(torch.bfloat16) if bf16 else dt
    Bt = torch.from_numpy(B)
    got, uses = _emulate_mxu_mm(dt, Bt, start, padL, m, W)
    assert got.shape == (m, K)
    assert near_error(got.numpy(), spmm_band_mxu_plain(dt, Bt, start, padL, m).numpy()) <= F32
    # every parallelogram value enters once; nothing outside [0, 256) or twice
    assert torch.all(uses[_parallelogram(W)] == 1) and int(uses.max()) == 1


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,m,n,start,padL,K", MXU_CASES)
def test_mxu_mm_walk_matches_pallas(jax_mods, W, m, n, start, padL, K, bf16):
    import jax.numpy as jnp

    _ast, spmv, _spgemm = jax_mods
    v, B = _band(W + m, m, W, n, K)
    dt_np = spmv.band_mxu_blocks(np.ascontiguousarray(v.T), W)
    dt_j = jnp.asarray(dt_np, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    Be = jnp.asarray(np.pad(B, ((padL, 0), (0, 128 - K))))
    want = np.asarray(spmv.pallas_spmm_band_mxu(dt_j, Be, start, TM=128, interpret=True))[:m, :K]
    dt = torch.from_numpy(dt_np)
    got, _uses = _emulate_mxu_mm(dt.to(torch.bfloat16) if bf16 else dt, torch.from_numpy(B), start, padL, m, W)
    assert near_error(got.numpy(), want) <= F32


@pytest.mark.parametrize("W,rows", [(1, (32, 32, 32, 32)), (64, (95, 95, 95, 95)), (128, (159, 159, 159, 159)),
                                    (129, (160, 160, 160, 160)), (256, (256, 224, 192, 160))])
def test_mxu_walk_window_rows(W, rows):
    """f32: 159 of 256 window rows a warp at W = 128; W = 256 (a caller
    with no band width) still skips the zero lower triangle c < s."""
    walk = mxu_walk(W, False)
    assert [(a, b) for a, b, _c, _d in walk] == [(0, 32), (32, 64), (64, 96), (96, 128)]
    assert tuple(d - c for _a, _b, c, d in walk) == rows
    halves = mxu_walk(W, True)
    assert len(halves) == 8
    for r_lo, r_hi, c_lo, c_hi in halves:
        assert c_lo % 16 == 0 and c_hi % 16 == 0 and c_lo <= r_lo and c_hi >= min(256, r_hi - 1 + W)


@pytest.mark.parametrize("bf16", [False, True])
def test_mxu_mm_non_finite_b_only_stored_zeros_meet(jax_mods, bf16):
    """Deliberate divergence (ROADMAP queue 3): B holds Inf and NaN at rows
    that only block 0's stored zeros meet (its bands end at window row
    128 + 8 - 1). The JAX kernel and the full-window plain version give NaN
    there; the walk never reads those rows and gives the band product."""
    import jax.numpy as jnp

    _ast, spmv, _spgemm = jax_mods
    W, m, n, K = 8, 128, 300, 16
    v, B = _band(5, m, W, n, K)
    B[200, 3], B[250, :] = np.inf, np.nan
    dt_np = spmv.band_mxu_blocks(np.ascontiguousarray(v.T), W)
    dt_j = jnp.asarray(dt_np, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    want = np.asarray(spmv.pallas_spmm_band_mxu(dt_j, jnp.asarray(np.pad(B, ((0, 0), (0, 128 - K)))), 0, TM=128,
                                                interpret=True))[:m, :K]
    assert np.all(np.isnan(want))
    dt = torch.from_numpy(dt_np)
    dt = dt.to(torch.bfloat16) if bf16 else dt
    Bt = torch.from_numpy(B)
    assert torch.all(torch.isnan(spmm_band_mxu_plain(dt, Bt, 0, 0, m)))
    got, _uses = _emulate_mxu_mm(dt, Bt, 0, 0, m, W)
    assert torch.all(torch.isfinite(got))
    vb = torch.from_numpy(v).to(torch.bfloat16).float() if bf16 else torch.from_numpy(v)
    Bb = Bt.to(torch.bfloat16).float() if bf16 else Bt
    assert near_error(got.numpy(), spmm_band_plain(vb, Bb, 0, 0).numpy()) <= F32


@pytest.mark.parametrize("W", [0, 257, -3])
def test_mxu_mm_wrapper_rejects_band_width(W):
    dt, B = torch.zeros(2, 256, 128), torch.zeros(256, 4)
    with pytest.raises(AoclSparseError) as e:
        spmm_band_mxu(dt, B, 0, 0, 256, W)
    assert e.value.status == Status.invalid_size


def test_mm_kid5_passes_band_width_and_matches_jax(jax_mods, monkeypatch):
    """mm(kid=5) on a bandtm form: the port passes the form's W to the
    block-window kernel; the result matches the JAX package's mm(kid=5)."""
    ast = jax_mods[0]
    m, K = 700, 12
    rng = np.random.default_rng(9)
    r = np.repeat(np.arange(m), 6)
    c = np.clip(r + rng.integers(-20, 21, r.size), 0, m - 1)
    S = sp.csr_matrix((rng.standard_normal(r.size).astype(np.float32), (r, c)), shape=(m, m))
    S.sum_duplicates()
    B = rng.standard_normal((m, K)).astype(np.float32)
    seen = []
    from aoclsparse_tpu_torch.kernels import spmm_band as mod

    real = mod.spmm_band_mxu

    def spy(dt, B_, start, padL, m_, W=256):
        seen.append(W)
        return real(dt, B_, start, padL, m_, W)

    monkeypatch.setattr(mod, "spmm_band_mxu", spy)
    A = tt.create_csr(m, m, S.indptr, S.indices, S.data, device="cpu")
    tt.set_mm_hint(A, NONE, GEN, nop=1000)
    tt.optimize(A)
    got = tt.mm(1.0, A, GEN, NONE, torch.from_numpy(B), 0.0, kid=5)
    form = A.plan.exec_form_for(GEN, NONE, kind="bandtm")
    assert seen == [form.bwd_W] and 1 <= form.bwd_W <= 129
    JA = ast.create_csr(m, m, S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data)
    import jax

    with jax.default_matmul_precision("highest"):  # the port's f32 products are exact f32
        want = np.asarray(ast.mm(1.0, JA, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0, kid=5))
    assert near_error(got.numpy(), want) <= F32
    assert near_error(got.numpy(), S.astype(np.float64) @ B.astype(np.float64)) <= F32


# --------------------------------------------------------------- #18 ----


def _emulate_gemm(A, B, WC, d0, ranges):
    """(C, taken, visited, written): the band GEMM's schedule (module note),
    all groups at once; a warp step that the vote skips adds nothing."""
    nblk, G, _WA = A.shape
    WB = B.shape[2]
    nrow, ncol = -(-G // 64), -(-WC // 128)
    Ap = torch.zeros(nblk, nrow * 64, A.shape[2], dtype=A.dtype)
    Ap[:, :G] = A
    C = torch.zeros(nblk, nrow * 64, ncol * 128, dtype=A.dtype)
    written = torch.zeros(nblk, nrow * 64, ncol * 128, dtype=torch.int32)
    taken = visited = 0
    for rt in range(nrow):
        for ct in range(ncol):
            r0, c0 = 64 * rt, 128 * ct
            acc = torch.zeros(nblk, 64, 128, dtype=A.dtype)
            for s, (lo, hi, br) in enumerate(ranges):
                cs, off = G * s, d0 + s
                g0, g1 = max(0, -off), min(nblk, nblk - off)
                if hi <= lo or g1 <= g0 or not (cs < c0 + 128 and cs + WB > c0):
                    continue
                j0, j1 = max(cs, c0) - c0, min(cs + WB, c0 + 128) - c0  # the stream's columns in the tile
                for k0 in range(lo, hi, 32):
                    nk = min(hi, k0 + 32) - k0
                    At = torch.zeros(g1 - g0, 64, 32, dtype=A.dtype)
                    At[:, :, :nk] = Ap[g0:g1, r0:r0 + 64, k0:k0 + nk]
                    Bt = torch.zeros(g1 - g0, 32, 128, dtype=A.dtype)
                    b0 = br + k0 - lo
                    Bt[:, :nk, j0:j1] = B[g0 + off:g1 + off, b0:b0 + nk, c0 + j0 - cs:c0 + j1 - cs]
                    for t in range(4):
                        a_nz = (At[:, :, 8 * t:8 * t + 8] != 0).reshape(g1 - g0, 2, 32 * 8).any(2)
                        b_nz = (Bt[:, 8 * t:8 * t + 8] != 0).reshape(g1 - g0, 8, 4, 32).any(3).any(1)
                        take = a_nz[:, :, None] & b_nz[:, None, :]  # (groups, warp row, warp column)
                        taken += int(take.sum())
                        visited += take.numel()
                        mask = take.repeat_interleave(32, 1).repeat_interleave(32, 2)
                        for k in range(8 * t, 8 * t + 8):
                            part = acc[g0:g1] + At[:, :, k, None] * Bt[:, k, None, :]
                            acc[g0:g1] = torch.where(mask, part, acc[g0:g1])
            C[:, r0:r0 + 64, c0:c0 + 128] = acc
            written[:, r0:r0 + 64, c0:c0 + 128] += 1
    return C[:, :G, :WC], taken, visited, written[:, :G, :WC]


def _banded(seed, m, lo, hi, per, dtype=np.float32):
    """`per` columns a row in [row + lo, row + hi] (clipped): scipy CSR."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), per)
    c = r + rng.integers(lo, hi + 1, r.size)
    keep = (c >= 0) & (c < m)
    S = sp.csr_matrix((rng.standard_normal(int(keep.sum())).astype(dtype), (r[keep], c[keep])), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S


def _plan(m, offA, offB, G, dtype=np.float32, per=4):
    SA, SB = _banded(m + 1, m, *offA, per, dtype), _banded(m + 2, m, *offB, per, dtype)
    TA = tt.create_csr(m, m, SA.indptr, SA.indices, SA.data, device="cpu")
    TB = tt.create_csr(m, m, SB.indptr, SB.indices, SB.data, device="cpu")
    eA, eB = _effective(TA, GEN, NONE), _effective(TB, GEN, NONE)
    plan = _symbolic(eA, eB)
    bp = build_band_gemm_plan(eA, eB, plan.ptr, plan.ind, G=G, force=True)
    bp.formA.refresh(eA.val)
    bp.formB.refresh(eB.val)
    return bp


#: (m, A's offsets, B's offsets, G): one stream, m off G; d0 > 0 (the last
#: groups' streams out of range); d0 < 0 (the first groups'); five streams;
#: the card's G = 128 with three streams
GEMM_CASES = [(301, (0, 0), (-5, 5), 32), (450, (40, 70), (-6, 6), 32), (470, (-75, -40), (-3, 9), 32),
              (333, (-50, 60), (-20, 20), 32), (700, (-4, 4), (-4, 4), 128)]


@pytest.fixture(scope="module", params=GEMM_CASES, ids=lambda c: f"m{c[0]}-G{c[3]}")
def gemm_case(request):
    m, offA, offB, G = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", "1")
        bp = _plan(m, offA, offB, G)
    A, B = bp.formA.bwd_val, bp.formB.bwd_val
    return bp, A, B, _emulate_gemm(A, B, bp.WC, bp.d0, bp.stream_ranges)


#: what each case is for (GEMM_CASES' note), by m
EDGES = {301: lambda bp: bp.nstream == 1 and 301 % bp.G, 450: lambda bp: bp.d0 > 0 and 450 % bp.G,
         470: lambda bp: bp.d0 < -1, 333: lambda bp: bp.nstream == 5,
         700: lambda bp: bp.G == 128 and bp.nstream == 3 and 700 % bp.G}


def test_gemm_plans_cover_the_edges(gemm_case):
    bp = gemm_case[0]
    assert EDGES[bp.formA.m](bp)


def test_gemm_schedule_matches_plain(gemm_case):
    bp, A, B, (C, _taken, _visited, written) = gemm_case
    want = band_gemm_plain(A, B, bp.WC, bp.d0, bp.stream_ranges)
    assert C.shape == want.shape and near_error(C.numpy(), want.numpy()) <= F32
    assert torch.all(written == 1)  # every C element once, zeros included


def test_gemm_schedule_counts_steps(gemm_case):
    bp, A, B, (_C, taken, visited, _written) = gemm_case
    assert (taken, visited) == band_gemm_steps(A, B, bp.WC, bp.d0, bp.stream_ranges)
    assert 0 < taken < visited  # sparse bands: both sides of the vote


def test_gemm_schedule_f64_and_dense_operands(gemm_case):
    """f64, and operands whose bands are dense: every step inside the slab
    and the stream's columns is taken."""
    bp, A, B, _emulated = gemm_case
    rng = np.random.default_rng(3)
    Ad = torch.from_numpy(rng.standard_normal(tuple(A.shape)))
    Bd = torch.from_numpy(rng.standard_normal(tuple(B.shape)))
    C, taken, visited, _written = _emulate_gemm(Ad, Bd, bp.WC, bp.d0, bp.stream_ranges)
    want = band_gemm_plain(Ad, Bd, bp.WC, bp.d0, bp.stream_ranges)
    assert near_error(C.numpy(), want.numpy()) <= F64
    assert (taken, visited) == band_gemm_steps(Ad, Bd, bp.WC, bp.d0, bp.stream_ranges)
    _C, taken_sparse, _v, _w = gemm_case[3]
    assert taken > taken_sparse


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,offA,offB,G", [GEMM_CASES[1], GEMM_CASES[3]])
def test_gemm_schedule_matches_pallas(jax_mods, monkeypatch, dtype, m, offA, offB, G):
    import jax.numpy as jnp

    ast, _spmv, spgemm = jax_mods
    from aoclsparse_tpu.kernels.xla.spgemm_band import build_band_gemm_plan as jbuild
    from aoclsparse_tpu.ops.level3.spgemm import _effective as jeff, _symbolic as jsym

    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", "1")
    SA, SB = _banded(m + 1, m, *offA, 4, dtype), _banded(m + 2, m, *offB, 4, dtype)
    JA = ast.create_csr(m, m, SA.indptr.astype(np.int64), SA.indices.astype(np.int32), SA.data)
    JB = ast.create_csr(m, m, SB.indptr.astype(np.int64), SB.indices.astype(np.int32), SB.data)
    jnone = ast.Operation.none
    eA, eB = jeff(JA, ast.MatrixDescriptor(), jnone), jeff(JB, ast.MatrixDescriptor(), jnone)
    jplan = jsym(eA, eB)
    jp = jbuild(eA, eB, jplan.ptr, jplan.ind, G=G, force=True)
    jp.formA.refresh(eA.val)
    jp.formB.refresh(eB.val)
    keys = ("G", "WA", "WB", "WC", "d0", "sl0", "nstream", "relC", "nblk")
    arrays = {k: getattr(jp, k) for k in keys}
    arrays.update(stream_ranges=jp.stream_ranges, extract_idx=np.asarray(jp.extract_idx),
                  bwd_val_A=np.asarray(jp.formA.bwd_val), bwd_val_B=np.asarray(jp.formB.bwd_val))
    tp = interop.band_gemm_plan_from_jax(arrays, device="cpu")
    A, B = tp.formA.bwd_val, tp.formB.bwd_val
    C, _taken, _visited, _written = _emulate_gemm(A, B, tp.WC, tp.d0, tp.stream_ranges)
    want = np.asarray(spgemm.pallas_band_gemm(jnp.asarray(jp.formA.bwd_val), jnp.asarray(jp.formB.bwd_val), G=jp.G,
                                              WB=jp.WB, WC=jp.WC, d0=jp.d0, ranges=jp.stream_ranges,
                                              interpret=True))
    assert near_error(C.numpy(), want) <= (F32 if dtype == np.float32 else F64)


def test_gemm_non_finite_b_where_a_chunk_is_zero(jax_mods):
    """Deliberate divergence (ROADMAP queue 3): B holds Inf in slab rows 8-15
    of the one stream, where every A value of the slab's step 1 is zero.
    The plain version and the JAX kernel give NaN (0 * Inf) in that B
    column; the schedule skips the step and gives the finite product."""
    import jax.numpy as jnp

    spgemm = jax_mods[2]
    rng = np.random.default_rng(17)
    nblk, G, WA, WB, WC = 3, 32, 24, 24, 56
    A = rng.standard_normal((nblk, G, WA)).astype(np.float32)
    B = rng.standard_normal((nblk, G, WB)).astype(np.float32)
    A[:, :, 8:16] = 0.0
    B[:, 10, 5] = np.inf
    ranges = ((0, 24, 0), (0, 0, 0))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    want = np.asarray(spgemm.pallas_band_gemm(jnp.asarray(A), jnp.asarray(B), G=G, WB=WB, WC=WC, d0=0,
                                              ranges=ranges, interpret=True))
    assert np.all(np.isnan(want[:, :, 5]))
    plain = band_gemm_plain(At, Bt, WC, 0, ranges)
    assert torch.all(torch.isnan(plain[:, :, 5]))
    C, taken, visited, _written = _emulate_gemm(At, Bt, WC, 0, ranges)
    assert torch.all(torch.isfinite(C)) and taken < visited
    A0, B0 = A.copy(), B.copy()
    B0[:, 8:16] = 0.0  # the product with the skipped step's zeros taken out
    ref = band_gemm_plain(torch.from_numpy(A0), torch.from_numpy(B0), WC, 0, ranges)
    assert near_error(C.numpy(), ref.numpy()) <= F32
