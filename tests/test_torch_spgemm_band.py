"""The SpGEMM band engine of the PyTorch port against aoclsparse_tpu.

- `build_band_gemm_plan` builds the JAX package's plans: WA, WB, WC, d0,
  sl0, nstream, relC, the stream ranges and the extraction map are equal
  (both at G = 32, the CPU's group size, under
  AOCLSPARSE_TPU_FORCE_BANDGEMM=1), and both refuse the same operands.
- The band GEMM's plain version (the CPU side of kernels/band_gemm.py) on
  the JAX package's own band operands (carried across by
  `interop.band_gemm_plan_from_jax`) against its Pallas kernel
  `pallas_band_gemm` in interpret mode and its scan engine
  `_band_gemm_scan`: m off a multiple of G, d0 < 0 and d0 > 0, streams
  whose block falls outside [0, nblk).
- sp2m, finalize after update_values and syrk through the band engine in
  both packages, and the port's band engine against its expansion engine.
- The CUDA kernel against its plain version (marked `cuda`, skipped
  without a card).

Tolerance: utils/tolerances.py's model, expected_precision(dtype) on
max |a - b| / max(|b|, 1): the same products summed in another order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import interop
from aoclsparse_tpu_torch.kernels.band_gemm import band_gemm, band_gemm_plain, band_gemm_steps
from aoclsparse_tpu_torch.kernels.spgemm_band import band_gemm_values, band_geometry, build_band_gemm_plan
from aoclsparse_tpu_torch.ops.level3.spgemm import _effective, _numeric_plan, _symbolic
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
F32 = expected_precision(torch.float32)
F64 = expected_precision(torch.float64)


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


@pytest.fixture(autouse=True)
def _force_band(monkeypatch):
    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", "1")
    for k in ("AOCLSPARSE_TPU_NO_BANDGEMM", "AOCLSPARSE_TPU_SPGEMM_HOST", "AOCLSPARSE_TPU_LAZY_SPGEMM"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def _banded(seed, m, lo, hi, per, dtype=np.float64):
    """`per` distinct columns a row in [row + lo, row + hi] (clipped to the
    matrix): scipy CSR."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), per)
    c = r + rng.integers(lo, hi + 1, r.size)
    keep = (c >= 0) & (c < m)
    S = sp.csr_matrix((rng.standard_normal(int(keep.sum())), (r[keep], c[keep])), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return sp.csr_matrix((S.data.astype(dtype), S.indices, S.indptr), shape=S.shape)


#: (m, A's offsets, B's offsets): a plain band; m off a multiple of G; A's
#: window right of the diagonal (d0 > 0, the last groups' streams out of
#: range); left of it (d0 < 0); and a wide A of many streams
PAIRS = [
    (400, (-8, 8), (-10, 10)),
    (513, (-30, 30), (-5, 12)),
    (450, (40, 70), (-6, 6)),
    (470, (-75, -40), (-3, 9)),
    (300, (-60, 70), (-20, 20)),
]


def _jax_plan(ast, SA, SB, G=32):
    from aoclsparse_tpu.kernels.xla.spgemm_band import build_band_gemm_plan as jbuild
    from aoclsparse_tpu.ops.level3.spgemm import _effective as jeff, _symbolic as jsym

    m = SA.shape[0]
    JA = ast.create_csr(m, m, SA.indptr.astype(np.int64), SA.indices.astype(np.int32), SA.data)
    JB = ast.create_csr(m, m, SB.indptr.astype(np.int64), SB.indices.astype(np.int32), SB.data)
    eA, eB = jeff(JA, ast.MatrixDescriptor(), ast.Operation.none), jeff(JB, ast.MatrixDescriptor(), ast.Operation.none)
    plan = jsym(eA, eB)
    return jbuild(eA, eB, plan.ptr, plan.ind, G=G, force=True), eA, eB


def _port_plan(SA, SB, G=32, dtype=None, force=True):
    m = SA.shape[0]
    TA = tt.create_csr(m, m, SA.indptr, SA.indices, SA.data if dtype is None else SA.data.astype(dtype), device="cpu")
    TB = tt.create_csr(m, m, SB.indptr, SB.indices, SB.data if dtype is None else SB.data.astype(dtype), device="cpu")
    eA, eB = _effective(TA, GEN, NONE), _effective(TB, GEN, NONE)
    plan = _symbolic(eA, eB)
    return build_band_gemm_plan(eA, eB, plan.ptr, plan.ind, G=G, force=force), eA, eB, plan


GEOMETRY = ("G", "WA", "WB", "WC", "d0", "sl0", "nstream", "relC", "nblk", "stream_ranges")


@pytest.mark.parametrize("m,offA,offB", PAIRS)
def test_plan_geometry_matches_jax(ast, m, offA, offB):
    SA, SB = _banded(1, m, *offA, 6), _banded(2, m, *offB, 5)
    jp, _, _ = _jax_plan(ast, SA, SB)
    tp, _, _, _ = _port_plan(SA, SB)
    if jp is None:
        assert tp is None
        return
    assert {k: getattr(tp, k) for k in GEOMETRY} == {k: getattr(jp, k) for k in GEOMETRY}
    np.testing.assert_array_equal(tp.extract_idx, np.asarray(jp.extract_idx))
    assert tp.formA.bwd_W == jp.formA.bwd_W and tp.formB.bwd_rel == jp.formB.bwd_rel


@pytest.mark.parametrize("G", [32, 128])
@pytest.mark.parametrize("m,offA,offB", PAIRS)
def test_symbolic_gate_matches_jax_estimate(ast, m, offA, offB, G):
    """The symbolic stage's gate (`band_geometry` before C's pattern exists)
    gives the JAX package's `_band_estimate`: the same refusals and the
    same two estimates."""
    from aoclsparse_tpu.ops.level3.spgemm import _band_estimate

    SA, SB = _banded(1, m, *offA, 6), _banded(2, m, *offB, 5)
    _, jA, jB = _jax_plan(ast, SA, SB)
    _, eA, eB, _ = _port_plan(SA, SB)
    want = _band_estimate(jA, jB, G=G)
    geo = band_geometry(eA, eB, G)
    if want is None:
        assert geo is None
        return
    np.testing.assert_allclose((geo.est_band, geo.est_exp), want, rtol=1e-12)


def test_plan_geometry_cases_cover_the_edges(ast):
    """The cases hold what they are for: d0 of both signs, m off G, and a
    plan of several streams."""
    plans = [_port_plan(_banded(1, m, *a, 6), _banded(2, m, *b, 5))[0] for m, a, b in PAIRS]
    assert {p.d0 > 0 for p in plans} == {True, False} and any(p.d0 < 0 for p in plans)
    assert any(p.nblk * p.G != m for p, (m, _a, _b) in zip(plans, PAIRS))
    assert max(p.nstream for p in plans) >= 4


def test_scattered_operand_refused_in_both(ast):
    rng = np.random.default_rng(3)
    m = 256
    r = np.repeat(np.arange(m), 4)
    S = sp.csr_matrix((np.ones(r.size), (r, rng.integers(0, m, r.size))), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    from aoclsparse_tpu.kernels.xla.spgemm_band import build_band_gemm_plan as jbuild

    _, eA, _ = _jax_plan(ast, S, S)
    jplan = __import__("aoclsparse_tpu.ops.level3.spgemm", fromlist=["_symbolic"])._symbolic(eA, eA)
    assert jbuild(eA, eA, jplan.ptr, jplan.ind, G=32, force=False) is None
    assert _port_plan(S, S, force=False)[0] is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,offA,offB,G", [(1024, (-16, 16), (-16, 16), 32), (1024, (-48, 48), (-40, 48), 128),
                                           (513, (-30, 30), (-5, 12), 32), (450, (40, 70), (-6, 6), 32)])
def test_plain_matches_pallas_and_scan(ast, dtype, m, offA, offB, G):
    import jax.numpy as jnp
    from aoclsparse_tpu.kernels.pallas.spgemm import pallas_band_gemm
    from aoclsparse_tpu.kernels.xla.spgemm_band import _band_gemm_scan, _ensure_streams

    SA, SB = _banded(4, m, *offA, 8, dtype), _banded(5, m, *offB, 8, dtype)
    jp, eA, eB = _jax_plan(ast, SA, SB, G=G)
    jp.formA.refresh(eA.val)
    jp.formB.refresh(eB.val)
    arrays = {k: getattr(jp, k) for k in GEOMETRY if k != "stream_ranges"}
    arrays.update(stream_ranges=jp.stream_ranges, extract_idx=np.asarray(jp.extract_idx),
                  bwd_val_A=np.asarray(jp.formA.bwd_val), bwd_val_B=np.asarray(jp.formB.bwd_val))
    tp = interop.band_gemm_plan_from_jax(arrays, device="cpu")
    got = band_gemm(tp.formA.bwd_val, tp.formB.bwd_val, tp.WC, tp.d0, tp.stream_ranges)
    assert got.shape == (tp.nblk, G, tp.WC) and got.dtype == tp.formA.bwd_val.dtype
    kw = dict(G=jp.G, WB=jp.WB, WC=jp.WC, ranges=jp.stream_ranges)
    scan = np.asarray(_band_gemm_scan(jp.formA.bwd_val, _ensure_streams(jp), **kw))
    pallas = np.asarray(pallas_band_gemm(jnp.asarray(jp.formA.bwd_val), jnp.asarray(jp.formB.bwd_val), d0=jp.d0,
                                         interpret=True, **kw))
    tol = F32 if dtype == np.float32 else F64
    assert near_error(got.numpy(), scan) <= tol
    assert near_error(got.numpy(), pallas) <= tol
    # the values through the extraction map are the product's: slot
    # (G g + r) WC + c holds C[G g + r, G g + relC + c]
    vals = got.reshape(-1)[torch.from_numpy(tp.extract_idx)].numpy()
    rows = tp.extract_idx // tp.WC
    cols = (rows // G) * G + tp.relC + tp.extract_idx % tp.WC
    dense = (SA.astype(np.float64) @ SB.astype(np.float64)).toarray()
    assert near_error(vals, dense[rows, cols]) <= tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_band_engine_matches_expansion(dtype):
    SA, SB = _banded(6, 513, -30, 30, 7), _banded(7, 513, -12, 20, 6)
    bp, eA, eB, plan = _port_plan(SA, SB, dtype=dtype)
    v_band = band_gemm_values(bp, eA.val, eB.val)
    v_exp = _numeric_plan(plan, eA.val, eB.val, False, False)
    assert v_band.dtype == v_exp.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert near_error(v_band.numpy(), v_exp.numpy()) <= (F32 if dtype == np.float32 else F64)


def _pair(ast, S):
    m, n = S.shape
    return (ast.create_csr(m, n, S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data),
            tt.create_csr(m, n, S.indptr, S.indices, S.data, device="cpu"))


def _same_values(ast, J, T, tol):
    _, _, _, jp, ji, jv = ast.export_csr(J)
    _, _, _, tp, ti, tv = tt.export_csr(T)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    assert near_error(tv, np.asarray(jv)) <= tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sp2m_band_engine_and_refinalize_match_jax(ast, dtype):
    SA, SB = _banded(8, 300, -9, 9, 5, dtype), _banded(9, 300, -11, 6, 5, dtype)
    (JA, TA), (JB, TB) = _pair(ast, SA), _pair(ast, SB)
    jn, jg = ast.Operation.none, ast.MatrixDescriptor()
    tol = F32 if dtype == np.float32 else F64
    J = ast.sp2m(jn, jg, JA, jn, jg, JB)
    T = tt.sp2m(NONE, GEN, TA, NONE, GEN, TB)
    assert T._spgemm_plan.band is not None and J._spgemm_plan.band is not None
    assert T._spgemm_plan.pa is None  # the band-first symbolic stage: pattern only
    _same_values(ast, J, T, tol)
    newv = np.random.default_rng(10).standard_normal(SB.nnz).astype(dtype)
    ast.update_values(JB, newv)
    tt.update_values(TB, newv)
    J = ast.sp2m(jn, jg, JA, jn, jg, JB, ast.Request.finalize, J)
    tt.sp2m(NONE, GEN, TA, NONE, GEN, TB, tt.Request.finalize, T)
    _same_values(ast, J, T, tol)
    SB2 = sp.csr_matrix((newv.astype(np.float64), SB.indices, SB.indptr), shape=SB.shape)
    _, _, _, p, i, v = tt.export_csr(T)
    assert near_error(sp.csr_matrix((v, i, p), shape=SB.shape).toarray(),
                      (SA.astype(np.float64) @ SB2).toarray()) <= tol


def test_syrk_upper_on_the_band_engine_matches_jax(ast):
    S = _banded(11, 320, -7, 7, 5)
    J, T = _pair(ast, S)
    C = tt.syrk(NONE, T)
    assert C._spgemm_plan.band is not None
    _same_values(ast, ast.syrk(ast.Operation.none, J), C, F64)
    _, _, _, p, i, _v = tt.export_csr(C)
    assert np.all(i >= np.repeat(np.arange(320), np.diff(p)))
    assert getattr(C, "_seed_bwdg", None) is None  # the band holds both triangles: never seeded


def test_complex_product_takes_another_engine(ast):
    S = _banded(12, 200, -6, 6, 4)
    Sc = sp.csr_matrix((S.data * (1 + 0.5j), S.indices, S.indptr), shape=S.shape)
    J, T = _pair(ast, Sc)
    C = tt.spmm(T, T)
    assert C._spgemm_plan.band is None
    _same_values(ast, ast.spmm(J, J), C, F64)


def test_wrapper_checks():
    A = torch.zeros(3, 32, 16)
    with pytest.raises(tt.AoclSparseError) as e:
        band_gemm(A, A.double(), 48, 0, ((0, 16, 0),))
    assert e.value.status == tt.Status.wrong_type
    with pytest.raises(tt.AoclSparseError) as e:
        band_gemm(A.to(torch.complex64), A.to(torch.complex64), 48, 0, ((0, 16, 0),))
    assert e.value.status == tt.Status.wrong_type
    with pytest.raises(tt.AoclSparseError) as e:
        band_gemm(A, A, 16, 0, ((0, 16, 0), (0, 8, 0)))  # the second stream leaves C
    assert e.value.status == tt.Status.invalid_value
    with pytest.raises(tt.AoclSparseError) as e:
        band_gemm(A, A, 48, 0, ((0, 16, 20),))  # slab rows past the group
    assert e.value.status == tt.Status.invalid_value
    with pytest.raises(tt.AoclSparseError) as e:
        band_gemm(A, A, 200, 0, tuple((0, 0, 0) for _ in range(7)))
    assert e.value.status == tt.Status.invalid_size
    # empty streams and out-of-range blocks leave zeros
    out = band_gemm_plain(torch.ones(2, 32, 16), torch.ones(2, 32, 16), 48, 5, ((0, 16, 0), (3, 3, 0)))
    assert out.shape == (2, 32, 48) and not out.any()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

#: (m, A's offsets, B's offsets, G): the card's G = 128 on a band; m off G
#: with d0 > 0; G = 32 with many streams and blocks out of range
CARD_CASES = [(4000, (-60, 60), (-50, 70), 128), (3001, (130, 200), (-9, 9), 128), (1100, (-60, 70), (-20, 20), 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,offA,offB,G", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda, dtype, m, offA, offB, G):
    bp, eA, eB, _plan = _port_plan(_banded(13, m, *offA, 9, dtype), _banded(14, m, *offB, 9, dtype), G=G)
    bp.formA.refresh(eA.val)
    bp.formB.refresh(eB.val)
    A, B = bp.formA.bwd_val.to(cuda), bp.formB.bwd_val.to(cuda)
    before = dict(band_gemm.launches)
    got = band_gemm(A, B, bp.WC, bp.d0, bp.stream_ranges)
    torch.cuda.synchronize()
    inst = "f32" if dtype == np.float32 else "f64"
    assert band_gemm.launches[inst] == before[inst] + 1
    want = band_gemm_plain(A, B, bp.WC, bp.d0, bp.stream_ranges)
    assert near_error(got.cpu().double().numpy(), want.cpu().double().numpy()) <= (F32 if inst == "f32" else F64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,offA,offB,G", CARD_CASES)
def test_kernel_dense_and_sparse_bands_on_card(cuda, dtype, m, offA, offB, G):
    """The kernel's skip vote on both sides: the plan's sparse bands (some
    warp steps skipped) and the same plan with dense bands (every step in
    the slab and the streams' columns taken), against the plain version,
    the same bits twice."""
    bp, eA, eB, _plan = _port_plan(_banded(13, m, *offA, 9, np.float32), _banded(14, m, *offB, 9, np.float32), G=G)
    bp.formA.refresh(eA.val)
    bp.formB.refresh(eB.val)
    rng = np.random.default_rng(21)
    sparse = (bp.formA.bwd_val.to(cuda, dtype), bp.formB.bwd_val.to(cuda, dtype))
    dense = tuple(torch.from_numpy(rng.standard_normal(tuple(t.shape))).to(cuda, dtype) for t in sparse)
    takes = []
    for A, B in (sparse, dense):
        got = band_gemm(A, B, bp.WC, bp.d0, bp.stream_ranges)
        assert torch.equal(band_gemm(A, B, bp.WC, bp.d0, bp.stream_ranges), got)
        want = band_gemm_plain(A, B, bp.WC, bp.d0, bp.stream_ranges)
        assert near_error(got.cpu().double().numpy(), want.cpu().double().numpy()) <= (
            F32 if dtype == torch.float32 else F64)
        takes.append(band_gemm_steps(A, B, bp.WC, bp.d0, bp.stream_ranges))
    assert takes[0][0] < takes[0][1] and takes[0][0] < takes[1][0]


@pytest.mark.cuda
def test_sp2m_on_card_launches_once_per_numeric_pass(cuda, monkeypatch):
    monkeypatch.delenv("AOCLSPARSE_TPU_FORCE_BANDGEMM")
    S = _banded(15, 5000, -40, 40, 12, np.float32)
    A = tt.create_csr(5000, 5000, S.indptr, S.indices, S.data, device=cuda)
    before = band_gemm.launches["f32"]
    C = tt.sp2m(NONE, GEN, A, NONE, GEN, A, tt.Request.nnz_count)
    assert band_gemm.launches["f32"] == before
    C = tt.sp2m(NONE, GEN, A, NONE, GEN, A, tt.Request.finalize, C)
    assert band_gemm.launches["f32"] == before + 1 and C.values_pending
    _, _, _, p, i, v = tt.export_csr(C)
    want = (S.astype(np.float64) @ S.astype(np.float64)).toarray()
    got = sp.csr_matrix((v, i, p), shape=S.shape).toarray()
    assert near_error(got, want) <= F32


@pytest.mark.cuda
def test_product_without_band_plan_stays_on_card(cuda, monkeypatch):
    """A product that no band plan takes, past the host engine's CPU size
    gate, runs on the device expansion engine when its operands are on the
    card: its triples are uploaded and no band GEMM launches."""
    monkeypatch.delenv("AOCLSPARSE_TPU_FORCE_BANDGEMM")
    S = sp.random(1000, 1000, density=0.05, random_state=np.random.default_rng(16), format="csr",
                  dtype=np.float32)
    S.sort_indices()
    A = tt.create_csr(1000, 1000, S.indptr, S.indices, S.data, device=cuda)
    before = dict(band_gemm.launches)
    C = tt.spmm(A, A)
    plan = C._spgemm_plan
    assert plan.band is None and plan.P > (1 << 17) and plan._dev_trip is not None
    assert dict(band_gemm.launches) == before
    _, _, _, p, i, v = tt.export_csr(C)
    want = (S.astype(np.float64) @ S.astype(np.float64)).toarray()
    assert near_error(sp.csr_matrix((v, i, p), shape=S.shape).toarray(), want) <= F32


def test_chip_smoke_operand_copies_equal_the_benchmarks():
    """chip_smoke.py's copies of the cant stand-in (benchmarks/realmat.py)
    and of the suite's banded generator (benchmarks/suite.py) build the same
    arrays for the same seed."""
    import importlib.util
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    mods = {}
    for name, path in (("chip_smoke", repo / "chip_smoke.py"), ("realmat", repo / "benchmarks" / "realmat.py"),
                       ("suite", repo / "benchmarks" / "suite.py")):
        spec = importlib.util.spec_from_file_location(f"_copy_{name}", path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    got = mods["chip_smoke"].cant(np.random.default_rng(7))
    want = mods["realmat"].generate("cant", seed=7)
    assert len(got) == len(want) == 5 and got[0] == 62469
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = mods["chip_smoke"].suite_banded(np.random.default_rng(7), 4096, 4096, 32, 16)
    want = mods["suite"].banded(np.random.default_rng(7), 4096, 4096, 32, 16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
