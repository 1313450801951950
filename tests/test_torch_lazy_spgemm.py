"""Lazy band-product values of the PyTorch port, mirroring
tests/test_lazy_spgemm.py, and mv KID 9 (the group-band SpMV a product's
seeded band runs on) against aoclsparse_tpu.

A SpGEMM product computed on the band engine leaves its CSR values pending
(AOCLSPARSE_TPU_LAZY_SPGEMM=1; the default on the card): structure queries
and a chained `mv` run without materializing them, `export_csr`
materializes exactly the product, `update_values` on a pending handle
replaces them without materializing the stale ones, a finalize re-run
recomputes them, and a transposed `mv` needs the plan and materializes
them. Values are held to float64 references (dense numpy, or the JAX
package on the same operands) by utils/tolerances.py's model,
expected_precision(float64) on max |a - b| / max(|b|, 1).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels.registry import registry
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE, TRANS = tt.Operation.none, tt.Operation.transpose
F64 = expected_precision(torch.float64)


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


@pytest.fixture(autouse=True)
def _force_band_lazy(monkeypatch):
    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", "1")
    monkeypatch.setenv("AOCLSPARSE_TPU_LAZY_SPGEMM", "1")
    for k in ("AOCLSPARSE_TPU_NO_BANDGEMM", "AOCLSPARSE_TPU_SPGEMM_HOST"):
        monkeypatch.delenv(k, raising=False)


def _band(seed, m, half=6, per=4):
    """`per` columns a row in a window of 2 half: (handle, dense)."""
    rng = np.random.default_rng(seed)
    base = np.clip(np.arange(m) - half, 0, m - 2 * half)
    pick = np.argsort(rng.random((m, 2 * half)), axis=1)[:, :per]
    cols = np.sort(base[:, None] + pick, axis=1).reshape(-1)
    ptr = np.arange(m + 1) * per
    val = rng.standard_normal(m * per)
    dense = np.zeros((m, m))
    dense[np.repeat(np.arange(m), per), cols] = val
    return tt.create_csr(m, m, ptr, cols, val, device="cpu"), dense


def _dense_of(C):
    m, n, _, ptr, ind, val = tt.export_csr(C)
    out = np.zeros((m, n))
    out[np.repeat(np.arange(m), np.diff(ptr)), ind] = val
    return out


def _mv(C, x, op=NONE, **kw):
    return tt.mv(1.0, C, GEN, op, torch.from_numpy(x), 0.0, **kw).numpy()


def test_full_computation_defers_extraction():
    A, dA = _band(11, 192)
    B, dB = _band(12, 192)
    C = tt.spmm(A, B)
    assert C._spgemm_plan.band is not None and C.values_pending
    # structure queries answer without materializing
    assert C.shape == (192, 192) and C.nnz > 0 and C.dtype == torch.float64 and C.device == torch.device("cpu")
    assert C.values_pending
    # a chained mv runs on the seeded band (KID 9) and leaves them pending
    x = np.random.default_rng(13).standard_normal(192)
    assert near_error(_mv(C, x), dA @ dB @ x) <= F64
    assert C.values_pending and C.plan is None
    # reading CSR values materializes exactly the product
    got = _dense_of(C)
    assert not C.values_pending
    assert near_error(got, dA @ dB) <= F64
    # the seed's staleness key is seated: mv now plants it in the plan
    assert C._seed_bwdg_val is C.data.val
    assert near_error(_mv(C, x), dA @ dB @ x) <= F64
    assert C.plan.exec_form_for(GEN, NONE) is C._seed_bwdg


def test_finalize_lazy_and_refinalize():
    A, dA = _band(14, 160)
    B, dB = _band(15, 160)
    C = tt.sp2m(NONE, GEN, A, NONE, GEN, B, request=tt.Request.nnz_count)
    assert C._spgemm_plan.band is not None and not C.values_pending
    C = tt.sp2m(NONE, GEN, A, NONE, GEN, B, request=tt.Request.finalize, C=C)
    assert C.values_pending
    assert near_error(_dense_of(C), dA @ dB) <= F64
    # serving loop: new operand values, finalize again, still right
    _m, _n, _, _ptr, _ind, val = tt.export_csr(A)
    tt.update_values(A, val * 2)
    C = tt.sp2m(NONE, GEN, A, NONE, GEN, B, request=tt.Request.finalize, C=C)
    assert C.values_pending and C.plan is None
    x = np.random.default_rng(16).standard_normal(160)
    assert near_error(_mv(C, x), 2 * dA @ dB @ x) <= F64
    assert near_error(_dense_of(C), 2 * dA @ dB) <= F64


def test_chained_spgemm_consumes_the_seed():
    """A pending product as an sp2m operand: its seeded band is the chained
    product's operand band (no relayout, no first refresh)."""
    A, dA = _band(17, 160)
    C1 = tt.spmm(A, A)
    assert C1.values_pending
    C2 = tt.spmm(C1, A)
    assert C2._spgemm_plan.band.formA is C1._seed_bwdg
    assert near_error(_dense_of(C2), dA @ dA @ dA) <= F64


def test_update_values_on_pending_skips_extraction():
    A, _dA = _band(18, 128)
    C = tt.spmm(A, A)
    assert C.values_pending
    calls = []
    lazy = C._lazy
    C._lazy = (*lazy[:4], lambda: calls.append(1) or lazy[4]())
    new = np.arange(1.0, C.nnz + 1.0)
    tt.update_values(C, new)
    assert not C.values_pending and not calls
    m, n, _, ptr, ind, val = tt.export_csr(C)
    np.testing.assert_array_equal(val, new)
    # the stale seed must not serve mv any more
    dense = np.zeros((m, n))
    dense[np.repeat(np.arange(m), np.diff(ptr)), ind] = new
    x = np.random.default_rng(19).standard_normal(128)
    assert near_error(_mv(C, x), dense @ x) <= F64
    assert C.plan.exec_form_for(GEN, NONE) is not C._seed_bwdg
    with pytest.raises(tt.AoclSparseError) as e:
        tt.update_values(tt.spmm(A, A), np.ones(3))
    assert e.value.status == tt.Status.invalid_size


def test_transpose_mv_materializes():
    A, dA = _band(20, 128)
    C = tt.spmm(A, A)
    x = np.random.default_rng(21).standard_normal(128)
    assert near_error(_mv(C, x, TRANS), (dA @ dA).T @ x) <= F64
    assert not C.values_pending  # the transpose needs the plan


def test_pending_product_in_mixed_mode():
    """The handle's precision policy reaches the seeded band: bf16 operands,
    f32 accumulation, within docs/precision.md's bound (two bf16 roundings
    a product: the band and x)."""
    A, dA = _band(22, 256)
    Af = tt.create_csr(256, 256, *tt.export_csr(A)[3:5], tt.export_csr(A)[5].astype(np.float32), device="cpu")
    C = tt.spmm(Af, Af)
    tt.set_precision_mode(C, "mixed")
    x = np.random.default_rng(23).standard_normal(256).astype(np.float32)
    y = tt.mv(1.0, C, GEN, NONE, torch.from_numpy(x), 0.0).double().numpy()
    assert C.values_pending
    d = dA.astype(np.float32).astype(np.float64)
    ref = d @ d @ x
    bound = 2 * 2.0**-8 * (np.abs(d @ d) @ np.abs(x)) + 2.0**-23 * 64 * np.abs(ref) + 1e-30
    assert np.all(np.abs(y - ref) <= bound)


def test_lazy_products_match_jax(ast, monkeypatch):
    """Both packages in lazy mode: the chained mv on the pending product and
    the materialized values agree."""
    A, dA = _band(24, 200)
    m, n, _, p, i, v = tt.export_csr(A)
    J = ast.create_csr(m, n, p.astype(np.int64), i.astype(np.int32), v)
    JC, TC = ast.spmm(J, J), tt.spmm(A, A)
    assert JC.values_pending and TC.values_pending
    x = np.random.default_rng(25).standard_normal(m)
    want = np.asarray(ast.mv(1.0, JC, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0))
    assert near_error(_mv(TC, x), want) <= F64
    _, _, _, jp, ji, jv = ast.export_csr(JC)
    _, _, _, tp, ti, tv = tt.export_csr(TC)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    assert near_error(tv, np.asarray(jv)) <= F64


@pytest.mark.parametrize("lazy", ["0", "1"])
def test_product_mv_runs_kid9_in_both(ast, monkeypatch, lazy):
    """With lazy values off (the CPU default) the seed is planted at the
    handle's first get_plan: the default mv form of the product is its band,
    in both packages."""
    monkeypatch.setenv("AOCLSPARSE_TPU_LAZY_SPGEMM", lazy)
    A, dA = _band(26, 224)
    m, n, _, p, i, v = tt.export_csr(A)
    J = ast.create_csr(m, n, p.astype(np.int64), i.astype(np.int32), v)
    JC, TC = ast.spmm(J, J), tt.spmm(A, A)
    x = np.random.default_rng(27).standard_normal(m)
    want = np.asarray(ast.mv(1.0, JC, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0))
    assert near_error(_mv(TC, x), want) <= F64
    if lazy == "0":
        assert TC.plan.exec_form_for(GEN, NONE).kind == "bwdg"
        assert ast.planner.plan.get_plan(JC).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none).kind == "bwdg"


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mv_kid9_matches_jax(ast, dtype):
    """mv KID 9 on a plain matrix: the G = 512 group form, both packages."""
    rng = np.random.default_rng(28)
    m = 1100
    r = np.repeat(np.arange(m), 9)
    c = np.clip(r + rng.integers(-40, 41, r.size), 0, m - 1)
    S = sp.csr_matrix((rng.standard_normal(r.size), (r, c)), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    data = S.data.astype(dtype)
    J = ast.create_csr(m, m, S.indptr.astype(np.int64), S.indices.astype(np.int32), data)
    T = tt.create_csr(m, m, S.indptr, S.indices, data, device="cpu")
    x = rng.standard_normal(m).astype(dtype)
    want = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0, kid=9))
    got = _mv(T, x, kid=9)
    tol = expected_precision(torch.float32 if dtype == np.float32 else torch.float64)
    assert near_error(got, want) <= tol
    assert near_error(got, S @ x.astype(np.float64)) <= tol
    assert registry.select("mv", fmt="bwdg", device="cpu").kid == 9


def test_planted_seed_refreshes_with_update_values(monkeypatch):
    """A product whose seed was planted in its plan (lazy values off): an
    update_values rescatters the new values into the same band through the
    extraction map, and mv follows them."""
    monkeypatch.setenv("AOCLSPARSE_TPU_LAZY_SPGEMM", "0")
    A, dA = _band(29, 200)
    C = tt.spmm(A, A)
    x = np.random.default_rng(30).standard_normal(200)
    assert not C.values_pending and near_error(_mv(C, x), dA @ dA @ x) <= F64
    form = C.plan.exec_form_for(GEN, NONE)
    assert form is C._seed_bwdg
    m, n, _, ptr, ind, _val = tt.export_csr(C)
    new = np.random.default_rng(31).standard_normal(C.nnz)
    tt.update_values(C, new)
    dense = np.zeros((m, n))
    dense[np.repeat(np.arange(m), np.diff(ptr)), ind] = new
    assert near_error(_mv(C, x), dense @ x) <= F64
    assert C.plan.exec_form_for(GEN, NONE) is form and form.kind == "bwdg"


def test_host_extraction_route():
    """A plan whose extraction route is pinned to "host" (the JAX package's
    autotune_spgemm pins it; the port keeps the attribute at "gather"):
    the pending values come from the native host numeric engine, the
    chained mv still from the band."""
    A, dA = _band(32, 176)
    C = tt.sp2m(NONE, GEN, A, NONE, GEN, A, request=tt.Request.nnz_count)
    C._spgemm_plan._extract_route = "host"
    C = tt.sp2m(NONE, GEN, A, NONE, GEN, A, request=tt.Request.finalize, C=C)
    x = np.random.default_rng(33).standard_normal(176)
    assert C.values_pending and near_error(_mv(C, x), dA @ dA @ x) <= F64
    assert near_error(_dense_of(C), dA @ dA) <= F64
    assert C._spgemm_plan.pa is not None  # the host route filled in the triples
