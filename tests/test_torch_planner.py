"""Planner of the PyTorch port against the JAX package's planner.

For the same CSR (made from a seed with numpy), the port's
`build_clean_csr`, `build_effective_csr` and `_build_bandt` must give the
JAX package's arrays: structure and maps exactly, values to the rounding of
a duplicate merge (summed in another order: f64 model tolerance), since
everything else is a pure gather or scatter of the same values.
"""

import numpy as np
import pytest
import torch

from aoclsparse_tpu_torch import (
    DiagType,
    FillMode,
    MatrixDescriptor,
    MatrixType,
    Operation,
    create_csr,
    update_values,
)
from aoclsparse_tpu_torch.core.formats import CSR as TCSR
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision

DESCRS = {
    "general": (MatrixDescriptor(), Operation.none),
    "transpose": (MatrixDescriptor(), Operation.transpose),
    "symmetric": (MatrixDescriptor(type=MatrixType.symmetric, fill_mode=FillMode.lower), Operation.none),
    "upper_sym_t": (MatrixDescriptor(type=MatrixType.symmetric, fill_mode=FillMode.upper), Operation.transpose),
    "lower_tri": (MatrixDescriptor(type=MatrixType.triangular, fill_mode=FillMode.lower), Operation.none),
    "lower_unit": (
        MatrixDescriptor(type=MatrixType.triangular, fill_mode=FillMode.lower, diag_type=DiagType.unit),
        Operation.none,
    ),
}
VTOL = expected_precision(torch.float64)


@pytest.fixture(scope="module")
def jplan():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.planner import plan

    return plan


def _to_jax_descr(d):
    from aoclsparse_tpu import DiagType as JD, FillMode as JF, MatrixDescriptor as JM, MatrixType as JT

    return JM(type=JT(int(d.type)), fill_mode=JF(int(d.fill_mode)), diag_type=JD(int(d.diag_type)))


def _band_coo(seed, m, halfw=4, n_far=12, dup=0, shuffle=False):
    """Band rows/cols/vals with far outliers, optional duplicates and an
    unsorted column order within rows."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 2 * halfw + 1)
    c = r + np.tile(np.arange(-halfw, halfw + 1), m)
    keep = (c >= 0) & (c < m) & (rng.random(r.size) < 0.8)
    r, c = r[keep], c[keep]
    fr = rng.integers(0, m, n_far)
    fc = (fr + rng.integers(m // 4, m // 2, n_far)) % m
    r, c = np.r_[r, fr], np.r_[c, fc]
    if dup:
        pick = rng.integers(0, r.size, dup)
        r, c = np.r_[r, r[pick]], np.r_[c, c[pick]]
    order = np.lexsort((rng.random(r.size) if shuffle else c, r))
    r, c = r[order], c[order]
    v = rng.standard_normal(r.size)
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, r + 1, 1)
    return np.cumsum(ptr), c.astype(np.int32), v


def _both_clean(jplan, ptr, ind, val, m):
    from aoclsparse_tpu.core.formats import CSR as JCSR

    jc = jplan.build_clean_csr(JCSR(ptr, ind, val, shape=(m, m)))
    tc = tplan.build_clean_csr(
        TCSR(torch.from_numpy(ptr), torch.from_numpy(ind), torch.from_numpy(val), shape=(m, m))
    )
    return jc, tc


OPERANDS = {
    "sorted": dict(seed=1, m=1500),  # > 4096 nnz: the band peels a spill
    "unsorted": dict(seed=2, m=1500, shuffle=True),
    "duplicates": dict(seed=3, m=1500, dup=300, shuffle=True),
    "small": dict(seed=4, m=97, n_far=2),  # <= 4096 nnz: no peel
}


@pytest.mark.parametrize("operand", sorted(OPERANDS))
def test_clean_csr_matches_jax(jplan, operand):
    spec = OPERANDS[operand]
    ptr, ind, val = _band_coo(**spec)
    jc, tc = _both_clean(jplan, ptr, ind, val, spec["m"])
    for f in ("ptr", "ind", "perm", "idiag", "iurow", "has_diag"):
        np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)), err_msg=f)
    assert tc.fulldiag == jc.fulldiag
    assert (tc.merge_seg is None) == (jc.merge_seg is None) == (operand != "duplicates")
    np.testing.assert_allclose(tc.val.numpy(), np.asarray(jc.val), rtol=VTOL, atol=VTOL)


@pytest.mark.parametrize("descr", sorted(DESCRS))
@pytest.mark.parametrize("operand", ["sorted", "duplicates", "small"])
def test_effective_csr_and_bandt_match_jax(jplan, descr, operand):
    spec = OPERANDS[operand]
    ptr, ind, val = _band_coo(**spec)
    jc, tc = _both_clean(jplan, ptr, ind, val, spec["m"])
    d, op = DESCRS[descr]
    je = jplan.build_effective_csr(jc, _to_jax_descr(d), op)
    te = tplan.build_effective_csr(tc, d, op)
    for f in ("ptr", "ind", "src"):
        np.testing.assert_array_equal(getattr(te, f), np.asarray(getattr(je, f)), err_msg=f)
    assert te.shape == je.shape
    np.testing.assert_allclose(te.val.numpy(), np.asarray(je.val), rtol=VTOL, atol=VTOL)

    jf = jplan._build_bandt(je)
    tf = tplan._build_bandt(te)
    assert (jf, tf) != (None, None)
    for f in ("bwd_W", "bwd_padL", "bandt_start"):
        assert getattr(tf, f) == getattr(jf, f), f
    np.testing.assert_array_equal(tf.bwd_dest, jf.bwd_dest)
    np.testing.assert_allclose(tf.bwd_val.numpy(), np.asarray(jf.bwd_val), rtol=VTOL, atol=VTOL)
    assert tf.has_spill == (jf.sp_ind is not None) == (operand != "small")
    if tf.has_spill:
        np.testing.assert_array_equal(tf.sp_ind.numpy(), np.asarray(jf.sp_ind))
        np.testing.assert_array_equal(tf.sp_rows.numpy(), np.asarray(jf.sp_rows))
        np.testing.assert_allclose(tf.sp_val.numpy(), np.asarray(jf.sp_val), rtol=VTOL, atol=VTOL)


def test_complex_hermitian_effective_matches_jax(jplan):
    ptr, ind, val = _band_coo(seed=5, m=200, n_far=3)
    val = val + 1j * np.random.default_rng(6).standard_normal(val.size)
    jc, tc = _both_clean(jplan, ptr, ind, val, 200)
    for op in Operation:
        d = MatrixDescriptor(type=MatrixType.hermitian, fill_mode=FillMode.upper)
        je = jplan.build_effective_csr(jc, _to_jax_descr(d), op)
        te = tplan.build_effective_csr(tc, d, op)
        np.testing.assert_array_equal(te.ind, np.asarray(je.ind))
        np.testing.assert_allclose(te.val.numpy(), np.asarray(je.val), rtol=VTOL, atol=VTOL)


def test_choose_mv_format_rederived_for_hopper():
    """Band operands take the band form; scattered square ones go to the
    general-structure composite, whose `_build_gen` rejects random structure and
    falls back to the gather form (the whole-matrix route waits for 2e6
    entries); complex ones take the gather form (no band kernel instance);
    explicit kinds still build (a bandt request whose row window is too
    wide ends on the bwd group windows, as in the JAX package)."""
    ptr, ind, val = _band_coo(seed=7, m=800, n_far=4)
    A = create_csr(800, 800, ptr, ind, val, device="cpu")
    plan = tplan.get_plan(A)
    assert plan.exec_form_for(MatrixDescriptor(), Operation.none).kind == "bandt"
    rng = np.random.default_rng(8)
    m = 800
    cols = np.sort(rng.integers(0, m, (m, 3)), axis=1).reshape(-1).astype(np.int32)
    B = create_csr(m, m, np.arange(m + 1) * 3, cols, rng.standard_normal(3 * m), device="cpu")
    eff = tplan.get_plan(B).effective_for(MatrixDescriptor(), Operation.none)
    assert tplan.choose_mv_format(eff) == "gen" and tplan._build_gen(eff) is None
    assert tplan.get_plan(B).exec_form_for(MatrixDescriptor(), Operation.none).kind == "ell"
    assert tplan.gather_fallback_kind(eff) == "ell"
    assert tplan.get_plan(B).exec_form_for(MatrixDescriptor(), Operation.none, kind="bandt").kind in (
        "bandt",
        "bwd",
    )
    C = create_csr(800, 800, ptr, ind, val.astype(np.complex128), device="cpu")
    assert tplan.get_plan(C).exec_form_for(MatrixDescriptor(), Operation.none).kind == "segsum"


def test_refresh_after_update_values_equals_fresh_plan():
    ptr, ind, val = _band_coo(seed=9, m=1500, dup=50, shuffle=True)
    A = create_csr(1500, 1500, ptr, ind, val, device="cpu")
    d, op = DESCRS["symmetric"]
    old = tplan.get_plan(A).exec_form_for(d, op)
    old.band_bf16()
    new_val = np.random.default_rng(10).standard_normal(val.size)
    update_values(A, new_val)
    assert old._bwd_val_bf16 is None  # derived bf16 band dropped by refresh
    fresh = tplan.get_plan(create_csr(1500, 1500, ptr, ind, new_val, device="cpu")).exec_form_for(d, op)
    np.testing.assert_allclose(old.bwd_val.numpy(), fresh.bwd_val.numpy(), rtol=VTOL, atol=VTOL)
    np.testing.assert_allclose(old.sp_val.numpy(), fresh.sp_val.numpy(), rtol=VTOL, atol=VTOL)
