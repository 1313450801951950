"""SpMM execution forms of the PyTorch port against the JAX package's planner.

For the same effective CSR (made from a seed with numpy), the port's
``bandtm``, ``diag``, ``ell``, ``ellhyb`` and ``bwdg`` builders and the
block windows of ``band_mxu_dt`` must give the JAX package's arrays:
structure and maps exactly, values exactly too (each is a pure scatter or
gather of the same values). A JAX form carried across with
`interop.mm_form_from_jax` serves the port's mm dispatch and gives the JAX
package's mm, within expected_precision(float64) on max |a - b| / max(|b|, 1).
"""

import numpy as np
import pytest
import torch

from aoclsparse_tpu_torch import MatrixDescriptor, Operation, create_csr, interop, update_values
from aoclsparse_tpu_torch.core.formats import CSR as TCSR
from aoclsparse_tpu_torch.ops.level3.csrmm import _run_mm_form
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

KINDS = ["bandtm", "diag", "ell", "ellhyb", "bwdg"]
KID = {"bandtm": 4, "diag": 7, "ell": 1, "ellhyb": 2, "bwdg": 3}


@pytest.fixture(scope="module")
def jax_pkg():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu
    from aoclsparse_tpu.planner import plan

    return aoclsparse_tpu, plan


def _coo(seed, m, halfw=5, n_far=12, long_rows=0):
    """Band with far outliers (a peel spill for bandtm) and optionally a few
    long rows (a tail spill for ellhyb): (ptr, ind, val)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 2 * halfw + 1)
    c = r + np.tile(np.arange(-halfw, halfw + 1), m)
    keep = (c >= 0) & (c < m) & (rng.random(r.size) < 0.8)
    r, c = r[keep], c[keep]
    fr = rng.integers(0, m, n_far)
    fc = (fr + rng.integers(m // 4, m // 2, n_far)) % m
    lr = np.repeat(rng.integers(0, m, long_rows), 40)
    lc = rng.integers(0, m, lr.size)
    r, c = np.r_[r, fr, lr], np.r_[c, fc, lc]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    keep = np.r_[True, (r[1:] != r[:-1]) | (c[1:] != c[:-1])]
    r, c = r[keep], c[keep]
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, r + 1, 1)
    return np.cumsum(ptr), c.astype(np.int32), rng.standard_normal(r.size)


OPERANDS = {
    "band_spill": dict(seed=1, m=1500),  # > 4096 nnz: bandtm peels a spill
    "long_rows": dict(seed=2, m=700, long_rows=6),  # ellhyb spills row tails
    "small": dict(seed=3, m=97, n_far=2),  # no peel
}


def _effective(jplan, spec, transpose=False):
    from aoclsparse_tpu import MatrixDescriptor as JM
    from aoclsparse_tpu.core.formats import CSR as JCSR

    ptr, ind, val = _coo(**spec)
    m = spec["m"]
    op = Operation.transpose if transpose else Operation.none
    jc = jplan.build_clean_csr(JCSR(ptr, ind, val, shape=(m, m)))
    tc = tplan.build_clean_csr(TCSR(torch.from_numpy(ptr), torch.from_numpy(ind), torch.from_numpy(val), shape=(m, m)))
    return jplan.build_effective_csr(jc, JM(), op), tplan.build_effective_csr(tc, MatrixDescriptor(), op)


def _jax_form(jplan, je, kind):
    if kind == "bandtm":
        return jplan._build_bandtm(je)
    if kind == "bwdg":
        return jplan._build_bwd(je, G=512, kind="bwdg")
    return jplan.build_exec_form(je, kind)


FIELDS = {
    "bandtm": ("bwd_W", "bwd_padL", "bandt_start"),
    "bwdg": ("bwd_W", "bwd_G", "bwd_base8", "bwd_padL", "bwd_n_pad", "bwd_rel"),
    "diag": ("dia_L", "dia_n_pad", "dia_offs_static"),
    "ell": (),
    "ellhyb": (),
}
ARRAYS = {
    "bandtm": ("bwd_dest", "bwd_val", "sp_ind", "sp_rows", "sp_val"),
    "bwdg": ("bwd_dest", "bwd_val"),
    "diag": ("dia_dest", "dia_val", "dia_offs"),
    "ell": ("ell_src", "ell_ind", "ell_val"),
    "ellhyb": ("ell_src", "ell_ind", "ell_val", "sp_ind", "sp_rows", "sp_val", "sp_src"),
}


def _host(a):
    return None if a is None else (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("operand", sorted(OPERANDS))
@pytest.mark.parametrize("kind", KINDS)
def test_form_arrays_match_jax(jax_pkg, kind, operand, transpose):
    _ast, jplan = jax_pkg
    je, te = _effective(jplan, OPERANDS[operand], transpose)
    jf, tf = _jax_form(jplan, je, kind), tplan.build_exec_form(te, kind)
    if kind == "bandtm" and jf is None:
        # the JAX package caps the band at its TPU kernel's VMEM budget; the
        # port at its own kernel's shared memory (band_max_w)
        assert jplan.BANDTM_MAX_W < tf.bwd_W
        jf = jplan.build_exec_form(je, "bandtm")
        tf = tplan.build_exec_form(te, "bwdg")
    assert tf.kind == jf.kind
    for f in FIELDS[kind]:
        assert getattr(tf, f) == getattr(jf, f), f
    for f in ARRAYS[kind]:
        a, b = _host(getattr(tf, f)), _host(getattr(jf, f))
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    if kind == "bandtm" and tf.bwd_W <= 129:
        np.testing.assert_array_equal(tf.band_mxu_dt().numpy(), np.asarray(jf.band_mxu_dt()))
        bf_t = tf.band_mxu_dt(bf16=True).float().numpy()
        np.testing.assert_array_equal(bf_t, np.asarray(jf.band_mxu_dt(bf16=True)).astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_carried_form_serves_mm_like_jax(jax_pkg, kind):
    ast, jplan = jax_pkg
    spec = OPERANDS["band_spill"]
    ptr, ind, val = _coo(**spec)
    m = spec["m"]
    J = ast.create_csr(m, m, ptr, ind, val)
    jf = jplan.get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind=kind)
    keys = ("bwd_val", "dia_val", "ell_val", "sp_val", "dia_offs", "ell_ind", "sp_ind", "sp_rows") + FIELDS[kind]
    arrays = {k: _host(getattr(jf, k)) if not isinstance(getattr(jf, k), (int, tuple)) else getattr(jf, k)
              for k in keys if getattr(jf, k, None) is not None}
    form = interop.mm_form_from_jax(kind, arrays, m, m, device="cpu")
    B = np.random.default_rng(4).standard_normal((m, 5))
    want = np.asarray(ast.mm(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0, kid=KID[kind]))
    got = _run_mm_form(form, torch.from_numpy(B), KID[kind])
    assert near_error(got.numpy(), want) <= expected_precision(torch.float64)


def test_refresh_after_update_values_equals_fresh_forms():
    ptr, ind, val = _coo(seed=5, m=900)
    A = create_csr(900, 900, ptr, ind, val, device="cpu")
    plan = tplan.get_plan(A)
    old = {k: plan.exec_form_for(MatrixDescriptor(), Operation.none, kind=k) for k in KINDS}
    old["bandtm"].band_mxu_dt(bf16=True)
    old["diag"].dia_bf16()
    new_val = np.random.default_rng(6).standard_normal(val.size)
    update_values(A, new_val)
    assert old["bandtm"]._derived is None and old["diag"]._derived is None
    fresh_plan = tplan.get_plan(create_csr(900, 900, ptr, ind, new_val, device="cpu"))
    for k in KINDS:
        fresh = fresh_plan.exec_form_for(MatrixDescriptor(), Operation.none, kind=k)
        for f in ARRAYS[k]:
            a, b = _host(getattr(old[k], f)), _host(getattr(fresh, f))
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{k}.{f}")


def test_bandtm_too_wide_falls_back_to_bwdg():
    """A window past the band kernel's shared memory builds the group form,
    as the JAX package's build_exec_form does past its own cap."""
    m = 600
    r = np.repeat(np.arange(m), 2)
    c = np.c_[np.arange(m), (np.arange(m) + 450) % m].reshape(-1)
    order = np.lexsort((c, r))
    A = create_csr(m, m, np.arange(m + 1) * 2, c[order].astype(np.int32), np.ones(2 * m), device="cpu")
    form = tplan.get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bandtm")
    assert form.kind == "bwdg"
