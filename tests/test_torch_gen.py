"""The general-structure forms of the PyTorch port (``gen`` and ``route``)
against the JAX package.

`_build_gen` builds the same form as the JAX planner, array for array, on
the structure classes of tests/test_gen_form.py: circuit-like, hub rows,
block-orientation chains, hubs with flips, a scrambled band (element
granularity) and the uniform-random rejection. Both layouts are held: the
band kernel's (W, m_pad) layout against the JAX package under
AOCLSPARSE_TPU_FORCE_PALLAS=1 (its Pallas layout, interpret mode), and the
G = 8 group windows against its default (the port is sent there by lowering
its BANDT_MAX_W). `mv` through KID 7 runs the composite on both sides; the
spill route engages on the CPU when the port's gate is opened to the CPU
(SPILL_ROUTE_DEVICES, SPILL_ROUTE_MIN) and the JAX side's
AOCLSPARSE_TPU_SPILL_ROUTE=1. All inputs are made with numpy from a seed.

Tolerances: utils/tolerances.py's model, expected_precision(dtype) on
max |a - b| / max(|b|, 1) — the two packages sum the same products in
another order. Under the mixed mode both round the band to bf16 and
accumulate in f32, so they hold the f32 bound against each other, and
docs/precision.md's bf16 bound against the float64 product.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
N = tt.Operation.none
TOL = {np.float32: expected_precision(torch.float32), np.float64: expected_precision(torch.float64)}
REPO = Path(__file__).resolve().parent.parent
tmv = importlib.import_module("aoclsparse_tpu_torch.ops.level2.mv")


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


@pytest.fixture
def jax_pallas(ast, monkeypatch):
    """The JAX package with its Pallas forms selectable on the CPU."""
    from aoclsparse_tpu.core.context import reset_context

    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_PALLAS", "1")
    reset_context()
    yield ast
    monkeypatch.delenv("AOCLSPARSE_TPU_FORCE_PALLAS")
    reset_context()


# -- operands (tests/test_gen_form.py's structure classes) ---------------------


def _local(rng, m, spread=10, per_row=6):
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-spread, spread + 1, per_row), 0, m - 1))
        dense[i, js] = rng.standard_normal(js.size)
    return dense


def circuit(seed, m=1024, hubs=5, scatter=200):
    rng = np.random.default_rng(seed)
    dense = _local(rng, m)
    for h in rng.choice(m, hubs, replace=False):
        rs = rng.choice(m, m // 3, replace=False)
        dense[rs, h] = rng.standard_normal(rs.size)
    dense[rng.integers(0, m, scatter), rng.integers(0, m, scatter)] = rng.standard_normal(scatter)
    return dense


def hub_rows(seed, m=2048):
    rng = np.random.default_rng(seed)
    dense = _local(rng, m, 6, 3)
    for r in rng.choice(m, 60, replace=False):
        cs = rng.choice(m, 50, replace=False)
        dense[r, cs] = rng.standard_normal(cs.size)
    return dense


def flip_chain(seed, m=2048, B=128, hubs=0):
    rng = np.random.default_rng(seed)
    base = _local(rng, m)
    q = np.arange(m).reshape(-1, B)
    q[1::2] = q[1::2, ::-1]
    dense = base[np.ix_(q.reshape(-1), q.reshape(-1))]
    if hubs:
        for h in rng.choice(m, hubs, replace=False):
            rs = rng.choice(m, m // 2, replace=False)
            dense[rs, h] = rng.standard_normal(rs.size)
        rr = rng.choice(m, 2, replace=False)
        dense[rr] = rng.standard_normal((2, m)) * (rng.random((2, m)) < 0.5)
        dense[rng.integers(0, m, 40), rng.integers(0, m, 40)] = rng.standard_normal(40)
    return dense


def scrambled(seed, m=1500):
    """An element-permuted narrow band: only element granularity (B = 1)
    recovers it; m = 1500 is no multiple of 8."""
    rng = np.random.default_rng(seed)
    p = rng.permutation(m)
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.clip(i + rng.integers(-8, 9, 5), 0, m - 1)
        dense[p[i], p[js]] = rng.standard_normal(js.size)
    return dense


def uniform(seed, m=2048, per_row=3):
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, m))
    for i in range(m):
        dense[i, rng.integers(0, m, per_row)] = rng.standard_normal(per_row)
    return dense


OPERANDS = {
    "circuit": lambda: circuit(1),
    "hub_rows": lambda: hub_rows(2),
    "flip_chain": lambda: flip_chain(3),
    "flips_hubs": lambda: flip_chain(4, m=1024, hubs=3),
    "scrambled": lambda: scrambled(5),
}


def _csr(dense, dtype):
    S = sp.csr_matrix(dense.astype(dtype))
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


def _pair(ast, dense, dtype):
    m = dense.shape[0]
    ptr, ind, val = _csr(dense, dtype)
    return ast.create_csr(m, m, ptr, ind, val), tt.create_csr(m, m, ptr, ind, val, device="cpu")


def _gen_forms(ast, J, T):
    from aoclsparse_tpu.planner.plan import get_plan

    jf = get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="gen")
    return jf, tplan.get_plan(T).exec_form_for(GEN, N, kind="gen")


GEN_INTS = ("m", "n", "gen_B", "gen_m_pad", "gen_bandt", "bwd_W", "bwd_padL", "bandt_start", "bwd_base8",
            "bwd_n_pad")
GEN_ARRAYS = ("gen_perm", "gen_out", "gen_flip", "bwd_val", "hub_cols", "hub_slab", "hubr_rows", "hubr_slab",
              "sp_ind", "sp_rows", "sp_val", "sp_src", "bwd_dest", "bwd_srcpos", "hub_dest", "hub_src",
              "hubr_dest", "hubr_src")


def _assert_same_gen(jf, tf):
    assert jf.kind == tf.kind == "gen"
    for key in GEN_INTS:
        if key in ("bwd_base8", "bwd_n_pad") and tf.gen_bandt:
            continue  # the group windows' geometry, unused by the band layout
        assert int(getattr(tf, key)) == int(getattr(jf, key)), key
    for key in GEN_ARRAYS:
        a, b = getattr(tf, key), getattr(jf, key)
        assert (a is None) == (b is None), key
        if a is not None:
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)


# -- the planner ----------------------------------------------------------------


@pytest.mark.parametrize("name", list(OPERANDS))
def test_build_gen_band_layout_equals_jax(jax_pallas, name):
    dense = OPERANDS[name]()
    J, T = _pair(jax_pallas, dense, np.float32)
    jf, tf = _gen_forms(jax_pallas, J, T)
    assert tf.gen_bandt
    _assert_same_gen(jf, tf)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(OPERANDS))
def test_build_gen_group_layout_equals_jax(ast, monkeypatch, name, dtype):
    monkeypatch.setattr(tplan, "BANDT_MAX_W", 0)
    J, T = _pair(ast, OPERANDS[name](), dtype)
    jf, tf = _gen_forms(ast, J, T)
    assert not tf.gen_bandt
    _assert_same_gen(jf, tf)


def test_build_gen_rejects_uniform_random_structure(ast):
    from aoclsparse_tpu.planner.plan import _build_gen as jax_build_gen
    from aoclsparse_tpu.planner.plan import get_plan

    J, T = _pair(ast, uniform(6), np.float32)
    assert jax_build_gen(get_plan(J).effective_for(ast.MatrixDescriptor(), ast.Operation.none, J.dtype)) is None
    assert tplan._build_gen(tplan.get_plan(T).effective_for(GEN, N)) is None


# -- mv through the composite -----------------------------------------------------


def _mv_both(ast, J, T, x, kid=7, **kw):
    op = kw.pop("op", N)
    yj = np.asarray(ast.mv(kw.get("alpha", 1.0), J, ast.MatrixDescriptor(), ast.Operation(int(op)), x,
                           kw.get("beta", 0.0), y=kw.get("y"), kid=kid))
    yt = tt.mv(kw.get("alpha", 1.0), T, GEN, op, torch.from_numpy(x), kw.get("beta", 0.0),
               None if kw.get("y") is None else torch.from_numpy(kw["y"]), kid=kid).numpy()
    return yj, yt


@pytest.mark.parametrize("name", ["circuit", "flips_hubs", "hub_rows"])
def test_mv_kid7_f32_band_layout_matches_jax_and_scipy(jax_pallas, name):
    dense = OPERANDS[name]().astype(np.float32)
    J, T = _pair(jax_pallas, dense, np.float32)
    rng = np.random.default_rng(7)
    m = dense.shape[0]
    x = rng.standard_normal(m).astype(np.float32)
    y0 = rng.standard_normal(m).astype(np.float32)
    ref = dense.astype(np.float64)
    for kw, want in (({}, ref @ x), (dict(alpha=2.5, beta=-0.5, y=y0), 2.5 * ref @ x - 0.5 * y0),
                     (dict(op=tt.Operation.transpose), ref.T @ x)):
        yj, yt = _mv_both(jax_pallas, J, T, x, **kw)
        assert near_error(yt, yj) <= TOL[np.float32], kw
        assert near_error(yt, want) <= TOL[np.float32], kw
    assert T.plan.exec_form_for(GEN, N, kind="gen").gen_bandt


@pytest.mark.parametrize("name", ["circuit", "scrambled"])
def test_mv_kid7_f64_matches_jax_and_scipy(ast, name):
    """The port serves a float64 gen band on the band kernel's f64 instance;
    the JAX package on its group windows: the same function."""
    dense = OPERANDS[name]()
    J, T = _pair(ast, dense, np.float64)
    x = np.random.default_rng(8).standard_normal(dense.shape[0])
    yj, yt = _mv_both(ast, J, T, x)
    assert near_error(yt, yj) <= TOL[np.float64]
    assert near_error(yt, dense @ x) <= TOL[np.float64]
    assert T.plan.exec_form_for(GEN, N, kind="gen").gen_bandt


def _mixed_bound(dense, x, roundings=1):
    """docs/precision.md: |y - y*| <= 2^-8 sum_j |a_ij x_j| + nnz_row eps_f32 |y*|
    per bf16 rounding of a product's operands."""
    ref = dense.astype(np.float64) @ x
    return ref, roundings * 2.0**-8 * (np.abs(dense) @ np.abs(x)) + (dense != 0).sum(1) * 2.0**-23 * np.abs(ref)


def test_mv_group_layout_mixed_matches_jax(ast, monkeypatch):
    """The G = 8 layout's mixed mode rounds the band, the hub slabs and x to
    bf16 on both sides (kernels/xla/spmv.py spmv_gen): two roundings of a
    product's operands. The JAX package also rounds each hub-slab product to
    bf16 on output, the port keeps it in f32: the port holds the documented
    bound, and the two agree within twice it."""
    monkeypatch.setattr(tplan, "BANDT_MAX_W", 0)
    dense = circuit(9).astype(np.float32)
    J, T = _pair(ast, dense, np.float32)
    ast.set_precision_mode(J, "mixed")
    tt.set_precision_mode(T, "mixed")
    x = np.random.default_rng(10).standard_normal(dense.shape[0]).astype(np.float32)
    yj, yt = _mv_both(ast, J, T, x)
    ref, bound = _mixed_bound(dense, x, roundings=2)
    assert np.all(np.abs(yt - ref) <= bound)
    assert np.all(np.abs(yt - yj) <= 2 * bound)
    assert not T.plan.exec_form_for(GEN, N, kind="gen").gen_bandt


def test_mv_mixed_band_matches_jax_and_bound(jax_pallas):
    dense = circuit(11).astype(np.float32)
    J, T = _pair(jax_pallas, dense, np.float32)
    jax_pallas.set_precision_mode(J, "mixed")
    tt.set_precision_mode(T, "mixed")
    x = np.random.default_rng(12).standard_normal(dense.shape[0]).astype(np.float32)
    yj, yt = _mv_both(jax_pallas, J, T, x)
    assert near_error(yt, yj) <= TOL[np.float32]
    ref, bound = _mixed_bound(dense, x)
    assert np.all(np.abs(yt - ref) <= bound)


def test_mv_spill_route_on_cpu_matches_jax(jax_pallas, monkeypatch):
    """The gen spill through select, route and accumulate (their plain
    versions here): the route's arrays equal the JAX form's, the result
    equals the JAX package's and the gather tail's, before and after
    update_values."""
    monkeypatch.setattr(tmv, "SPILL_ROUTE_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(tmv, "SPILL_ROUTE_MIN", 0)
    monkeypatch.setenv("AOCLSPARSE_TPU_SPILL_ROUTE", "1")
    dense = circuit(13, scatter=600).astype(np.float32)
    J, T = _pair(jax_pallas, dense, np.float32)
    x = np.random.default_rng(14).standard_normal(dense.shape[0]).astype(np.float32)
    for scale in (1.0, 0.5):
        if scale != 1.0:
            vals = _csr(dense * scale, np.float32)[2]
            jax_pallas.update_values(J, vals)
            tt.update_values(T, vals)
        yj, yt = _mv_both(jax_pallas, J, T, x)
        assert near_error(yt, yj) <= TOL[np.float32]
        assert near_error(yt, scale * dense.astype(np.float64) @ x) <= TOL[np.float32]
        jf, tf = _gen_forms(jax_pallas, J, T)
        assert tf._spill_route is not None and jf._spill_route is not None
        for key in ("sel_idx", "sel_val", "sel_blk", "acc_idx", "acc_blk", "acc_cid", "masks", "masks_packed"):
            a, b = getattr(tf._spill_route, key), getattr(jf._spill_route, key)
            assert (a is None) == (b is None), key
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    monkeypatch.setattr(tmv, "SPILL_ROUTE_DEVICES", ("cuda",))
    y_gather = tt.mv(1.0, T, GEN, N, torch.from_numpy(x), 0.0, kid=7).numpy()
    assert near_error(yt, y_gather) <= TOL[np.float32]


def test_update_values_refreshes_gen_forms(ast):
    dense = flip_chain(15, m=1024, hubs=3)
    J, T = _pair(ast, dense, np.float64)
    x = np.random.default_rng(16).standard_normal(dense.shape[0])
    tt.mv(1.0, T, GEN, N, torch.from_numpy(x), 0.0, kid=7)
    v2 = np.random.default_rng(17).standard_normal(T.nnz)
    ast.update_values(J, v2)
    tt.update_values(T, v2)
    ptr, ind, _ = _csr(dense, np.float64)
    ref = sp.csr_matrix((v2, ind, ptr), shape=dense.shape) @ x
    yj, yt = _mv_both(ast, J, T, x)
    assert near_error(yt, ref) <= TOL[np.float64]
    assert near_error(yt, yj) <= TOL[np.float64]


# -- the default choice: gen, then route, then the gather fallback ---------------


def test_default_choice_gen_route_gather(ast, monkeypatch):
    # general structure the composite takes
    T = _pair(ast, circuit(18).astype(np.float32), np.float32)[1]
    assert tplan.get_plan(T).exec_form_for(GEN, N).kind == "gen"
    # structure nothing can band: the gather fallback below the route gate
    dense = uniform(19).astype(np.float32)
    J, T = _pair(ast, dense, np.float32)
    eff = tplan.get_plan(T).effective_for(GEN, N)
    fallback = tplan.gather_fallback_kind(eff)
    assert fallback == "ell"
    assert tplan.choose_mv_format(eff) == "gen"
    assert tplan.get_plan(T).exec_form_for(GEN, N).kind == fallback
    x = np.random.default_rng(20).standard_normal(dense.shape[0]).astype(np.float32)
    ref = dense.astype(np.float64) @ x
    assert near_error(tt.mv(1.0, T, GEN, N, torch.from_numpy(x), 0.0).numpy(), ref) <= TOL[np.float32]
    # above the (lowered) route gate: the whole-matrix route, equal to JAX's
    monkeypatch.setattr(tplan, "ROUTE_MIN_NNZ", 0)
    T2 = _pair(ast, dense, np.float32)[1]
    form = tplan.get_plan(T2).exec_form_for(GEN, N)
    assert form.kind == "route"
    from aoclsparse_tpu.planner.plan import get_plan

    jf = get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="route")
    for key in ("sel_idx", "sel_val", "sel_blk", "acc_idx", "acc_blk", "acc_cid", "masks", "masks_packed"):
        a, b = getattr(form._spill_route, key), getattr(jf._spill_route, key)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    yt = tt.mv(1.0, T2, GEN, N, torch.from_numpy(x), 0.0).numpy()
    assert near_error(yt, ref) <= TOL[np.float32]
    tt.update_values(T2, 2.0 * _csr(dense, np.float32)[2])
    assert near_error(tt.mv(1.0, T2, GEN, N, torch.from_numpy(x), 0.0).numpy(), 2.0 * ref) <= TOL[np.float32]
    # the route serves float32 only: a float64 operand takes the fallback
    T3 = _pair(ast, dense, np.float64)[1]
    assert tplan.get_plan(T3).exec_form_for(GEN, N).kind == fallback


def test_striped_whole_matrix_route(ast, monkeypatch):
    """Past 2^18 entries the whole-matrix route splits into row stripes (of
    2^17 slots here, a quarter of the default)."""
    from aoclsparse_tpu_torch.planner import spill_route

    monkeypatch.setattr(tplan, "ROUTE_MIN_NNZ", 0)
    monkeypatch.setattr(spill_route, "STRIPE_SLOTS", 1 << 17)
    rng = np.random.default_rng(21)
    m = 8192
    S = sp.random(m, m, density=36.0 / m, random_state=np.random.RandomState(22), dtype=np.float32,
                  format="csr")
    S.sort_indices()
    assert S.nnz > 1 << 18
    T = tt.create_csr(m, m, S.indptr, S.indices, S.data, device="cpu")
    form = tplan.get_plan(T).exec_form_for(GEN, N)
    assert form.kind == "route" and len(form._spill_route.stripes) > 1
    x = rng.standard_normal(m).astype(np.float32)
    yt = tt.mv(1.0, T, GEN, N, torch.from_numpy(x), 0.0).numpy()
    assert near_error(yt, S.astype(np.float64) @ x) <= TOL[np.float32]


def test_kid_validation_matches_jax(ast):
    """kid=14 (the route) is not pinnable, and kid=7 on a structure the
    composite rejects is invalid: invalid_kid in both packages."""
    dense = uniform(23)
    J, T = _pair(ast, dense, np.float64)
    x = np.random.default_rng(24).standard_normal(dense.shape[0])
    for kid in (14, 7):
        with pytest.raises(ast.AoclSparseError) as ej:
            ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0, kid=kid)
        with pytest.raises(tt.AoclSparseError) as et:
            tt.mv(1.0, T, GEN, N, torch.from_numpy(x), 0.0, kid=kid)
        assert int(et.value.status) == int(ej.value.status) == int(tt.Status.invalid_kid)
    # kid 1 pins the ell gather form, as in the JAX package
    yj, yt = _mv_both(ast, J, T, x, kid=1)
    assert near_error(yt, yj) <= TOL[np.float64]


def test_chip_smoke_webbase_copy_equals_realmat():
    """chip_smoke.py's copy of the webbase-1M stand-in builds the same CSR
    as benchmarks/realmat.py for seed 7."""
    specs = {}
    for name, path in (("chip_smoke", REPO / "chip_smoke.py"), ("realmat", REPO / "benchmarks" / "realmat.py")):
        spec = importlib.util.spec_from_file_location(f"_copy_{name}", path)
        specs[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(specs[name])
    got = specs["chip_smoke"].webbase_1m(np.random.default_rng(7))
    want = specs["realmat"].generate("webbase-1M", seed=7)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
