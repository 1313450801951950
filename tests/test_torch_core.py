"""Core of the PyTorch port against the JAX package: status and enum
contracts, DOID flattening, CSR validation, the registry, the context, and
the interop that carries a CSR and a bandt form across."""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import interop
from aoclsparse_tpu_torch.core import types as ttypes
from aoclsparse_tpu_torch.core.context import DEFAULT_DEVICE, get_context
from aoclsparse_tpu_torch.core.descr import get_doid, trans_doid
from aoclsparse_tpu_torch.kernels.registry import registry
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


ENUMS = [
    "Status", "Operation", "IndexBase", "MatrixType", "FillMode", "DiagType", "Order",
    "FormatType", "Request", "SorType", "MemoryPolicy", "MatrixSort", "IluType",
]


@pytest.mark.parametrize("name", ENUMS)
def test_enums_match_jax(ast, name):
    mine, theirs = getattr(ttypes, name), getattr(ast, name)
    assert {e.name: int(e) for e in mine} == {e.name: int(e) for e in theirs}


def test_status_contract():
    assert len(tt.Status) == 15 + 1  # success + the 15 error statuses
    e = tt.AoclSparseError(tt.Status.invalid_kid, "x")
    assert e.status == tt.Status.invalid_kid and "invalid_kid" in str(e)


def test_doid_matches_jax(ast):
    from aoclsparse_tpu.core.descr import get_doid as jget, trans_doid as jtrans

    for mt in tt.MatrixType:
        for fm in tt.FillMode:
            for op in tt.Operation:
                for dt in (torch.float64, torch.complex128):
                    d = tt.MatrixDescriptor(type=mt, fill_mode=fm)
                    jd = ast.MatrixDescriptor(type=ast.MatrixType(int(mt)), fill_mode=ast.FillMode(int(fm)))
                    jdt = np.float64 if dt == torch.float64 else np.complex128
                    mine = get_doid(d, op, dt)
                    assert int(mine) == int(jget(jd, ast.Operation(int(op)), jdt))
                    assert int(trans_doid(mine)) == int(jtrans(jget(jd, ast.Operation(int(op)), jdt)))


def test_dtype_policy():
    assert ttypes.check_value_dtype(np.float32) == torch.float32
    assert ttypes.real_dtype_of(torch.complex64) == torch.float32
    with pytest.raises(tt.AoclSparseError) as e:
        ttypes.check_value_dtype(np.int32)
    assert e.value.status == tt.Status.wrong_type


def test_create_export_roundtrip_one_based():
    ptr = np.array([1, 3, 4, 6])
    ind = np.array([1, 3, 2, 1, 3], np.int32)
    val = np.arange(5, dtype=np.float32)
    A = tt.create_csr(3, 3, ptr, ind, val, base=tt.IndexBase.one, device="cpu")
    assert A.device == torch.device("cpu") and A.data.ptr[0] == 0
    m, n, nnz, p, i, v = tt.export_csr(A)
    np.testing.assert_array_equal(p, ptr)
    np.testing.assert_array_equal(i, ind)
    np.testing.assert_array_equal(v, val)
    tt.destroy(A)
    tt.destroy(None)


def test_default_device_is_cuda_and_context_detects_cpu_here():
    assert DEFAULT_DEVICE == torch.device("cuda", 0)
    ctx = get_context()
    if not torch.cuda.is_available():
        assert ctx.platform == "cpu" and ctx.hbm_gbps is None and ctx.sm is None


def test_registry_table_and_dispatcher():
    kids = {e.kid: e.fmt for e in registry.table("mv")}
    assert kids == {
        0: "segsum", 1: "ell", 2: "ellhyb", 3: "bsr", 4: "dia", 5: "bwd", 6: "diag", 7: "gen", 8: "bandt",
        9: "bwdg", 10: "sell", 11: "host", 12: "bandt", 13: "bandt", 14: "route"
    }
    assert {op: [e.kid for e in registry.table(op)] for op in ("axpyi", "doti", "gthrz", "roti", "sctrs")} == {
        op: [0] for op in ("axpyi", "doti", "gthrz", "roti", "sctrs")
    }
    assert tt.debug_dispatcher("mv", fmt="bwd", device="cpu")["name"] == "cuda_bwd"
    assert tt.debug_dispatcher("mv", fmt="host", device="cpu")["kid"] == 11
    assert {e.kid: e.fmt for e in registry.table("sv")} == {0: "blocked", 1: "level", 2: "host"}
    assert {e.kid: e.fmt for e in registry.table("mm")} == {
        0: "segsum", 1: "ell", 2: "ellhyb", 3: "bwdg", 4: "bandtm", 5: "bandtm", 6: "gen", 7: "diag"
    }
    assert tt.debug_dispatcher("mm", fmt="bandtm", device="cpu")["name"] == "cuda_bandtm"
    assert tt.debug_dispatcher("mm", fmt="diag", device="cpu")["kid"] == 7
    assert tt.debug_dispatcher("mv", fmt="bandt", device="cpu")["kid"] == 12
    assert tt.debug_dispatcher("mv", fmt="segsum", device="cpu")["kid"] == 0
    assert tt.debug_dispatcher("mv", fmt="bwdg", device="cpu")["name"] == "torch_bwdg"
    assert tt.debug_dispatcher("mv", fmt="gen", device="cpu")["kid"] == 7
    assert tt.debug_dispatcher("mv", fmt="route", device="cpu")["name"] == "cuda_spill_route"
    assert tt.debug_dispatcher("sv", device="cpu")["name"] == "cuda_trsv_win"
    with pytest.raises(tt.AoclSparseError) as e:
        registry.select("mv", fmt="segsum", kid=8)
    assert e.value.status == tt.Status.invalid_kid
    with pytest.raises(tt.AoclSparseError) as e:
        registry.select("sm")  # trsm runs through the sv table, as in the JAX package
    assert e.value.status == tt.Status.not_implemented


def test_port_imports_no_jax():
    """Every module of the port, the spill-route engine's, the SpGEMM
    family's and the measurement path's among them, and chip_smoke.py import
    neither jax nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys, aoclsparse_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = ('kernels.spill_route', 'kernels.benes', 'kernels.route', 'kernels.spmv_gen',\n"
        "       'planner.spill_route', 'kernels.band_gemm', 'kernels.spgemm_band', 'ops.level3.spgemm',\n"
        "       'kernels.band_tiles', 'kernels.spmv_mxu', 'kernels.stream_read', 'utils.profiling')\n"
        "assert all('aoclsparse_tpu_torch.' + n in sys.modules for n in new)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'aoclsparse_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(__import__("pathlib").Path(__file__).parents[1]))


def test_force_kid_env(monkeypatch):
    from aoclsparse_tpu_torch.core.context import reset_context

    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_KID", "8")
    reset_context()
    try:
        assert registry.select("mv", fmt="bandt", device="cpu").kid == 8
    finally:
        monkeypatch.delenv("AOCLSPARSE_TPU_FORCE_KID")
        reset_context()


def test_hint_and_precision_mode_validation():
    A = tt.create_csr(2, 2, np.array([0, 1, 2]), np.array([0, 1], np.int32), np.ones(2), device="cpu")
    with pytest.raises(tt.AoclSparseError) as e:
        tt.set_mv_hint(A, tt.Operation.none, tt.MatrixDescriptor(), nop=0)
    assert e.value.status == tt.Status.invalid_value
    tt.set_mv_hint(A, tt.Operation.none, tt.MatrixDescriptor(), nop=0, kid=8)
    with pytest.raises(tt.AoclSparseError) as e:
        tt.set_precision_mode(A, "bf16")
    assert e.value.status == tt.Status.invalid_value
    with pytest.raises(tt.AoclSparseError) as e:
        tt.update_values(A, np.ones(3))
    assert e.value.status == tt.Status.invalid_size


def test_interop_carries_csr_and_bandt_form(ast):
    rng = np.random.default_rng(0)
    m = 1300
    r = np.repeat(np.arange(m), 7)
    c = np.clip(r + np.tile(np.arange(-3, 4), m), 0, m - 1)
    far = rng.integers(0, m, 15)
    r, c = np.r_[r, far], np.r_[c, (far + 600) % m]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    keep = np.r_[True, (r[1:] != r[:-1]) | (c[1:] != c[:-1])]
    r, c = r[keep], c[keep]
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, r + 1, 1)
    ptr = np.cumsum(ptr)
    val = rng.standard_normal(r.size)
    J = ast.create_csr(m, m, ptr, c.astype(np.int32), val)
    _m, _n, _nnz, p, i, v = ast.export_csr(J)
    T = interop.matrix_from_jax_arrays(m, m, p, i, v, device="cpu")
    jform = ast.planner.plan.get_plan(J).exec_form_for(
        ast.MatrixDescriptor(), ast.Operation.none, kind="bandt"
    )
    assert jform.sp_ind is not None
    arrays = {k: np.asarray(getattr(jform, k)) for k in ("bwd_val", "sp_val", "sp_ind", "sp_rows")}
    arrays.update(bwd_W=jform.bwd_W, bwd_padL=jform.bwd_padL, bandt_start=jform.bandt_start)
    form = interop.bandt_form_from_jax(arrays, device="cpu")
    x = rng.standard_normal(m)
    from aoclsparse_tpu_torch.ops.level2.mv import _run_exec_form

    want = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0, kid=8))
    via_form = _run_exec_form(form, torch.from_numpy(x), 8)
    via_handle = tt.mv(1.0, T, tt.MatrixDescriptor(), tt.Operation.none, torch.from_numpy(x), 0.0, kid=8)
    assert near_error(via_form.numpy(), want) <= expected_precision(torch.float64)
    assert near_error(via_handle.numpy(), want) <= expected_precision(torch.float64)


def test_native_binds_rcm_and_benes():
    """The host library's rcm and benes_plan are bound (the numpy versions
    are the fallback): an RCM order that recovers a scrambled band, and a
    routing plan that realises its permutation."""
    from aoclsparse_tpu_torch import native
    from aoclsparse_tpu_torch.kernels.route import apply_benes

    assert native.available()
    lib = native._load()
    assert lib is not None and hasattr(lib, "rcm") and hasattr(lib, "benes_plan")
    rng = np.random.default_rng(1)
    m = 400
    p = rng.permutation(m)
    r = np.repeat(np.arange(m), 3)
    c = np.clip(r + np.tile([-1, 0, 1], m), 0, m - 1)
    r, c = p[r], p[c]
    order = np.lexsort((c, r))
    ptr = np.cumsum(np.r_[0, np.bincount(r, minlength=m)])
    perm, bw = native.rcm_permutation(m, ptr, c[order])
    assert sorted(perm) == list(range(m)) and bw <= 2
    src = rng.permutation(256)
    masks = native.benes_plan(8, src)
    assert masks.shape == (15, 256) and masks.dtype == np.uint8
    out = apply_benes(torch.arange(256, dtype=torch.float32), torch.from_numpy(masks), 8)
    np.testing.assert_array_equal(out.numpy(), src)


def test_interop_carries_gen_form(ast, monkeypatch):
    """A JAX gen form (its G = 8 layout, float64) carried across runs the
    port's composite to the JAX package's result."""
    from aoclsparse_tpu.planner.plan import get_plan

    from aoclsparse_tpu_torch.ops.level2.mv import _run_exec_form

    rng = np.random.default_rng(2)
    m = 1024
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-10, 11, 6), 0, m - 1))
        dense[i, js] = rng.standard_normal(js.size)
    for h in rng.choice(m, 4, replace=False):
        dense[rng.choice(m, m // 3, replace=False), h] = 1.0
    dense[rng.integers(0, m, 200), rng.integers(0, m, 200)] = 1.0
    ptr = np.r_[0, np.cumsum((dense != 0).sum(1))]
    J = ast.create_csr(m, m, ptr, np.nonzero(dense)[1].astype(np.int32), dense[dense != 0])
    jf = get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="gen")
    keys = ("bwd_val", "sp_val", "sp_ind", "sp_rows", "gen_perm", "gen_out", "gen_flip", "hub_cols", "hub_slab",
            "hubr_rows", "hubr_slab")
    arrays = {k: None if getattr(jf, k) is None else np.asarray(getattr(jf, k)) for k in keys}
    arrays.update({k: getattr(jf, k) for k in ("bwd_W", "bwd_G", "bwd_base8", "bwd_n_pad", "bwd_padL",
                                               "bandt_start", "gen_B", "gen_m_pad", "gen_bandt")})
    form = interop.gen_form_from_jax(arrays, m, m, device="cpu")
    x = rng.standard_normal(m)
    want = np.asarray(ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, x, 0.0, kid=7))
    got = _run_exec_form(form, torch.from_numpy(x), 7)
    assert not form.gen_bandt and form.hub_cols is not None
    assert near_error(got.numpy(), want) <= expected_precision(torch.float64)
    assert near_error(got.numpy(), dense @ x) <= expected_precision(torch.float64)
