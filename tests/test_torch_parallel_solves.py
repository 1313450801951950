"""The distributed solves of the PyTorch port (aoclsparse_tpu_torch.parallel:
trsv, trsm, sweeps, spgemm) against the JAX package's.

As tests/test_torch_parallel.py: the port in one module-scoped world of
four gloo ranks on the CPU (tests/torch_dist_cases.py, suite "solves"), the
JAX package in this process on a four-device mesh, both on the same seeded
operands (tests/test_dist_depth.py's cases: both fills, multi-RHS, the
symgs chain's refresh and its cache, the level engines, a non-local halo
refused). Tolerance: near_error within expected_precision(float64).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from aoclsparse_tpu_torch import parallel as par
from aoclsparse_tpu_torch.core.types import Status
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

TOL = expected_precision(torch.float64)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu as ast
    from aoclsparse_tpu import parallel as jp
    from aoclsparse_tpu.core.types import DiagType, FillMode, MatrixType
    from aoclsparse_tpu.planner.plan import get_plan

    def tri(fill):
        return ast.MatrixDescriptor(type=MatrixType.triangular, fill_mode=fill, diag_type=DiagType.non_unit)

    return SimpleNamespace(jax=jax, ast=ast, par=jp, get_plan=get_plan, tri=tri, FillMode=FillMode,
                           MatrixType=MatrixType, mesh=jp.make_mesh(cases.NDEV))


@pytest.fixture(scope="module")
def world():
    from aoclsparse_tpu_torch import native

    data = cases.inputs("solves")
    native.available()
    ranks = par.spawn_world(cases.run_suite, cases.NDEV, "solves", data, backend="gloo", device="cpu",
                            timeout_s=120)
    return data, ranks


def case(world, name):
    data, ranks = world
    r = ranks[0][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(r["error"])
    return data[name], r, [rk[name] for rk in ranks]


def jcsr(jx, dense):
    ptr, ind, val = cases.csr_of(dense)
    return jx.ast.create_csr(dense.shape[0], dense.shape[1], ptr, ind, val)


def close(got, want):
    err = near_error(np.asarray(got), np.asarray(want))
    assert err <= TOL, err


def test_dist_trsv_pipeline_both_fills(world, jx):
    from aoclsparse_tpu.planner.triangular import trsv_form_for

    d, r, _ = case(world, "trsv_pipeline")
    for fill in (jx.FillMode.lower, jx.FillMode.upper):
        L = d["L"] if fill == jx.FillMode.lower else d["L"].T
        f = trsv_form_for(jx.get_plan(jcsr(jx, L)), jx.tri(fill), jx.ast.Operation.none, nb=16)
        close(r[fill.name], np.asarray(jx.par.dist_trsv_pipeline(jx.mesh, f, d["b"])))
        np.testing.assert_allclose(L @ r[fill.name], d["b"], atol=1e-8)


def test_dist_trsm_pipeline_and_dist_trsm(world, jx):
    """The column wavefront and the column-sharded solve (the form's own
    solve, the window kernels' plain versions here) against JAX."""
    from aoclsparse_tpu.parallel.trsm import dist_trsm as jdist_trsm
    from aoclsparse_tpu.planner.triangular import trsv_form_for

    d, r, _ = case(world, "trsm")
    f = trsv_form_for(jx.get_plan(jcsr(jx, d["L"])), jx.tri(jx.FillMode.lower), jx.ast.Operation.none, nb=16)
    assert r["kind"] == f.kind == "win"
    close(r["pipeline"], np.asarray(jx.par.dist_trsm_pipeline(jx.mesh, f, d["B"])))
    close(r["dist_trsm"], np.asarray(jdist_trsm(jx.mesh, f, d["B"])))
    np.testing.assert_allclose(d["L"] @ r["dist_trsm"], d["B"], atol=1e-8)


def test_dist_trsv_levels_general(world, jx):
    from aoclsparse_tpu.planner.triangular import trsv_level_form_for

    d, r, _ = case(world, "trsv_levels")
    A = jcsr(jx, d["A"])
    for fill in (jx.FillMode.lower, jx.FillMode.upper):
        f = trsv_level_form_for(jx.get_plan(A), jx.tri(fill), jx.ast.Operation.none)
        close(r[fill.name], np.asarray(jx.par.dist_trsv_levels(jx.mesh, f, d["b"])))
    f = trsv_level_form_for(jx.get_plan(A), jx.tri(jx.FillMode.lower), jx.ast.Operation.none)
    close(r["multi"], np.asarray(jx.par.dist_trsv_levels(jx.mesh, f, d["B"])))


def test_dist_symgs_and_ilu_apply(world, jx):
    d, r, _ = case(world, "symgs")
    A = jcsr(jx, d["A"])
    gen = jx.ast.MatrixDescriptor()
    close(r["gen"], np.asarray(jx.par.dist_symgs(jx.mesh, A, gen, 1.3, d["b"])))
    close(r["ilu"], np.asarray(jx.par.dist_ilu_apply(jx.mesh, A, d["b"])))
    At = jcsr(jx, np.tril(d["A"]))
    close(r["sym"], np.asarray(jx.par.dist_symgs(jx.mesh, At, gen.with_(type=1), 1.0, d["b"])))


def test_dist_symgs_chain_matches_eager_sweeps(world, jx):
    d, r, _ = case(world, "chain")
    A = jcsr(jx, d["A"])
    gen = jx.ast.MatrixDescriptor()
    close(r["chain"], r["eager"])
    close(r["chain"], np.asarray(jx.par.dist_symgs_chain(jx.mesh, A, gen, 1.3, d["b"], nsweeps=3)))
    close(r["x0"], np.asarray(jx.par.dist_symgs_chain(jx.mesh, A, gen, 1.0, d["b"], nsweeps=2, x0=d["x0"])))
    At = jcsr(jx, np.tril(d["A"]))
    close(r["sym"], np.asarray(jx.par.dist_symgs_chain(jx.mesh, At, gen.with_(type=1), 1.0, d["b"], nsweeps=2)))


def test_dist_symgs_chain_refresh_and_contract(world, jx):
    d, r, _ = case(world, "chain_refresh")
    A = jcsr(jx, d["A"])
    gen = jx.ast.MatrixDescriptor()
    x1 = np.asarray(jx.par.dist_symgs_chain(jx.mesh, A, gen, 1.0, d["b"], nsweeps=2))
    jx.ast.update_values(A, cases.csr_of(d["A"])[2] * 2)
    x2 = np.asarray(jx.par.dist_symgs_chain(jx.mesh, A, gen, 1.0, d["b"], nsweeps=2))
    close(r["x1"], x1)
    close(r["x2"], x2)
    assert not np.allclose(r["x1"], r["x2"])
    assert r["null_b"] == {"raised": "AoclSparseError", "status": int(Status.invalid_pointer)}
    assert r["zero_sweeps"] == {"raised": "AoclSparseError", "status": int(Status.invalid_value)}


def test_dist_symgs_cache_refreshes_on_update(world, jx):
    d, r, _ = case(world, "cache")
    A = jcsr(jx, d["A"])
    gen = jx.ast.MatrixDescriptor()
    jx.ast.update_values(A, cases.csr_of(d["A"])[2] * 2)
    close(r["x2"], np.asarray(jx.ast.symgs(jx.ast.Operation.none, A, gen, 1.0, d["b"])))
    assert not np.allclose(r["x1"], r["x2"])


def test_level_engines(world, jx):
    d, r, _ = case(world, "level_engine")
    A, S = jcsr(jx, d["A"]), jcsr(jx, d["S"])
    close(r["ilu"], np.asarray(jx.par.dist_ilu_apply(jx.mesh, A, d["b"], engine="level")))
    close(r["symgs"], np.asarray(jx.par.dist_symgs(jx.mesh, S, jx.ast.MatrixDescriptor(), 1.0, d["b"],
                                                   engine="level")))
    for key in ("ilu_bad", "symgs_bad"):
        assert r[key] == {"raised": "AoclSparseError", "status": int(Status.invalid_value)}


def test_dist_spgemm_numeric(world, jx):
    from aoclsparse_tpu.core.descr import GENERAL
    from aoclsparse_tpu.ops.level3.spgemm import _effective, _symbolic

    d, r, _ = case(world, "spgemm_numeric")
    A, B = jcsr(jx, d["A"]), jcsr(jx, d["B"])
    effA = _effective(A, GENERAL, jx.ast.Operation.none)
    effB = _effective(B, GENERAL, jx.ast.Operation.none)
    plan = _symbolic(effA, effB)
    np.testing.assert_array_equal(r["ptr"], plan.ptr)
    np.testing.assert_array_equal(r["ind"], plan.ind)
    close(r["val"], np.asarray(jx.par.dist_spgemm_numeric(jx.mesh, plan, effA.val, effB.val)))


@pytest.mark.parametrize("name", ["spgemm_rowpart", "spgemm_halo"])
def test_dist_spgemm_row_and_halo(world, jx, name):
    from aoclsparse_tpu.core.descr import GENERAL
    from aoclsparse_tpu.ops.level3.spgemm import _effective

    d, r, _ = case(world, name)
    eff = _effective(jcsr(jx, d["A"]), GENERAL, jx.ast.Operation.none)
    fn = jx.par.dist_spgemm_rowpart if name == "spgemm_rowpart" else jx.par.dist_spgemm_halo
    Cptr, Cind, Cval = fn(jx.mesh, eff, eff)
    np.testing.assert_array_equal(r["ptr"], Cptr)
    np.testing.assert_array_equal(r["ind"], Cind)
    close(r["val"], Cval)


def test_dist_spgemm_halo_rejects_nonlocal(world, jx):
    from aoclsparse_tpu.core.descr import GENERAL
    from aoclsparse_tpu.ops.level3.spgemm import _effective

    d, r, _ = case(world, "spgemm_nonlocal")
    assert r == {"raised": "ValueError"}
    eff = _effective(jcsr(jx, d["A"]), GENERAL, jx.ast.Operation.none)
    with pytest.raises(ValueError):
        jx.par.dist_spgemm_halo(jx.mesh, eff, eff)


# ---------------------------------------------------------------------------
# caches of sharded value copies (in this process: no collective runs)
# ---------------------------------------------------------------------------


def _cpu_mesh(rank, size=2):
    from aoclsparse_tpu_torch.parallel.placement import Mesh

    return Mesh("x", size, rank, torch.device("cpu"), "gloo")


def test_level_slices_follow_every_refresh():
    """dist_trsv_levels' per-form slices are rebuilt after each refresh of
    the level form, however many refreshes come between two solves."""
    from aoclsparse_tpu_torch.parallel.trsv import _level_slices
    from aoclsparse_tpu_torch.planner.plan import get_plan
    from aoclsparse_tpu_torch.planner.triangular import _oriented_triangle, trsv_level_form_for

    dense = cases.inputs("solves")["trsv_levels"]["A"]
    t = cases.tri(cases.FillMode.lower)

    def level_form(scale):
        plan = get_plan(cases.handle(_cpu_mesh(0), scale * dense))
        return plan, trsv_level_form_for(plan, t, cases.NONE)

    for rank in (0, 1):
        _, f = level_form(1.0)
        _level_slices(_cpu_mesh(rank), f)
        for scale in (2.0, 3.0):
            f.refresh(_oriented_triangle(level_form(scale)[0], t, cases.NONE)[0].val)
        got, want = _level_slices(_cpu_mesh(rank), f), _level_slices(_cpu_mesh(rank), level_form(3.0)[1])
        assert len(got) == len(want)
        for (gr, gparts), (wr, wparts) in zip(got, want):
            torch.testing.assert_close(gr, wr, rtol=0, atol=0)
            for g, w in zip(gparts, wparts):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("engine", ["pipeline", "level"])
def test_sweep_operands_are_reused_until_update_values(engine):
    """dist_symgs' sharded SpMVs and solve forms are kept on the plan for
    one values epoch: reused by the next sweep, rebuilt after
    update_values."""
    import aoclsparse_tpu_torch as tt
    from aoclsparse_tpu_torch.core.types import MatrixType
    from aoclsparse_tpu_torch.parallel.sweeps import _sweep_ops

    dense = cases.inputs("solves")["cache"]["A"]
    mesh = _cpu_mesh(1)
    A = cases.handle(mesh, dense)
    ops = _sweep_ops(mesh, A, cases.GEN, MatrixType.general, "x", engine)
    assert _sweep_ops(mesh, A, cases.GEN, MatrixType.general, "x", engine) is ops
    for scale in (2.0, 3.0):
        tt.update_values(A, torch.from_numpy(cases.csr_of(dense)[2] * scale))
    fresh = _sweep_ops(mesh, A, cases.GEN, MatrixType.general, "x", engine)
    assert fresh is not ops
    assert _sweep_ops(mesh, A, cases.GEN, MatrixType.general, "x", engine) is fresh
