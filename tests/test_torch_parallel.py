"""The distributed layer of the PyTorch port (aoclsparse_tpu_torch.parallel:
spmv, cg, gmres, partition, precond, placement) against the JAX package's
(aoclsparse_tpu.parallel).

The port runs in one module-scoped world of four gloo ranks on the CPU
(parallel.spawn_world; tests/torch_dist_cases.py holds the rank side), which
computes every case of this file in one spawn. The JAX side runs in this
process on a four-device mesh of its eight virtual CPU devices. Both start
from the same seeded numpy operands (torch_dist_cases.inputs), the cases of
tests/test_parallel.py and tests/test_dist_depth.py: uneven rows, a single
group, a tiny shard's overlap fallback, a spilled form refused, local-only
halo plans, the block-Jacobi contract, the pipelined CG's quick exit.

Tolerance: utils/tolerances.py's model, near_error (max |a - b| /
max(|b|, 1)) within expected_precision(float64); CG iteration counts
equal in f64; true residuals within 10 rtol. The single-process loops
(cg_*_jit, gmres_bwd_jit) run here on CPU tensors.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
import torch_dist_cases as cases
from aoclsparse_tpu_torch import parallel as par
from aoclsparse_tpu_torch.core.types import Status
from aoclsparse_tpu_torch.planner.plan import get_plan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

TOL = expected_precision(torch.float64)
GEN, NONE = tt.MatrixDescriptor(), tt.Operation.none

#: the JAX package's parallel/__init__.py names
JAX_NAMES = (
    "cg_bwd_jit cg_ell_jit dist_cg dist_cg_bwd dist_cg_bwd_halo dist_cg_ell_halo dist_cg_pipelined "
    "prepare_dist_ell dist_gmres_bwd dist_gmres_bwd_halo gmres_bwd_jit dist_spgemm_halo dist_spgemm_numeric "
    "dist_spgemm_rowpart partition_products nnz_balanced_bounds pack_balanced_ell dist_ilu_apply dist_symgs "
    "dist_symgs_chain compact_balanced dist_spmm_bwd_halo dist_spmm_ell_halo_plan dist_spmv_balanced_halo "
    "dist_spmv_bwd_halo dist_spmv_bwd_halo_overlap dist_spmv_ell dist_spmv_ell_balanced dist_spmv_ell_halo_plan "
    "dist_spmv_ell_sharded_x make_mesh plan_general_halo shard_ell dist_trsm_pipeline dist_trsv_levels "
    "dist_trsv_pipeline fetch mesh_is_multiprocess put block_jacobi_inv global_mesh init_multiprocess"
).split()


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu as ast
    from aoclsparse_tpu import parallel as jp
    from aoclsparse_tpu.planner import plan as jplan

    return SimpleNamespace(jax=jax, ast=ast, par=jp, plan=jplan, mesh=jp.make_mesh(cases.NDEV))


@pytest.fixture(scope="module")
def world():
    from aoclsparse_tpu_torch import native

    data = cases.inputs("parallel")
    native.available()  # the host library, built once before the ranks start
    ranks = par.spawn_world(cases.run_suite, cases.NDEV, "parallel", data, backend="gloo", device="cpu",
                            timeout_s=120)
    return data, ranks


def case(world, name):
    """(operands, rank 0's result, every rank's result) of a case."""
    data, ranks = world
    r = ranks[0][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(r["error"])
    return data[name], r, [rk[name] for rk in ranks]


def jcsr(jx, dense):
    ptr, ind, val = cases.csr_of(dense)
    return jx.ast.create_csr(dense.shape[0], dense.shape[1], ptr, ind, val)


def jform(jx, A, kind):
    return jx.plan.get_plan(A).exec_form_for(jx.ast.MatrixDescriptor(), jx.ast.Operation.none, kind=kind)


def jbwd(jx, A):
    eff = jx.plan.get_plan(A).effective_for(jx.ast.MatrixDescriptor(), jx.ast.Operation.none, A.dtype)
    return jx.plan._build_bwd(eff)


def jell_padded(jx, dense):
    """The JAX ELL form's arrays, rows padded to a device multiple."""
    f = jform(jx, jcsr(jx, dense), "ell")
    ind, val = np.asarray(f.ell_ind), np.asarray(f.ell_val)
    mp = -(-ind.shape[0] // cases.NDEV) * cases.NDEV
    return (np.pad(ind, ((0, mp - ind.shape[0]), (0, 0)), constant_values=-1),
            np.pad(val, ((0, mp - val.shape[0]), (0, 0))))


def jput(jx, v, *spec):
    from jax.sharding import PartitionSpec

    return jx.par.put(np.asarray(v), jx.mesh, PartitionSpec(*spec))


def close(got, want, scale=1.0):
    err = near_error(np.asarray(got), np.asarray(want))
    assert err <= TOL * scale, err


def same_solve(port, jax_out, m=None):
    """Port (x, k) against the JAX package's (x, k, rnorm): equal count in f64."""
    x, k, _rn = jax_out
    assert port["k"] == int(k), (port["k"], int(k))
    close(port["x"][:m], np.asarray(x)[:m])


def residual_ok(A, x, b, rtol):
    assert np.linalg.norm(A @ x - b) <= 10 * rtol * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# names, placement, partition, precond
# ---------------------------------------------------------------------------


def test_public_names():
    missing = [n for n in JAX_NAMES if not hasattr(par, n)]
    assert len(JAX_NAMES) == 42 and not missing, missing
    from aoclsparse_tpu_torch.parallel import multiproc, spmv, trsm, trsv

    for mod, name in ((trsm, "dist_trsm"), (multiproc, "process_count"), (multiproc, "process_index"),
                      (spmv, "spmv_ell_runner"), (trsv, "pipeline_runner")):
        assert callable(getattr(mod, name))


def test_public_names_match_jax(jx):
    assert all(hasattr(jx.par, n) for n in JAX_NAMES)


def test_no_world_names_init_multiprocess():
    with pytest.raises(tt.AoclSparseError, match="init_multiprocess") as e:
        par.global_mesh()
    assert e.value.status == Status.invalid_operation
    with pytest.raises(tt.AoclSparseError) as e2:
        par.init_multiprocess("localhost:1", 1, 0)  # no backend named
    assert e2.value.status == Status.invalid_value


def test_placement(world):
    d, r, allr = case(world, "placement")
    X = d["X"]
    for key in ("rows", "cols", "rep"):
        np.testing.assert_array_equal(r[key], X)
    for rank, rr in enumerate(allr):
        np.testing.assert_array_equal(rr["row_block"], X[2 * rank:2 * rank + 2])
        assert rr["row_offset"] == 2 * rank and rr["col_offset"] == 3 * rank and rr["index"] == rank
    assert r["device"] == "cpu" and r["multi"] and r["count"] == cases.NDEV
    assert r["mesh3"] == {"raised": "AoclSparseError", "status": int(Status.invalid_value)}
    assert r["odd"] == {"raised": "AoclSparseError", "status": int(Status.invalid_size)}


def test_partition_matches_jax(jx):
    data = cases.inputs("parallel")
    ptr, ind, _val = cases.csr_of(data["ell_balanced"]["A"])
    for align in (8, 1):
        np.testing.assert_array_equal(par.nnz_balanced_bounds(ptr, 4, align=align),
                                      jx.par.nnz_balanced_bounds(ptr, 4, align=align))
    for a, b in zip(par.pack_balanced_ell(ptr, ind, 4), jx.par.pack_balanced_ell(ptr, ind, 4)):
        np.testing.assert_array_equal(a, b)


def test_block_jacobi_inv_contract(jx):
    """Identity padding blocks, the diagonal's inverse, nb must divide m_pad;
    the same blocks as the JAX package's on a coupled operand."""
    m = 24
    A = tt.create_csr(m, m, np.arange(m + 1), np.arange(m), np.full(m, 3.0), device="cpu")
    eff = get_plan(A).effective_for(GEN, NONE, A.dtype)
    D = par.block_jacobi_inv(eff, 8, 32)
    np.testing.assert_allclose(D[3], np.eye(8))
    np.testing.assert_allclose(D[0], np.eye(8) / 3.0)
    with pytest.raises(ValueError):
        par.block_jacobi_inv(eff, 7, 32)
    dense = cases.inputs("parallel")["pcg_block"]["A"]
    ptr, ind, val = cases.csr_of(dense)
    tA = tt.create_csr(256, 256, ptr, ind, val, device="cpu")
    jA = jcsr(jx, dense)
    jeff = jx.plan.get_plan(jA).effective_for(jx.ast.MatrixDescriptor(), jx.ast.Operation.none, jA.dtype)
    np.testing.assert_allclose(par.block_jacobi_inv(get_plan(tA).effective_for(GEN, NONE, tA.dtype), 16, 256),
                               jx.par.block_jacobi_inv(jeff, 16, 256), rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# spmv
# ---------------------------------------------------------------------------


def test_dist_spmv_ell(world, jx):
    d, r, _ = case(world, "spmv_ell")
    A = jcsr(jx, d["A"])
    f = jform(jx, A, "ell")
    ind_s, val_s, _ = jx.par.shard_ell(jx.mesh, f.ell_ind, f.ell_val)
    close(r["y"][:64], np.asarray(jx.par.dist_spmv_ell(jx.mesh, ind_s, val_s, d["x"]))[:64])
    y2 = jx.par.dist_spmv_ell_sharded_x(jx.mesh, ind_s, val_s, jput(jx, d["x"], "x"))
    close(r["y_sharded_x"][:64], np.asarray(y2)[:64])
    close(r["y"][:64], d["A"] @ d["x"])


@pytest.mark.parametrize("name", ["bwd_halo", "bwd_halo_tiny"])
def test_dist_spmv_bwd_halo(world, jx, name):
    """Uneven rows (500 over 4 ranks) and a tiny shard (8 rows a rank: the
    overlap variant takes the unsplit path), both variants, against JAX."""
    d, r, _ = case(world, name)
    m = d["A"].shape[0]
    f = jbwd(jx, jcsr(jx, d["A"]))
    xs = jput(jx, cases.padded(d["x"], 8 * cases.NDEV), "x")
    close(r["y"], np.asarray(jx.par.dist_spmv_bwd_halo(jx.mesh, f, xs)))
    close(r["y_overlap"], np.asarray(jx.par.dist_spmv_bwd_halo_overlap(jx.mesh, f, xs)))
    close(r["y"][:m], d["A"] @ d["x"])


def test_halo_rejects_spilled_form(world):
    _d, r, _ = case(world, "bwd_halo_spill")
    assert r == {"raised": "ValueError"}


@pytest.mark.parametrize("name", ["spmm_bwd_halo[-6]", "spmm_bwd_halo[0]", "spmm_bwd_halo[40]",
                                  "spmm_bwd_halo_single"])
def test_dist_spmm_bwd_halo(world, jx, name):
    """The group-band SpMM halo (2 groups a rank, and one: no interior)."""
    d, r, _ = case(world, name)
    m = d["A"].shape[0]
    f = jform(jx, jcsr(jx, d["A"]), "bwdg")
    assert r["G"] == f.bwd_G == 512 and not r["spill"]
    Bs = jput(jx, cases.padded(d["B"], f.bwd_G * cases.NDEV), "x", None)
    close(r["C"][:m], np.asarray(jx.par.dist_spmm_bwd_halo(jx.mesh, f, Bs))[:m])
    close(r["C"][:m], d["A"] @ d["B"])


def test_dist_spmv_ell_balanced(world, jx):
    d, r, _ = case(world, "ell_balanced")
    ptr, ind, val = cases.csr_of(d["A"])
    src, ell_ind, mloc, bounds = jx.par.pack_balanced_ell(ptr, ind, cases.NDEV)
    vals = np.where(src >= 0, val[np.clip(src, 0, None)], 0.0)
    want = np.asarray(jx.par.dist_spmv_ell_balanced(jx.mesh, ell_ind, d["x"], bounds, vals))
    np.testing.assert_array_equal(r["bounds"], bounds)
    close(r["y"], want)


def test_dist_spmv_general_halo_plan(world, jx):
    d, r, _ = case(world, "halo_plan")
    ind, val = jell_padded(jx, d["A"])
    xs = jput(jx, cases.padded(d["x"], cases.NDEV), "x")
    close(r["y"], np.asarray(jx.par.dist_spmv_ell_halo_plan(jx.mesh, ind, val, xs)))
    close(r["y"], r["y_gather"])
    close(r["y"][:96], d["A"] @ d["x"])
    for a, b in zip(par.plan_general_halo(ind, cases.NDEV, 24), jx.par.plan_general_halo(ind, cases.NDEV, 24)):
        np.testing.assert_array_equal(a, b)


def test_plan_general_halo_local_only(jx):
    """Block-diagonal structure plans an empty exchange, as in the JAX package."""
    ndev, m_loc, n_loc = 4, 8, 8
    ell = np.full((ndev * m_loc, 3), -1, dtype=np.int64)
    for dd in range(ndev):
        for rr in range(m_loc):
            ell[dd * m_loc + rr, 0] = dd * n_loc + (rr % n_loc)
    ind_remap, pack_idx, S_max = par.plan_general_halo(ell, ndev, n_loc)
    assert S_max == 1 and (pack_idx == 0).all() and (ind_remap[ell >= 0] < n_loc).all()
    for a, b in zip((ind_remap, pack_idx, S_max), jx.par.plan_general_halo(ell, ndev, n_loc)):
        np.testing.assert_array_equal(a, b)


def test_dist_spmm_general_halo_plan(world, jx):
    d, r, _ = case(world, "spmm_halo_plan")
    ind, val = jell_padded(jx, d["A"])
    Bs = jput(jx, cases.padded(d["B"], cases.NDEV), "x", None)
    close(r["C"], np.asarray(jx.par.dist_spmm_ell_halo_plan(jx.mesh, ind, val, Bs)))
    close(r["C"][:80], d["A"] @ d["B"])


def test_dist_spmv_balanced_halo_skew(world, jx):
    d, r, _ = case(world, "balanced_halo")
    ptr, ind, val = cases.csr_of(d["A"])
    y, bounds, mloc = jx.par.dist_spmv_balanced_halo(jx.mesh, ptr, ind, val,
                                                     jput(jx, cases.padded(d["x"], cases.NDEV), "x"))
    np.testing.assert_array_equal(r["bounds"], bounds)
    close(r["y"], jx.par.compact_balanced(y, bounds, mloc))
    close(r["y"], d["A"] @ d["x"])


# ---------------------------------------------------------------------------
# cg
# ---------------------------------------------------------------------------


def test_cg_ell_jit_single(jx):
    d = cases.inputs("parallel")["cg_ell"]
    m = d["b"].shape[0]
    ptr, ind, val = cases.csr_of(d["A"])
    f = get_plan(tt.create_csr(m, m, ptr, ind, val, device="cpu")).exec_form_for(GEN, NONE, kind="ell")
    x, k, _rn = par.cg_ell_jit(f.ell_ind, f.ell_val, torch.from_numpy(d["b"]), torch.zeros(m), 1e-10, 0.0, 200)
    jf = jform(jx, jcsr(jx, d["A"]), "ell")
    jnp = jx.jax.numpy
    xj, kj, _ = jx.par.cg_ell_jit(jf.ell_ind, jf.ell_val, jnp.asarray(d["b"]), jnp.zeros(m), jnp.asarray(1e-10),
                                  jnp.asarray(0.0), 200)
    assert k == int(kj)
    close(x.numpy(), np.asarray(xj))


def test_cg_ell_jit_puts_host_operands_on_the_port_device(monkeypatch):
    """Numpy operands go to `device`, and with none to the port's default
    device (cuda:0; here a stand-in device caught before the loop), never
    silently to the CPU; the CPU answer equals the tensor call's."""
    from aoclsparse_tpu_torch.core import context
    from aoclsparse_tpu_torch.parallel import cg as pcg

    d = cases.inputs("parallel")["cg_ell"]
    m = d["b"].shape[0]
    ptr, ind, val = cases.csr_of(d["A"])
    f = get_plan(tt.create_csr(m, m, ptr, ind, val, device="cpu")).exec_form_for(GEN, NONE, kind="ell")
    ind_h, val_h = f.ell_ind.numpy(), f.ell_val.numpy()
    x, k, _ = par.cg_ell_jit(ind_h, val_h, d["b"], np.zeros(m), 1e-10, 0.0, 200, device="cpu")
    xt, kt, _ = par.cg_ell_jit(f.ell_ind, f.ell_val, torch.from_numpy(d["b"]), torch.zeros(m), 1e-10, 0.0, 200)
    assert x.device.type == "cpu" and k == kt
    np.testing.assert_array_equal(x.numpy(), xt.numpy())
    seen = []
    monkeypatch.setattr(context, "DEFAULT_DEVICE", torch.device("meta"))
    monkeypatch.setattr(pcg, "_cg_loop", lambda mv, b, x0, *a: seen.append((b.device, x0.device)))
    par.cg_ell_jit(ind_h, val_h, d["b"], np.zeros(m), 1e-10, 0.0, 200)
    assert seen == [(torch.device("meta"), torch.device("meta"))]


def test_cg_bwd_and_gmres_bwd_jit_single(jx):
    """The group-window loops (kernel #4's plain version here) with the
    JAX loops' counts, on a form with a peel spill."""
    data = cases.inputs("parallel")
    jnp = jx.jax.numpy
    for A_d, is_cg in ((data["cg_bwd"]["A"], True), (data["gmres"]["A"], False)):
        m = A_d.shape[0]
        bvec = A_d @ np.ones(m)
        ptr, ind, val = cases.csr_of(A_d)
        f = get_plan(tt.create_csr(m, m, ptr, ind, val, device="cpu")).exec_form_for(GEN, NONE, kind="bwd")
        jf = jform(jx, jcsr(jx, A_d), "bwd")
        assert (f.bwd_W, f.bwd_base8, f.bwd_padL) == (jf.bwd_W, jf.bwd_base8, jf.bwd_padL)
        geo = (f.bwd_W, f.bwd_base8, f.bwd_padL, f.bwd_n_pad)
        jgeo = (jf.bwd_W, jf.bwd_base8, jf.bwd_padL, jf.bwd_n_pad)
        sp = (f.sp_ind, f.sp_rows, f.sp_val)
        jsp = (jf.sp_ind, jf.sp_rows, jf.sp_val)
        if is_cg:
            x, k, _ = par.cg_bwd_jit(f.bwd_val, bvec, np.zeros(m), 1e-10, 0.0, 300, *geo, *sp)
            xj, kj, _ = jx.par.cg_bwd_jit(jf.bwd_val, jnp.asarray(bvec), jnp.zeros(m),
                                          jnp.asarray(1e-10), jnp.asarray(0.0), 300, *jgeo, *jsp)
        else:
            x, k, _ = par.gmres_bwd_jit(f.bwd_val, bvec, np.zeros(m), 1e-10, 0.0, 20, 30, *geo, *sp)
            xj, kj, _ = jx.par.gmres_bwd_jit(jf.bwd_val, jnp.asarray(bvec), jnp.zeros(m), jnp.asarray(1e-10),
                                             jnp.asarray(0.0), 20, 30, *jgeo, *jsp)
        assert int(k) == int(kj)
        close(x.numpy(), np.asarray(xj))


def test_cg_bandv_jit_f32_and_bf16(jx):
    """The band-kernel CG (#1's and #2's plain versions here) against the
    JAX package's on its vertical Pallas band in interpret mode (f32), and
    the bf16 band against the f32 solve at the bf16 bound."""
    from aoclsparse_tpu.planner.plan import get_plan as jget_plan

    rng = np.random.default_rng(3)
    m = 128
    B = (rng.standard_normal((m, m)) * (rng.random((m, m)) < 0.2)) * (
        np.abs(np.subtract.outer(np.arange(m), np.arange(m))) < 12)
    dense = (B @ B.T + m * np.eye(m)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    ptr, ind, val = cases.csr_of(dense)
    f = get_plan(tt.create_csr(m, m, ptr, ind, val, device="cpu")).exec_form_for(GEN, NONE, kind="bandt")
    sp = dict(sp_ind=f.sp_ind, sp_rows=f.sp_rows, sp_val=f.sp_val)
    x, k, _ = par.cg_bandv_jit(f.bwd_val, b, np.zeros(m, np.float32), 1e-6, 0.0, 200, f.bwd_W, f.bwd_padL,
                               f.bandt_start, **sp)
    jA = jx.ast.create_csr(m, m, ptr, ind, val)
    jf = jget_plan(jA).exec_form_for(jx.ast.MatrixDescriptor(), jx.ast.Operation.none, kind="bandt")
    vt4 = jf.bandt_vertical(TM=128)
    jnp = jx.jax.numpy
    from aoclsparse_tpu.parallel.cg import cg_bandv_jit as jcg_bandv

    xj, kj, _ = jcg_bandv(vt4, jnp.asarray(b), jnp.zeros(m, jnp.float32), jnp.asarray(1e-6, jnp.float32),
                                    jnp.asarray(0.0, jnp.float32), 200, vt4.shape[0] // 8, jf.bwd_padL,
                                    jf.bandt_start, TM=128, sp_ind=jf.sp_ind, sp_rows=jf.sp_rows, sp_val=jf.sp_val,
                                    interpret=True)
    assert k == int(kj)
    assert near_error(x.numpy(), np.asarray(xj)) <= expected_precision(torch.float32, 10)
    xb, kb, _ = par.cg_bandv_jit(f.band_bf16(), b, np.zeros(m, np.float32), 1e-3, 0.0, 200, f.bwd_W, f.bwd_padL,
                                 f.bandt_start, **sp)
    assert x.dtype == xb.dtype == torch.float32 and kb > 0
    assert np.linalg.norm(dense @ xb.numpy() - b) <= 4 * 2.0**-8 * np.linalg.norm(b) * np.sqrt(m)


def test_dist_cg_uneven_rows(world, jx):
    d, r, allr = case(world, "cg_ell")
    f = jform(jx, jcsr(jx, d["A"]), "ell")
    same_solve(r, jx.par.dist_cg(jx.mesh, f.ell_ind, f.ell_val, d["b"], rtol=1e-10, maxit=200))
    residual_ok(d["A"], r["x"], d["b"], 1e-10)
    assert len({rr["k"] for rr in allr}) == 1


def test_dist_cg_bwd(world, jx):
    d, r, _ = case(world, "cg_bwd")
    f = jform(jx, jcsr(jx, d["A"]), "bwd")
    same_solve(r, jx.par.dist_cg_bwd(jx.mesh, f, d["b"], rtol=1e-10, maxit=300))
    residual_ok(d["A"], r["x"], d["b"], 1e-10)


def test_dist_cg_bwd_halo(world, jx):
    d, r, _ = case(world, "cg_halo")
    f = jform(jx, jcsr(jx, d["A"]), "bwd")
    same_solve(r["halo"], jx.par.dist_cg_bwd_halo(jx.mesh, f, d["b"], rtol=1e-10, maxit=400))
    same_solve(r["bwd"], jx.par.dist_cg_bwd(jx.mesh, f, d["b"], rtol=1e-10, maxit=400))
    residual_ok(d["A"], r["halo"]["x"], d["b"], 1e-10)


def test_dist_cg_pipelined_matches_classic(world, jx):
    d, r, _ = case(world, "cg_pipelined")
    f = jform(jx, jcsr(jx, d["A"]), "bwd")
    same_solve(r["pipe"], jx.par.dist_cg_pipelined(jx.mesh, f, d["b"], rtol=1e-12, maxit=400))
    assert abs(r["pipe"]["k"] - r["halo"]["k"]) <= 3
    close(r["pipe"]["x"], np.ones(256), 1e-3)
    assert r["pipe"]["rn"] <= 1e-9 * np.linalg.norm(d["b"])


def test_dist_cg_pipelined_quick_exits(world, jx):
    d, r, _ = case(world, "cg_quick")
    f = jform(jx, jcsr(jx, d["A"]), "bwd")
    m = d["b"].shape[0]
    _x, kz, _ = jx.par.dist_cg_pipelined(jx.mesh, f, np.zeros(m), rtol=1e-10, atol=1e-300, maxit=50)
    _x, ke, _ = jx.par.dist_cg_pipelined(jx.mesh, f, d["b"], x0=d["xstar"], rtol=1e-10, maxit=50)
    assert r["zero"]["k"] == kz == 0 and np.allclose(r["zero"]["x"], 0.0)
    assert r["exact"]["k"] == ke == 0
    np.testing.assert_allclose(r["exact"]["x"], d["xstar"], atol=1e-12)


def test_dist_pcg_jacobi_variants(world, jx):
    d, r, _ = case(world, "pcg_jacobi")
    f = jform(jx, jcsr(jx, d["A"]), "bwd")
    dinv = 1.0 / np.diag(d["A"])
    same_solve(r["jacobi"], jx.par.dist_cg_bwd_halo(jx.mesh, f, d["b"], rtol=1e-12, maxit=3000, dinv=dinv))
    same_solve(r["pipe"], jx.par.dist_cg_pipelined(jx.mesh, f, d["b"], rtol=1e-12, maxit=3000, dinv=dinv))
    assert r["jacobi"]["k"] < r["none"]["k"] / 3
    residual_ok(d["A"], r["jacobi"]["x"], d["b"], 1e-12)


def test_dist_pcg_block_jacobi(world, jx):
    d, r, _ = case(world, "pcg_block")
    jA = jcsr(jx, d["A"])
    f = jform(jx, jA, "bwd")
    jeff = jx.plan.get_plan(jA).effective_for(jx.ast.MatrixDescriptor(), jx.ast.Operation.none, jA.dtype)
    dblk = jx.par.block_jacobi_inv(jeff, 16, 256)
    np.testing.assert_allclose(r["dblk"], dblk, rtol=1e-12, atol=1e-14)
    same_solve(r["block"], jx.par.dist_cg_bwd_halo(jx.mesh, f, d["b"], rtol=1e-12, maxit=5000, dinv=dblk))
    same_solve(r["pipe"], jx.par.dist_cg_pipelined(jx.mesh, f, d["b"], rtol=1e-12, maxit=5000, dinv=dblk))
    assert r["block"]["k"] < r["jacobi"]["k"]
    residual_ok(d["A"], r["block"]["x"], d["b"], 1e-12)


def test_dist_cg_ell_halo_general_structure(world, jx):
    d, r, _ = case(world, "cg_ell_halo")
    f = jform(jx, jcsr(jx, d["A"]), "ell")
    same_solve(r["halo"], jx.par.dist_cg_ell_halo(jx.mesh, f.ell_ind, f.ell_val, d["b"], rtol=1e-12, maxit=500))
    same_solve(r["jacobi"], jx.par.dist_cg_ell_halo(jx.mesh, f.ell_ind, f.ell_val, d["b"], rtol=1e-12, maxit=500,
                                                    dinv=1.0 / np.diag(d["A"])))
    assert r["halo"]["k"] == r["cg"]["k"]
    residual_ok(d["A"], r["halo"]["x"], d["b"], 1e-12)


# ---------------------------------------------------------------------------
# gmres
# ---------------------------------------------------------------------------


def test_dist_gmres_bwd(world, jx):
    d, r, _ = case(world, "gmres")
    f = jform(jx, jcsr(jx, d["A"]), "bwd")
    same_solve(r, jx.par.dist_gmres_bwd(jx.mesh, f, d["b"], rtol=1e-10, maxit=300))
    residual_ok(d["A"], r["x"], d["b"], 1e-10)


def test_dist_gmres_halo_matches_replicated(world, jx):
    d, r, _ = case(world, "gmres_halo")
    f = jform(jx, jcsr(jx, d["A"]), "bwd")
    same_solve(r["halo"], jx.par.dist_gmres_bwd_halo(jx.mesh, f, d["b"], rtol=1e-12, restart=20, maxit=300))
    assert r["halo"]["k"] == r["rep"]["k"]
    close(r["halo"]["x"], r["rep"]["x"])
    residual_ok(d["A"], r["halo"]["x"], d["b"], 1e-12)


def test_dist_gmres_halo_preconditioned(world, jx):
    d, r, _ = case(world, "gmres_precond")
    jA = jcsr(jx, d["A"])
    f = jform(jx, jA, "bwd")
    jeff = jx.plan.get_plan(jA).effective_for(jx.ast.MatrixDescriptor(), jx.ast.Operation.none, jA.dtype)
    dblk = jx.par.block_jacobi_inv(jeff, 16, 256)
    kw = dict(rtol=1e-12, restart=20, maxit=2000)
    same_solve(r["jacobi"], jx.par.dist_gmres_bwd_halo(jx.mesh, f, d["b"], dinv=1.0 / np.diag(d["A"]), **kw))
    same_solve(r["block"], jx.par.dist_gmres_bwd_halo(jx.mesh, f, d["b"], dinv=dblk, **kw))
    assert r["block"]["k"] <= r["jacobi"]["k"] < r["none"]["k"]
