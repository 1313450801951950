"""Rank-side cases of the distributed parity tests of the PyTorch port
(tests/test_torch_parallel.py, test_torch_parallel_solves.py,
test_torch_collectives.py).

Spawned ranks import this module, so it imports no JAX (tests/conftest.py
does; this file is not collected). `inputs(suite)` makes every case's
operands from fixed seeds with numpy; the test module passes them to
`run_suite` on a four-rank gloo world (aoclsparse_tpu_torch.parallel
`spawn_world`) and runs the JAX package on the same operands in its own
process. A case returns numpy results; an exception a case expects comes
back as {"raised": name, "status": ...}, any other as {"error": text}.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import parallel as par
from aoclsparse_tpu_torch.core.types import AoclSparseError, DiagType, FillMode, MatrixType
from aoclsparse_tpu_torch.parallel.placement import P
from aoclsparse_tpu_torch.utils import collectives as coll

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
NDEV = 4


# ---------------------------------------------------------------------------
# operands (numpy, seeded)
# ---------------------------------------------------------------------------


def csr_of(dense):
    msk = dense != 0
    ptr = np.concatenate([[0], np.cumsum(msk.sum(1))]).astype(np.int64)
    return ptr, np.nonzero(msk)[1].astype(np.int32), dense[msk]


def random_dense(rng, m, n, density):
    """tests/conftest.py random_csr's matrix (no forced diagonal)."""
    mask = rng.random((m, n)) < density
    dense = np.zeros((m, n))
    dense[mask] = rng.standard_normal(mask.sum())
    return dense


def band_dense(rng, m, half):
    """Full band |i - j| <= half, random values (test_dist_depth _band_csr)."""
    dense = np.zeros((m, m))
    for d in range(-half, half + 1):
        dense += np.diag(rng.standard_normal(m - abs(d)), d)
    return dense


def shifted_band(rng, m, per, lo_shift):
    """Row i: `per` columns in [i + lo_shift, i + lo_shift + 2 per) (test_parallel _band_csr)."""
    span = 2 * per
    base = np.clip(np.arange(m) + lo_shift, 0, m - span)
    pick = np.argsort(rng.random((m, span)), axis=1)[:, :per]
    cols = np.sort(base[:, None] + pick, axis=1)
    dense = np.zeros((m, m))
    dense[np.repeat(np.arange(m), per), cols.reshape(-1)] = rng.standard_normal(m * per)
    return dense


def spd_dense(rng, m):
    B = rng.standard_normal((m, m))
    B[np.abs(B) < 1.2] = 0
    return B @ B.T + m * np.eye(m)


def skewed_dense(rng, m):
    """Power-law rows: the first dense, the tail nearly empty."""
    dense = np.zeros((m, m))
    for i in range(m):
        k = int(min(m, max(1, m // (i + 1))))
        dense[i, rng.choice(m, k, replace=False)] = rng.standard_normal(k)
    return dense


def symmetric_band(rng, m, half, diag):
    d = band_dense(rng, m, half)
    return (d + d.T) / 2 + np.eye(m) * diag


def inputs(suite: str) -> dict:
    """Every case's operands of `suite`, from fixed seeds."""
    rng = np.random.default_rng(42)
    out = {}
    if suite == "parallel":
        out["spmv_ell"] = dict(A=random_dense(rng, 64, 64, 0.2), x=rng.standard_normal(64))
        out["bwd_halo"] = dict(A=band_dense(rng, 500, 6), x=rng.standard_normal(500))
        out["bwd_halo_tiny"] = dict(A=band_dense(rng, 32, 5), x=rng.standard_normal(32))
        out["bwd_halo_spill"] = dict(A=band_dense(rng, 256, 3))
        for s in (-6, 0, 40):
            out[f"spmm_bwd_halo[{s}]"] = dict(A=shifted_band(rng, 4096, 5, s), B=rng.standard_normal((4096, 8)))
        out["spmm_bwd_halo_single"] = dict(A=shifted_band(rng, 2048, 4, 0), B=rng.standard_normal((2048, 4)))
        out["ell_balanced"] = dict(A=skewed_dense(rng, 256), x=rng.standard_normal(256))
        out["halo_plan"] = dict(A=random_dense(rng, 96, 96, 0.08), x=rng.standard_normal(96))
        out["spmm_halo_plan"] = dict(A=random_dense(rng, 80, 80, 0.07), B=rng.standard_normal((80, 6)))
        out["balanced_halo"] = dict(A=skewed_dense(rng, 192), x=rng.standard_normal(192))
        out["cg_ell"] = dict(A=spd_dense(rng, 37), b=rng.standard_normal(37))
        out["cg_bwd"] = dict(A=spd_dense(rng, 72), b=rng.standard_normal(72))
        penta = np.zeros((384, 384))
        for off, v in [(0, 6.0), (1, -1.0), (2, -0.5)]:
            penta += np.diag(np.full(384 - off, v), off)
            if off:
                penta += np.diag(np.full(384 - off, v), -off)
        out["cg_halo"] = dict(A=penta, b=rng.standard_normal(384))
        sb = symmetric_band(rng, 256, 3, 8.0)
        out["cg_pipelined"] = dict(A=sb, b=sb @ np.ones(256))
        qb = symmetric_band(rng, 128, 2, 6.0)
        xs = rng.standard_normal(128)
        out["cg_quick"] = dict(A=qb, b=qb @ xs, xstar=xs)
        jd = band_dense(rng, 256, 3)
        jd = (jd + jd.T) / 2 + np.diag(np.exp(rng.uniform(0, 6, 256))) * 8
        xs = rng.standard_normal(256)
        out["pcg_jacobi"] = dict(A=jd, b=jd @ xs, xstar=xs)
        bd = np.zeros((256, 256))
        for dd in range(-3, 4):
            bd += np.diag(rng.standard_normal(256 - abs(dd)) * (2.0 if dd else 1.0), dd)
        bd = (bd + bd.T) / 2 + np.eye(256) * 10
        s = np.exp(rng.uniform(0, 3, 256))
        bd = bd * np.outer(s, s)
        xs = rng.standard_normal(256)
        out["pcg_block"] = dict(A=bd, b=bd @ xs, xstar=xs)
        B = rng.standard_normal((128, 128))
        B[np.abs(B) < 1.3] = 0
        ed = B @ B.T + 128 * np.eye(128)
        ed[np.abs(ed) < 1e-12] = 0
        xs = rng.standard_normal(128)
        out["cg_ell_halo"] = dict(A=ed, b=ed @ xs, xstar=xs)
        gd = random_dense(rng, 72, 72, 0.5)
        gd[np.abs(gd) < 1.0] = 0
        np.fill_diagonal(gd, 36.0)
        out["gmres"] = dict(A=gd, b=rng.standard_normal(72))
        hd = band_dense(rng, 256, 3)
        np.fill_diagonal(hd, np.abs(hd).sum(1) + 1)
        xs = rng.standard_normal(256)
        out["gmres_halo"] = dict(A=hd, b=hd @ xs, xstar=xs)
        pd = band_dense(rng, 256, 3) * 2.0
        np.fill_diagonal(pd, np.abs(pd).sum(1) + 1)
        s = np.exp(rng.uniform(0, 3, 256))
        pd = pd * np.outer(s, s)
        xs = rng.standard_normal(256)
        out["gmres_precond"] = dict(A=pd, b=pd @ xs, xstar=xs)
        out["placement"] = dict(X=rng.standard_normal((8, 12)))
    elif suite == "solves":
        lo = np.tril(rng.standard_normal((256, 256))) * (np.abs(rng.standard_normal((256, 256))) < 0.6)
        np.fill_diagonal(lo, 4.0 + rng.random(256))
        out["trsv_pipeline"] = dict(L=lo, b=rng.standard_normal(256))
        tm = np.tril(rng.standard_normal((128, 128))) * (np.abs(rng.standard_normal((128, 128))) < 0.5)
        np.fill_diagonal(tm, 5.0)
        out["trsm"] = dict(L=tm, B=rng.standard_normal((128, 24)))
        full = np.tril(rng.random((128, 128)) < 0.05) * rng.standard_normal((128, 128))
        np.fill_diagonal(full, 2.0 + rng.random(128))
        full = np.tril(full) + np.triu(rng.standard_normal((128, 128)) * (rng.random((128, 128)) < 0.05), 1)
        out["trsv_levels"] = dict(A=full, b=rng.standard_normal(128), B=rng.standard_normal((128, 3)))
        for name, m in (("symgs", 160), ("chain", 160), ("chain_refresh", 96), ("cache", 96)):
            D = np.tril(rng.standard_normal((m, m)) * (rng.random((m, m)) < 0.15), -1)
            out[name] = dict(A=D + D.T + np.diag(6 + rng.random(m)), b=rng.standard_normal(m),
                             x0=rng.standard_normal(m))
        ld = (rng.random((96, 96)) < 0.06) * rng.standard_normal((96, 96))
        np.fill_diagonal(ld, 4.0 + rng.random(96))
        sd = (rng.random((96, 96)) < 0.06) * rng.standard_normal((96, 96))
        sd = (sd + sd.T) / 2
        np.fill_diagonal(sd, 5.0 + rng.random(96))
        out["level_engine"] = dict(A=ld, S=sd, b=rng.standard_normal(96))
        out["spgemm_numeric"] = dict(A=random_dense(rng, 30, 25, 0.25), B=random_dense(rng, 25, 28, 0.25))
        out["spgemm_rowpart"] = dict(A=skewed_dense(rng, 192))
        out["spgemm_halo"] = dict(A=band_dense(rng, 256, 4))
        nl = np.eye(64)
        nl[0, 0], nl[0, 63] = 0.0, 1.0
        out["spgemm_nonlocal"] = dict(A=nl)
    elif suite == "collectives":
        sb = symmetric_band(rng, 512, 3, 8.0)
        out["ledger"] = dict(A=sb, b=np.linspace(0.5, 1.5, 512), B=random_dense(rng, 128, 128, 0.05) + 20 * np.eye(128))
        out["primitives"] = dict(v=rng.standard_normal((NDEV, 6)))
    return out


# ---------------------------------------------------------------------------
# port-side helpers
# ---------------------------------------------------------------------------


def handle(mesh, dense, dtype=np.float64):
    ptr, ind, val = csr_of(dense)
    m, n = dense.shape
    return tt.create_csr(m, n, ptr, ind, val.astype(dtype), device=mesh.device)


def form(A, kind):
    from aoclsparse_tpu_torch.planner.plan import get_plan

    return get_plan(A).exec_form_for(GEN, NONE, kind=kind)


def spill_free_bwd(A):
    from aoclsparse_tpu_torch.planner.plan import _build_bwd, get_plan

    return _build_bwd(get_plan(A).effective_for(GEN, NONE, A.dtype))


def ell_padded(A):
    """The ELL form's arrays with rows padded to a rank multiple."""
    f = form(A, "ell")
    ind, val = f.ell_ind.numpy(), f.ell_val.numpy()
    mp = -(-ind.shape[0] // NDEV) * NDEV
    return (np.pad(ind, ((0, mp - ind.shape[0]), (0, 0)), constant_values=-1),
            np.pad(val, ((0, mp - val.shape[0]), (0, 0))))


def padded(v, mult):
    n = v.shape[0]
    return np.pad(v, [(0, -(-n // mult) * mult - n)] + [(0, 0)] * (v.ndim - 1))


def host(mesh, v):
    return par.fetch(v, mesh)


def solved(mesh, out):
    x, k, rn = out
    return {"x": host(mesh, x), "k": int(k), "rn": float(rn)}


def raised(fn):
    try:
        fn()
    except AoclSparseError as e:
        return {"raised": "AoclSparseError", "status": int(e.status)}
    except ValueError:
        return {"raised": "ValueError"}
    return {"raised": None}


def tri(fill, diag=DiagType.non_unit):
    return tt.MatrixDescriptor(type=MatrixType.triangular, fill_mode=fill, diag_type=diag)


def block_inv(A, nb, m_pad):
    from aoclsparse_tpu_torch.planner.plan import get_plan

    return par.block_jacobi_inv(get_plan(A).effective_for(GEN, NONE, A.dtype), nb, m_pad)


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------


def _parallel(mesh, d, name):
    if name == "spmv_ell":
        A = handle(mesh, d["A"])
        f = form(A, "ell")
        ind_s, val_s, _ = par.shard_ell(mesh, f.ell_ind, f.ell_val)
        y1 = host(mesh, par.dist_spmv_ell(mesh, ind_s, val_s, d["x"]))
        y2 = host(mesh, par.dist_spmv_ell_sharded_x(mesh, ind_s, val_s, par.put(d["x"], mesh, P("x"))))
        return {"y": y1, "y_sharded_x": y2}
    if name in ("bwd_halo", "bwd_halo_tiny"):
        A = handle(mesh, d["A"])
        f = spill_free_bwd(A)
        xs = par.put(padded(d["x"], 8 * NDEV), mesh, P("x"))
        return {"y": host(mesh, par.dist_spmv_bwd_halo(mesh, f, xs)),
                "y_overlap": host(mesh, par.dist_spmv_bwd_halo_overlap(mesh, f, xs))}
    if name == "bwd_halo_spill":
        f = spill_free_bwd(handle(mesh, d["A"]))
        f.sp_ind = torch.zeros(3, dtype=torch.int64)
        return raised(lambda: par.dist_spmv_bwd_halo(mesh, f, par.put(np.zeros(256), mesh, P("x"))))
    if name.startswith("spmm_bwd_halo"):
        A = handle(mesh, d["A"])
        f = form(A, "bwdg")
        Bs = par.put(padded(d["B"], f.bwd_G * NDEV), mesh, P("x", None))
        return {"C": host(mesh, par.dist_spmm_bwd_halo(mesh, f, Bs)), "G": f.bwd_G,
                "spill": f.sp_ind is not None and int(f.sp_ind.shape[0]) > 0}
    if name == "ell_balanced":
        ptr, ind, val = csr_of(d["A"])
        src, ell_ind, mloc, bounds = par.pack_balanced_ell(ptr, ind, NDEV)
        vals = np.where(src >= 0, val[np.clip(src, 0, None)], 0.0)
        return {"y": host(mesh, par.dist_spmv_ell_balanced(mesh, ell_ind, d["x"], bounds, vals)), "bounds": bounds}
    if name == "halo_plan":
        ind, val = ell_padded(handle(mesh, d["A"]))
        xs = par.put(padded(d["x"], NDEV), mesh, P("x"))
        ind_s, val_s, _ = par.shard_ell(mesh, ind, val)
        return {"y": host(mesh, par.dist_spmv_ell_halo_plan(mesh, ind, val, xs)),
                "y_gather": host(mesh, par.dist_spmv_ell_sharded_x(mesh, ind_s, val_s, xs))}
    if name == "spmm_halo_plan":
        ind, val = ell_padded(handle(mesh, d["A"]))
        Bs = par.put(padded(d["B"], NDEV), mesh, P("x", None))
        return {"C": host(mesh, par.dist_spmm_ell_halo_plan(mesh, ind, val, Bs))}
    if name == "balanced_halo":
        ptr, ind, val = csr_of(d["A"])
        y, bounds, mloc = par.dist_spmv_balanced_halo(mesh, ptr, ind, val, par.put(padded(d["x"], NDEV), mesh, P("x")))
        return {"y": par.compact_balanced(y, bounds, mloc, mesh), "bounds": bounds}
    if name == "cg_ell":
        f = form(handle(mesh, d["A"]), "ell")
        return solved(mesh, par.dist_cg(mesh, f.ell_ind, f.ell_val, d["b"], rtol=1e-10, maxit=200))
    if name == "cg_bwd":
        f = form(handle(mesh, d["A"]), "bwd")
        return solved(mesh, par.dist_cg_bwd(mesh, f, d["b"], rtol=1e-10, maxit=300))
    if name == "cg_halo":
        f = form(handle(mesh, d["A"]), "bwd")
        return {"bwd": solved(mesh, par.dist_cg_bwd(mesh, f, d["b"], rtol=1e-10, maxit=400)),
                "halo": solved(mesh, par.dist_cg_bwd_halo(mesh, f, d["b"], rtol=1e-10, maxit=400))}
    if name == "cg_pipelined":
        f = form(handle(mesh, d["A"]), "bwd")
        return {"halo": solved(mesh, par.dist_cg_bwd_halo(mesh, f, d["b"], rtol=1e-12, maxit=400)),
                "pipe": solved(mesh, par.dist_cg_pipelined(mesh, f, d["b"], rtol=1e-12, maxit=400))}
    if name == "cg_quick":
        f = form(handle(mesh, d["A"]), "bwd")
        m = d["b"].shape[0]
        return {"zero": solved(mesh, par.dist_cg_pipelined(mesh, f, np.zeros(m), rtol=1e-10, atol=1e-300, maxit=50)),
                "exact": solved(mesh, par.dist_cg_pipelined(mesh, f, d["b"], x0=d["xstar"], rtol=1e-10, maxit=50))}
    if name == "pcg_jacobi":
        f = form(handle(mesh, d["A"]), "bwd")
        dinv = 1.0 / np.diag(d["A"])
        return {"none": solved(mesh, par.dist_cg_bwd_halo(mesh, f, d["b"], rtol=1e-12, maxit=3000)),
                "jacobi": solved(mesh, par.dist_cg_bwd_halo(mesh, f, d["b"], rtol=1e-12, maxit=3000, dinv=dinv)),
                "pipe": solved(mesh, par.dist_cg_pipelined(mesh, f, d["b"], rtol=1e-12, maxit=3000, dinv=dinv))}
    if name == "pcg_block":
        A = handle(mesh, d["A"])
        f = form(A, "bwd")
        dblk = block_inv(A, 16, 256)
        return {"dblk": dblk,
                "jacobi": solved(mesh, par.dist_cg_bwd_halo(mesh, f, d["b"], rtol=1e-12, maxit=5000,
                                                            dinv=1.0 / np.diag(d["A"]))),
                "block": solved(mesh, par.dist_cg_bwd_halo(mesh, f, d["b"], rtol=1e-12, maxit=5000, dinv=dblk)),
                "pipe": solved(mesh, par.dist_cg_pipelined(mesh, f, d["b"], rtol=1e-12, maxit=5000, dinv=dblk))}
    if name == "cg_ell_halo":
        f = form(handle(mesh, d["A"]), "ell")
        return {"cg": solved(mesh, par.dist_cg(mesh, f.ell_ind, f.ell_val, d["b"], rtol=1e-12, maxit=500)),
                "halo": solved(mesh, par.dist_cg_ell_halo(mesh, f.ell_ind, f.ell_val, d["b"], rtol=1e-12, maxit=500)),
                "jacobi": solved(mesh, par.dist_cg_ell_halo(mesh, f.ell_ind, f.ell_val, d["b"], rtol=1e-12, maxit=500,
                                                            dinv=1.0 / np.diag(d["A"])))}
    if name == "gmres":
        f = form(handle(mesh, d["A"]), "bwd")
        return solved(mesh, par.dist_gmres_bwd(mesh, f, d["b"], rtol=1e-10, maxit=300))
    if name == "gmres_halo":
        f = form(handle(mesh, d["A"]), "bwd")
        return {"rep": solved(mesh, par.dist_gmres_bwd(mesh, f, d["b"], rtol=1e-12, restart=20, maxit=300)),
                "halo": solved(mesh, par.dist_gmres_bwd_halo(mesh, f, d["b"], rtol=1e-12, restart=20, maxit=300))}
    if name == "gmres_precond":
        A = handle(mesh, d["A"])
        f = form(A, "bwd")
        dblk = block_inv(A, 16, 256)
        kw = dict(rtol=1e-12, restart=20, maxit=2000)
        return {"none": solved(mesh, par.dist_gmres_bwd_halo(mesh, f, d["b"], **kw)),
                "jacobi": solved(mesh, par.dist_gmres_bwd_halo(mesh, f, d["b"], dinv=1.0 / np.diag(d["A"]), **kw)),
                "block": solved(mesh, par.dist_gmres_bwd_halo(mesh, f, d["b"], dinv=dblk, **kw))}
    if name == "placement":
        X = d["X"]
        rows = par.put(X, mesh, P("x"))
        cols = par.put(X, mesh, P(None, "x"))
        rep = par.put(X, mesh, P())
        return {"rows": host(mesh, rows), "cols": host(mesh, cols), "rep": host(mesh, rep),
                "row_block": rows.local.numpy(), "row_offset": rows.offset, "col_offset": cols.offset,
                "device": str(rows.local.device), "multi": par.mesh_is_multiprocess(mesh),
                "count": par.process_count(), "index": par.process_index(),
                "mesh3": raised(lambda: par.make_mesh(3)), "odd": raised(lambda: par.put(X[:7], mesh, P("x")))}
    raise KeyError(name)


def _solves(mesh, d, name):
    from aoclsparse_tpu_torch.ops.level3.spgemm import _effective, _symbolic
    from aoclsparse_tpu_torch.planner.plan import get_plan
    from aoclsparse_tpu_torch.planner.triangular import trsv_form_for, trsv_level_form_for

    if name == "trsv_pipeline":
        out = {}
        for fill in (FillMode.lower, FillMode.upper):
            L = d["L"] if fill == FillMode.lower else d["L"].T
            f = trsv_form_for(get_plan(handle(mesh, L)), tri(fill), NONE, nb=16)
            out[fill.name] = host(mesh, par.dist_trsv_pipeline(mesh, f, d["b"]))
        return out
    if name == "trsm":
        f = trsv_form_for(get_plan(handle(mesh, d["L"])), tri(FillMode.lower), NONE, nb=16)
        return {"pipeline": host(mesh, par.dist_trsm_pipeline(mesh, f, d["B"])),
                "dist_trsm": host(mesh, par.dist_trsm(mesh, f, d["B"])), "kind": f.kind}
    if name == "trsv_levels":
        A = handle(mesh, d["A"])
        out = {}
        for fill in (FillMode.lower, FillMode.upper):
            f = trsv_level_form_for(get_plan(A), tri(fill), NONE)
            out[fill.name] = host(mesh, par.dist_trsv_levels(mesh, f, d["b"]))
        f = trsv_level_form_for(get_plan(A), tri(FillMode.lower), NONE)
        out["multi"] = host(mesh, par.dist_trsv_levels(mesh, f, d["B"]))
        return out
    if name == "symgs":
        A = handle(mesh, d["A"])
        out = {"gen": host(mesh, par.dist_symgs(mesh, A, GEN, 1.3, d["b"])),
               "ilu": host(mesh, par.dist_ilu_apply(mesh, A, d["b"]))}
        At = handle(mesh, np.tril(d["A"]))
        out["sym"] = host(mesh, par.dist_symgs(mesh, At, GEN.with_(type=MatrixType.symmetric), 1.0, d["b"]))
        return out
    if name == "chain":
        A = handle(mesh, d["A"])
        At = handle(mesh, np.tril(d["A"]))
        sym = GEN.with_(type=MatrixType.symmetric)
        eager = None
        for _ in range(3):
            eager = par.dist_symgs(mesh, A, GEN, 1.3, d["b"], x0=eager)
        return {"chain": host(mesh, par.dist_symgs_chain(mesh, A, GEN, 1.3, d["b"], nsweeps=3)),
                "eager": host(mesh, eager),
                "x0": host(mesh, par.dist_symgs_chain(mesh, A, GEN, 1.0, d["b"], nsweeps=2, x0=d["x0"])),
                "sym": host(mesh, par.dist_symgs_chain(mesh, At, sym, 1.0, d["b"], nsweeps=2))}
    if name == "chain_refresh":
        A = handle(mesh, d["A"])
        x1 = host(mesh, par.dist_symgs_chain(mesh, A, GEN, 1.0, d["b"], nsweeps=2))
        tt.update_values(A, torch.from_numpy(csr_of(d["A"])[2] * 2))
        x2 = host(mesh, par.dist_symgs_chain(mesh, A, GEN, 1.0, d["b"], nsweeps=2))
        return {"x1": x1, "x2": x2,
                "null_b": raised(lambda: par.dist_symgs_chain(mesh, A, GEN, 1.0, None, nsweeps=2)),
                "zero_sweeps": raised(lambda: par.dist_symgs_chain(mesh, A, GEN, 1.0, d["b"], nsweeps=0))}
    if name == "cache":
        A = handle(mesh, d["A"])
        x1 = host(mesh, par.dist_symgs(mesh, A, GEN, 1.0, d["b"]))
        tt.update_values(A, torch.from_numpy(csr_of(d["A"])[2] * 2))
        return {"x1": x1, "x2": host(mesh, par.dist_symgs(mesh, A, GEN, 1.0, d["b"]))}
    if name == "level_engine":
        A, S = handle(mesh, d["A"]), handle(mesh, d["S"])
        return {"ilu": host(mesh, par.dist_ilu_apply(mesh, A, d["b"], engine="level")),
                "symgs": host(mesh, par.dist_symgs(mesh, S, GEN, 1.0, d["b"], engine="level")),
                "ilu_bad": raised(lambda: par.dist_ilu_apply(mesh, A, d["b"], engine="nope")),
                "symgs_bad": raised(lambda: par.dist_symgs(mesh, S, GEN, 1.0, d["b"], engine="bogus"))}
    if name == "spgemm_numeric":
        A, B = handle(mesh, d["A"]), handle(mesh, d["B"])
        effA, effB = _effective(A, GEN, NONE), _effective(B, GEN, NONE)
        plan = _symbolic(effA, effB)
        return {"ptr": plan.ptr, "ind": plan.ind, "val": host(mesh, par.dist_spgemm_numeric(mesh, plan, effA.val,
                                                                                            effB.val))}
    if name in ("spgemm_rowpart", "spgemm_halo"):
        eff = _effective(handle(mesh, d["A"]), GEN, NONE)
        fn = par.dist_spgemm_rowpart if name == "spgemm_rowpart" else par.dist_spgemm_halo
        Cptr, Cind, Cval = fn(mesh, eff, eff)
        return {"ptr": Cptr, "ind": Cind, "val": Cval}
    if name == "spgemm_nonlocal":
        eff = _effective(handle(mesh, d["A"]), GEN, NONE)
        return raised(lambda: par.dist_spgemm_halo(mesh, eff, eff))
    raise KeyError(name)


def _collectives(mesh, d, name):
    if name == "ledger":
        A = handle(mesh, d["A"], np.float32)
        from aoclsparse_tpu_torch.planner.plan import _build_bwd, get_plan

        f = _build_bwd(get_plan(A).effective_for(GEN, NONE, A.dtype))
        b = d["b"].astype(np.float32)
        out = {}
        for nm, fn in (("dist_cg_bwd_halo", par.dist_cg_bwd_halo), ("dist_cg_pipelined", par.dist_cg_pipelined),
                       ("dist_gmres_bwd_halo", par.dist_gmres_bwd_halo)):
            out[nm] = coll.ledger_summary(coll.collective_ledger(fn, mesh, f, b, rtol=1e-4, maxit=50))
        Bh = handle(mesh, d["B"], np.float32)
        e = form(Bh, "ell")
        out["dist_cg_ell_halo"] = coll.ledger_summary(coll.collective_ledger(
            par.dist_cg_ell_halo, mesh, e.ell_ind, e.ell_val, np.ones(128, np.float32), rtol=1e-4, maxit=50))
        xs = par.put(padded(b, 8 * NDEV), mesh, P("x"))
        out["dist_spmv_bwd_halo"] = coll.ledger_summary(coll.collective_ledger(par.dist_spmv_bwd_halo, mesh, f, xs))
        out["m"] = f.m
        return out
    if name == "primitives":
        v = torch.from_numpy(d["v"][mesh.rank].copy())
        return {"all_reduce": coll.all_reduce(v, mesh).numpy(),
                "right": coll.ppermute(v, mesh, 1).numpy(), "left": coll.ppermute(v, mesh, -1).numpy(),
                "gather": coll.all_gather(v[None], mesh).numpy(),
                "to_all": coll.all_to_all(torch.arange(NDEV * 2, dtype=torch.float64) + 10 * mesh.rank, mesh).numpy(),
                "async": coll.all_reduce(v, mesh, async_op=True).wait().numpy()}
    raise KeyError(name)


SUITES = {"parallel": _parallel, "solves": _solves, "collectives": _collectives}


def run_suite(mesh, suite: str, data: dict) -> dict:
    """Every case of `suite` on this rank: {case: result}."""
    fn = SUITES[suite]
    out = {}
    for name, d in data.items():
        try:
            out[name] = fn(mesh, d, name)
        except Exception:  # a case's failure is that case's test's
            out[name] = {"error": traceback.format_exc()}
    return out


def world_device(mesh):
    """The device a world started with no `device` puts its blocks on."""
    return str(mesh.device)


def card_halo(mesh, m: int):
    """The card check of the distributed layer (marked cuda): the band halo
    SpMV and the halo CG on the bench-like operand, with the kernel's
    launches on this rank, and the devices its results and a host-operand
    `cg_ell_jit` landed on."""
    from aoclsparse_tpu_torch.kernels.spmv_bwd import spmv_bwd

    rng = np.random.default_rng(7)
    dense = symmetric_band(rng, m, 4, 12.0)
    A = handle(mesh, dense, np.float32)
    f = form(A, "bwd")
    x = rng.standard_normal(m).astype(np.float32)
    before = dict(spmv_bwd.launches)
    ys = par.dist_spmv_bwd_halo(mesh, f, par.put(padded(x, 8 * mesh.size), mesh, P("x")))
    xr, k, rn = par.dist_cg_bwd_halo(mesh, f, dense @ np.ones(m), rtol=1e-5, maxit=200)
    launches = spmv_bwd.launches["f32"] - before["f32"]
    e = form(A, "ell")
    xe, _, _ = par.cg_ell_jit(e.ell_ind.cpu().numpy(), e.ell_val.cpu().numpy(), dense @ np.ones(m), np.zeros(m),
                              1e-5, 0.0, 5)
    devices = [str(t.device) for t in (ys.local, xr.local, xe)]
    return {"y": host(mesh, ys)[:m], "want": (dense.astype(np.float32) @ x), "x": host(mesh, xr), "k": k,
            "launches": launches, "mesh_device": str(mesh.device), "devices": devices}
