"""The collectives of the PyTorch port's distributed layer
(aoclsparse_tpu_torch/utils/collectives.py) and its collective ledger
against the JAX package's.

- The wrappers (all_reduce, ppermute both ways, all_gather, all_to_all, an
  all-reduce in flight) on a four-rank gloo world against numpy.
- The ledger: for dist_cg_bwd_halo, dist_cg_pipelined, dist_cg_ell_halo and
  dist_gmres_bwd_halo the port's collectives an iteration, by kind, and
  their bytes equal the JAX package's `collective_ledger` of the same path
  on the same operand (four-device mesh); MULTICHIP_LEDGER.json's counts
  (2 permutes and 2 all-reduces for the halo CG, 2 and 1 for the pipelined
  CG) and the halo SpMV's two permutes and no all_gather.
- `predict_weak_scaling`: the JAX model's numbers when given the JAX
  package's link constants, and defaults that are not those constants.
- On the card (marked cuda, skipped elsewhere): two gloo ranks sharing
  cuda:0 through the band halo SpMV and the halo CG, with kernel #4's
  launches on every rank, and a one-rank NCCL world through the same.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from aoclsparse_tpu_torch import parallel as par
from aoclsparse_tpu_torch.utils import collectives as coll

KRYLOV = ("dist_cg_bwd_halo", "dist_cg_pipelined", "dist_gmres_bwd_halo", "dist_cg_ell_halo")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu as ast
    from aoclsparse_tpu import parallel as jp
    from aoclsparse_tpu.utils import collectives as jcoll

    return SimpleNamespace(jax=jax, ast=ast, par=jp, coll=jcoll, mesh=jp.make_mesh(cases.NDEV))


@pytest.fixture(scope="module")
def world():
    from aoclsparse_tpu_torch import native

    data = cases.inputs("collectives")
    native.available()
    ranks = par.spawn_world(cases.run_suite, cases.NDEV, "collectives", data, backend="gloo", device="cpu",
                            timeout_s=120)
    return data, ranks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_collectives.py there")
    return torch.device("cuda", 0)


def case(world, name):
    data, ranks = world
    r = ranks[0][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(r["error"])
    return data[name], r, [rk[name] for rk in ranks]


def test_primitives(world):
    d, _r, allr = case(world, "primitives")
    v = d["v"]
    n = cases.NDEV
    for rank, r in enumerate(allr):
        np.testing.assert_allclose(r["all_reduce"], v.sum(0), rtol=1e-14)
        np.testing.assert_allclose(r["async"], v.sum(0), rtol=1e-14)
        np.testing.assert_array_equal(r["right"], v[(rank - 1) % n])  # from the left neighbour
        np.testing.assert_array_equal(r["left"], v[(rank + 1) % n])
        np.testing.assert_array_equal(r["gather"], v)
        # chunk `rank` of every sender, in sender order
        want = np.concatenate([np.arange(2 * rank, 2 * rank + 2) + 10.0 * s for s in range(n)])
        np.testing.assert_array_equal(r["to_all"], want)


def _jax_ledger(jx, name, data):
    """The JAX package's ledger of one Krylov path on the ledger operand:
    its solve program's jaxpr (`last_inner`; dist_cg_ell_halo keeps none,
    so its jitted program is caught as it is built)."""
    from jax.sharding import PartitionSpec

    import aoclsparse_tpu.parallel.cg as jcg
    from aoclsparse_tpu.planner.plan import _build_bwd, get_plan

    ptr, ind, val = cases.csr_of(data["A"])
    A = jx.ast.create_csr(512, 512, ptr, ind, val.astype(np.float32))
    form = _build_bwd(get_plan(A).effective_for(jx.ast.MatrixDescriptor(), jx.ast.Operation.none, A.dtype))
    b = data["b"].astype(np.float32)
    if name == "dist_spmv_bwd_halo":
        xs = jx.par.put(cases.padded(b, 8 * cases.NDEV), jx.mesh, PartitionSpec("x"))
        return jx.coll.collective_ledger(lambda x: jx.par.dist_spmv_bwd_halo(jx.mesh, form, x), xs)
    if name != "dist_cg_ell_halo":
        fn = getattr(jx.par, name)
        fn(jx.mesh, form, b, rtol=1e-4, maxit=50)
        inner, args = fn.last_inner
        return jx.coll.collective_ledger(inner, *args)
    Bp, Bi, Bv = cases.csr_of(data["B"])
    Bh = jx.ast.create_csr(128, 128, Bp, Bi, Bv.astype(np.float32))
    ef = get_plan(Bh).exec_form_for(jx.ast.MatrixDescriptor(), jx.ast.Operation.none, kind="ell")
    caught = {}
    real = jcg.jax

    class _Jax:
        def __getattr__(self, attr):
            return getattr(real, attr)

        def jit(self, f):
            jitted = real.jit(f)

            def call(*args):
                caught["prog"] = (jitted, args)
                return jitted(*args)

            return call

    jcg.jax = _Jax()
    try:
        jcg.dist_cg_ell_halo(jx.mesh, ef.ell_ind, ef.ell_val, np.ones(128, np.float32), rtol=1e-4, maxit=50)
    finally:
        jcg.jax = real
    prog, args = caught["prog"]
    return jx.coll.collective_ledger(prog, *args)


@pytest.mark.parametrize("name", KRYLOV + ("dist_spmv_bwd_halo",))
def test_ledger_matches_jax(world, jx, name):
    d, r, allr = case(world, "ledger")
    want = jx.coll.ledger_summary(_jax_ledger(jx, name, d))
    for rr in allr:
        got = rr[name]
        assert got["per_iteration"] == want["per_iteration"], (got, want)
        assert got["one_time"] == want["one_time"], (got, want)
        assert got["per_iteration_bytes"] == want["per_iteration_bytes"], (got, want)


def test_ledger_counts_of_record(world):
    """MULTICHIP_LEDGER.json's per-iteration counts; the pipelined CG's one
    all-reduce; halo payloads O(W), not O(n / ranks)."""
    _d, r, _ = case(world, "ledger")
    rec = json.loads((Path(__file__).resolve().parents[1] / "MULTICHIP_LEDGER.json").read_text())
    text = json.dumps(rec)
    assert "all_reduce" in text and "collective_permute" in text
    assert r["dist_cg_bwd_halo"]["per_iteration"] == {"collective_permute": 2, "all_reduce": 2}
    assert r["dist_cg_pipelined"]["per_iteration"] == {"all_reduce": 1, "collective_permute": 2}
    assert r["dist_cg_bwd_halo"]["per_iteration_bytes"] < -(-r["m"] // (8 * cases.NDEV)) * 8 * 4
    spmv = {**r["dist_spmv_bwd_halo"]["one_time"], **r["dist_spmv_bwd_halo"]["per_iteration"]}
    assert spmv.get("collective_permute", 0) == 2 and spmv.get("all_gather", 0) == 0


def test_predict_weak_scaling(jx):
    summary = {"per_iteration": {"all_reduce": 1, "collective_permute": 2}, "per_iteration_bytes": 4096}
    want = jx.coll.predict_weak_scaling(summary, 2e-4)
    got = coll.predict_weak_scaling(summary, 2e-4, link_bw=jx.coll.ICI_BW, link_lat=jx.coll.ICI_LAT)
    assert got["efficiency"] == want["efficiency"] and got["binding_term"] == want["binding_term"]
    assert (coll.NVLINK_BW, coll.NVLINK_LAT) != (jx.coll.ICI_BW, jx.coll.ICI_LAT)
    assert coll.NVLINK_BW == 450e9
    default = coll.predict_weak_scaling(summary, 2e-4)
    assert "4.5e+10" not in default["model"] and set(default["efficiency"]) == set(want["efficiency"])


def test_ledger_does_not_nest():
    with pytest.raises(RuntimeError):
        coll.collective_ledger(coll.collective_ledger, lambda: None)


@pytest.mark.cuda
def test_card_two_gloo_ranks_share_the_card(cuda):
    """Two gloo ranks on cuda:0 (a world started with no device), transfers
    staged through host memory: the halo SpMV and CG on kernel #4, launched
    on every rank; no result, nor a host-operand cg_ell_jit, on the CPU."""
    from aoclsparse_tpu_torch import native

    native.available()
    out = par.spawn_world(cases.card_halo, 2, 4096, backend="gloo")
    for r in out:
        np.testing.assert_allclose(r["y"], r["want"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["x"], np.ones(4096), atol=1e-3)
        assert r["launches"] > r["k"] > 0
        assert r["mesh_device"] == "cuda:0"
        assert all(dv.startswith("cuda") for dv in r["devices"]), r["devices"]
    assert out[0]["k"] == out[1]["k"]


@pytest.mark.cuda
def test_card_one_rank_nccl(cuda):
    from aoclsparse_tpu_torch import native

    native.available()
    (r,) = par.spawn_world(cases.card_halo, 1, 4096, backend="nccl", device=None)
    np.testing.assert_allclose(r["y"], r["want"], rtol=1e-4, atol=1e-4)
    assert r["launches"] > r["k"] > 0
    assert all(dv.startswith("cuda") for dv in r["devices"]), r["devices"]


def test_a_world_with_no_device_puts_its_blocks_on_the_card():
    """start_world/spawn_world name no device by default, so gloo ranks put
    their blocks on the port's device (cuda:0), as init_multiprocess does;
    CPU shards are asked for with device="cpu". Nothing here touches the
    card: the rank only reports its mesh's device."""
    assert par.spawn_world(cases.world_device, 1, backend="gloo", timeout_s=60) == ["cuda:0"]
    assert par.spawn_world(cases.world_device, 1, backend="gloo", device="cpu", timeout_s=60) == ["cpu"]
