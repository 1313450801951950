"""CG in permuted space and `mv_operator` on a gen operand, PyTorch port
against the JAX package.

`pcg_solve(precond=None)` on a matrix planned as `gen` (band layout)
permutes b once, iterates with the permutation-free composite and permutes
x back once (solvers/fused.py `_gen_pspace`), as the JAX package does on its
TPU. On the CPU the JAX planner does not pick `gen` by itself, so its side
runs the same loop on its `gen` form directly (its `_gen_pspace` and
`_build_cg_run`, as its pcg_solve composes them) under
AOCLSPARSE_TPU_FORCE_PALLAS=1 (its Pallas band layout, interpret mode). Operands are the circuit-like profile of tests/test_gen_form.py
symmetrised with a Gershgorin diagonal shift, made from a seed with numpy.

Tolerances: the iteration counts agree within 2 (the two packages sum in
another order, f32); each solution's true relative residual, in float64
with scipy, is within 10 rtol (the recursive residual of f32 CG drifts from
the true one by O(eps_f32 cond(A)), cond <= 2R + 1 for the shift). The
operator's round trip is exact (a permutation); its products hold
utils/tolerances.py's f32 model against mv.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
N = tt.Operation.none
F32 = expected_precision(torch.float32)
tmv = importlib.import_module("aoclsparse_tpu_torch.ops.level2.mv")


@pytest.fixture
def jax_pallas(monkeypatch):
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu
    from aoclsparse_tpu.core.context import reset_context

    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_PALLAS", "1")
    reset_context()
    yield aoclsparse_tpu
    monkeypatch.delenv("AOCLSPARSE_TPU_FORCE_PALLAS")
    reset_context()


def _spd(seed, m=1024, scatter=200):
    """Circuit-like (local band + hub columns + scatter), symmetrised, with a
    Gershgorin shift: a scipy CSR in float32."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-10, 11, 6), 0, m - 1))
        d[i, js] = rng.standard_normal(js.size)
    for h in rng.choice(m, 5, replace=False):
        rs = rng.choice(m, m // 3, replace=False)
        d[rs, h] = rng.standard_normal(rs.size)
    d[rng.integers(0, m, scatter), rng.integers(0, m, scatter)] = rng.standard_normal(scatter)
    d = 0.5 * (d + d.T)
    d[np.arange(m), np.arange(m)] = np.abs(d).sum(1) + 1.0
    S = sp.csr_matrix(d.astype(np.float32))
    S.sort_indices()
    return S


def _handle(S):
    m = S.shape[0]
    return tt.create_csr(m, m, S.indptr, S.indices, S.data, device="cpu")


def _jax_pspace(ast, S):
    """(matvec_p, to_p, from_p) of the JAX package's gen form of S."""
    from aoclsparse_tpu.planner.plan import get_plan
    from aoclsparse_tpu.solvers.fused import _gen_pspace

    m = S.shape[0]
    J = ast.create_csr(m, m, S.indptr, S.indices, S.data)
    form = get_plan(J).exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="gen")
    form.precision_mode = "full"
    assert form.gen_bandt
    return _gen_pspace(form)


def _jax_pcg(ast, S, b, x0, rtol, maxit):
    """The JAX package's permuted-space CG (solvers/fused.py:407-416)."""
    import jax
    import jax.numpy as jnp

    from aoclsparse_tpu.solvers.fused import _build_cg_run

    matvec_p, to_p, from_p = _jax_pspace(ast, S)
    run = jax.jit(_build_cg_run(matvec_p, None, maxit))
    xp, k, rnorm = run(to_p(jnp.asarray(b)), to_p(jnp.asarray(x0)), jnp.float32(rtol), jnp.float32(0.0))
    return np.asarray(from_p(xp)), int(k), float(rnorm)


def _true_res(S, x, b):
    return float(np.linalg.norm(S.astype(np.float64) @ x.astype(np.float64) - b) / np.linalg.norm(b))


@pytest.mark.parametrize("route", [False, True])
def test_pcg_permuted_space_matches_jax(jax_pallas, monkeypatch, route):
    """route: the spill rides select, route and accumulate (plain versions)
    on both sides."""
    if route:
        monkeypatch.setattr(tmv, "SPILL_ROUTE_DEVICES", ("cuda", "cpu"))
        monkeypatch.setattr(tmv, "SPILL_ROUTE_MIN", 0)
        monkeypatch.setenv("AOCLSPARSE_TPU_SPILL_ROUTE", "1")
    S = _spd(1, scatter=600 if route else 200)
    m = S.shape[0]
    T = _handle(S)
    form = tt.optimize(T).exec_form_for(GEN, N)
    assert form.kind == "gen" and form.gen_bandt and form.has_spill
    b = np.random.default_rng(2).standard_normal(m).astype(np.float32)
    rtol = 1e-5
    xt, kt, rt = tt.pcg_solve(T, torch.from_numpy(b), rtol=rtol, maxit=300)
    zeros = np.zeros(m, np.float32)
    xj, kj, rj = _jax_pcg(jax_pallas, S, b, zeros, rtol, 300)
    assert (form._spill_route is not None) == route
    assert abs(kt - kj) <= 2, (kt, kj)
    assert rt <= rtol * np.linalg.norm(b) * 1.0001
    assert _true_res(S, xt.numpy(), b) <= 10 * rtol
    assert _true_res(S, np.asarray(xj), b) <= 10 * rtol
    # x0 and maxit reach the permuted loop too
    x0 = np.random.default_rng(3).standard_normal(m).astype(np.float32)
    xt5, kt5, _ = tt.pcg_solve(T, torch.from_numpy(b), x0=torch.from_numpy(x0), rtol=0.0, maxit=5)
    xj5, kj5, _ = _jax_pcg(jax_pallas, S, b, x0, 0.0, 5)
    assert kt5 == kj5 == 5
    assert near_error(xt5.numpy(), np.asarray(xj5)) <= 1e-3  # 5 f32 iterations apart


def test_pcg_permuted_space_follows_update_values():
    S = _spd(4)
    T = _handle(S)
    b = np.random.default_rng(5).standard_normal(S.shape[0]).astype(np.float32)
    x1, _, _ = tt.pcg_solve(T, torch.from_numpy(b), rtol=1e-6, maxit=300)
    tt.update_values(T, 2.0 * S.data)
    x2, _, _ = tt.pcg_solve(T, torch.from_numpy(b), rtol=1e-6, maxit=300)
    assert T.plan.exec_form_for(GEN, N).kind == "gen"
    assert _true_res(2.0 * S, x2.numpy(), b) <= 1e-5
    assert near_error(x2.numpy(), 0.5 * x1.numpy()) <= 1e-4


def test_mv_operator_round_trip(jax_pallas):
    S = _spd(6)
    m = S.shape[0]
    T = _handle(S)
    op = tt.mv_operator(T)
    jmv, jto, jfrom = _jax_pspace(jax_pallas, S)
    assert op.space == "permuted"
    x = np.random.default_rng(7).standard_normal(m).astype(np.float32)
    xt = torch.from_numpy(x)
    xp = op.to_space(xt)
    assert xp.shape[0] == T.plan.exec_form_for(GEN, N).gen_m_pad
    np.testing.assert_array_equal(op.from_space(xp).numpy(), x)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jto(x)))
    # three chained products in permuted space against three mv calls
    v, vp, vj = xt, xp, jto(x)
    for _ in range(3):
        v = tt.mv(1.0, T, GEN, N, v, 0.0) / 10.0
        vp = op(vp) / 10.0
        vj = jmv(vj) / 10.0
    assert near_error(op.from_space(vp).numpy(), v.numpy()) <= F32
    assert near_error(op.from_space(vp).numpy(), np.asarray(jfrom(vj))) <= F32


def test_mv_operator_original_space_on_band_operand():
    """Other forms iterate in the original space: apply is the mv core."""
    m = 600
    rows = np.repeat(np.arange(m), 5)
    cols = np.clip(rows + np.tile(np.arange(-2, 3), m), 0, m - 1)
    S = sp.csr_matrix((np.random.default_rng(8).standard_normal(rows.size).astype(np.float32), (rows, cols)),
                      shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    T = _handle(S)
    op = tt.mv_operator(T)
    assert op.space == "original"
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(m).astype(np.float32))
    assert torch.equal(op.to_space(x), x)
    assert near_error(op(x).numpy(), S.astype(np.float64) @ x.double().numpy()) <= F32
    with pytest.raises(tt.AoclSparseError) as e:
        tt.mv_operator(None)
    assert e.value.status == tt.Status.invalid_pointer
