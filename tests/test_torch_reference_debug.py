"""The port's numpy oracles (utils/reference.py), its debug modes
(utils/debug.py) and its public surface.

The oracles are the port's own copy of the JAX package's
utils/reference.py: on seeded inputs both give the same arrays (the same
numpy arithmetic, so equal to the last bit). The NaN/Inf trap raises
FloatingPointError naming the op in each entry point while it is on, and
leaves the non-finite result alone outside it; deterministic_mode sets and
restores torch's switch and the cuBLAS workspace variable. The top level
exports every public name of the JAX package's.
"""

import ast as pyast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.utils import debug
from aoclsparse_tpu_torch.utils import reference as tref

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
REPO = Path(__file__).resolve().parent.parent


def _sq(seed, m=24, density=0.3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, m)) < density) * rng.standard_normal((m, m))
    np.fill_diagonal(dense, 3.0 + rng.random(m))
    dense = dense.astype(dtype)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    return dense, ptr, np.nonzero(dense)[1].astype(np.int64), dense[dense != 0]


DESCRS = [
    dict(type=tt.MatrixType.general),
    dict(type=tt.MatrixType.symmetric, fill_mode=tt.FillMode.upper),
    dict(type=tt.MatrixType.hermitian, fill_mode=tt.FillMode.lower),
    dict(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower, diag_type=tt.DiagType.unit),
    dict(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.upper, diag_type=tt.DiagType.zero),
]


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    from aoclsparse_tpu.core.descr import MatrixDescriptor as JD
    from aoclsparse_tpu.utils import reference

    return reference, JD


@pytest.mark.parametrize("d", range(len(DESCRS)))
@pytest.mark.parametrize("op", [tt.Operation.none, tt.Operation.transpose, tt.Operation.conjugate_transpose])
def test_oracles_match_the_jax_packages(jref, d, op):
    ref, JD = jref
    dense, ptr, ind, val = _sq(d, dtype=np.complex128)
    val = val + 1j * np.random.default_rng(d).standard_normal(val.size)
    m = dense.shape[0]
    td, jd = tt.MatrixDescriptor(**DESCRS[d]), JD(**{k: int(v) for k, v in DESCRS[d].items()})
    rng = np.random.default_rng(100 + d)
    x, y, B, C = rng.standard_normal(m), rng.standard_normal(m), rng.standard_normal((m, 3)), rng.standard_normal((m, 3))
    assert np.array_equal(tref.csr_to_dense(m, m, ptr, ind, val), ref.csr_to_dense(m, m, ptr, ind, val))
    assert np.array_equal(tref.effective_dense(m, m, ptr, ind, val, td), ref.effective_dense(m, m, ptr, ind, val, jd))
    assert np.array_equal(tref.ref_mv(2.0, m, m, ptr, ind, val, td, op, x, 0.5, y),
                          ref.ref_mv(2.0, m, m, ptr, ind, val, jd, int(op), x, 0.5, y))
    assert np.array_equal(tref.ref_mm(2.0, m, m, ptr, ind, val, td, op, B, 0.5, C),
                          ref.ref_mm(2.0, m, m, ptr, ind, val, jd, int(op), B, 0.5, C))
    if DESCRS[d]["type"] == tt.MatrixType.triangular and DESCRS[d]["diag_type"] != tt.DiagType.zero:
        assert np.array_equal(tref.ref_trsv(1.5, m, ptr, ind, val, td, op, x),
                              ref.ref_trsv(1.5, m, ptr, ind, val, jd, int(op), x))
    assert np.array_equal(tref.ref_add(2.0, m, m, ptr, ind, val, op, ptr, ind, val),
                          ref.ref_add(2.0, m, m, ptr, ind, val, int(op), ptr, ind, val))
    assert np.array_equal(tref.ref_spgemm_dense(op, m, m, ptr, ind, val, NONE, m, m, ptr, ind, val),
                          ref.ref_spgemm_dense(int(op), m, m, ptr, ind, val, 111, m, m, ptr, ind, val))


def test_solver_oracles_match_the_jax_packages(jref):
    ref, _JD = jref
    dense, ptr, ind, val = _sq(7)
    m = dense.shape[0]
    b, x0 = np.random.default_rng(8).standard_normal(m), np.zeros(m)
    lu_t, dp_t = tref.ref_ilu0(m, ptr, ind, val)
    lu_j, dp_j = ref.ref_ilu0(m, ptr, ind, val)
    assert np.array_equal(lu_t, lu_j) and np.array_equal(dp_t, dp_j)
    assert np.array_equal(tref.ref_sor(1.2, m, ptr, ind, val, x0, b, 2), ref.ref_sor(1.2, m, ptr, ind, val, x0, b, 2))
    assert np.array_equal(tref.ref_symgs(m, ptr, ind, val, x0, b, 2), ref.ref_symgs(m, ptr, ind, val, x0, b, 2))
    # and the port's own ILU0 and SymGS against them
    A = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    st = tt.ilu0_factorize(A)
    assert np.allclose(st.lu.numpy(), lu_t, rtol=1e-12, atol=1e-12)
    xs = tt.symgs(NONE, A, GEN, 1.0, b)
    assert np.allclose(xs.numpy(), tref.ref_symgs(m, ptr, ind, val, x0, b), rtol=1e-10, atol=1e-12)


def _operands():
    dense, ptr, ind, val = _sq(9, m=64)
    A = tt.create_csr(64, 64, ptr, ind, val, device="cpu")
    bad = np.ones(64)
    bad[5] = np.inf
    return A, torch.from_numpy(bad)


TRI = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
CALLS = {
    "mv": lambda A, v: tt.mv(1.0, A, GEN, NONE, v, 0.0),
    "mm": lambda A, v: tt.mm(1.0, A, GEN, NONE, torch.stack([v, v], 1), 0.0),
    "trsv": lambda A, v: tt.trsv(1.0, A, TRI, NONE, v),
    "trsm": lambda A, v: tt.trsm(1.0, A, TRI, NONE, torch.stack([v, v], 1)),
    "ilu_smoother": lambda A, v: tt.ilu_smoother(A, None, v),
    "symgs": lambda A, v: tt.symgs(NONE, A, GEN, 1.0, v),
    "sorv": lambda A, v: tt.sorv(tt.SorType.forward, GEN, A, 1.0, 1.0, torch.zeros(64, dtype=v.dtype), v),
    "CG iteration": lambda A, v: tt.pcg_solve(A, v, maxit=3),
    "GMRES iteration": lambda A, v: tt.pgmres_solve(A, v, maxit=3),
}


@pytest.mark.parametrize("op", list(CALLS))
def test_nan_checks_raise_in_each_entry_point(op):
    A, bad = _operands()
    with debug.nan_checks():
        with pytest.raises(FloatingPointError, match=op):
            CALLS[op](A, bad)
        CALLS[op](A, torch.ones(64, dtype=torch.float64))  # finite: no raise
    out = CALLS[op](A, bad)  # outside the context the non-finite result comes back
    if isinstance(out, torch.Tensor):
        assert not torch.isfinite(out).all()


def test_nan_checks_global_switch_and_finalize():
    A, bad = _operands()
    debug.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError, match="mv"):
            tt.mv(1.0, A, GEN, NONE, bad, 0.0)
        A.data.val[3] = np.nan
        tt.update_values(A, A.data.val.clone())
        C = tt.sp2m(NONE, GEN, A, NONE, GEN, A, request=tt.Request.nnz_count)
        with pytest.raises(FloatingPointError, match="sp2m finalize"):
            tt.sp2m(NONE, GEN, A, NONE, GEN, A, request=tt.Request.finalize, C=C)
    finally:
        debug.enable_nan_checks(False)
    assert not torch.isfinite(tt.mv(1.0, A, GEN, NONE, bad, 0.0)).all()


def test_deterministic_mode_sets_and_restores(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = torch.are_deterministic_algorithms_enabled()
    with debug.deterministic_mode():
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == debug.CUBLAS_DETERMINISTIC
        A, _bad = _operands()
        y1 = tt.mv(1.0, A, GEN, NONE, torch.ones(64, dtype=torch.float64), 0.0)
        assert torch.equal(y1, tt.mv(1.0, A, GEN, NONE, torch.ones(64, dtype=torch.float64), 0.0))
    assert torch.are_deterministic_algorithms_enabled() == before
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ


def test_top_level_exports_every_public_name_of_the_jax_package():
    """Read from the JAX package's source, so no JAX import is needed."""
    tree = pyast.parse((REPO / "aoclsparse_tpu" / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, pyast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, pyast.FunctionDef):
            names.add(node.name)
    assert len(names) >= 120
    assert sorted(n for n in names if not hasattr(tt, n)) == []
