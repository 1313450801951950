"""Handle checkpoints of the PyTorch port (io/checkpoint.py) against the JAX
package's (aoclsparse_tpu/io/checkpoint.py): the same npz keys, so a
checkpoint written by either package loads in the other, with its ILU0
factor, and the loaded handle's ilu_smoother gives the writer's result.
Also tests/test_checkpoint_misc.py:76's case, the level engine
(ilu_smoother kid=1) on a restored factor, and the handle's base, dtype and
device. Operands are made from a seed with numpy; the tolerance is
utils/tolerances.py's expected_precision(float64) on
max |a - b| / max(|b|, 1) (both packages run the same factor's solves, in
another order).
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.io import load_matrix, save_matrix
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

TOL = expected_precision(torch.float64)


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


def _operand(seed, m=300, density=0.03):
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, m)) < density) * rng.standard_normal((m, m))
    np.fill_diagonal(dense, 4.0 + rng.random(m))
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    return dense, ptr, np.nonzero(dense)[1].astype(np.int32), dense[dense != 0], rng.standard_normal(m)


def test_jax_checkpoint_loads_in_the_port(ast, tmp_path):
    from aoclsparse_tpu.io.checkpoint import save_matrix as jsave

    dense, ptr, ind, val, b = _operand(1)
    m = dense.shape[0]
    J = ast.create_csr(m, m, ptr, ind, val)
    ast.ilu0_factorize(J)
    want = np.asarray(ast.ilu_smoother(J, None, b))
    jsave(str(tmp_path / "j.npz"), J)
    T = load_matrix(tmp_path / "j.npz", device="cpu")
    assert T.ilu_state is not None and T.ilu_state.l_form is not None
    assert near_error(tt.ilu_smoother(T, None, b).numpy(), want) <= TOL
    x = np.random.default_rng(2).standard_normal(m)
    assert near_error(tt.mv(1.0, T, tt.MatrixDescriptor(), tt.Operation.none, x, 0.0).numpy(), dense @ x) <= TOL


def test_port_checkpoint_loads_in_the_jax_package(ast, tmp_path):
    from aoclsparse_tpu.io.checkpoint import load_matrix as jload

    dense, ptr, ind, val, b = _operand(3)
    m = dense.shape[0]
    T = tt.create_csr(m, m, ptr + 1, ind + 1, val, base=tt.IndexBase.one, device="cpu")
    tt.ilu0_factorize(T)
    want = tt.ilu_smoother(T, None, b).numpy()
    save_matrix(tmp_path / "t.npz", T)
    J = jload(str(tmp_path / "t.npz"))
    assert int(J.base) == 1
    assert near_error(np.asarray(ast.ilu_smoother(J, None, b)), want) <= TOL
    T2 = load_matrix(tmp_path / "t.npz", device="cpu")
    assert T2.base == tt.IndexBase.one and T2.dtype == torch.float64
    assert torch.equal(tt.ilu_smoother(T2, None, b), tt.ilu_smoother(T, None, b))


def test_checkpoint_restored_ilu_level_engine(tmp_path):
    """ilu_smoother(kid=1) on a restored handle builds the level sweeps from
    the restored factor (tests/test_checkpoint_misc.py:76)."""
    dense, ptr, ind, val, b = _operand(5, m=48, density=0.1)
    A = tt.create_csr(48, 48, ptr, ind, val, device="cpu")
    tt.ilu0_factorize(A)
    save_matrix(tmp_path / "ck.npz", A)
    B = load_matrix(tmp_path / "ck.npz", device="cpu")
    x0 = tt.ilu_smoother(A, None, b, kid=1).numpy()
    x1 = tt.ilu_smoother(B, None, b, kid=1).numpy()
    assert near_error(x1, x0) <= TOL


def test_bf16_handle_and_no_factor(tmp_path):
    """A bf16 handle keeps its dtype (its values travel widened to f32);
    a handle without a factor loads without one; a wrong version refuses."""
    dense, ptr, ind, val, _b = _operand(7)
    m = dense.shape[0]
    A = tt.create_csr(m, m, ptr, ind, torch.from_numpy(val).to(torch.bfloat16), device="cpu")
    save_matrix(tmp_path / "b.npz", A)
    B = load_matrix(tmp_path / "b.npz", device="cpu")
    assert B.dtype == torch.bfloat16 and B.ilu_state is None
    assert torch.equal(B.data.val, A.data.val)
    z = dict(np.load(tmp_path / "b.npz"))
    z["format_version"] = np.int64(2)
    np.savez(tmp_path / "v2.npz", **z)
    with pytest.raises(tt.AoclSparseError) as e:
        load_matrix(tmp_path / "v2.npz", device="cpu")
    assert e.value.status == tt.Status.invalid_value
