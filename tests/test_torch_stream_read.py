"""The streaming-read probe of the PyTorch port against the JAX package's
`pallas_stream_read` (run in interpret mode) on (128, C) slabs made from a
seed with numpy, C off a multiple of the tile. The CUDA kernel is held
against the plain version and a float64 sum on the card (marked `cuda`,
skipped elsewhere).

Tolerance: utils/tolerances.py's model, expected_precision(float32) on
|a - b| / max(|b|, 1): both sides sum the same float32 values in float32,
in another order.
"""

import numpy as np
import pytest
import torch

from aoclsparse_tpu_torch import AoclSparseError, Status
from aoclsparse_tpu_torch.kernels.stream_read import stream_read, stream_read_plain
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

TOL = expected_precision(torch.float32)


@pytest.fixture(scope="module")
def jax_pallas():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.kernels.pallas import spmv

    return spmv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def _slab(seed, R, C):
    return np.random.default_rng(seed).standard_normal((R, C)).astype(np.float32)


@pytest.mark.parametrize("C", [5000, 2048, 777, 1])
@pytest.mark.parametrize("TM", [512, 2048])
def test_plain_matches_pallas_stream_read(jax_pallas, C, TM):
    import jax.numpy as jnp

    v = _slab(C, 128, C)
    want = float(jax_pallas.pallas_stream_read(jnp.asarray(v), TM=TM, interpret=True))
    got = stream_read_plain(torch.from_numpy(v), TM=TM)
    assert got.dtype == torch.float32 and got.shape == ()
    assert near_error(got.numpy(), want) <= TOL
    assert near_error(got.numpy(), v.astype(np.float64).sum()) <= TOL


@pytest.mark.parametrize("shape", [(128, 5000), (3, 7, 11), (1000,), ()])
def test_stream_read_on_cpu_is_the_plain_sum(shape):
    v = torch.from_numpy(np.asarray(np.random.default_rng(1).standard_normal(shape), np.float32))
    got = stream_read(v)
    assert torch.equal(got, stream_read_plain(v))
    assert near_error(got.numpy(), v.double().sum().numpy()) <= TOL


def test_stream_read_rejects_bad_operands():
    with pytest.raises(AoclSparseError) as e:
        stream_read(torch.zeros(128, 10, dtype=torch.float64))
    assert e.value.status == Status.wrong_type
    with pytest.raises(AoclSparseError) as e:
        stream_read(torch.zeros(128, 10, dtype=torch.bfloat16))
    assert e.value.status == Status.wrong_type
    with pytest.raises(AoclSparseError) as e:
        stream_read(torch.zeros(10, 128).t())
    assert e.value.status == Status.invalid_value
    with pytest.raises(AoclSparseError) as e:
        stream_read(torch.zeros(10, device="meta"))
    assert e.value.status == Status.not_implemented


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 5000), (128, 262144), (32 * 1024 * 1024,), (7,), (128, 4097)])
def test_cuda_kernel_matches_plain(cuda, shape):
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32)).to(cuda)
    before = stream_read.launches["f32"]
    got = stream_read(v)
    again = stream_read(v)
    torch.cuda.synchronize()
    assert stream_read.launches["f32"] == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits
    assert near_error(got.cpu().numpy(), stream_read_plain(v).cpu().numpy()) <= TOL
    assert near_error(got.cpu().numpy(), v.double().sum().cpu().numpy()) <= TOL
