"""utils/profiling.py of the PyTorch port against the JAX package's: the
reference's FLOP/byte formulas over a grid of sizes (exact equality: the
same integer arithmetic), roofline against a stubbed context, chained
timing on a CPU tensor, the Chrome trace of torch.profiler, and Welch's t
statistic (to float64 rounding)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from aoclsparse_tpu_torch import AoclSparseError, Status
from aoclsparse_tpu_torch.core.context import Context
from aoclsparse_tpu_torch.utils import profiling as prof


@pytest.fixture(scope="module")
def jprof():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.utils import profiling

    return profiling


SIZES = [(0, 0, 0), (1, 1, 1), (10, 12, 100), (262144, 262144, 16777216), (1000005, 1000005, 3085975)]


@pytest.mark.parametrize("m,n,nnz", SIZES)
@pytest.mark.parametrize("beta", [False, True])
@pytest.mark.parametrize("val_size,idx_size", [(4, 4), (8, 4), (2, 8), (16, 8)])
def test_byte_formulas_equal_jax(jprof, m, n, nnz, beta, val_size, idx_size):
    assert prof.spmv_bytes(m, n, nnz, val_size, idx_size, beta) == jprof.spmv_bytes(m, n, nnz, val_size, idx_size,
                                                                                   beta)
    assert prof.ilu0_bytes(m, nnz, val_size, idx_size) == jprof.ilu0_bytes(m, nnz, val_size, idx_size)


@pytest.mark.parametrize("m,n,nnz", SIZES)
@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("k", [1, 16, 64])
def test_flop_formulas_equal_jax(jprof, m, n, nnz, flag, k):
    assert prof.spmv_flops(nnz, m, flag) == jprof.spmv_flops(nnz, m, flag)
    assert prof.trsv_flops(nnz, m, flag) == jprof.trsv_flops(nnz, m, flag)
    assert prof.csrmm_flops(nnz, k, n, flag) == jprof.csrmm_flops(nnz, k, n, flag)
    assert prof.spgemm_flops(nnz * k) == jprof.spgemm_flops(nnz * k)


def test_formula_values():
    assert prof.spmv_flops(100) == 200
    assert prof.spmv_flops(100, 10, True) == 220
    assert prof.trsv_flops(100, 10) == 190
    assert prof.trsv_flops(100, 10, unit_diag=True) == 200
    assert prof.csrmm_flops(50, 4) == 400
    assert prof.spmv_bytes(10, 10, 100, 8) == (11 + 100) * 4 + 110 * 8 + 80


def _ctx(hbm):
    return Context("cuda", "NVIDIA H100 80GB HBM3", (9, 0), hbm, None)


@pytest.mark.parametrize("frac", [1.0, 0.8])
def test_roofline_against_stubbed_context(jprof, monkeypatch, frac):
    monkeypatch.setattr(prof, "get_context", lambda: _ctx(3350.0))
    r = prof.roofline(bytes_moved=134.2e6, seconds=0.05e-3, frac=frac)
    assert r["achieved_gbps"] == pytest.approx(2684.0)
    assert r["peak_gbps"] == 3350.0
    assert r["fraction_of_peak"] == pytest.approx(2684.0 / 3350.0)
    assert r["fraction_of_target"] == pytest.approx(2684.0 / (3350.0 * frac))
    # the JAX package's roofline on a context of the same peak gives the same keys and values
    monkeypatch.setattr(jprof, "get_context", lambda: SimpleNamespace(hbm_gbps=3350.0))
    assert jprof.roofline(bytes_moved=134.2e6, seconds=0.05e-3, frac=frac) == pytest.approx(r)


def test_roofline_raises_without_a_peak(monkeypatch):
    monkeypatch.setattr(prof, "get_context", lambda: _ctx(None))
    with pytest.raises(AoclSparseError) as e:
        prof.roofline(1e9, 1.0)
    assert e.value.status == Status.invalid_value


def test_chain_bench_on_cpu_tensor():
    x = torch.ones(1024)
    calls = []

    def run():
        calls.append(1)
        return x * 2

    res = prof.chain_bench(run, name="double", iters=10, chunks=2)
    assert len(calls) == 1 + 10
    assert res.name == "double" and res.iters == 10 and len(res.times) == 2
    assert 0 < res.t_min <= res.t_median and res.t_mean > 0
    assert res.gflops(2e9) == pytest.approx(2.0 / res.t_median)
    assert res.gbytes(1e9) == pytest.approx(1.0 / res.t_median)
    assert prof.chain_bench(lambda: (x + 1, 3), iters=3, chunks=5).iters == 5


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path / "t")):
        torch.ones(256).cumsum(0)
    doc = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert doc["traceEvents"]
    with prof.trace(None):
        pass


@pytest.mark.parametrize("a,b", [([1.0, 1.1, 0.9], [2.0, 2.1, 1.9]), ([5.0, 5.0, 5.0], [5.0, 5.0]),
                                 (list(np.linspace(0, 1, 17)), list(np.linspace(0.2, 1.5, 9)))])
def test_two_sample_t_equals_jax(jprof, a, b):
    got = prof.two_sample_t(a, b)
    want = jprof.two_sample_t(a, b)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-12)


def test_two_sample_t_sign():
    st = prof.two_sample_t([1.0, 1.1, 0.9], [2.0, 2.1, 1.9])
    assert st["t"] < 0 and st["mean_b"] > st["mean_a"]
