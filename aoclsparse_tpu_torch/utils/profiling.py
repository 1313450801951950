"""Tracing, timing and roofline accounting; the PyTorch counterpart of
``aoclsparse_tpu/utils/profiling.py``.

The reference has no in-library tracing: timing lives in its bench harness
(aoclsparse_clock, testing_csrmv.hpp:79-92) with FLOP/byte formulas
(aoclsparse_flops.hpp / aoclsparse_gbyte.hpp) and a two-sample t-test
(tools/twosampletest.py). This module gives the same: the reference's
per-op FLOP/byte counts, roofline accounting against the card's published
HBM peak (`core.context`), chained timing, a ``torch.profiler`` trace
written as a Chrome trace, and Welch's t statistic.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.context import get_context
from ..core.types import AoclSparseError, Status

__all__ = [
    "spmv_flops",
    "spmv_bytes",
    "trsv_flops",
    "csrmm_flops",
    "spgemm_flops",
    "ilu0_bytes",
    "roofline",
    "BenchResult",
    "chain_bench",
    "trace",
    "two_sample_t",
]


# -- FLOP / byte formulas (aoclsparse_flops.hpp:40-..., aoclsparse_gbyte.hpp) --


def spmv_flops(nnz: int, m: int = 0, beta_nonzero: bool = False) -> float:
    """2*nnz (+2m if beta) — spmv_gflop_count (aoclsparse_flops.hpp:40-44)."""
    return 2.0 * nnz + (2.0 * m if beta_nonzero else 0.0)


def spmv_bytes(m: int, n: int, nnz: int, val_size: int, idx_size: int = 4, beta_nonzero=False):
    """csrmv_gbyte_count (aoclsparse_gbyte.hpp:41-47)."""
    reads = (m + 1 + nnz) * idx_size + (nnz + n + m * (1 if beta_nonzero else 0)) * val_size
    writes = m * val_size
    return reads + writes


def trsv_flops(nnz: int, m: int, unit_diag: bool = False) -> float:
    """2*nnz - m non-unit (aoclsparse_flops.hpp:46-55)."""
    return 2.0 * nnz - (0 if unit_diag else m)


def csrmm_flops(nnz_a: int, k: int, nnz_c: int = 0, beta_nonzero: bool = False) -> float:
    """csrmm_gflop_count (aoclsparse_flops.hpp:64-73)."""
    return 2.0 * nnz_a * k + (2.0 * nnz_c if beta_nonzero else 0.0)


def spgemm_flops(visited_products: int) -> float:
    """csr2m_gflop_count: 2 * visited products (aoclsparse_flops.hpp:74-...)."""
    return 2.0 * visited_products


def ilu0_bytes(m: int, nnz: int, val_size: int, idx_size: int = 4) -> float:
    """csrilu0_gbyte_count (aoclsparse_gbyte.hpp:121-...)."""
    return (m + 1 + nnz) * idx_size + 2.0 * nnz * val_size


def roofline(bytes_moved: float, seconds: float, frac: float = 1.0) -> Dict[str, float]:
    """Achieved vs the card's published peak HBM bandwidth. Raises
    AoclSparseError (invalid_value) where the context knows no peak (on the
    CPU, or a card not in core/context.py's table)."""
    ctx = get_context()
    if not ctx.hbm_gbps:
        raise AoclSparseError(Status.invalid_value, f"no published HBM peak for {ctx.device_kind}")
    achieved = bytes_moved / seconds / 1e9
    peak = ctx.hbm_gbps * frac
    return {
        "achieved_gbps": achieved,
        "peak_gbps": ctx.hbm_gbps,
        "fraction_of_peak": achieved / ctx.hbm_gbps,
        "fraction_of_target": achieved / peak if peak else math.inf,
    }


# -- timing -------------------------------------------------------------------


@dataclasses.dataclass
class BenchResult:
    name: str
    iters: int
    t_mean: float
    t_median: float
    t_min: float
    times: List[float]

    def gflops(self, flops: float) -> float:
        return flops / self.t_median / 1e9

    def gbytes(self, nbytes: float) -> float:
        return nbytes / self.t_median / 1e9


def _wait(y) -> None:
    """Wait for the device work behind y: one synchronise on a card; a CPU
    tensor is ready when the call returns."""
    for t in y if isinstance(y, (tuple, list)) else (y,):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


def chain_bench(run, name: str = "op", iters: int = 50, chunks: int = 5) -> BenchResult:
    """Time `run()` with back-to-back calls and one synchronise per chunk,
    on the host clock, after one warm-up call; seconds per call."""
    y = run()
    _wait(y)
    per_chunk = max(1, iters // chunks)
    times = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        for _ in range(per_chunk):
            y = run()
        _wait(y)
        times.append((time.perf_counter() - t0) / per_chunk)
    return BenchResult(
        name=name,
        iters=per_chunk * chunks,
        t_mean=float(np.mean(times)),
        t_median=float(np.median(times)),
        t_min=float(np.min(times)),
        times=times,
    )


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` capture of the block (host and, where there is a
    card, device activity), written to `logdir`/trace.json as a Chrome
    trace; no capture when logdir is None."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def two_sample_t(a, b) -> Dict[str, float]:
    """Welch's two-sample t statistic for comparing two timing runs
    (tools/twosampletest.py / aoclsparse_stats.cpp analog)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    na, nb = a.size, b.size
    va, vb = a.var(ddof=1), b.var(ddof=1)
    se = math.sqrt(va / na + vb / nb)
    t = (a.mean() - b.mean()) / se if se else 0.0
    # Welch-Satterthwaite dof
    dof = (
        (va / na + vb / nb) ** 2 / ((va / na) ** 2 / (na - 1) + (vb / nb) ** 2 / (nb - 1))
        if se
        else na + nb - 2
    )
    return {"t": float(t), "dof": float(dof), "mean_a": float(a.mean()), "mean_b": float(b.mean())}
