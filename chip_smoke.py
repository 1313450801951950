#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (aoclsparse_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and g++. It
imports nothing of JAX or of the JAX package. Phases, each raising on
failure (exit code != 0, no result line):

1. require a CUDA card; print nvidia-smi's name and power limit;
2. build the kernels from aoclsparse_tpu_torch/csrc with nvcc (sm_90a) and
   the host C++ library with g++; require that the latter loads;
3. hold each kernel instance against its plain PyTorch version:
   - the band kernel on the bench operand (m = n = 262144, 64 nnz/row,
     half-bandwidth 64, seed 7, built as bench.py:220-233) in f32, bf16
     band and f64, and on a small odd-m operand with a peel spill in f32
     and f64;
   - the band SpMM kernel on the bench operand's bandtm form at K = 64 in
     f32 and f64, and with its spill on the small odd-m operand at K = 7;
     the block-window kernel on the bench form at K = 64 in f32 and bf16;
   - the diagonal kernel on the 27-point stencil of HPCG's default local
     grid (104^3: m = 1,124,864, 29,791,000 nnz; hpcg.dat) at K = 64 in
     f32, bf16 and f64, and on a small odd-m operand with negative offsets;
   - the window-solve kernels on the ILU0 L and U forms of the SPD operand
     (the bench profile symmetrised plus a Gershgorin diagonal shift,
     25,296,970 nnz; nb = 256, WL = 64, nblk = 1024) in f32 and f64, with
     one right-hand side and with K = 16, and on a small odd-m form whose
     window reaches back over several blocks (K = 300 for the multi-RHS
     kernel: several column chunks);
   - the spill-route kernels (select, Benes route, accumulate) on the spill
     route of the webbase-1M stand-in's gen form (benchmarks/realmat.py,
     seed 7: m = 1,000,005, about 3.1M nnz; planned through its handle by
     optimize), on one stripe of the whole-matrix route of the scatter
     operand (m = 262,144, the diagonal plus 8 uniform random columns a
     row, seed 23), on a small ragged case and on a k = 7 route;
4. drive the main path: create_csr(device="cuda") -> set_mv_hint(nop=1000)
   -> optimize -> mv (default form, kid=8, kid=12, alpha/beta with y, the
   mixed bf16 band, a float64 handle); and create_csr -> set_mm_hint(nop=
   1000) -> optimize -> mm at K = 64 on the bench operand (default, kid=4,
   kid=5, kid=7, kid=0, alpha/beta with C, Order.column, op=transpose, the
   mixed mode through kid=5 and kid=7, a float64 handle) and on the
   stencil (default and kid=7, full and mixed), each checked against a
   float64 scipy CSR reference, with exactly one kernel launch per call;
5. solvers on the SPD operand, on a handle made by create_csr ->
   set_mv_hint / set_sv_hint / set_lu_smoother_hint / set_sm_hint ->
   optimize: pcg_solve(rtol=1e-6) with no preconditioner (one band launch
   per iteration); trsv lower non-unit in f32 and upper non-unit on a
   float64 handle, each checked by its f64 scipy residual; trsm at K = 16
   (lower f32, upper f64), checked per column; ilu_smoother with a 1-D and
   an (m, 16) b, checked by the residual of L (U x) = b with the port's own
   factors; and pcg_solve(precond="ilu0") and ("sgs"), each in fewer
   iterations than with none, with a true relative residual <= 1e-5 and
   the launch counts the composition implies;
5b. the general-structure path, counted on its own: mv on the webbase
   stand-in (default: gen with its spill on the route; kid=7; alpha/beta;
   the mixed bf16 band; mv_operator in permuted space; update_values and a
   re-run; a float64 handle, which the planner sends to the gather
   fallback), mv on the scatter operand (the whole-matrix route), each
   against a float64 scipy reference and with the launches each call
   implies; and pcg_solve with no preconditioner on the symmetrised
   webbase, in permuted space, to a true relative residual <= 10 rtol;
6. time kernel vs plain version vs one PyTorch library call (torch.sparse
   CSR products and triangular solves, index_add_ and a permutation
   gather, timed here as yardsticks only), against each kernel's bound
   from this run's inputs (stored operands, and beside it their nonzero
   entries only); one mv call, one mm call per operand, one trsm call,
   one CG iteration, one ilu_smoother call and one ILU0-PCG iteration with
   CUDA events or the host clock (median of repeats), with stream rates
   against the card's published HBM peak, and the set-up seconds of
   ilu0_factorize; the spill-route engine against the gather +
   index_add_ tail, the webbase band kernel alone, mv on the webbase and
   scatter operands with a profiler window each (device time by kernel,
   idle share), and one permuted-space CG iteration.

Launch counts are reset just before phase 4 and read after phase 5, and
reset again just before phase 5b and read after it (the kernels line takes
the spill-route kernels' counts from 5b). The second-to-last line is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import native
from aoclsparse_tpu_torch.kernels import build
from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv, band_spmv_plain, spmv_bandt
from aoclsparse_tpu_torch.kernels.benes import PASS_GROUP, TILE_LOG, benes_route, benes_route_plain
from aoclsparse_tpu_torch.kernels.route import apply_benes, apply_route, pack_masks, route_masks
from aoclsparse_tpu_torch.kernels.spill_route import oh_accum, oh_accum_plain, oh_select, oh_select_plain
from aoclsparse_tpu_torch.kernels.spmm_band import (
    spmm_band,
    spmm_band_mxu,
    spmm_band_mxu_plain,
    spmm_band_plain,
    spmm_bandtm,
)
from aoclsparse_tpu_torch.kernels.spmm_diag import spmm_diag, spmm_diag_plain
from aoclsparse_tpu_torch.kernels.trsv_win import trsm_chunk, trsm_win, trsm_win_plain, trsv_win, trsv_win_plain
from aoclsparse_tpu_torch.ops.level2.mv import _spill_route_on
from aoclsparse_tpu_torch.planner.spill_route import build_spill_route, spill_route_apply
from aoclsparse_tpu_torch.planner.triangular import trsv_form_for
from aoclsparse_tpu_torch.solvers.ilu import ilu0_factorize
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
LOWER = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
UPPER = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.upper)
#: kernel -> (source, the TPU kernel(s) it replaces as file:line)
KERNELS = {
    "band_spmv_f32": ("aoclsparse_tpu_torch/csrc/band_spmv.cu",
                      "aoclsparse_tpu/kernels/pallas/spmv.py:531"),  # pallas_spmv_band_t, KID 8
    "band_spmv_bf16": ("aoclsparse_tpu_torch/csrc/band_spmv.cu",
                       "aoclsparse_tpu/kernels/pallas/spmv.py:626"),  # pallas_spmv_band_v, KID 12
    "band_spmv_f64": ("aoclsparse_tpu_torch/csrc/band_spmv.cu",
                      "aoclsparse_tpu/kernels/pallas/spmv.py:899"),  # pallas_spmv_band_v_df, KID 13
    # pallas_trsv_win_inv8 and pallas_trsv_win_inv: one contract
    "trsv_win_f32": ("aoclsparse_tpu_torch/csrc/trsv_win.cu",
                     "aoclsparse_tpu/kernels/pallas/trsv.py:74, aoclsparse_tpu/kernels/pallas/trsv.py:114"),
    "trsv_win_f64": ("aoclsparse_tpu_torch/csrc/trsv_win.cu",
                     "aoclsparse_tpu/kernels/pallas/trsv.py:74, aoclsparse_tpu/kernels/pallas/trsv.py:114"),
    "spmm_band_f32": ("aoclsparse_tpu_torch/csrc/spmm_band.cu",
                      "aoclsparse_tpu/kernels/pallas/spmv.py:173"),  # pallas_spmm_band_t, mm KID 4
    "spmm_band_f64": ("aoclsparse_tpu_torch/csrc/spmm_band.cu",
                      "aoclsparse_tpu/kernels/pallas/spmv.py:173"),
    "spmm_band_mxu_f32": ("aoclsparse_tpu_torch/csrc/spmm_band.cu",
                          "aoclsparse_tpu/kernels/pallas/spmv.py:306"),  # pallas_spmm_band_mxu, KID 5
    "spmm_band_mxu_bf16": ("aoclsparse_tpu_torch/csrc/spmm_band.cu",
                           "aoclsparse_tpu/kernels/pallas/spmv.py:306"),
    "spmm_diag_f32": ("aoclsparse_tpu_torch/csrc/spmm_diag.cu",
                      "aoclsparse_tpu/kernels/pallas/spmv.py:446"),  # pallas_spmm_diag, mm KID 7
    "spmm_diag_bf16": ("aoclsparse_tpu_torch/csrc/spmm_diag.cu",
                       "aoclsparse_tpu/kernels/pallas/spmv.py:446"),
    "spmm_diag_f64": ("aoclsparse_tpu_torch/csrc/spmm_diag.cu",
                      "aoclsparse_tpu/kernels/pallas/spmv.py:446"),
    "trsm_win_f32": ("aoclsparse_tpu_torch/csrc/trsv_win.cu",
                     "aoclsparse_tpu/kernels/pallas/trsv.py:160"),  # pallas_trsm_win_inv
    "trsm_win_f64": ("aoclsparse_tpu_torch/csrc/trsv_win.cu",
                     "aoclsparse_tpu/kernels/pallas/trsv.py:160"),
    "oh_select_f32": ("aoclsparse_tpu_torch/csrc/spill_route.cu",
                      "aoclsparse_tpu/kernels/pallas/spill_route.py:66"),  # pallas_oh_select
    "oh_accum_f32": ("aoclsparse_tpu_torch/csrc/spill_route.cu",
                     "aoclsparse_tpu/kernels/pallas/spill_route.py:126"),  # pallas_oh_accum
    "benes_route_f32": ("aoclsparse_tpu_torch/csrc/benes.cu",
                        "aoclsparse_tpu/kernels/pallas/route_fused.py:73"),  # pallas_benes_apply
}
#: the kernels of the general-structure path (phase 5b), counted there
GEN_PATH = ("oh_select_f32", "oh_accum_f32", "benes_route_f32")
#: launch counters of the wrappers, by kernel-name prefix
COUNTERS = {
    "band_spmv": band_spmv.launches,
    "trsv_win": trsv_win.launches,
    "spmm_band": spmm_band.launches,
    "spmm_band_mxu": spmm_band_mxu.launches,
    "spmm_diag": spmm_diag.launches,
    "trsm_win": trsm_win.launches,
    "oh_select": oh_select.launches,
    "oh_accum": oh_accum.launches,
    "benes_route": benes_route.launches,
}
#: kernel vs plain: the same products summed in another order, so the
#: accumulation dtype's model tolerance (utils/tolerances.py, scale 1);
#: the bf16 instance accumulates in f32 over the same bf16 band values
KERNEL_TOL = {
    "band_spmv_f32": expected_precision(torch.float32),
    "band_spmv_bf16": expected_precision(torch.float32),
    "band_spmv_f64": expected_precision(torch.float64),
    "trsv_win_f32": expected_precision(torch.float32),
    "trsv_win_f64": expected_precision(torch.float64),
    "spmm_band_f32": expected_precision(torch.float32),
    "spmm_band_f64": expected_precision(torch.float64),
    "spmm_band_mxu_f32": expected_precision(torch.float32),
    "spmm_band_mxu_bf16": expected_precision(torch.float32),
    "spmm_diag_f32": expected_precision(torch.float32),
    "spmm_diag_bf16": expected_precision(torch.float32),
    "spmm_diag_f64": expected_precision(torch.float64),
    "trsm_win_f32": expected_precision(torch.float32),
    "trsm_win_f64": expected_precision(torch.float64),
    # one f32 multiply a slot on both sides: the f32 model is a loose cap
    "oh_select_f32": expected_precision(torch.float32),
    # the same contributions summed per row in another order (shared-memory
    # atomics, whose order changes from run to run)
    "oh_accum_f32": expected_precision(torch.float32),
    # a routing moves values and does no arithmetic: bit-equal
    "benes_route_f32": 0.0,
}
#: mv and mm against the float64 reference: the operand dtype's model tolerance
MV_TOL = {"f32": expected_precision(torch.float32), "f64": expected_precision(torch.float64)}
#: peak operation rates for bound_ms, by operand type (NVIDIA H100 SXM data
#: sheet, dense, no sparsity): f32 and f64 outside the tensor cores (the f32
#: kernels compute in full f32, no TF32), bf16 on the tensor cores: the
#: least time the card could take, whatever the kernel itself uses
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "f64": 34e12}
K_MM = 64  # the SpMM right-hand sides of phases 3, 4 and 6
K_SM = 16  # the trsm right-hand sides of phases 3, 5 and 6
SEED_B = 23  # B of the SpMM phases


def log(*a):
    print(*a, flush=True)


def bench_operand(m=262144, row_nnz=64, half_bw=64, seed=7):
    """The bench.py:220-233 operand: (ptr, ind, val f32, x f32)."""
    n = m
    rng = np.random.default_rng(seed)
    win = 2 * half_bw
    base = np.clip(np.arange(m) - half_bw, 0, n - win)
    pick = np.argsort(rng.random((m, win)), axis=1)[:, :row_nnz]
    cols = np.sort(base[:, None] + pick, axis=1)
    ptr = np.arange(m + 1, dtype=np.int64) * row_nnz
    val = rng.standard_normal(m * row_nnz).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return ptr, cols.reshape(-1).astype(np.int32), val, x


def spill_operand(m=4099, seed=11):
    """Odd-m band (half-width 12) plus a few far outliers, which the planner
    peels into a spill: (ptr, ind, val f64, x f64)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 25)
    cols = rows + np.tile(np.arange(-12, 13), m)
    keep = (cols >= 0) & (cols < m)
    rows, cols = rows[keep], cols[keep]
    far_r = rng.integers(0, m, 40)
    far_c = (far_r + rng.integers(200, 900, 40)) % m
    S = sp.csr_matrix(
        (rng.standard_normal(rows.size + 40), (np.r_[rows, far_r], np.r_[cols, far_c])),
        shape=(m, m),
    )
    S.sum_duplicates()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data, rng.standard_normal(m)


def reset_counts():
    for counts in COUNTERS.values():
        for k in counts:
            counts[k] = 0


def read_counts():
    return {f"{prefix}_{k}": v for prefix, counts in COUNTERS.items() for k, v in counts.items()}


def row_nnz(ptr):
    return np.diff(ptr).astype(np.float64)


def bandt_form(ptr, ind, val, dev, kind="bandt"):
    A = tt.create_csr(len(ptr) - 1, len(ptr) - 1, ptr, ind, val, device=dev)
    form = tt.optimize(A).exec_form_for(GEN, NONE, kind=kind)
    if form.kind != kind:
        raise AssertionError(f"operand planned as {form.kind}, want {kind}")
    return form


def plain_bandt(vt, x, form):
    """The full bandt dispatch with the plain band version."""
    y = band_spmv_plain(vt, x, form.bandt_start, form.bwd_padL)
    if form.has_spill:
        y.index_add_(0, form.sp_rows, (form.sp_val * x[form.sp_ind]).to(y.dtype))
    return y


def spd_operand(ptr, ind, val, m):
    """The bench profile symmetrised plus a Gershgorin diagonal shift (SPD):
    (scipy CSR with the f32-rounded values in f64, ptr, ind, val f32)."""
    S = sp.csr_matrix((val.astype(np.float64), ind, ptr), shape=(m, m))
    Ssym = ((S + S.T) * 0.5).tocsr()
    Ssym = (Ssym + sp.diags(np.asarray(abs(Ssym).sum(axis=1)).ravel() + 1.0)).tocsr()
    Ssym.sort_indices()
    sval32 = Ssym.data.astype(np.float32)
    Sspd = sp.csr_matrix((sval32.astype(np.float64), Ssym.indices, Ssym.indptr), shape=(m, m))
    return Sspd, Ssym.indptr.astype(np.int64), Ssym.indices.astype(np.int32), sval32


def wide_window_operand(m=3001, seed=13):
    """Odd-m lower band (half-width 48) plus entries reaching 200-300 rows
    back, so a form of nb = 64 carries a window over several blocks (and
    the band keeps it under the planner's density cap): (ptr, ind, val f64)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 49)
    cols = rows - np.tile(np.arange(49), m)
    keep = cols >= 0
    rows, cols = rows[keep], cols[keep]
    far_r = rng.integers(300, m, 60)
    far_c = far_r - rng.integers(200, 300, 60)
    vals = np.where(rows == cols, 4.0, 0.3 * rng.standard_normal(rows.size))
    S = sp.csr_matrix(
        (np.r_[vals, 0.1 * rng.standard_normal(60)], (np.r_[rows, far_r], np.r_[cols, far_c])),
        shape=(m, m),
    )
    S.sum_duplicates()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


def stencil27(nx=104):
    """The HPCG operand: the 27-point stencil of an nx^3 grid, 26 on the
    diagonal and -1 for each neighbour (HPCG's default local grid is 104^3,
    hpcg.dat), built row by row in sorted column order: (ptr, ind, val f32)."""
    m = nx**3
    i = np.arange(m, dtype=np.int64)
    z, y, x = i // (nx * nx), (i // nx) % nx, i % nx
    offs, masks = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                offs.append((dz * nx + dy) * nx + dx)
                masks.append((0 <= z + dz) & (z + dz < nx) & (0 <= y + dy) & (y + dy < nx)
                             & (0 <= x + dx) & (x + dx < nx))
    valid = np.stack(masks, axis=1)  # (m, 27), offsets increasing along axis 1
    cols = (i[:, None] + np.asarray(offs)[None, :])[valid]
    ptr = np.concatenate([[0], np.cumsum(valid.sum(1))])
    rows = np.repeat(i, valid.sum(1))
    return ptr, cols.astype(np.int32), np.where(cols == rows, 26.0, -1.0).astype(np.float32)


def diag_operand(m=3001, seed=19):
    """Odd-m operand of a few diagonals, negative offsets included, none
    through the middle of the rows: (ptr, ind, val f64)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in (-1500, -37, -3, 0, 2, 17, 900):
        i = np.arange(max(0, -off), min(m, m - off))
        rows.append(i)
        cols.append(i + off)
    r, c = np.concatenate(rows), np.concatenate(cols)
    S = sp.csr_matrix((rng.standard_normal(r.size), (r, c)), shape=(m, m))
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


def _dedupe_coo(r, c, m, n):
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    keep = np.concatenate([[True], (r[1:] != r[:-1]) | (c[1:] != c[:-1])])
    return r[keep], c[keep]


def _finish(r, c, m, n, rng, diag_boost, sym_vals):
    """COO -> CSR with dedupe, guaranteed full diagonal, optional symmetric
    values and diagonal dominance (benchmarks/realmat.py:46-73)."""
    r = np.asarray(r, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    mask = (r >= 0) & (r < m) & (c >= 0) & (c < n)
    r, c = r[mask], c[mask]
    d = np.arange(min(m, n), dtype=np.int64)
    r = np.concatenate([r, d])
    c = np.concatenate([c, d])
    r, c = _dedupe_coo(r, c, m, n)
    if sym_vals:
        lo = np.minimum(r, c)
        hi = np.maximum(r, c)
        key = lo * n + hi
        uq, inv = np.unique(key, return_inverse=True)
        vals_uq = rng.standard_normal(uq.size)
        val = vals_uq[inv]
    else:
        val = rng.standard_normal(r.size)
    if diag_boost:
        val[r == c] = np.abs(val[r == c]) + diag_boost
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(ptr, r + 1, 1)
    ptr = np.cumsum(ptr)
    return m, n, ptr, c.astype(np.int32), val.astype(np.float32)


def webbase_1m(rng, diag_boost=0.0):
    """The Williams/webbase-1M stand-in of benchmarks/realmat.py:179-215
    (copied with _dedupe_coo and _finish, so that this script imports nothing
    outside the port; a CPU test holds the copy equal for seed 7): n =
    1,000,005, power-law column (in-link) degrees over ~8000 hub pages,
    dense site-local links within +-128 and a uniform global tail:
    (m, n, ptr, ind, val f32)."""
    m = 1000005
    n_loc = int(1.40 * m)
    rows_l = rng.integers(0, m, n_loc)
    cols_l = np.clip(rows_l + rng.integers(-128, 129, n_loc), 0, m - 1)
    n_hub = int(0.55 * m)
    hub_ids = rng.zipf(1.55, n_hub)
    keep = hub_ids <= 8000
    hub_ids = hub_ids[keep] - 1
    hub_pages = rng.permutation(m)[:8000].astype(np.int64)
    half = hub_ids.size // 2
    rows_h1 = rng.integers(0, m, half)
    cols_h1 = hub_pages[hub_ids[:half]]
    ids2 = hub_ids[half:]
    uq, cnt = np.unique(ids2, return_counts=True)
    cnt = np.minimum(cnt, 4700)
    rows_h2 = np.repeat(hub_pages[uq], cnt)
    cols_h2 = rng.integers(0, m, rows_h2.size)
    rows_h = np.concatenate([rows_h1, rows_h2])
    cols_h = np.concatenate([cols_h1, cols_h2])
    n_rand = int(0.33 * m)
    rows_r = rng.integers(0, m, n_rand)
    cols_r = rng.integers(0, m, n_rand)
    r = np.concatenate([rows_l, rows_h, rows_r])
    c = np.concatenate([cols_l, cols_h, cols_r])
    return _finish(r, c, m, m, rng, diag_boost, sym_vals=False)


def scatter_operand(m=262144, per_row=8, seed=23):
    """The diagonal (4.0) plus `per_row` uniform random columns a row with
    standard normal values (duplicates summed): structure nothing can band,
    as in graph and random-structure matrices: (ptr, ind, val f32)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), per_row)
    cols = rng.integers(0, m, rows.size)
    vals = rng.standard_normal(rows.size)
    d = np.arange(m)
    S = sp.csr_matrix((np.r_[vals, np.full(m, 4.0)], (np.r_[rows, d], np.r_[cols, d])), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data.astype(np.float32)


def route_launches(sr):
    """Launches of the route kernel in one apply of SpillRoute `sr`
    (kernels/benes.py): per packed network of k_c stages, one shared-memory
    launch and 2 ceil((k_c - TILE_LOG) / PASS_GROUP) global passes; the outer
    stages of a k > 20 split in ceil(d / PASS_GROUP) passes on each side."""
    if sr.masks_packed is None:
        return 0
    nets = int(sr.masks_packed.shape[0])
    d = nets.bit_length() - 1
    per_net = 1 + 2 * -(-max(0, sr.k - d - TILE_LOG) // PASS_GROUP)
    return nets * per_net + 2 * -(-d // PASS_GROUP)


def route_desc(sr):
    nets = 0 if sr.masks_packed is None else int(sr.masks_packed.shape[0])
    outer = 0 if sr.masks is None else int(sr.masks.shape[0])
    return (f"k={sr.k} ({nets} packed network(s) of k={sr.k - max(nets, 1).bit_length() + 1}, "
            f"{outer} outer stage(s)), {sr.n_sel_tiles} select / {sr.acc_idx.shape[0]} accumulate chunks, "
            f"{route_launches(sr)} route launches an apply")


def csr_tensor(ptr, ind, val, dev, dtype):
    """torch.sparse CSR tensor of the operand: the library yardstick only."""
    m = len(ptr) - 1
    with warnings.catch_warnings():  # torch marks its sparse CSR support beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(np.asarray(ptr, np.int64)), torch.from_numpy(np.asarray(ind, np.int64)),
            torch.from_numpy(np.asarray(val)).to(dtype), size=(m, m),
        ).to(dev)


def bound_of(nbytes, flops, inst, peak_gbps):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over the HBM peak and the operations over the
    peak rate of the instance's arithmetic."""
    t_bytes = nbytes / (peak_gbps * 1e9) * 1e3
    t_ops = flops / PEAK_FLOPS[inst] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def nz_bytes(*tensors):
    """Bytes of the nonzero entries only: what the function needs of a
    stored form whose padding (band edges, the zero triangle of inverted
    blocks) holds zeros."""
    return sum(int(torch.count_nonzero(t)) * t.element_size() for t in tensors)


def library_ms(fn, once=False, **kw):
    """CUDA-event time of a PyTorch library call, or (None, error) when this
    install refuses it: a yardstick, never part of the port. once: the first
    call's own time, for calls that take seconds (no warm-up, no repeats)."""
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    if once:
        return t0.elapsed_time(t1), None
    return cuda_ms(fn, **kw), None


def compare(kernel, label, got, want, errs):
    torch.cuda.synchronize()
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    if not (np.all(np.isfinite(g)) and g.shape == w.shape):
        raise AssertionError(f"{kernel} {label}: non-finite or misshapen kernel output")
    rel = near_error(g, w)
    abs_err = float(np.max(np.abs(g - w))) if g.size else 0.0
    errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
    tol = KERNEL_TOL[kernel]
    log(f"  {kernel} {label}: max rel err {rel:.3e} (tol {tol:.3e}) max abs {abs_err:.3e}")
    if not rel <= tol:
        raise AssertionError(f"{kernel} {label}: kernel disagrees with its plain version")


def check_mv(name, got, ref, tol):
    g = got.double().cpu().numpy()
    if not (np.all(np.isfinite(g)) and g.shape == ref.shape):
        raise AssertionError(f"{name}: non-finite or misshapen mv output")
    err = near_error(g, ref)
    log(f"  {name}: max rel err vs f64 reference {err:.3e} (tol {tol:.3e})")
    if err > tol:
        raise AssertionError(f"{name}: mv disagrees with the float64 reference")


def check_residual(name, T, x, b, tol):
    """||T x - b|| / ||b|| in float64 with scipy, against `tol`."""
    xh = x.double().cpu().numpy()
    if not (np.all(np.isfinite(xh)) and xh.shape == b.shape):
        raise AssertionError(f"{name}: non-finite or misshapen output")
    res = float(np.linalg.norm(T @ xh - b) / np.linalg.norm(b))
    log(f"  {name}: relative residual {res:.3e} (tol {tol:.1e})")
    if not res <= tol:
        raise AssertionError(f"{name}: residual above tolerance")
    return res


def check_mm(name, got, ref, tol, launches=None, kernel=None):
    """mm output against its float64 reference; `launches` (a count taken
    before the call) requires exactly one launch of `kernel` in it."""
    check_mv(name, got, ref, tol)
    if kernel is not None:
        prefix, inst = kernel.rsplit("_", 1)
        done = COUNTERS[prefix][inst] - launches
        if done != 1:
            raise AssertionError(f"{name}: {done} launches of {kernel}, want exactly 1")


def residual_cols(name, T, X, B, tol):
    """Per-column ||T x_j - b_j|| / ||b_j|| in float64, the worst against `tol`."""
    Xh = X.double().cpu().numpy()
    if not (np.all(np.isfinite(Xh)) and Xh.shape == B.shape):
        raise AssertionError(f"{name}: non-finite or misshapen output")
    res = float(np.max(np.linalg.norm(T @ Xh - B, axis=0) / np.linalg.norm(B, axis=0)))
    log(f"  {name}: worst column relative residual {res:.3e} (tol {tol:.1e})")
    if not res <= tol:
        raise AssertionError(f"{name}: residual above tolerance")


def cuda_ms(fn, reps=15, inner=10, warm=3):
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    by CUDA events, after `warm` warm-up calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return statistics.median(times)


def profile_mv(name, call, calls=5, top=8):
    """One torch.profiler window over `calls` back-to-back calls after a
    warm-up: device time per call by kernel, and the device's idle share of
    the window's host-clock time (kernels on one stream do not overlap)."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _k, t, _c in kern)
    if not kern:
        log(f"  {name} profile: the profiler recorded no device time (not measured)")
        return
    log(f"  {name} profile ({calls} calls): device busy {busy / calls:.1f} us a call of {wall_us / calls:.1f} us "
        f"on the host clock, idle share {1 - busy / wall_us:.3f}; {sum(c for _k, _t, c in kern) // calls} "
        f"kernel launches a call; by kernel (us a call):")
    for key, t, c in sorted(kern, key=lambda r: -r[1])[:top]:
        log(f"    {t / calls:9.1f}  x{c // calls:<3d} {key[:90]}")


def iteration_ms(solve, k_lo, k_hi, turns=3):
    """ms of one solver iteration: the difference of two fixed-length
    solves (rtol = 0) on the host clock, median of `turns`."""
    t_iter = []
    for _ in range(turns):
        tk = {}
        for kk in (k_lo, k_hi):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = solve(kk)
            torch.cuda.synchronize()
            tk[kk] = time.perf_counter() - t0
            if done != kk:
                raise AssertionError(f"fixed-length solve ran {done} of {kk} iterations")
        t_iter.append((tk[k_hi] - tk[k_lo]) / (k_hi - k_lo) * 1e3)
    return statistics.median(t_iter), t_iter


def main() -> int:
    t_start = time.perf_counter()

    def phase(title):
        log(f"{title} (at {time.perf_counter() - t_start:.1f} s)")

    # 1. the card
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke needs one NVIDIA card")
        return 1
    dev = torch.device("cuda", 0)
    # the plain versions are the references: full f32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    ctx = tt.get_context()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {ctx.device_kind} "
        f"sm {ctx.sm} peak {ctx.hbm_gbps} GB/s")
    if ctx.hbm_gbps is None:
        raise AssertionError(f"no published HBM peak for {ctx.device_kind}")

    # 2. build
    t0 = time.perf_counter()
    lib = build.build_library()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    ptxas = lib.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas:", line.strip())
    t0 = time.perf_counter()
    # a numpy ILU0 at this size would stand in silently: require the C++ one
    if not native.available():
        raise AssertionError("the host C++ library (g++ build of host_kernels.cpp) did not load")
    log(f"host library: {time.perf_counter() - t0:.2f} s")

    # 3. kernel vs plain version
    phase("phase 3: kernel vs plain version")
    t0 = time.perf_counter()
    ptr, ind, val, x = bench_operand()
    m = n = len(ptr) - 1
    nnz = ind.size
    log(f"  bench operand built in {time.perf_counter() - t0:.1f} s (m={m}, nnz={nnz})")
    errs = {}
    f32 = bandt_form(ptr, ind, val, dev)
    x32 = torch.from_numpy(x).to(dev)
    log(f"  bench bandt form: W={f32.bwd_W} padL={f32.bwd_padL} start={f32.bandt_start} "
        f"spill={0 if not f32.has_spill else f32.sp_ind.numel()}")
    args32 = (f32.bandt_start, f32.bwd_padL)
    vt_bf = f32.band_bf16()
    compare("band_spmv_f32", "bench", band_spmv(f32.bwd_val, x32, *args32),
            band_spmv_plain(f32.bwd_val, x32, *args32), errs)
    compare("band_spmv_bf16", "bench", band_spmv(vt_bf, x32, *args32),
            band_spmv_plain(vt_bf, x32, *args32), errs)
    f64 = bandt_form(ptr, ind, val.astype(np.float64), dev)
    x64 = x32.double()
    args64 = (f64.bandt_start, f64.bwd_padL)
    compare("band_spmv_f64", "bench", band_spmv(f64.bwd_val, x64, *args64),
            band_spmv_plain(f64.bwd_val, x64, *args64), errs)
    sptr, sind, sval, sx = spill_operand()
    for inst, dt in (("f32", np.float32), ("f64", np.float64)):
        sf = bandt_form(sptr, sind, sval.astype(dt), dev)
        if not (sf.has_spill and sf.m % 2 == 1):
            raise AssertionError("small operand must be odd-m with a spill")
        xs = torch.from_numpy(sx.astype(dt)).to(dev)
        got = spmv_bandt(sf.bwd_val, xs, sf.sp_val, sf.sp_ind, sf.sp_rows,
                         start=sf.bandt_start, padL=sf.bwd_padL)
        compare(f"band_spmv_{inst}", f"small odd-m + spill (m={sf.m}, W={sf.bwd_W}, "
                f"spill={sf.sp_ind.numel()})", got, plain_bandt(sf.bwd_val, xs, sf), errs)
    del f64

    # the SPD operand's handle, through the entry points, and its ILU0
    t0 = time.perf_counter()
    Sspd, cptr, cind, cval = spd_operand(ptr, ind, val, m)
    C = tt.create_csr(m, n, cptr, cind, cval, device="cuda")
    tt.set_mv_hint(C, NONE, GEN, nop=1000)
    tt.set_sv_hint(C, NONE, LOWER, nop=1000)
    tt.set_lu_smoother_hint(C, NONE, GEN, nop=1000)
    tt.set_sm_hint(C, NONE, LOWER, nop=1000)
    tt.optimize(C)
    torch.cuda.synchronize()
    log(f"  SPD operand: nnz={Sspd.nnz}, create_csr + hints + optimize {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    st = ilu0_factorize(C)
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    t0 = time.perf_counter()
    ilu_ops = {"L": st.l_form.operands(), "U": st.u_form.operands()}
    torch.cuda.synchronize()
    t_invert = time.perf_counter() - t0
    for name, form in (("L", st.l_form), ("U", st.u_form)):
        log(f"  ILU0 {name} form: nb={form.nb} WL={form.WL} nblk={form.nblk} "
            f"reversed={form.reversed_} unit={form.unit_diag} source={form._src_space}")
        if form._src_space != "clean":
            raise AssertionError("the ILU0 forms did not come from the native builder")
    log(f"  ilu0_factorize (C++ IKJ + native form builds + upload) {t_factor:.2f} s; "
        f"diagonal-block inversion (both factors) {t_invert:.2f} s")
    wrng = np.random.default_rng(17)
    bw = torch.from_numpy(wrng.standard_normal(st.l_form.m_pad).astype(np.float32)).to(dev)
    bw_m = torch.from_numpy(wrng.standard_normal((st.l_form.m_pad, K_SM)).astype(np.float32)).to(dev)
    for name, form in (("L", st.l_form), ("U", st.u_form)):
        dT, lT = ilu_ops[name]
        label = f"ILU0 {name} (nb={form.nb}, WL={form.WL}, nblk={form.nblk})"
        compare("trsv_win_f32", label, trsv_win(dT, lT, bw, form.nb, form.WL),
                trsv_win_plain(dT, lT, bw, form.nb, form.WL), errs)
        compare("trsm_win_f32", f"{label} K={K_SM}", trsm_win(dT, lT, bw_m, form.nb, form.WL),
                trsm_win_plain(dT, lT, bw_m, form.nb, form.WL), errs)
        dT, lT, b64, bm64 = dT.double(), lT.double(), bw.double(), bw_m.double()
        compare("trsv_win_f64", label, trsv_win(dT, lT, b64, form.nb, form.WL),
                trsv_win_plain(dT, lT, b64, form.nb, form.WL), errs)
        compare("trsm_win_f64", f"{label} K={K_SM}", trsm_win(dT, lT, bm64, form.nb, form.WL),
                trsm_win_plain(dT, lT, bm64, form.nb, form.WL), errs)
        del dT, lT, b64, bm64
    wptr, wind, wval = wide_window_operand()
    for inst, dt in (("f32", np.float32), ("f64", np.float64)):
        Wh = tt.create_csr(len(wptr) - 1, len(wptr) - 1, wptr, wind, wval.astype(dt), device="cuda")
        wf = trsv_form_for(tt.optimize(Wh), LOWER, NONE, nb=64)
        if not (wf.WL > wf.nb and wf.m % 2 == 1):
            raise AssertionError(f"small form must be odd-m with WL > nb, got m={wf.m} WL={wf.WL}")
        dT, lT = wf.operands()
        bs = torch.from_numpy(wrng.standard_normal(wf.m_pad).astype(dt)).to(dev)
        label = f"small odd-m (m={wf.m}, nb={wf.nb}, WL={wf.WL}, nblk={wf.nblk})"
        compare(f"trsv_win_{inst}", label, trsv_win(dT, lT, bs, wf.nb, wf.WL),
                trsv_win_plain(dT, lT, bs, wf.nb, wf.WL), errs)
        kc = trsm_chunk(300, wf.nb, wf.WL, bs.element_size())
        if not 300 > kc > 0:
            raise AssertionError(f"K=300 must need several column chunks, got chunk {kc}")
        bs = torch.from_numpy(wrng.standard_normal((wf.m_pad, 300)).astype(dt)).to(dev)
        compare(f"trsm_win_{inst}", f"{label} K=300 ({-(-300 // kc)} chunks of {kc})",
                trsm_win(dT, lT, bs, wf.nb, wf.WL), trsm_win_plain(dT, lT, bs, wf.nb, wf.WL), errs)
    del Wh, wf, dT, lT, bs

    # the SpMM kernels on the bench operand's bandtm form
    Bm = torch.from_numpy(np.random.default_rng(SEED_B).standard_normal((n, K_MM)).astype(np.float32)).to(dev)
    Bm64 = Bm.double()
    tm32 = bandt_form(ptr, ind, val, dev, kind="bandtm")
    tm64 = bandt_form(ptr, ind, val.astype(np.float64), dev, kind="bandtm")
    targs = (tm32.bandt_start, tm32.bwd_padL)
    log(f"  bench bandtm form: W={tm32.bwd_W} padL={tm32.bwd_padL} start={tm32.bandt_start} "
        f"spill={0 if not tm32.has_spill else tm32.sp_ind.numel()}")
    compare("spmm_band_f32", f"bench K={K_MM}", spmm_band(tm32.bwd_val, Bm, *targs),
            spmm_band_plain(tm32.bwd_val, Bm, *targs), errs)
    compare("spmm_band_f64", f"bench K={K_MM}", spmm_band(tm64.bwd_val, Bm64, *targs),
            spmm_band_plain(tm64.bwd_val, Bm64, *targs), errs)
    dt32, dtbf = tm32.band_mxu_dt(), tm32.band_mxu_dt(bf16=True)
    for kernel, dt_ in (("spmm_band_mxu_f32", dt32), ("spmm_band_mxu_bf16", dtbf)):
        compare(kernel, f"bench K={K_MM} (nblk={dt_.shape[0]})", spmm_band_mxu(dt_, Bm, *targs, m),
                spmm_band_mxu_plain(dt_, Bm, *targs, m), errs)
    for inst, dt in (("f32", np.float32), ("f64", np.float64)):
        sf = bandt_form(sptr, sind, sval.astype(dt), dev, kind="bandtm")
        if not (sf.has_spill and sf.m % 2 == 1):
            raise AssertionError("small operand must be odd-m with a spill")
        Bs = torch.from_numpy(np.random.default_rng(29).standard_normal((sf.n, 7)).astype(dt)).to(dev)
        sargs = (sf.bandt_start, sf.bwd_padL)
        want = spmm_band_plain(sf.bwd_val, Bs, *sargs)
        want.index_add_(0, sf.sp_rows, (sf.sp_val[:, None] * Bs[sf.sp_ind]).to(want.dtype))
        compare(f"spmm_band_{inst}", f"small odd-m + spill K=7 (m={sf.m}, W={sf.bwd_W}, "
                f"spill={sf.sp_ind.numel()})",
                spmm_bandtm(sf.bwd_val, Bs, sf.sp_val, sf.sp_ind, sf.sp_rows, *sargs), want, errs)

    # the stencil's handle, through the entry points, and the diagonal kernel
    t0 = time.perf_counter()
    hptr, hind, hval = stencil27()
    mh = len(hptr) - 1
    log(f"  stencil {round(mh ** (1 / 3))}^3 built in {time.perf_counter() - t0:.1f} s (m={mh}, nnz={hind.size})")
    t0 = time.perf_counter()
    H = tt.create_csr(mh, mh, hptr, hind, hval, device="cuda")
    tt.set_mm_hint(H, NONE, GEN, nop=1000)
    tt.optimize(H)
    torch.cuda.synchronize()
    if [f.kind for f in H.plan.exec_forms.values()] != ["diag"]:
        raise AssertionError(f"stencil planned as {[f.kind for f in H.plan.exec_forms.values()]}, want diag")
    hf = next(iter(H.plan.exec_forms.values()))
    log(f"  stencil: create_csr + set_mm_hint + optimize {time.perf_counter() - t0:.2f} s; diag form "
        f"ndiag={len(hf.dia_offs_static)}, offsets {hf.dia_offs_static[0]}..{hf.dia_offs_static[-1]}")
    Bh = torch.from_numpy(np.random.default_rng(SEED_B + 1).standard_normal((mh, K_MM)).astype(np.float32)).to(dev)
    Bh64 = Bh.double()
    hv64 = hf.dia_val.double()
    for kernel, dv, Bx in (("spmm_diag_f32", hf.dia_val, Bh), ("spmm_diag_bf16", hf.dia_bf16(), Bh),
                           ("spmm_diag_f64", hv64, Bh64)):
        compare(kernel, f"stencil K={K_MM}", spmm_diag(dv, hf.dia_offs, Bx), spmm_diag_plain(dv, hf.dia_offs, Bx),
                errs)
    dptr, dind, dval = diag_operand()
    for inst, dt in (("f32", np.float32), ("bf16", np.float32), ("f64", np.float64)):
        df = bandt_form(dptr, dind, dval.astype(dt), dev, kind="diag")
        if not (df.m % 2 == 1 and df.dia_offs_static[0] < 0):
            raise AssertionError("small diag operand must be odd-m with a negative offset")
        dv = df.dia_bf16() if inst == "bf16" else df.dia_val
        Bs = torch.from_numpy(np.random.default_rng(37).standard_normal((df.n, 13)).astype(dt)).to(dev)
        compare(f"spmm_diag_{inst}", f"small odd-m K=13 (m={df.m}, offsets {df.dia_offs_static})",
                spmm_diag(dv, df.dia_offs, Bs), spmm_diag_plain(dv, df.dia_offs, Bs), errs)

    # the spill-route kernels: on the webbase stand-in's gen spill (through
    # its handle, planned by optimize), on one stripe of the scatter
    # operand's whole-matrix route, and on a small ragged case
    def check_route_kernels(label, sr, xv, yv):
        contrib = oh_select(xv, sr.sel_idx, sr.sel_val, sr.sel_blk, n_out=sr.n)
        compare("oh_select_f32", label, contrib, oh_select_plain(xv, sr.sel_idx, sr.sel_val, sr.sel_blk, sr.n), errs)
        routed = apply_route(contrib, sr.masks, sr.masks_packed, sr.k)
        compare("benes_route_f32", f"{label} (k={sr.k})", routed,
                apply_benes(contrib, route_masks(sr.masks, sr.masks_packed, sr.k), sr.k), errs)
        args = (sr.acc_idx, sr.acc_cid, sr.acc_start, sr.n_acc_tiles, yv)
        compare("oh_accum_f32", label, oh_accum(routed, *args), oh_accum_plain(routed, *args), errs)

    t0 = time.perf_counter()
    wm, _wn, wptr, wind, wval = webbase_1m(np.random.default_rng(7))
    log(f"  webbase-1M stand-in built in {time.perf_counter() - t0:.1f} s (m={wm}, nnz={wind.size})")
    t0 = time.perf_counter()
    Wh = tt.create_csr(wm, wm, wptr, wind, wval, device="cuda")
    tt.set_mv_hint(Wh, NONE, GEN, nop=1000)
    tt.optimize(Wh)
    torch.cuda.synchronize()
    t_wplan = time.perf_counter() - t0
    wform = next(iter(Wh.plan.exec_forms.values()))
    if not (wform.kind == "gen" and wform.gen_bandt and _spill_route_on(wform, dev)):
        raise AssertionError(f"webbase planned as {wform.kind} (band layout {wform.gen_bandt}), "
                             "want gen in the band layout with its spill on the route")
    t0 = time.perf_counter()
    wroute = wform.spill_route()
    torch.cuda.synchronize()
    t_wroute = time.perf_counter() - t0
    log(f"  webbase gen form: create_csr + set_mv_hint + optimize {t_wplan:.2f} s, spill route plan {t_wroute:.2f} s; "
        f"B={wform.gen_B} m_pad={wform.gen_m_pad} W={wform.bwd_W} start={wform.bandt_start} padL={wform.bwd_padL}, "
        f"spilled {wform.sp_ind.numel()}, hub columns {wform.hub_cols.numel()}, hub rows "
        f"{0 if wform.hubr_rows is None else wform.hubr_rows.numel()}, flipped blocks "
        f"{0 if wform.gen_flip is None else int(wform.gen_flip.sum())}; route {route_desc(wroute)}; "
        f"form bytes {wform.nbytes() / 1e9:.3f} GB (route {wroute.nbytes() / 1e6:.1f} MB)")
    rrng = np.random.default_rng(43)
    xs_d = torch.from_numpy(rrng.standard_normal(wform.gen_m_pad).astype(np.float32)).to(dev)
    ys_d = torch.from_numpy(rrng.standard_normal(wform.gen_m_pad).astype(np.float32)).to(dev)
    check_route_kernels("webbase spill", wroute, xs_d, ys_d)
    t0 = time.perf_counter()
    qptr, qind, qval = scatter_operand()
    qm = len(qptr) - 1
    Qh = tt.create_csr(qm, qm, qptr, qind, qval, device="cuda")
    tt.set_mv_hint(Qh, NONE, GEN, nop=1000)
    tt.optimize(Qh)
    torch.cuda.synchronize()
    qform = next(iter(Qh.plan.exec_forms.values()))
    if qform.kind != "route":
        raise AssertionError(f"scatter operand planned as {qform.kind}, want route")
    qstripes = qform._spill_route.stripes
    log(f"  scatter operand (m={qm}, nnz={qind.size}): create_csr + set_mv_hint + optimize "
        f"{time.perf_counter() - t0:.2f} s -> route form, {len(qstripes)} stripes, each "
        f"{sorted({s.k for s in qstripes})}; stripe 0 rows [{qform._spill_route.row_lo[0]}, "
        f"{qform._spill_route.row_hi[0]}): {route_desc(qstripes[0])}; form bytes {qform.nbytes() / 1e6:.1f} MB")
    xq_d = torch.from_numpy(rrng.standard_normal(qm).astype(np.float32)).to(dev)
    yq_d = torch.from_numpy(rrng.standard_normal(qform._spill_route.row_hi[0]).astype(np.float32)).to(dev)
    check_route_kernels("scatter stripe 0", qstripes[0], xq_d, yq_d)
    # small: 2500 entries over rows [2100, 6000) (untouched leading y
    # blocks), columns over a ragged x of 5003 (a chunk straddles its end)
    srows = np.sort(rrng.integers(2100, 6000, 2500))
    scols = rrng.integers(0, 5003, 2500)
    ssr = build_spill_route(srows, scols, torch.from_numpy(rrng.standard_normal(2500).astype(np.float32)).to(dev),
                            6000, n_pad_x=5003)
    check_route_kernels("small ragged", ssr, torch.from_numpy(rrng.standard_normal(5003).astype(np.float32)).to(dev),
                        torch.from_numpy(rrng.standard_normal(6000).astype(np.float32)).to(dev))
    src7 = rrng.permutation(128)
    v7 = torch.from_numpy(rrng.standard_normal(128).astype(np.float32)).to(dev)
    p7 = torch.from_numpy(pack_masks(native.benes_plan(7, src7))).to(dev)
    got7 = benes_route(v7, p7, 7)
    compare("benes_route_f32", "k=7 random permutation", got7, benes_route_plain(v7, p7, 7), errs)
    if not torch.equal(got7.cpu(), v7.cpu()[torch.from_numpy(src7)]):
        raise AssertionError("benes_route_f32 k=7: the route does not realise its permutation")

    # 4. the main path, counted
    phase("phase 4: main path (create_csr -> set_mv_hint -> optimize -> mv)")
    S = sp.csr_matrix((val.astype(np.float64), ind, ptr), shape=(m, n))
    ref = S @ x.astype(np.float64)
    reset_counts()
    t0 = time.perf_counter()
    A = tt.create_csr(m, n, ptr, ind, val, device="cuda")
    tt.set_mv_hint(A, NONE, GEN, nop=1000)
    plan = tt.optimize(A)
    torch.cuda.synchronize()
    log(f"  create_csr + optimize: {time.perf_counter() - t0:.2f} s")
    forms = list(plan.exec_forms.values())
    if [f.kind for f in forms] != ["bandt"]:
        raise AssertionError(f"optimize built {[f.kind for f in forms]}, want one bandt form")
    before = dict(band_spmv.launches)
    check_mv("mv default", tt.mv(1.0, A, GEN, NONE, x32, 0.0), ref, MV_TOL["f32"])
    check_mv("mv kid=8", tt.mv(1.0, A, GEN, NONE, x32, 0.0, kid=8), ref, MV_TOL["f32"])
    check_mv("mv kid=12", tt.mv(1.0, A, GEN, NONE, x32, 0.0, kid=12), ref, MV_TOL["f32"])
    yin = torch.from_numpy(np.random.default_rng(3).standard_normal(m).astype(np.float32)).to(dev)
    check_mv("mv alpha=1.5 beta=-0.5", tt.mv(1.5, A, GEN, NONE, x32, -0.5, yin),
             1.5 * ref - 0.5 * yin.double().cpu().numpy(), MV_TOL["f32"])
    if band_spmv.launches["f32"] - before["f32"] != 4:
        raise AssertionError(f"f32 mv calls did not each launch the kernel: {band_spmv.launches}")
    tt.set_precision_mode(A, "mixed")
    ymix = tt.mv(1.0, A, GEN, NONE, x32, 0.0).double().cpu().numpy()
    tt.set_precision_mode(A, "full")
    # docs/precision.md error contract of the bf16 band: per element
    # |y - y*| <= 2^-8 * sum_j |a_ij x_j| + nnz_row * eps_f32 * |y*|
    bound = 2.0**-8 * (abs(S) @ np.abs(x.astype(np.float64))) + row_nnz(ptr) * 2.0**-23 * np.abs(ref)
    worst = float(np.max(np.abs(ymix - ref) / bound))
    log(f"  mv mixed (bf16 band, kid=12): max |err| / documented bound {worst:.3f} (must be <= 1)")
    if not (np.all(np.isfinite(ymix)) and worst <= 1.0):
        raise AssertionError("mixed-precision mv outside the documented error bound")
    A64 = tt.create_csr(m, n, ptr, ind, val.astype(np.float64), device="cuda")
    tt.set_mv_hint(A64, NONE, GEN, nop=1000)
    tt.optimize(A64)
    check_mv("mv float64 (kid 13 route)", tt.mv(1.0, A64, GEN, NONE, x64, 0.0), ref, MV_TOL["f64"])
    del A64

    phase(f"phase 4b: main path (create_csr -> set_mm_hint -> optimize -> mm, K={K_MM})")

    def count(kernel):
        prefix, inst = kernel.rsplit("_", 1)
        return COUNTERS[prefix][inst]

    def mm_case(name, handle, kernel, ref_, tol, *args, **kw):
        c0 = count(kernel) if kernel else None
        got = tt.mm(*args[:1], handle, GEN, *args[1:], **kw)
        check_mm(name, got, ref_, tol, c0, kernel)
        return got

    t0 = time.perf_counter()
    Amm = tt.create_csr(m, n, ptr, ind, val, device="cuda")
    tt.set_mm_hint(Amm, NONE, GEN, nop=1000)
    tt.optimize(Amm)
    torch.cuda.synchronize()
    log(f"  create_csr + set_mm_hint + optimize: {time.perf_counter() - t0:.2f} s")
    if [f.kind for f in Amm.plan.exec_forms.values()] != ["bandtm"]:
        raise AssertionError(f"optimize built {[f.kind for f in Amm.plan.exec_forms.values()]}, want bandtm")
    Bnp = Bm64.cpu().numpy()
    ref_mm = S @ Bnp
    f32tol, f64tol = MV_TOL["f32"], MV_TOL["f64"]
    mm_case("mm default (bandtm)", Amm, "spmm_band_f32", ref_mm, f32tol, 1.0, NONE, Bm, 0.0)
    mm_case("mm kid=4", Amm, "spmm_band_f32", ref_mm, f32tol, 1.0, NONE, Bm, 0.0, kid=4)
    mm_case("mm kid=5 (block windows)", Amm, "spmm_band_mxu_f32", ref_mm, f32tol, 1.0, NONE, Bm, 0.0, kid=5)
    mm_case("mm kid=7 (diag form)", Amm, "spmm_diag_f32", ref_mm, f32tol, 1.0, NONE, Bm, 0.0, kid=7)
    mm_case("mm kid=0 (segsum, plain torch)", Amm, None, ref_mm, f32tol, 1.0, NONE, Bm, 0.0, kid=0)
    Cin = torch.from_numpy(np.random.default_rng(41).standard_normal((m, K_MM)).astype(np.float32)).to(dev)
    mm_case("mm alpha=1.5 beta=-0.5", Amm, "spmm_band_f32", 1.5 * ref_mm - 0.5 * Cin.double().cpu().numpy(),
            f32tol, 1.5, NONE, Bm, -0.5, Cin)
    c0 = count("spmm_band_f32")
    outT = tt.mm(1.0, Amm, GEN, NONE, Bm.T.contiguous(), 0.0, order=tt.Order.column)
    if tuple(outT.shape) != (K_MM, m):
        raise AssertionError(f"Order.column mm returned {tuple(outT.shape)}")
    check_mm("mm Order.column", outT.T, ref_mm, f32tol, c0, "spmm_band_f32")
    mm_case("mm op=transpose", Amm, "spmm_band_f32", S.T @ Bnp, f32tol, 1.0, tt.Operation.transpose, Bm, 0.0)
    if Amm.plan.mm_kinds[(GEN.type, GEN.fill_mode, GEN.diag_type, tt.Operation.transpose)] != "bandtm":
        raise AssertionError("the transposed bench operand did not take bandtm")
    sab = abs(S) @ np.abs(Bnp)  # sum_j |a_ij b_j|, the bound's product term
    row_nz = row_nnz(ptr)[:, None]

    def mixed_case(name, handle, kernel, ref_, sab, nz, roundings, **kw):
        """docs/precision.md: |c - c*| <= 2^-8 sum |a b| + nnz_row eps_f32 |c*|
        per bf16 rounding of a product's operands (the B rounding of KID 5
        is the second)."""
        tt.set_precision_mode(handle, "mixed")
        c0 = count(kernel)
        got = tt.mm(1.0, handle, GEN, NONE, kw.pop("B"), 0.0, **kw).double().cpu().numpy()
        tt.set_precision_mode(handle, "full")
        if count(kernel) - c0 != 1:
            raise AssertionError(f"{name}: {count(kernel) - c0} launches of {kernel}, want 1")
        lim = roundings * 2.0**-8 * sab + nz * 2.0**-23 * np.abs(ref_)
        worst = float(np.max(np.abs(got - ref_) / lim))
        log(f"  {name}: max |err| / documented bound ({roundings} bf16 rounding(s)) {worst:.3f} (must be <= 1)")
        if not (np.all(np.isfinite(got)) and worst <= 1.0):
            raise AssertionError(f"{name}: outside the documented error bound")

    mixed_case("mm mixed kid=5 (bf16 windows and B)", Amm, "spmm_band_mxu_bf16", ref_mm, sab, row_nz, 2,
               B=Bm, kid=5)
    mixed_case("mm mixed kid=7 (bf16 diagonals)", Amm, "spmm_diag_bf16", ref_mm, sab, row_nz, 1, B=Bm, kid=7)
    A64mm = tt.create_csr(m, n, ptr, ind, val.astype(np.float64), device="cuda")
    tt.set_mm_hint(A64mm, NONE, GEN, nop=1000)
    tt.optimize(A64mm)
    mm_case("mm float64 default", A64mm, "spmm_band_f64", ref_mm, f64tol, 1.0, NONE, Bm64, 0.0)
    mm_case("mm float64 kid=7", A64mm, "spmm_diag_f64", ref_mm, f64tol, 1.0, NONE, Bm64, 0.0, kid=7)
    del A64mm
    Sh = sp.csr_matrix((hval.astype(np.float64), hind, hptr), shape=(mh, mh))
    Bhnp = Bh64.cpu().numpy()
    ref_h = Sh @ Bhnp
    mm_case("mm stencil default (diag)", H, "spmm_diag_f32", ref_h, f32tol, 1.0, NONE, Bh, 0.0)
    mm_case("mm stencil kid=7", H, "spmm_diag_f32", ref_h, f32tol, 1.0, NONE, Bh, 0.0, kid=7)
    hz = row_nnz(hptr)[:, None]
    sab = abs(Sh) @ np.abs(Bhnp)
    mixed_case("mm stencil mixed default", H, "spmm_diag_bf16", ref_h, sab, hz, 1, B=Bh)
    mixed_case("mm stencil mixed kid=7", H, "spmm_diag_bf16", ref_h, sab, hz, 1, B=Bh, kid=7)
    del sab

    # 5. solvers on the SPD operand
    phase("phase 5: CG (pcg_solve, precond=None), trsv, ilu_smoother, ILU0- and SGS-PCG")
    cform = C.plan.exec_form_for(GEN, NONE)
    if cform.kind != "bandt":
        raise AssertionError(f"SPD operand planned as {cform.kind}")
    b = np.random.default_rng(5).standard_normal(m).astype(np.float32)
    b_d = torch.from_numpy(b).to(dev)
    bref = b.astype(np.float64)
    rtol = 1e-6
    # f32 CG: the recursive residual drifts from the true one by O(eps_f32 *
    # cond(A)); cond <= (2R+1)/1 for the Gershgorin shift, so allow 10x rtol
    res_tol = 10 * rtol
    iters = {}

    def run_pcg(precond, band_per_iter):
        n_band, n_sv = band_spmv.launches["f32"], trsv_win.launches["f32"]
        t0 = time.perf_counter()
        xs, k, rnorm = tt.pcg_solve(C, b_d, rtol=rtol, maxit=1000, precond=precond)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        nb_l = band_spmv.launches["f32"] - n_band
        ns_l = trsv_win.launches["f32"] - n_sv
        true_res = float(np.linalg.norm(bref - Sspd @ xs.double().cpu().numpy()) / np.linalg.norm(bref))
        log(f"  pcg precond={precond}: {k} iterations in {t_solve:.3f} s, ||r||={rnorm:.3e}, "
            f"true rel residual {true_res:.3e} (tol {res_tol:.1e}), band launches {nb_l}, "
            f"trsv launches {ns_l}")
        if not (k < 1000 and rnorm <= rtol * np.linalg.norm(b) * 1.0001):
            raise AssertionError(f"CG precond={precond} did not converge")
        if not (np.isfinite(true_res) and true_res <= res_tol):
            raise AssertionError(f"CG precond={precond}: true residual above tolerance")
        # one band launch per matvec (+ the initial residual); a
        # preconditioner adds two window solves and, for SGS, its
        # strict-lower mv
        want_sv = 0 if precond is None else 2 * k
        if nb_l != band_per_iter * k + 1 or ns_l != want_sv:
            raise AssertionError(
                f"CG precond={precond} launched {nb_l} band / {ns_l} trsv kernels in {k} iterations, "
                f"want {band_per_iter * k + 1} / {want_sv}"
            )
        iters[precond] = k

    log(f"  SPD operand W={cform.bwd_W}")
    run_pcg(None, 1)
    xl = tt.trsv(1.0, C, LOWER, NONE, b_d)
    check_residual("trsv f32 lower non-unit", sp.tril(Sspd).tocsr(), xl, bref,
                   expected_precision(torch.float32))
    xsm = tt.ilu_smoother(C, GEN, b_d)
    lu = st.lu.double().cpu().numpy()
    rows = np.repeat(np.arange(m), np.diff(cptr))
    low = cind < rows
    Lf = sp.csr_matrix((np.r_[lu[low], np.ones(m)], (np.r_[rows[low], np.arange(m)],
                        np.r_[cind[low], np.arange(m)])), shape=(m, m))
    Uf = sp.csr_matrix((lu[~low], (rows[~low], cind[~low])), shape=(m, m))
    LU = spla.aslinearoperator(Lf) @ spla.aslinearoperator(Uf)  # applied, never multiplied out
    check_residual("ilu_smoother: L (U x) = b", LU, xsm, bref, expected_precision(torch.float32))
    Bsm = np.random.default_rng(31).standard_normal((m, K_SM)).astype(np.float32)
    Bsm_d = torch.from_numpy(Bsm).to(dev)
    Bsm64 = Bsm.astype(np.float64)
    c0 = trsm_win.launches["f32"]
    residual_cols(f"trsm f32 lower non-unit K={K_SM}", sp.tril(Sspd).tocsr(),
                  tt.trsm(1.0, C, LOWER, NONE, Bsm_d), Bsm64, expected_precision(torch.float32))
    residual_cols(f"ilu_smoother (m, {K_SM}) b: L (U X) = B", LU, tt.ilu_smoother(C, GEN, Bsm_d), Bsm64,
                  expected_precision(torch.float32))
    if trsm_win.launches["f32"] - c0 != 3:
        raise AssertionError(f"trsm + 2-D ilu_smoother made {trsm_win.launches['f32'] - c0} multi-RHS "
                             "launches, want 1 + 2")
    run_pcg("ilu0", 1)
    run_pcg("sgs", 2)
    for precond in ("ilu0", "sgs"):
        if not iters[precond] < iters[None]:
            raise AssertionError(f"precond={precond} took {iters[precond]} iterations, none {iters[None]}")
    C64 = tt.create_csr(m, n, cptr, cind, cval.astype(np.float64), device="cuda")
    tt.set_sv_hint(C64, NONE, UPPER, nop=1000)
    tt.set_sm_hint(C64, NONE, UPPER, nop=1000)
    tt.optimize(C64)
    check_residual("trsv f64 upper non-unit (reversed form)", sp.triu(Sspd).tocsr(),
                   tt.trsv(1.0, C64, UPPER, NONE, b_d.double()), bref, expected_precision(torch.float64))
    c0 = trsm_win.launches["f64"]
    residual_cols(f"trsm f64 upper non-unit K={K_SM} (reversed form)", sp.triu(Sspd).tocsr(),
                  tt.trsm(1.0, C64, UPPER, NONE, Bsm_d.double()), Bsm64, expected_precision(torch.float64))
    if trsm_win.launches["f64"] - c0 != 1:
        raise AssertionError("trsm f64 did not launch the multi-RHS kernel once")
    del C64
    launches = read_counts()
    log(f"  main-path launches: {launches}")
    for kernel, count in launches.items():
        if count == 0 and kernel not in GEN_PATH:
            raise AssertionError(f"kernel {kernel} never launched on the main path")

    # 5b. the general-structure path, counted on its own
    phase("phase 5b: general-structure path (webbase gen + spill route, scatter route, permuted-space CG)")
    reset_counts()
    Sw = sp.csr_matrix((wval.astype(np.float64), wind, wptr), shape=(wm, wm))
    xw = np.random.default_rng(47).standard_normal(wm).astype(np.float32)
    xw_d = torch.from_numpy(xw).to(dev)
    refw = Sw @ xw.astype(np.float64)
    per_call = {"band_spmv_f32": 1, "oh_select_f32": 1, "oh_accum_f32": 1, "benes_route_f32": route_launches(wroute)}

    def counted(name, fn, want):
        """Run fn; require exactly `want` launches of each kernel named."""
        c0 = read_counts()
        out = fn()
        c1 = read_counts()
        done = {k: c1[k] - c0[k] for k in want}
        if done != want:
            raise AssertionError(f"{name}: launches {done}, want {want}")
        return out

    check_mv("webbase mv default (gen, spill route)",
             counted("webbase mv", lambda: tt.mv(1.0, Wh, GEN, NONE, xw_d, 0.0), per_call), refw, MV_TOL["f32"])
    check_mv("webbase mv kid=7", counted("kid=7", lambda: tt.mv(1.0, Wh, GEN, NONE, xw_d, 0.0, kid=7), per_call),
             refw, MV_TOL["f32"])
    yw = torch.from_numpy(np.random.default_rng(53).standard_normal(wm).astype(np.float32)).to(dev)
    check_mv("webbase mv alpha=1.5 beta=-0.5",
             counted("alpha/beta", lambda: tt.mv(1.5, Wh, GEN, NONE, xw_d, -0.5, yw), per_call),
             1.5 * refw - 0.5 * yw.double().cpu().numpy(), MV_TOL["f32"])
    tt.set_precision_mode(Wh, "mixed")
    mixed_call = dict(per_call, band_spmv_f32=0, band_spmv_bf16=1)
    ymix = counted("mixed", lambda: tt.mv(1.0, Wh, GEN, NONE, xw_d, 0.0), mixed_call).double().cpu().numpy()
    tt.set_precision_mode(Wh, "full")
    # docs/precision.md: the bf16 band rounds one operand of each band product
    bound = 2.0**-8 * (abs(Sw) @ np.abs(xw.astype(np.float64))) + row_nnz(wptr) * 2.0**-23 * np.abs(refw)
    worst = float(np.max(np.abs(ymix - refw) / bound))
    log(f"  webbase mv mixed (bf16 band): max |err| / documented bound {worst:.3f} (must be <= 1)")
    if not (np.all(np.isfinite(ymix)) and worst <= 1.0):
        raise AssertionError("webbase mixed-precision mv outside the documented error bound")
    op = tt.mv_operator(Wh)
    if op.space != "permuted":
        raise AssertionError(f"mv_operator on the gen form iterates in the {op.space} space")
    check_mv("webbase mv_operator (permuted space, round trip)",
             counted("mv_operator", lambda: op.from_space(op(op.to_space(xw_d))), per_call), refw, MV_TOL["f32"])
    wval2 = np.random.default_rng(59).standard_normal(wval.size).astype(np.float32)
    t0 = time.perf_counter()
    tt.update_values(Wh, wval2)
    torch.cuda.synchronize()
    log(f"  webbase update_values: {time.perf_counter() - t0:.2f} s")
    refw2 = sp.csr_matrix((wval2.astype(np.float64), wind, wptr), shape=(wm, wm)) @ xw.astype(np.float64)
    check_mv("webbase mv after update_values",
             counted("update_values", lambda: tt.mv(1.0, Wh, GEN, NONE, xw_d, 0.0), per_call), refw2, MV_TOL["f32"])
    t0 = time.perf_counter()
    W64 = tt.create_csr(wm, wm, wptr, wind, wval.astype(np.float64), device="cuda")
    tt.set_mv_hint(W64, NONE, GEN, nop=1000)
    tt.optimize(W64)
    w64form = next(iter(W64.plan.exec_forms.values()))
    # at 8 B a value the gen cost model (the JAX package's constants) prices
    # the band above GEN_MARGIN of the gather form, and the route serves
    # float32 only: the gather fallback, as the JAX package plans it
    if w64form.kind not in ("ell", "ellhyb", "segsum"):
        raise AssertionError(f"float64 webbase planned as {w64form.kind}, want the gather fallback")
    check_mv(f"webbase mv float64 (gather fallback: {w64form.kind})",
             counted("f64", lambda: tt.mv(1.0, W64, GEN, NONE, xw_d.double(), 0.0),
                     {"band_spmv_f64": 0, "oh_select_f32": 0}), refw, MV_TOL["f64"])
    log(f"  float64 webbase: plan + mv {time.perf_counter() - t0:.2f} s")
    del W64, w64form
    Sq = sp.csr_matrix((qval.astype(np.float64), qind, qptr), shape=(qm, qm))
    xq = np.random.default_rng(61).standard_normal(qm).astype(np.float32)
    q_call = {"oh_select_f32": len(qstripes), "oh_accum_f32": len(qstripes),
              "benes_route_f32": sum(route_launches(s) for s in qstripes), "band_spmv_f32": 0}
    xq_d = torch.from_numpy(xq).to(dev)
    check_mv("scatter mv default (whole-matrix route)",
             counted("scatter mv", lambda: tt.mv(1.0, Qh, GEN, NONE, xq_d, 0.0), q_call),
             Sq @ xq.astype(np.float64), MV_TOL["f32"])
    # CG in permuted space on the symmetrised webbase
    t0 = time.perf_counter()
    Sws, gptr, gind, gval = spd_operand(wptr, wind, wval, wm)
    G = tt.create_csr(wm, wm, gptr, gind, gval, device="cuda")
    tt.set_mv_hint(G, NONE, GEN, nop=1000)
    tt.optimize(G)
    gform = next(iter(G.plan.exec_forms.values()))
    if not (gform.kind == "gen" and gform.gen_bandt and _spill_route_on(gform, dev)):
        raise AssertionError(f"symmetrised webbase planned as {gform.kind}, want gen with a routed spill")
    groute = gform.spill_route()
    torch.cuda.synchronize()
    log(f"  symmetrised webbase (nnz={gind.size}): plan + spill route {time.perf_counter() - t0:.2f} s; "
        f"W={gform.bwd_W}, spilled {gform.sp_ind.numel()}, hub columns {gform.hub_cols.numel()}, hub rows "
        f"{0 if gform.hubr_rows is None else gform.hubr_rows.numel()}; route {route_desc(groute)}")
    bg = np.random.default_rng(67).standard_normal(wm).astype(np.float32)
    bg_d = torch.from_numpy(bg).to(dev)
    c0 = read_counts()
    t0 = time.perf_counter()
    xg, kg, rg = tt.pcg_solve(G, bg_d, rtol=rtol, maxit=1000)
    torch.cuda.synchronize()
    t_gcg = time.perf_counter() - t0
    c1 = read_counts()
    true_g = float(np.linalg.norm(bg - Sws @ xg.double().cpu().numpy()) / np.linalg.norm(bg.astype(np.float64)))
    log(f"  pcg permuted space (symmetrised webbase): {kg} iterations in {t_gcg:.3f} s, ||r||={rg:.3e}, true rel "
        f"residual {true_g:.3e} (tol {res_tol:.1e}); launches {({k: c1[k] - c0[k] for k in per_call})}")
    if not (kg < 1000 and np.isfinite(true_g) and true_g <= res_tol):
        raise AssertionError("permuted-space CG did not converge to the tolerance")
    g_call = {"band_spmv_f32": kg + 1, "oh_select_f32": kg + 1, "oh_accum_f32": kg + 1,
              "benes_route_f32": (kg + 1) * route_launches(groute)}
    if {k: c1[k] - c0[k] for k in g_call} != g_call:
        raise AssertionError(f"permuted-space CG launches {({k: c1[k] - c0[k] for k in g_call})}, want {g_call}")
    gen_launches = read_counts()
    log(f"  general-structure path launches: {gen_launches}")
    for kernel in GEN_PATH:
        if gen_launches[kernel] == 0:
            raise AssertionError(f"kernel {kernel} never launched on the general-structure path")
        launches[kernel] = gen_launches[kernel]

    # 6. timing
    phase("phase 6: timing (CUDA events or host clock, median of repeats)")
    peak = ctx.hbm_gbps
    ms, plain_ms, bounds, lib = {}, {}, {}, {}

    def turns(kernel, kern, plain, kreps=(15, 10), preps=(15, 10), kwarm=3, pwarm=1):
        """plain, kernel, kernel, plain: compare within one call, in turns."""
        p1 = cuda_ms(plain, reps=preps[0], inner=preps[1], warm=pwarm)
        k1 = cuda_ms(kern, reps=kreps[0], inner=kreps[1], warm=kwarm)
        k2 = cuda_ms(kern, reps=kreps[0], inner=kreps[1], warm=kwarm)
        p2 = cuda_ms(plain, reps=preps[0], inner=preps[1], warm=pwarm)
        ms[kernel], plain_ms[kernel] = min(k1, k2), min(p1, p2)
        return k1, k2, p1, p2

    def note(kernel, nbytes_, need, flops, lib_fn=None, lib_kw=None):
        """Record the kernel's bound and its library yardstick; log them.
        nbytes_ counts the stored operands once each, zero padding included
        (the bound_ms of the kernels line); need counts only their nonzero
        entries, the function's own bytes, logged beside it."""
        inst = kernel.rsplit("_", 1)[1]
        bounds[kernel] = bound_of(nbytes_, flops, inst, peak)
        need_ms, need_by = bound_of(need, flops, inst, peak)
        err = "no library call computes this instance's function"
        lib[kernel] = None
        if lib_fn is not None:
            lib[kernel], err = library_ms(lib_fn, **(lib_kw or {}))
        lib_s = f"{lib[kernel]:.4f} ms" if lib[kernel] is not None else f"none ({err})"
        log(f"  {kernel}: kernel {ms[kernel]:.4f} ms, plain {plain_ms[kernel]:.4f} ms, library {lib_s}, "
            f"bound {bounds[kernel][0]:.4f} ms ({bounds[kernel][1]}; {nbytes_ / 1e6:.1f} MB stored, "
            f"{flops / 1e9:.2f} GFLOP) = {bounds[kernel][0] / ms[kernel]:.3f} of the bound; "
            f"nonzeros only {need_ms:.4f} ms ({need_by}; {need / 1e6:.1f} MB) = {need_ms / ms[kernel]:.3f}")

    A32 = csr_tensor(ptr, ind, val, dev, torch.float32)
    A64 = csr_tensor(ptr, ind, val, dev, torch.float64)
    f64 = bandt_form(ptr, ind, val.astype(np.float64), dev)
    cases = {
        "band_spmv_f32": (f32.bwd_val, x32, args32, lambda: A32 @ x32),
        "band_spmv_bf16": (vt_bf, x32, args32, None),
        "band_spmv_f64": (f64.bwd_val, x64, (f64.bandt_start, f64.bwd_padL), lambda: A64 @ x64),
    }
    for kernel, (vt, xv, args, lib_fn) in cases.items():
        turns(kernel, lambda: band_spmv(vt, xv, *args), lambda: band_spmv_plain(vt, xv, *args))
        band_bytes = nbytes(vt)
        log(f"  {kernel}: band stream {band_bytes / ms[kernel] / 1e6:.1f} GB/s "
            f"({band_bytes / ms[kernel] / 1e6 / peak:.3f} of peak {peak} GB/s)")
        note(kernel, nbytes(vt, xv) + m * xv.element_size(), nz_bytes(vt, xv) + m * xv.element_size(),
             2 * vt.numel(), lib_fn)
    del f64
    fL = st.l_form
    dT32, lT32 = ilu_ops["L"]
    dT64, lT64, b64, bm64 = dT32.double(), lT32.double(), bw.double(), bw_m.double()
    Lf.sort_indices()
    L32 = csr_tensor(Lf.indptr, Lf.indices, Lf.data, dev, torch.float32)
    L64 = csr_tensor(Lf.indptr, Lf.indices, Lf.data, dev, torch.float64)
    # a step: the triangular nb x nb inverted block and the WL x nb window
    step_flops = 2 * (fL.nb * (fL.nb + 1) // 2 + fL.WL * fL.nb) * fL.nblk
    for inst, (dT, lT, bb, bmm, Lt) in (("f32", (dT32, lT32, bw, bw_m, L32)), ("f64", (dT64, lT64, b64, bm64, L64))):
        # the plain loops walk 1024 blocks from Python: few repeats
        kernel = f"trsv_win_{inst}"
        turns(kernel, lambda: trsv_win(dT, lT, bb, fL.nb, fL.WL), lambda: trsv_win_plain(dT, lT, bb, fL.nb, fL.WL),
              kreps=(3, 2), preps=(1, 1), kwarm=1, pwarm=0)
        op_bytes = nbytes(dT, lT)
        log(f"  {kernel} (ILU0 L form, nb={fL.nb} WL={fL.WL} nblk={fL.nblk}): operand stream "
            f"{op_bytes / ms[kernel] / 1e6:.1f} GB/s ({op_bytes / ms[kernel] / 1e6 / peak:.4f} of peak {peak} GB/s; "
            f"{op_bytes / 1e6:.1f} MB per solve)")
        # the library solve re-analyses the triangle each call (seconds): the
        # first call's own time
        one = dict(once=True)
        op_need = nz_bytes(dT, lT)
        note(kernel, op_bytes + 2 * nbytes(bb), op_need + 2 * nbytes(bb), step_flops,
             lambda: torch.triangular_solve(bb[:, None], Lt, upper=False, unitriangular=True), one)
        kernel = f"trsm_win_{inst}"
        turns(kernel, lambda: trsm_win(dT, lT, bmm, fL.nb, fL.WL), lambda: trsm_win_plain(dT, lT, bmm, fL.nb, fL.WL),
              kreps=(3, 1), preps=(1, 1), kwarm=1, pwarm=0)
        note(kernel, op_bytes + 2 * nbytes(bmm), op_need + 2 * nbytes(bmm), step_flops * K_SM,
             lambda: torch.triangular_solve(bmm, Lt, upper=False, unitriangular=True), one)
        log(f"  {kernel}: K={K_SM} solve costs {ms[kernel] / ms[f'trsv_win_{inst}']:.2f}x the K=1 solve")
    del dT64, lT64, b64, bm64
    mm_flops = 2 * tm32.bwd_val.numel() * K_MM
    for inst, v, Bx, Ax in (("f32", tm32.bwd_val, Bm, A32), ("f64", tm64.bwd_val, Bm64, A64)):
        kernel = f"spmm_band_{inst}"
        turns(kernel, lambda: spmm_band(v, Bx, *targs), lambda: spmm_band_plain(v, Bx, *targs),
              kreps=(15, 5), preps=(3, 1))
        c_bytes = nbytes(Bx) * m // n
        note(kernel, nbytes(v, Bx) + c_bytes, nz_bytes(v, Bx) + c_bytes, mm_flops,
             lambda: torch.sparse.mm(Ax, Bx), dict(reps=5, inner=2))
    for inst, dt_ in (("f32", dt32), ("bf16", dtbf)):
        kernel = f"spmm_band_mxu_{inst}"
        turns(kernel, lambda: spmm_band_mxu(dt_, Bm, *targs, m), lambda: spmm_band_mxu_plain(dt_, Bm, *targs, m),
              kreps=(15, 5), preps=(3, 2))
        # the same band product as spmm_band: the windows' zero triangles
        # are stored bytes, not operations the function needs
        note(kernel, nbytes(dt_, Bm) + m * K_MM * 4, nz_bytes(dt_, Bm) + m * K_MM * 4, mm_flops,
             (lambda: torch.sparse.mm(A32, Bm)) if inst == "f32" else None, dict(reps=5, inner=2))
    H32 = csr_tensor(hptr, hind, hval, dev, torch.float32)
    H64 = csr_tensor(hptr, hind, hval, dev, torch.float64)
    for inst, dv, Bx, Hx in (("f32", hf.dia_val, Bh, H32), ("bf16", hf.dia_bf16(), Bh, None),
                             ("f64", hv64, Bh64, H64)):
        kernel = f"spmm_diag_{inst}"
        turns(kernel, lambda: spmm_diag(dv, hf.dia_offs, Bx), lambda: spmm_diag_plain(dv, hf.dia_offs, Bx),
              kreps=(15, 5), preps=(3, 1))
        c_bytes = nbytes(hf.dia_offs) + mh * K_MM * Bx.element_size()
        note(kernel, nbytes(dv, Bx) + c_bytes, nz_bytes(dv, Bx) + c_bytes, 2 * dv.numel() * K_MM,
             (lambda: torch.sparse.mm(Hx, Bx)) if Hx is not None else None, dict(reps=5, inner=2))
    del A64, H64, hv64, Bh64
    gbytes = {  # bench.py:60 useful bytes; bf16 credited as the f32 op
        "f32": ((m + 1 + nnz) * 4 + (nnz + n + m) * 4) / 1e9,
        "f64": ((m + 1 + nnz) * 4 + (nnz + n + m) * 8) / 1e9,
    }
    t_mv = cuda_ms(lambda: tt.mv(1.0, A, GEN, NONE, x32, 0.0))
    tt.set_precision_mode(A, "mixed")
    t_mv_mixed = cuda_ms(lambda: tt.mv(1.0, A, GEN, NONE, x32, 0.0))
    tt.set_precision_mode(A, "full")
    for name, t, gb in (("mv f32", t_mv, gbytes["f32"]), ("mv bf16 band", t_mv_mixed, gbytes["f32"])):
        eff = gb / (t / 1e3)
        log(f"  {name}: {t:.4f} ms/call, effective {eff:.1f} GB/s = {eff / peak:.3f} of peak "
            f"{peak} GB/s (bench.py:60 useful bytes)")
    # mm: useful bytes (m+1+nnz)*4 + (nnz + (n+m)*K)*vsize, the mv formula with K columns
    for name, handle, Bx, mrows, nz in (("mm bench (bandtm)", Amm, Bm, m, nnz), ("mm stencil (diag)", H, Bh, mh,
                                                                                 hind.size)):
        t = cuda_ms(lambda: tt.mm(1.0, handle, GEN, NONE, Bx, 0.0), reps=15, inner=5)
        eff = ((mrows + 1 + nz) * 4 + (nz + 2 * mrows * K_MM) * 4) / (t / 1e3) / 1e9
        log(f"  {name} K={K_MM} f32: {t:.4f} ms/call, effective {eff:.1f} GB/s = {eff / peak:.3f} of peak {peak} GB/s")
    t_trsm = cuda_ms(lambda: tt.trsm(1.0, C, LOWER, NONE, Bsm_d), reps=5, inner=1, warm=1)
    log(f"  trsm f32 lower K={K_SM}: {t_trsm:.4f} ms/call (one multi-RHS window solve + padding)")
    t_cg, t_cg_all = iteration_ms(lambda kk: tt.pcg_solve(C, b_d, rtol=0.0, maxit=kk)[1], 10, 60)
    log(f"  CG iteration: {t_cg:.4f} ms (host clock, median of "
        f"{[round(t, 4) for t in t_cg_all]}; includes one host read per iteration)")
    t_sm = cuda_ms(lambda: tt.ilu_smoother(C, GEN, b_d), reps=5, inner=2, warm=1)
    log(f"  ilu_smoother: {t_sm:.4f} ms/call (two window solves + reversal and padding)")
    # ILU0-PCG gains about 2.3 digits an iteration here: past ~10 fixed
    # iterations its f32 residual underflows, so the lengths stay short
    t_pcg, t_pcg_all = iteration_ms(
        lambda kk: tt.pcg_solve(C, b_d, rtol=0.0, maxit=kk, precond="ilu0")[1], 1, 6)
    log(f"  ILU0-PCG iteration: {t_pcg:.4f} ms (host clock, median of "
        f"{[round(t, 4) for t in t_pcg_all]})")
    log(f"  set-up: ilu0_factorize {t_factor:.2f} s + diagonal-block inversion {t_invert:.2f} s")

    # the spill-route kernels on the webbase spill route (after
    # update_values: the same structure, new values)
    sr = wroute
    contrib = oh_select(xs_d, sr.sel_idx, sr.sel_val, sr.sel_blk, n_out=sr.n)
    routed = apply_route(contrib, sr.masks, sr.masks_packed, sr.k)
    n_spill = wform.sp_ind.numel()
    slots = sr.n_sel_tiles * 1024
    xblk_bytes = int(torch.unique(sr.sel_blk).numel()) * 4096
    turns("oh_select_f32", lambda: oh_select(xs_d, sr.sel_idx, sr.sel_val, sr.sel_blk, n_out=sr.n),
          lambda: oh_select_plain(xs_d, sr.sel_idx, sr.sel_val, sr.sel_blk, sr.n))
    # read index and value, write the contribution (12 B a slot), each x
    # block once, the chunk's block id; one multiply a slot
    note("oh_select_f32", slots * 12 + xblk_bytes + nbytes(sr.sel_blk), n_spill * 12 + xblk_bytes, slots)
    acc_args = (sr.acc_idx, sr.acc_cid, sr.acc_start, sr.n_acc_tiles, ys_d)
    turns("oh_accum_f32", lambda: oh_accum(routed, *acc_args), lambda: oh_accum_plain(routed, *acc_args))
    real = sr.acc_cid < sr.n_acc_tiles
    blk = torch.repeat_interleave(torch.arange(sr.nyblk, device=dev),
                                  (sr.acc_start[1:] - sr.acc_start[:-1]).long())
    acc_rows = (blk[real][:, None] * 1024 + sr.acc_idx.reshape(-1, 1024)[real].long()).reshape(-1)
    acc_vals = routed[: sr.n_acc_tiles * 1024].reshape(-1, 1024)[sr.acc_cid[real].long()].reshape(-1)
    y_lib = ys_d.clone()
    # read index and contribution of every real slot (8 B), y in and out,
    # the chunk lists; one add a slot
    acc_bytes = sr.n_acc_tiles * 1024 * 8 + 2 * nbytes(ys_d) + nbytes(sr.acc_cid, sr.acc_start)
    note("oh_accum_f32", acc_bytes, n_spill * 8 + 2 * nbytes(ys_d), sr.n_acc_tiles * 1024,
         lambda: y_lib.index_add_(0, acc_rows, acc_vals))
    masks_full = route_masks(sr.masks, sr.masks_packed, sr.k)
    turns("benes_route_f32", lambda: apply_route(contrib, sr.masks, sr.masks_packed, sr.k),
          lambda: apply_benes(contrib, masks_full, sr.k), preps=(5, 2))
    perm = apply_benes(torch.arange(sr.n, dtype=torch.float32, device=dev), masks_full, sr.k).long()
    if not torch.equal(contrib[perm], routed):
        raise AssertionError("the decoded permutation does not reproduce the route")
    # v in and out, the masks once ((8 + ceil((2k-1)/8)) 2^k B for one packed network)
    route_bytes = 2 * nbytes(contrib) + nbytes(sr.masks_packed) + (0 if sr.masks is None else nbytes(sr.masks))
    note("benes_route_f32", route_bytes, route_bytes, 0, lambda: contrib[perm])
    del masks_full, perm, acc_rows, acc_vals, y_lib
    t_engine = cuda_ms(lambda: spill_route_apply(xs_d, ys_d, sr))
    t_tail = cuda_ms(lambda: ys_d.clone().index_add_(0, wform.sp_rows, wform.sp_val * xs_d[wform.sp_ind]))
    log(f"  webbase spill of {n_spill} entries: select + route + accumulate {t_engine:.4f} ms vs the gather + "
        f"index_add_ tail {t_tail:.4f} ms (the port's path below the gate)")
    t_wband = cuda_ms(lambda: band_spmv(wform.bwd_val, xs_d, wform.bandt_start, wform.bwd_padL))
    wband_bytes = nbytes(wform.bwd_val)
    log(f"  webbase band (W={wform.bwd_W}, {wband_bytes / 1e9:.3f} GB): band kernel {t_wband:.4f} ms = "
        f"{wband_bytes / t_wband / 1e6:.1f} GB/s ({wband_bytes / t_wband / 1e6 / peak:.3f} of peak)")
    # mv on the general-structure operands, against torch.sparse CSR @ x
    for name, handle, xv, (pp, ii, vv), extra in (
        ("webbase mv (gen, spill route)", Wh, xw_d, (wptr, wind, wval2), {}),
        ("webbase mv mixed (bf16 band)", Wh, xw_d, (wptr, wind, wval2), {"mixed": True}),
        ("scatter mv (route)", Qh, xq_d, (qptr, qind, qval), {}),
    ):
        if extra:
            tt.set_precision_mode(handle, "mixed")
        t = cuda_ms(lambda: tt.mv(1.0, handle, GEN, NONE, xv, 0.0), reps=9, inner=5)
        if extra:
            tt.set_precision_mode(handle, "full")
        mrows, nz = len(pp) - 1, ii.size
        useful = ((mrows + 1 + nz) * 4 + (nz + 2 * mrows) * 4) / 1e9  # bench.py:60, f32
        At = csr_tensor(pp, ii, vv, dev, torch.float32)
        t_lib, err = library_ms(lambda: At @ xv, reps=9, inner=5)
        lib_s = f"{t_lib:.4f} ms" if t_lib is not None else f"none ({err})"
        log(f"  {name}: {t:.4f} ms/call, effective {useful / (t / 1e3):.1f} GB/s = "
            f"{useful / (t / 1e3) / peak:.3f} of peak {peak} GB/s (bench.py:60 useful bytes); "
            f"torch.sparse CSR @ x {lib_s}")
        del At
    profile_mv("webbase mv (gen, spill route)", lambda: tt.mv(1.0, Wh, GEN, NONE, xw_d, 0.0))
    profile_mv("scatter mv (route)", lambda: tt.mv(1.0, Qh, GEN, NONE, xq_d, 0.0))
    t_gi, t_gi_all = iteration_ms(lambda kk: tt.pcg_solve(G, bg_d, rtol=0.0, maxit=kk)[1], 5, 25)
    log(f"  permuted-space CG iteration (symmetrised webbase): {t_gi:.4f} ms (host clock, median of "
        f"{[round(t, 4) for t in t_gi_all]})")
    phase("done")

    kernels = [
        {
            "name": kernel,
            "route": "cuda",
            "source": KERNELS[kernel][0],
            "replaces": KERNELS[kernel][1],
            "launches": launches[kernel],
            "max_abs_err": errs[kernel],
            "ms": ms[kernel],
            "plain_ms": plain_ms[kernel],
            "bound_ms": bounds[kernel][0],
            "bound_by": bounds[kernel][1],
            "library_ms": lib[kernel],
        }
        for kernel in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
