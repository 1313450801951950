#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (aoclsparse_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and g++. It
imports nothing of JAX or of the JAX package. Phases, each raising on
failure (exit code != 0, no result line):

1. require a CUDA card; print nvidia-smi's name and power limit;
2. build the kernels from aoclsparse_tpu_torch/csrc with nvcc (sm_90a) and
   the host C++ library with g++; require that the latter loads, and that
   -Xptxas -v gives the route, accumulate, block-window SpMV, group-window,
   window-solve (passes A, B, C and the bf16 rounding; every instance),
   block-window SpMM (both instances), band GEMM (both instances), band
   SpMM (every instance), diagonal SpMM (every instance), blocked-solve
   chain (every instance) and level-solve (every instance, complex
   included) kernels no stack frame and no spills (their registers logged);
3. hold each kernel instance against its plain PyTorch version:
   - the band kernel on the bench operand (m = n = 262144, 64 nnz/row,
     half-bandwidth 64, seed 7, built as bench.py:220-233) in f32, bf16
     band and f64, and on a small odd-m operand with a peel spill in f32
     and f64;
   - the group-window kernel (mv KID 5) on the bench operand's bwd form
     (W = 136, its peel spill added in the launch), on the small odd-m
     operand (W = 40), whose windows start left of column 0, and on a
     W = 8 form, in f32, bf16 band and f64, each called twice for the
     same bits;
   - the tile-major band kernels (one CTA a tile; persistent, cp.async
     double-buffered) on the bench bandt form's tile-major band (TM = 256)
     and the block-window SpMV on its block windows at the form's band
     width, in f32 and bf16, and on the small odd-m form's with start > 0
     and padL > 0 (the last tile and block ragged); the block-window SpMV
     also at W = 256 on the bench windows and on random windows at W = 1
     and 129, each at its band width called twice for the same bits;
     the streaming-read probe on the bench band slab
     (128, 262144) and on a 128 MiB buffer (bench.py:291), also against a
     float64 sum;
   - the band SpMM kernel on the bench operand's bandtm form at K = 64 in
     f32 and f64, called twice for the same bits, with its spill on the
     small odd-m operand at K = 7, and on random bands at W = 1 and at the
     cap (400 f32, 184 f64) with K = 300 and m below one tile; the bf16
     band instance (B and C f32) on the bench band rounded to bf16 and on
     random bf16 bands at W = 2 and 400;
     the block-window kernel on the bench form at K = 64 in f32 and bf16,
     told the form's band width and W = 256, and on random windows at
     W = 1, 64 and 128 (m = 4099, start > 0, padL > 0, K = 64 and 9), each
     at its band width called twice for the same bits;
   - the diagonal kernel on the 27-point stencil of HPCG's default local
     grid (104^3: m = 1,124,864, 29,791,000 nnz; hpcg.dat) at K = 64 in
     f32, bf16 and f64, called twice for the same bits, on a small odd-m
     operand with negative offsets, and on 192 diagonals, a lone far
     diagonal with offsets past +-n, and the 12^3 stencil (K = 1, 13, 300);
   - the window-solve kernels (pass A, the chain, grouped on these forms,
     and pass C, over dinvT, P = lwT @ dinvT and F) on the ILU0 L and U
     forms of the SPD operand (the bench profile symmetrised plus a
     Gershgorin diagonal shift, 25,296,970 nnz; nb = 256, WL = 64,
     nblk = 1024) in f32 and f64, with one right-hand side and with K = 16,
     logging how much the far part of a group (v F_j, j >= a + 2) weighs
     there; on operands of the same shape whose tails have a spectral norm
     of 0.95 (the far part weighs, and must), where a zeroed F must fail
     the comparison; on the ILU0 L and U forms of the 5-point 2-D
     Laplacian on a 90^2 grid (a real factor whose far part weighs:
     grouped, nb = 128, WL = 96, 64 blocks, groups of 8), in f32 and f64;
     and on a small odd-m form whose window reaches back
     over several blocks (the plain chain; K = 300 for the multi-RHS
     solve: several column chunks), each called twice for the same bits;
     and the bf16 instance (f32 P and F) on the SPD operand's ILU0 L form
     rounded to bf16, K = 1 and K = 16, against the plain version, which
     rounds where the Pallas kernels round;
   - the spill-route kernels (select, Benes route, accumulate) on the spill
     route of the webbase-1M stand-in's gen form (benchmarks/realmat.py,
     seed 7: m = 1,000,005, about 3.1M nnz; planned through its handle by
     optimize), on one stripe of the whole-matrix route of the scatter
     operand (m = 262,144, the diagonal plus 8 uniform random columns a
     row, seed 23), on a small ragged case and on a k = 7 route, each route
     in its scheduled launches (three for k = 21) and each accumulate
     repeated bit for bit; a k = 22 route, also with its passes capped at
     96 KB of shared memory (passes A and C split); the accumulate on a hot
     row (1,500 entries across a y block's two chunks, row 0 at the head)
     and on chunks whose rows are out of order;
   - the blocked-solve chain kernel (csrc/trsv_blocked.cu) on the dwin
     forms of the ILU0 L and U factors of the 104^3 stencil (f32 and f64
     handles, K = 1 and 16), on the gather forms of the scatter operand's
     lower and upper triangles (f32 and f64, K = 1 and 16), and on small
     synthetic forms (one block; a ragged last block; an offset past
     m_pad; a unit diagonal; K = 1 and 3), each called twice for the same
     bits;
   - the level-solve kernel (csrc/trsv_level.cu) on the level forms of the
     same ILU0 L and U factors (722 levels each; f32 and f64, K = 1 and 16)
     and of the scatter operand's lower and upper triangles (f32 and f64,
     K = 1 and 16), and its complex64 and complex128 instances on the level
     forms of the ILU0 factors of the stencil shifted by i I (SIGMA), K = 1
     and 16, each called twice for the same bits;
   - the band GEMM kernel (SpGEMM numeric stage) in f32 and f64 on the band
     plan of the cant stand-in's A.A (benchmarks/realmat.py:105, copied
     here, seed 7: m = 62,469, 4,108,752 nnz; G = 128, WA = WB = 560,
     WC = 1072, 5 streams), on the suite's SpGEMM operand
     (benchmarks/suite.py:712-713: m = 65,536, half-bandwidth 32, 16
     nnz/row), on a small case with m off a multiple of G and d0 > 0 (and
     on the same plan with dense random bands, where no warp step skips),
     and on one whose first groups' streams fall outside [0, nblk), each
     twice for the same bits, logging each plan's taken and skipped warp
     steps;
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
   the launch counts the composition implies (a window solve: its passes'
   launches, kernels/trsv_win.py solve_launches); then on the 104^3
   stencil, whose default mv form and strict triangles' mv forms are diag
   (the mv rule's diag branch; mv KID 6, plain spmv_diag) and where the
   default solve takes the level kernel
   (planner/triangular.py sv_engine_for): ilu0_factorize (its factors
   cached since phase 3), ilu_smoother (default: two level launches;
   kid=0: two dwin launches), pcg_solve(precond="ilu0") and ("sgs") to
   rtol 1e-6 with a true relative residual <= 1e-5 (two level launches an
   iteration, no chain launch), symgs, symgs_mv and sorv (level) against
   float64 scipy sweeps, trsv by default and kid=1
   (level kernel) and kid=2 (host engine) against kid=0 (dwin), and trsv
   on a float64 handle by default and kid=0 (the f64 level and dwin
   instances);
5b. the general-structure path, counted on its own: mv on the webbase
   stand-in (default: gen with its spill on the route; kid=7; alpha/beta;
   the mixed bf16 band; mv_operator in permuted space; update_values and a
   re-run; a float64 handle, which the planner sends to the gather
   fallback), mv on the scatter operand (the whole-matrix route), each
   against a float64 scipy reference and with the launches each call
   implies; and pcg_solve with no preconditioner on the symmetrised
   webbase, in permuted space, to a true relative residual <= 10 rtol;
   and trsv on the scatter operand's triangles (f32 lower, f64 upper) by
   default (the level kernel) and kid=0 (gather forms on the chain kernel),
   each by its float64 residual;
5c. the SpGEMM path, counted on its own, on the cant stand-in: sp2m
   request=nnz_count (no band GEMM launch; the band engine attached),
   request=finalize (one launch; the values pending), a chained mv on the
   product (no launch, still pending) against float64 scipy A (A x),
   export_csr against float64 scipy A.A on the product's pattern,
   update_values(A, 2 val) and a second finalize (4x the values), spmm and
   csr2m (one launch each), a float64 handle (the f64 instance) and syrk
   upper on the band engine; then the scatter operand's Q.Q, which no band
   plan takes, on the device expansion engine (no launch) against float64
   scipy;
5d. the formats path, counted on its own, on the bench operand at full
   size: create_coo and create_csc (export_csc) with mv through CSR,
   convert_format to BSR (block_dim 4, mv kid=3), DIA (mv kid=4) and ELL
   (mv), set_mv_hint_kid(kid=5) + optimize + mv(kid=5) in f32, the mixed
   mode and on a float64 handle (one group-window launch each), mv kid=6,
   kid=10 and kid=11 (the host engine), csrmv / diamv / bsrmv / ellmv on
   the raw arrays, each against float64 scipy; the level-1 ops on a sparse
   vector of 2^22 entries against a dense y of 2^24 against numpy; and
   write_mtx / read_mtx round trips of the cant stand-in and of a
   symmetric file of its lower triangle written by scipy.io.mmwrite;
5e. the measurement path, counted on its own (bench.py:220-350):
   create_csr -> set_mv_hint(nop=1000) -> optimize -> the bandt form, its
   tile-major band and its block windows; the two tile-major kernels and
   the block-window SpMV, each plus the peel spill, in f32 against float64
   scipy A x and with a bf16 band against docs/precision.md's bound, one
   launch a call; the streaming-read probe on the band slab against a
   float64 sum; each kernel timed by utils/profiling.py's chain_bench and
   put against the published peak by its roofline, and one profiling.trace
   written to the gitignored _smoke/trace/;
5f. the solver framework, counted on its own: on the nonsymmetric bench
   operand (the bench profile plus the SPD operand's Gershgorin shift, not
   symmetrised: bandt, ILU0 on win forms) itsol_solve GMRES with ILU0 in
   f32 and on a float64 handle, with no preconditioner at restart 4 (at
   the default 20 it converges within one cycle), pgmres_solve with
   "ilu0" and with none, itsol_rci_solve driven by hand with mv and a
   Jacobi User preconditioner, itsol_solve_operator and make_gmres_operator
   on mv (the matrix paths' iterations and x, bit for bit); on the 104^3
   stencil itsol_solve CG with "cg preconditioner" = "sgs" (within one
   iteration of pcg_solve's, its sweeps on the level kernel); on the
   webbase stand-in with the same shift (gen, spill route) pgmres_solve
   with none in permuted space (b and x0 permuted in, x out, once each):
   each to a true relative residual <= 10 rtol by a float64 scipy product,
   with the launches its counts imply (unit calls' launches times the
   solve's matvecs and preconditioner applies) and the RCI and fused
   GMRES within one restart of each other;
5g. the bf16 and complex path, counted on its own: bf16 trsv and trsm
   (K = 16) on the bench operand's lower triangle with the Gershgorin
   shift (the window solves' bf16 instance), bf16 mm at K = 64 on the bench
   operand (bandtm, the band SpMM's bf16 instance; a bf16 result), each
   against float64 scipy on the bf16 values within the bf16 model
   tolerance; on the 104^3 stencil shifted by i I in complex64 trsv,
   ilu_smoother, sorv (complex omega and alpha), ILU0-GMRES through
   pgmres_solve and itsol_solve and SGS-CG through itsol_solve (each sweep
   two launches of the level kernel's complex64 instance), trsv on a
   complex128 handle (the complex128 instance), and complex64 ILU0-GMRES on
   the shifted bench operand, whose win forms have no complex kernel
   instance: the plain block loops; each by its residual (10 rtol for the
   solvers) and its launches;
6. time kernel vs plain version vs one PyTorch library call (torch.sparse
   CSR products and triangular solves, index_add_ and a permutation
   gather, timed here as yardsticks only; each behind a device spin that
   outlasts the host's enqueue, so the events time the device alone),
   against each kernel's bound
   from this run's inputs (stored operands, and beside it their nonzero
   entries only), with the diagonal kernel's offset windows and the bytes
   it stages a call, and the band kernel's tile and rings; one mv call,
   one mm call per operand (and mm kid=5, the block windows, on the bench
   operand), one trsm call,
   one CG iteration, one ilu_smoother call and one ILU0-PCG iteration with
   CUDA events or the host clock (median of repeats), with stream rates
   against the card's published HBM peak, the window solves' passes by a
   profiler window (each launch's device time, bytes and rate, the chains'
   time a step) beside the same solve with the plain chain, and the
   set-up seconds of ilu0_factorize, of the diagonal-block inversion and of
   P and F; the route and the accumulate also cold (after writing
   a 128 MiB buffer) beside their library calls; the spill-route engine
   against the gather + index_add_ tail (call and device time), the webbase
   band kernel alone, mv on the webbase and
   scatter operands with a profiler window each (device time by kernel,
   idle share), and one permuted-space CG iteration; the band GEMM kernel
   against its plain version and cuSPARSE SpGEMM (torch.sparse CSR @ CSR),
   a finalize, the extraction gather and the chained mv on the band, and
   the host seconds of the symbolic stage and of the band relayout; a
   finalize of Q.Q on the device expansion engine against the host engine
   (pinned) and cuSPARSE SpGEMM; the group-window kernel in each instance
   against its plain version and cuSPARSE CSR @ x, warm and cold (after
   writing a 128 MiB buffer), and one mv(kid=5) call and one mv call on
   each format's handle; the tile-major kernels and the block-window SpMV
   against their plain version and cuSPARSE CSR @ x (the block windows
   warm and cold, their bound over the parallelogram they need); the
   read probe on the 128 MiB buffer and on the band slab against its plain
   version and torch.sum; the chain kernel's dwin (stencil ILU0 L) and
   gather (scatter lower) instances and the level kernel on the same
   triangles against their plain versions and torch.triangular_solve on
   the CSR triangle, the level kernel's dependency round trip (a
   bidiagonal chain, one level a row) and the sv gate's constants (us a
   level, us a chain step) as measured, the level kernel's complex
   instances on the complex stencil's ILU0 L beside cuSPARSE's complex
   solve, mv KID 6 (the plain spmv_diag) on the stencil beside its bound
   and cuSPARSE, the complex plain win route (one bench ILU0 L solve), the
   window solves' bf16 instances (no library call) and the band SpMM's
   (beside cuSPARSE's f32 product on the bf16-rounded values), the
   stencil's trsv by kid, its
   ilu_smoother by default and kid=0, ILU0-/SGS-PCG iteration times by the
   level kernel and, in turn, with the gate closed (the chain kernel), the
   CG iteration, and profiles of the default solve and of ILU0-PCG
   iterations (and profiles of SGS-PCG and CG iterations, with the idle
   share); the solver framework's iterations (ILU0-GMRES and GMRES by
   pgmres_solve on the nonsymmetric bench operand, itsol SGS-CG on the
   stencil, permuted GMRES on the shifted webbase: the difference of two
   fixed-length solves, whole cycles) and a profile of two ILU0-GMRES
   cycles.

Launch counts are reset just before phase 4 and read after phase 5, reset
again just before phase 5b and read after it, and again around phases 5c,
5d, 5e, 5f and 5g (the kernels line takes the spill-route kernels' counts
from 5b, the band GEMM's from 5c, the group-window kernel's from 5d, the
measurement path's kernels' from 5e and the bf16 and complex instances'
from 5g; the gather instances of the chain kernel count in 5b, its dwin
instances and the level kernel's real ones on the main path; 5f launches
only kernels counted before, and checks its own counts). The second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import statistics
from pathlib import Path
import subprocess
import sys
import time
import warnings

import numpy as np
import scipy.io
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import interop, native
from aoclsparse_tpu_torch.kernels import build
from aoclsparse_tpu_torch.kernels.band_gemm import band_gemm, band_gemm_plain, band_gemm_steps
from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv, band_spmv_plain, spmv_bandt
from aoclsparse_tpu_torch.kernels.band_tiles import (
    band_spmv_tiles,
    band_spmv_tiles_dbuf,
    band_spmv_tiles_plain,
    spmv_bandt_tiles,
)
from aoclsparse_tpu_torch.kernels import benes as benes_mod
from aoclsparse_tpu_torch.kernels import trsv_win as trsv_win_mod
from aoclsparse_tpu_torch.kernels.benes import benes_apply, benes_apply_plain, benes_route, benes_route_plain, route_passes
from aoclsparse_tpu_torch.kernels.route import apply_benes, apply_route, pack_masks, plan_route_arrays, route_masks
from aoclsparse_tpu_torch.kernels.spill_route import oh_accum, oh_accum_plain, oh_select, oh_select_plain
from aoclsparse_tpu_torch.kernels.spmm_band import (
    BAND_JC,
    BAND_RING,
    BAND_STAGES,
    BAND_TM,
    band_max_w,
    band_mxu_blocks,
    mxu_walk,
    spmm_band,
    spmm_band_mxu,
    spmm_band_mxu_plain,
    spmm_band_plain,
    spmm_bandtm,
)
from aoclsparse_tpu_torch.kernels.spgemm_band import build_band_gemm_plan, extract_values
from aoclsparse_tpu_torch.kernels.plain_spmv import spmv_diag
from aoclsparse_tpu_torch.kernels.spmm_diag import diag_schedule, spmm_diag, spmm_diag_plain
from aoclsparse_tpu_torch.kernels.spmv_bwd import spmv_bwd, spmv_bwd_plain
from aoclsparse_tpu_torch.kernels.spmv_mxu import spmv_band_mxu, spmv_band_mxu_plain, spmv_bandmxu
from aoclsparse_tpu_torch.kernels.stream_read import stream_read, stream_read_plain
from aoclsparse_tpu_torch.io import read_mtx, write_mtx
from aoclsparse_tpu_torch.kernels.trsv_blocked import trsv_dwin, trsv_dwin_plain, trsv_gather, trsv_gather_plain
from aoclsparse_tpu_torch.kernels.trsv_level import build_level_form, trsv_level, trsv_level_plain
from aoclsparse_tpu_torch.kernels.trsv_win import (
    chain_group,
    chain_plan,
    solve_launches,
    trsm_chunk,
    trsm_win,
    trsm_win_plain,
    trsv_win,
    trsv_win_plain,
    win_solve_operands,
)
from aoclsparse_tpu_torch.ops.level2.mv import _spill_route_on
from aoclsparse_tpu_torch.ops.level3.spgemm import _effective
from aoclsparse_tpu_torch.planner.spill_route import build_spill_route, spill_route_apply
from aoclsparse_tpu_torch.planner import triangular as ttri
from aoclsparse_tpu_torch.planner.triangular import invert_diag_blocks, trsv_form_for
from aoclsparse_tpu_torch.solvers import fused as fused_mod
from aoclsparse_tpu_torch.solvers.ilu import _factor_nlev, _level_forms, ilu0_factorize
from aoclsparse_tpu_torch.utils import profiling
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
    "band_gemm_f32": ("aoclsparse_tpu_torch/csrc/band_gemm.cu",
                      "aoclsparse_tpu/kernels/pallas/spgemm.py:38"),  # pallas_band_gemm
    "band_gemm_f64": ("aoclsparse_tpu_torch/csrc/band_gemm.cu",
                      "aoclsparse_tpu/kernels/pallas/spgemm.py:38"),
    # pallas_spmv_bwd, mv KID 5
    "spmv_bwd_f32": ("aoclsparse_tpu_torch/csrc/spmv_bwd.cu", "aoclsparse_tpu/kernels/pallas/spmv.py:1093"),
    "spmv_bwd_bf16": ("aoclsparse_tpu_torch/csrc/spmv_bwd.cu", "aoclsparse_tpu/kernels/pallas/spmv.py:1093"),
    "spmv_bwd_f64": ("aoclsparse_tpu_torch/csrc/spmv_bwd.cu", "aoclsparse_tpu/kernels/pallas/spmv.py:1093"),
    # pallas_spmv_band_vc (tile-major band) and pallas_spmv_band_vd (its
    # band double-buffered by manual DMA)
    "band_spmv_tiles_f32": ("aoclsparse_tpu_torch/csrc/band_spmv_tiles.cu",
                            "aoclsparse_tpu/kernels/pallas/spmv.py:708"),
    "band_spmv_tiles_bf16": ("aoclsparse_tpu_torch/csrc/band_spmv_tiles.cu",
                             "aoclsparse_tpu/kernels/pallas/spmv.py:708"),
    "band_spmv_tiles_dbuf_f32": ("aoclsparse_tpu_torch/csrc/band_spmv_tiles.cu",
                                 "aoclsparse_tpu/kernels/pallas/spmv.py:791"),
    "band_spmv_tiles_dbuf_bf16": ("aoclsparse_tpu_torch/csrc/band_spmv_tiles.cu",
                                  "aoclsparse_tpu/kernels/pallas/spmv.py:791"),
    # pallas_spmv_band_mxu (block windows)
    "spmv_band_mxu_f32": ("aoclsparse_tpu_torch/csrc/spmv_mxu.cu", "aoclsparse_tpu/kernels/pallas/spmv.py:1019"),
    "spmv_band_mxu_bf16": ("aoclsparse_tpu_torch/csrc/spmv_mxu.cu", "aoclsparse_tpu/kernels/pallas/spmv.py:1019"),
    # pallas_stream_read (the read-rate probe)
    "stream_read_f32": ("aoclsparse_tpu_torch/csrc/stream_read.cu", "aoclsparse_tpu/kernels/pallas/spmv.py:364"),
    # the chain of the dwin and gather blocked solves: the JAX package runs
    # them as XLA scans (trsv_blocked_dwin, trsv_blocked), no Pallas kernel
    "trsv_dwin_f32": ("aoclsparse_tpu_torch/csrc/trsv_blocked.cu", "aoclsparse_tpu/kernels/xla/trsv.py:103"),
    "trsv_dwin_f64": ("aoclsparse_tpu_torch/csrc/trsv_blocked.cu", "aoclsparse_tpu/kernels/xla/trsv.py:103"),
    "trsv_gather_f32": ("aoclsparse_tpu_torch/csrc/trsv_blocked.cu", "aoclsparse_tpu/kernels/xla/trsv.py:152"),
    "trsv_gather_f64": ("aoclsparse_tpu_torch/csrc/trsv_blocked.cu", "aoclsparse_tpu/kernels/xla/trsv.py:152"),
    # the level-scheduled solve (sv KID 1): the JAX package runs it as XLA
    # level loops (_solve_levels_jit, _solve_runs_jit), no Pallas kernel
    "trsv_level_f32": ("aoclsparse_tpu_torch/csrc/trsv_level.cu", "aoclsparse_tpu/kernels/xla/trsv_level.py:138"),
    "trsv_level_f64": ("aoclsparse_tpu_torch/csrc/trsv_level.cu", "aoclsparse_tpu/kernels/xla/trsv_level.py:138"),
    # the bf16 instances of the window solves (#12-#14) and of the band
    # SpMM (#8), and the complex instances of the level solve
    "trsv_win_bf16": ("aoclsparse_tpu_torch/csrc/trsv_win.cu",
                      "aoclsparse_tpu/kernels/pallas/trsv.py:74, aoclsparse_tpu/kernels/pallas/trsv.py:114"),
    "trsm_win_bf16": ("aoclsparse_tpu_torch/csrc/trsv_win.cu", "aoclsparse_tpu/kernels/pallas/trsv.py:160"),
    "spmm_band_bf16": ("aoclsparse_tpu_torch/csrc/spmm_band.cu", "aoclsparse_tpu/kernels/pallas/spmv.py:173"),
    "trsv_level_c64": ("aoclsparse_tpu_torch/csrc/trsv_level.cu", "aoclsparse_tpu/kernels/xla/trsv_level.py:138"),
    "trsv_level_c128": ("aoclsparse_tpu_torch/csrc/trsv_level.cu", "aoclsparse_tpu/kernels/xla/trsv_level.py:138"),
}
#: the kernels of the general-structure path (phase 5b), counted there
GEN_PATH = ("oh_select_f32", "oh_accum_f32", "benes_route_f32", "trsv_gather_f32", "trsv_gather_f64")
#: the kernels of the SpGEMM path (phase 5c), counted there
SPGEMM_PATH = ("band_gemm_f32", "band_gemm_f64")
#: the kernels of the formats path (phase 5d), counted there
FORMATS_PATH = ("spmv_bwd_f32", "spmv_bwd_bf16", "spmv_bwd_f64")
#: the kernels of the measurement path (phase 5e), counted there
MEASURE_PATH = ("band_spmv_tiles_f32", "band_spmv_tiles_bf16", "band_spmv_tiles_dbuf_f32",
                "band_spmv_tiles_dbuf_bf16", "spmv_band_mxu_f32", "spmv_band_mxu_bf16", "stream_read_f32")
#: the kernels of the bf16 and complex path (phase 5g), counted there
LOWPREC_PATH = ("trsv_win_bf16", "trsm_win_bf16", "spmm_band_bf16", "trsv_level_c64", "trsv_level_c128")
#: the complex stencil of phases 3, 5g and 6: HPCG's operand shifted by
#: i SIGMA I, the shifted-Laplacian setting of Helmholtz preconditioning
SIGMA = 1.0
#: the solver framework's path (phase 5f), counted there
SOLVER_PATH = ("band_spmv_f32", "band_spmv_f64", "trsv_win_f32", "trsv_win_f64", "trsv_level_f32", "oh_select_f32",
               "oh_accum_f32", "benes_route_f32")
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
    "band_gemm": band_gemm.launches,
    "spmv_bwd": spmv_bwd.launches,
    "band_spmv_tiles": band_spmv_tiles.launches,
    "band_spmv_tiles_dbuf": band_spmv_tiles_dbuf.launches,
    "spmv_band_mxu": spmv_band_mxu.launches,
    "stream_read": stream_read.launches,
    "trsv_dwin": trsv_dwin.launches,
    "trsv_gather": trsv_gather.launches,
    "trsv_level": trsv_level.launches,
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
    # the same products summed in another order (exact f32 / f64 FMA)
    "band_gemm_f32": expected_precision(torch.float32),
    "band_gemm_f64": expected_precision(torch.float64),
    # the same products (and spill terms) summed in another order; bf16: the
    # same bf16 band values accumulated in f32 on both sides
    "spmv_bwd_f32": expected_precision(torch.float32),
    "spmv_bwd_bf16": expected_precision(torch.float32),
    "spmv_bwd_f64": expected_precision(torch.float64),
    # the same products summed in another order; bf16: the same bf16 band
    # values (and, for the block windows, x rounded to bf16 on both sides)
    # accumulated in f32
    "band_spmv_tiles_f32": expected_precision(torch.float32),
    "band_spmv_tiles_bf16": expected_precision(torch.float32),
    "band_spmv_tiles_dbuf_f32": expected_precision(torch.float32),
    "band_spmv_tiles_dbuf_bf16": expected_precision(torch.float32),
    "spmv_band_mxu_f32": expected_precision(torch.float32),
    "spmv_band_mxu_bf16": expected_precision(torch.float32),
    # the same f32 values summed in f32 in another order
    "stream_read_f32": expected_precision(torch.float32),
    # the same products summed in another order (the slices of a step's
    # sums meet in a fixed order), the dtype's model tolerance
    "trsv_dwin_f32": expected_precision(torch.float32),
    "trsv_dwin_f64": expected_precision(torch.float64),
    "trsv_gather_f32": expected_precision(torch.float32),
    "trsv_gather_f64": expected_precision(torch.float64),
    # the same products summed in another order (32 lanes a row meeting in
    # a fixed butterfly), the dtype's model tolerance
    "trsv_level_f32": expected_precision(torch.float32),
    "trsv_level_f64": expected_precision(torch.float64),
    # the kernel sums in f32 over the bf16 operands and rounds the window and
    # x; the plain version rounds each product as the Pallas kernel does:
    # four bf16 units in the last place (2^-5), far inside the bf16 model
    # tolerance (0.5); the two differ by one rounding of x on the emulated
    # operands (tests/test_torch_win_solve_passes.py) and on the SPD ILU0 L
    "trsv_win_bf16": 4 * 2.0**-7,
    "trsm_win_bf16": 4 * 2.0**-7,
    # the same bf16 band values and f32 B, f32 sums in another order
    "spmm_band_bf16": expected_precision(torch.float32),
    # complex multiply-adds in another order (a fixed butterfly): the
    # model tolerance of the real part's dtype
    "trsv_level_c64": expected_precision(torch.complex64),
    "trsv_level_c128": expected_precision(torch.complex128),
}
#: mv and mm against the float64 reference: the operand dtype's model tolerance
MV_TOL = {"f32": expected_precision(torch.float32), "f64": expected_precision(torch.float64)}
#: peak operation rates for bound_ms, by operand type (NVIDIA H100 SXM data
#: sheet, dense, no sparsity), the highest at the type's full precision:
#: f32 outside the tensor cores (they take f32 only as TF32), f64 on the
#: tensor cores (full-IEEE f64 FMA, 67 TFLOP/s; 34 outside them), bf16 on
#: the tensor cores: the least time the card could take, whatever the kernel
#: itself uses
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "f64": 67e12, "c64": 67e12, "c128": 67e12}
#: a dtype's instance name in the kernels' names
INST = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16", torch.complex64: "c64",
        torch.complex128: "c128"}
K_MM = 64  # the SpMM right-hand sides of phases 3, 4 and 6
K_SM = 16  # the trsm right-hand sides of phases 3, 5 and 6
SEED_B = 23  # B of the SpMM phases
SEED_STRONG = 31  # the window solves' strong-tail operands (phase 3)
TM_TILES = 256  # the tile of the tile-major band (phases 3, 5e and 6)
#: device spin a call ahead of a kernel's timed calls (cuda_ms backlog):
#: about 0.2 ms at the H100's 1.98 GHz boost clock, more than the host takes
#: to enqueue one wrapper call
SLEEP_CYCLES = 400_000
COLD_VALUES = 32 * 1024 * 1024  # the read probe's 128 MiB f32 buffer (bench.py:291)


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


def bwd_args(form):
    """The kernel wrapper's arguments after (band, x) for a bwd form."""
    return (form.bwd_base8, form.bwd_padL, form.m, form.sp_val, form.sp_ind, form.sp_rows, form.sp_gptr)


def plain_bwd(band, x, form):
    """The bwd form's contract, spill included, in the plain version."""
    return spmv_bwd_plain(band, x, form.bwd_base8, form.bwd_padL, form.m, form.sp_val, form.sp_ind, form.sp_rows)


def bwd_desc(form):
    return (f"m={form.m} nblk={form.bwd_val.shape[0]} W={form.bwd_W} window start {form.bwd_rel} "
            f"base8={form.bwd_base8} padL={form.bwd_padL} spilled={form.sp_ind.numel() if form.has_spill else 0} "
            f"band {nbytes(form.bwd_val) / 1e6:.1f} MB")


def diagonal_operand(m=8193, n_far=10, seed=29):
    """The diagonal plus n_far far entries: a bwd form of W = 8 whose far
    entries the planner peels into a spill (past 4096 entries, and under
    0.25 % of them): (ptr, ind, val f64, x f64)."""
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, m, n_far)
    fc = (fr + rng.integers(m // 4, m // 2, n_far)) % m
    d = np.arange(m)
    S = sp.csr_matrix((rng.standard_normal(m + n_far), (np.r_[d, fr], np.r_[d, fc])), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data, rng.standard_normal(m)


def spd_operand(ptr, ind, val, m):
    """The bench profile symmetrised plus a Gershgorin diagonal shift (SPD):
    (scipy CSR with the f32-rounded values in f64, ptr, ind, val f32)."""
    S = sp.csr_matrix((val.astype(np.float64), ind, ptr), shape=(m, m))
    Ssym = ((S + S.T) * 0.5).tocsr()
    return shifted_operand(Ssym.indptr, Ssym.indices, Ssym.data, m)


def shifted_operand(ptr, ind, val, m):
    """The operand plus a Gershgorin diagonal shift (each diagonal entry its
    row's absolute sum plus 1): strictly row-diagonally dominant, and
    nonsymmetric unless the operand is symmetric. (scipy CSR with the
    f32-rounded values in f64, ptr, ind, val f32)."""
    S = sp.csr_matrix((np.asarray(val, dtype=np.float64), ind, ptr), shape=(m, m))
    S = (S + sp.diags(np.asarray(abs(S).sum(axis=1)).ravel() + 1.0)).tocsr()
    S.sort_indices()
    val32 = S.data.astype(np.float32)
    S32 = sp.csr_matrix((val32.astype(np.float64), S.indices, S.indptr), shape=(m, m))
    return S32, S.indptr.astype(np.int64), S.indices.astype(np.int32), val32


def laplacian_2d(nx):
    """CSR (ptr, ind, val f64) of the 5-point 2-D Laplacian on an nx x nx
    grid (4 on the diagonal, -1 to each grid neighbour)."""
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    L = (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()
    L.sort_indices()
    return L.indptr.astype(np.int32), L.indices.astype(np.int32), L.data


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


def strong_tail_operands(nblk, nb, WL, seed, dev, rho=0.95):
    """Window-solve operands (Dinv lower triangular, lwT; f64 on dev) whose
    tails T_k = P_k[:, nb - WL:] of P = lwT @ dinvT are rho Q_k, Q_k random
    orthogonal (WL <= nb): ||T_k||_2 = rho, so a group's products keep
    ||F_j|| = rho^(j-a+1) (0.19 after 32 blocks) and a fault in the far part
    of a group shows. Dinv = I + small lower-triangular noise."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    dinv = (torch.eye(nb, dtype=f64) + torch.tril(torch.randn(nblk, nb, nb, generator=g, dtype=f64)) * (0.3 / nb))
    P = torch.randn(nblk, WL, nb, generator=g, dtype=f64) * (0.3 / WL)
    P[:, :, nb - WL :] = rho * torch.linalg.qr(torch.randn(nblk, WL, WL, generator=g, dtype=f64))[0]
    dinv, P = dinv.to(dev), P.to(dev)
    # lwT dinvT = P: Dinv lwT^T = P^T
    lwT = torch.linalg.solve_triangular(dinv, P.transpose(1, 2), upper=False).transpose(1, 2).contiguous()
    return dinv, lwT


def far_weight(ops, x, nb, WL):
    """What the far part of a group adds in a grouped window solve: max |v F_j|
    over the blocks j >= a + 2 of the groups after the first (a the group's
    first block, v its window: the chain rows of block a - 1 in the solve x),
    over max(max |x|, 1); 0 for a solve that is not grouped."""
    s, nblk = ops.group, ops.P.shape[0]
    if not s:
        return 0.0
    X = x.reshape(nblk, nb, -1).double()
    j = torch.arange(s, nblk, device=x.device)
    a = j // s * s
    j, a = j[j - a >= 2], a[j - a >= 2]
    far = (ops.F[j].double().transpose(1, 2) @ X[a - 1, nb - WL :]).abs().max()
    return float(far) / max(float(X.abs().max()), 1.0)


def tail_norm(ops, nb, WL, pick="max"):
    """The largest (or, pick="min", the smallest) spectral norm of the
    blocks' chain maps T_k = P_k[:, nb - min(WL, nb):]."""
    T = ops.P[:, :, nb - min(WL, nb) :].double()
    return float(getattr(torch.linalg.matrix_norm(T, ord=2), pick)())


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


def _grid_block_mesh(dims, dof, neigh_offsets, rng, corner_frac=0.0):
    """dof-per-node mesh on a structured grid (benchmarks/realmat.py:76-102):
    every node couples all its dof to all of each neighbour's at the given
    grid offsets; a random fraction of the corner offsets is kept."""
    nx, ny, nz = dims
    nn = nx * ny * nz
    idx = np.arange(nn, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    src, dst = [], []
    for (dx, dy, dz, is_corner) in neigh_offsets:
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
        if is_corner and corner_frac < 1.0:
            ok = ok & (rng.random(nn) < corner_frac)
        j = jx + nx * (jy + ny * jz)
        src.append(idx[ok])
        dst.append(j[ok])
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    di = np.arange(dof, dtype=np.int64)
    r = (src[:, None, None] * dof + di[None, :, None]) + 0 * di[None, None, :]
    c = (dst[:, None, None] * dof + di[None, None, :]) + 0 * di[None, :, None]
    return r.ravel(), c.ravel()


def cant(rng, diag_boost=0.0):
    """The Williams/cant stand-in of benchmarks/realmat.py:105-132 (copied,
    so that this script imports nothing outside the port; a CPU test holds
    the copy equal for seed 7): 3-dof nodes on a 631 x 11 x 3 cantilever
    grid, n = 62,469, a 19-point neighbourhood, a second ring along the
    beam axis and a fraction of the corners, symmetric values:
    (m, n, ptr, ind, val f32)."""
    offsets = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                dist = abs(dx) + abs(dy) + abs(dz)
                if dist == 0:
                    continue
                offsets.append((dx, dy, dz, dist == 3))
    for dz in (-2, 2):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                offsets.append((dx, dy, dz, True))
    r, c = _grid_block_mesh((3, 11, 631), 3, offsets, rng, corner_frac=0.43)
    m = 631 * 11 * 3 * 3
    return _finish(r, c, m, m, rng, diag_boost, sym_vals=True)


def suite_banded(rng, m, n, half_bw, row_nnz, dtype=np.float32):
    """The banded generator of benchmarks/suite.py:37-52 (copied; a CPU test
    holds it equal): row_nnz - 1 random columns in a window of 2 half_bw
    plus the diagonal, duplicates nudged: (ptr, ind, val)."""
    win = 2 * half_bw
    base = np.clip(np.arange(m) - half_bw, 0, n - win)
    pick = np.argsort(rng.random((m, win)), axis=1)[:, : row_nnz - 1]
    cols = base[:, None] + pick
    cols = np.concatenate([cols, np.minimum(np.arange(m), n - 1)[:, None]], axis=1)
    cols = np.sort(cols, axis=1)
    dup = np.concatenate([np.zeros((m, 1), bool), cols[:, 1:] == cols[:, :-1]], axis=1)
    cols[dup] += 1
    cols = np.sort(np.clip(cols, 0, n - 1), axis=1)
    ptr = np.arange(m + 1, dtype=np.int64) * cols.shape[1]
    val = rng.standard_normal(cols.size).astype(dtype)
    return ptr, cols.reshape(-1).astype(np.int32), val


def offset_band(m, lo, hi, per, seed):
    """`per` columns a row drawn from [row + lo, row + hi] (clipped, the
    duplicates summed): (ptr, ind, val f32)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), per)
    c = r + rng.integers(lo, hi + 1, r.size)
    keep = (c >= 0) & (c < m)
    S = sp.csr_matrix((rng.standard_normal(int(keep.sum())), (r[keep], c[keep])), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data.astype(np.float32)


def gemm_plan(label, ptr, ind, val, force=False):
    """The band plan of A.A at the card's G = 128 through a handle on the
    card, its operand bands filled: (plan, P, nnzC, pattern s, relayout s)."""
    m = len(ptr) - 1
    eff = _effective(tt.create_csr(m, m, ptr, ind, val, device="cuda"), GEN, NONE)
    t0 = time.perf_counter()
    Cp, Ci, P = native.spgemm_pattern(m, eff.ptr, eff.ind, eff.ptr, eff.ind)
    t_pat = time.perf_counter() - t0
    t0 = time.perf_counter()
    bp = build_band_gemm_plan(eff, eff, Cp.astype(np.int32), Ci, G=128, force=force)
    if bp is None:
        raise AssertionError(f"{label}: the operands gave no band plan")
    bp.formA.refresh(eff.val)
    bp.formB.refresh(eff.val)
    torch.cuda.synchronize()
    t_relay = time.perf_counter() - t0
    log(f"  {label}: m={m} nnz={ind.size} P={P} nnzC={Ci.size}; G={bp.G} WA={bp.WA} WB={bp.WB} WC={bp.WC} "
        f"d0={bp.d0} sl0={bp.sl0} nstream={bp.nstream} nblk={bp.nblk} ranges={bp.stream_ranges}; "
        f"pattern {t_pat:.2f} s, band relayout {t_relay:.2f} s")
    return bp, P, int(Ci.size), t_pat, t_relay


def csr_keys(ptr, ind, m):
    """row * m + col of each stored entry (sorted for a sorted CSR)."""
    return np.repeat(np.arange(len(ptr) - 1, dtype=np.int64), np.diff(ptr)) * m + np.asarray(ind, np.int64)


def on_pattern(ptr, ind, ref, m):
    """The float64 scipy product `ref` read on the pattern (ptr, ind): scipy
    drops entries that sum to exactly zero, which read as zero here."""
    ref = ref.tocsr()
    ref.sort_indices()
    keys = csr_keys(ptr, ind, m)
    rkeys = csr_keys(ref.indptr, ref.indices, m)
    pos = np.searchsorted(keys, rkeys)
    if not (np.all(pos < keys.size) and np.array_equal(keys[np.minimum(pos, keys.size - 1)], rkeys)):
        raise AssertionError("scipy's product has entries outside the computed pattern")
    out = np.zeros(keys.size)
    out[pos] = ref.data
    return out


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
    """Launches of the route kernel in one apply of SpillRoute `sr`: one a
    pass of kernels/benes.py route_passes over the whole plan (three where
    k > TILE_LOG, one below)."""
    if sr.masks_packed is None:
        return 0
    d = int(sr.masks_packed.shape[0]).bit_length() - 1
    return len(route_passes(sr.k, d, smem=benes_mod.PASS_SMEM))


def ptxas_resources(ptxas_log, names):
    """{function: (bytes of stack frame, of spill stores, of spill loads,
    registers)} from nvcc -Xptxas -v output, for the kernels whose mangled
    name holds one of `names`."""
    out, fn = {}, None
    for line in ptxas_log.splitlines():
        if "Function properties for" in line:
            fn = line.rsplit(" ", 1)[-1]
            fn = fn if any(nm in fn for nm in names) else None
        elif fn is not None and "bytes stack frame" in line:
            out[fn] = [int(t) for t in line.replace(",", " ").split() if t.isdigit()][:3] + [None]
        elif fn is not None and "Used" in line and "registers" in line:
            out[fn][3] = int(line.split("Used")[1].split()[0])
            fn = None
    return {k: tuple(v) for k, v in out.items()}


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


def ratio(a, b):
    """a / b to four places, "none" where a is None (no library time)."""
    return "none" if a is None else f"{a / b:.4f}"


def level_bytes(form, b):
    """Bytes a level solve must move: its compact CSR (lrow, lptr, lcol,
    lval, dinv) and b read once, x written once."""
    return nbytes(form.lrow, form.lptr, form.lcol, form.lval, form.dinv, b) + b.numel() * b.element_size()


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


def host64(t):
    """A tensor on the host in float64 (complex128 for a complex one)."""
    return t.detach().to(torch.complex128 if t.is_complex() else torch.float64).cpu().numpy()


def compare(kernel, label, got, want, errs):
    torch.cuda.synchronize()
    g, w = host64(got), host64(want)
    if not (np.all(np.isfinite(g)) and g.shape == w.shape):
        raise AssertionError(f"{kernel} {label}: non-finite or misshapen kernel output")
    rel = near_error(g, w)
    abs_err = float(np.max(np.abs(g - w))) if g.size else 0.0
    errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
    tol = KERNEL_TOL[kernel]
    log(f"  {kernel} {label}: max rel err {rel:.3e} (tol {tol:.3e}) max abs {abs_err:.3e}")
    if not rel <= tol:
        raise AssertionError(f"{kernel} {label}: kernel disagrees with its plain version")


def same_bits(kernel, label, call):
    """Two calls of a kernel: the same bits (a fixed sum order, no atomics).
    Returns the first result."""
    a, b = call(), call()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{kernel} {label}: two calls differ")
    return a


def check_mv(name, got, ref, tol):
    g = host64(got)
    if not (np.all(np.isfinite(g)) and g.shape == ref.shape):
        raise AssertionError(f"{name}: non-finite or misshapen mv output")
    err = near_error(g, ref)
    log(f"  {name}: max rel err vs f64 reference {err:.3e} (tol {tol:.3e})")
    if err > tol:
        raise AssertionError(f"{name}: mv disagrees with the float64 reference")


def check_residual(name, T, x, b, tol):
    """||T x - b|| / ||b|| in float64 with scipy, against `tol`."""
    xh = host64(x)
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
    Xh = host64(X)
    if not (np.all(np.isfinite(Xh)) and Xh.shape == B.shape):
        raise AssertionError(f"{name}: non-finite or misshapen output")
    res = float(np.max(np.linalg.norm(T @ Xh - B, axis=0) / np.linalg.norm(B, axis=0)))
    log(f"  {name}: worst column relative residual {res:.3e} (tol {tol:.1e})")
    if not res <= tol:
        raise AssertionError(f"{name}: residual above tolerance")


def cuda_ms(fn, reps=15, inner=10, warm=3, backlog=False):
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    by CUDA events, after `warm` warm-up calls: a call's time, which is the
    host's enqueue time where the host is slower than the device. backlog:
    the device first spins SLEEP_CYCLES a call (torch.cuda._sleep) while
    the host enqueues the calls, so that the events time the device's work
    alone: a kernel's time."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if backlog:
            torch.cuda._sleep(SLEEP_CYCLES * inner)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return statistics.median(times)


def cold_ms(fn, flush, reps=15):
    """Median device time of one call right after `flush` (a buffer larger
    than the 50 MB L2) is written, by CUDA events, each behind a device spin
    that outlasts the host's enqueue of the flush and the call."""
    fn()
    torch.cuda.synchronize()
    ev = []
    for r in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2 * SLEEP_CYCLES)
        flush.fill_(float(r))
        t0.record()
        fn()
        t1.record()
        ev.append((t0, t1))
    torch.cuda.synchronize()
    return statistics.median(t0.elapsed_time(t1) for t0, t1 in ev)


def profile_mv(name, call, calls=5, top=8):
    """One torch.profiler window over `calls` back-to-back calls after a
    warm-up: device time per call by kernel, and the device's idle share of
    the calls' host-clock time (kernels on one stream do not overlap). The
    profiler may miss a window's first kernel, so one untimed call opens the
    window, and only device events that start inside the timed calls'
    record_function range count (the range's own annotation on the device
    track excepted)."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
        with torch.profiler.record_function("timed calls"):
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    mark = next((e for e in events if e.name == "timed calls"), None)
    by_kernel = {}
    for e in events:
        if (mark is not None and e.device_type == torch.autograd.DeviceType.CUDA and e.name != mark.name
                and e.time_range.start >= mark.time_range.start and e.time_range.elapsed_us() > 0):
            t, c = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    if not by_kernel:
        log(f"  {name} profile: the profiler recorded no device time (not measured)")
        return
    busy = sum(t for t, _c in by_kernel.values())
    log(f"  {name} profile ({calls} calls): device busy {busy / calls:.1f} us a call of {wall_us / calls:.1f} us "
        f"on the host clock, idle share {1 - busy / wall_us:.3f}; {sum(c for _t, c in by_kernel.values()) / calls:g} "
        f"kernel launches a call; by kernel (us a call):")
    for key, (t, c) in sorted(by_kernel.items(), key=lambda r: -r[1][0])[:top]:
        log(f"    {t / calls:9.1f}  x{c / calls:<4g} {key[:90]}")


def win_passes(kernel, call, form, K, itemsize, calls=5, rounds=False):
    """One torch.profiler window over `calls` window solves: each launch's
    device time a solve, in launch order (pass A; the chain, or for a
    grouped solve pass L, the group chain and the fix-up F; pass C; the
    bf16 instance's rounding, `rounds`), the chains' time a dependent step,
    and the bytes each pass reads and writes with their rate: A dinvT's
    upper triangle, B and X; a chain its steps' WL x R operand tails and R
    rows of X read and written a step; F the prefix products, the windows
    and the rows; C P's other columns, the windows and X's other rows; the
    rounding X's f32 work copy read and its bf16 values written (counted in
    `itemsize` values: the bf16 instance's are its f32 sums')."""
    nblk, nb, WL = form.nblk, form.nb, form.WL
    R = min(WL, nb)
    r0 = nb - R
    s = chain_group(nblk, nb, WL)
    full = nblk // s if s else 0
    nf = nblk - s - max(full - 1, 0) if s else 0  # blocks the fix-up F takes
    # (label, kernel, values read and written, dependent steps)
    passes = [("A", "win_block", (nblk * nb * (nb + 1) // 2 + 2 * nblk * nb * K), 0)]
    passes.append(("L (each group's chain)" if s else "B (the chain)", "win_chain", nblk * WL * R + 2 * nblk * R * K,
                   s or nblk))
    if full >= 2:
        passes.append(("G (the groups' chain)", "win_chain", full * WL * WL + 2 * full * R * K, full))
    if s:
        passes.append(("F (fix-up)", "win_fix", nf * (WL * WL + WL * K + 2 * R * K), 0))
    if r0 and nblk > 1:
        passes.append(("C", "win_fix", (nblk - 1) * (WL * r0 + WL * K + 2 * r0 * K), 0))
    if rounds:
        passes.append(("R (x to bf16)", "win_round", nblk * nb * K * 3 // 2, 0))
    call()
    torch.cuda.synchronize()
    # the profiler may miss the window's first kernel, or (seen once) every
    # kernel of a window: read the last calls - 1 solves, and only if their
    # kernels come in the launch order; open up to three windows before
    # giving up
    for attempt in range(1, 4):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        got = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "win_" in e.name),
                     key=lambda e: e.time_range.start)
        want = (calls - 1) * len(passes)
        ev = got[len(got) - want:] if len(got) >= want else []
        if ev and all(passes[i % len(passes)][1] in e.name for i, e in enumerate(ev)):
            break
        log(f"  {kernel}: profiler window {attempt} recorded {len(got)} window-solve kernels, "
            f"{[e.name[:24] for e in got[:len(passes)]]}, not {calls} solves of {len(passes)}")
    else:
        raise AssertionError(f"{kernel}: in three profiler windows the kernels did not match {calls - 1} solves "
                             f"of the passes {[p[1] for p in passes]}")
    calls -= 1
    plan = chain_plan(nb, WL, 1 if K == 1 else trsm_chunk(K, nb, WL, itemsize), itemsize)
    log(f"  {kernel} passes (profiler, the last {calls} of {calls + 1} solves; "
        f"{'groups of ' + str(s) + ' blocks' if s else 'plain chain'}; "
        f"chain CTAs: {plan.threads} threads, {plan.kb} column(s), {plan.tg} slices, {plan.stages} stages of "
        f"{-(-WL // plan.tt)} tile(s) a step):")
    total_us = total_b = 0.0
    for i, (label, _name, vals, steps) in enumerate(passes):
        us = sum(ev[i + len(passes) * r].device_time for r in range(calls)) / calls
        nbytes_ = vals * itemsize
        total_us += us
        total_b += nbytes_
        log(f"    {label}: {us:.1f} us a solve, {nbytes_ / 1e6:.1f} MB, {nbytes_ / (us * 1e3):.1f} GB/s"
            + (f"; {us / steps * 1e3:.1f} ns a step of {steps}" if steps else ""))
    log(f"    design bytes {total_b / 1e6:.1f} MB a solve; device time {total_us:.1f} us, "
        f"{total_b / (total_us * 1e3):.1f} GB/s")


def plain_chain_note(kernel, call, form, calls=3):
    """Log the plain-chain solve's device time and its chain's time a step
    (profiler), beside the grouped solve's."""
    t = cuda_ms(call, reps=5, inner=3, warm=1, backlog=True)
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    # the last calls - 1 chains: the profiler may miss the window's first kernel
    chains = [e.device_time for e in sorted(prof.events(), key=lambda e: e.time_range.start)
              if e.device_type == torch.autograd.DeviceType.CUDA and "win_chain" in e.name][-(calls - 1):]
    chain_us = sum(chains) / max(len(chains), 1)
    log(f"  {kernel} with the plain chain (one chain of {form.nblk} steps): {t:.4f} ms a solve, the chain "
        f"{chain_us:.1f} us = {chain_us / form.nblk * 1e3:.1f} ns a step (profiler)")


def plain_chain_solve(dT, P, B, nb, WL):
    """The window solve's launches with the plain chain (group 0: one chain
    of nblk steps, no F) on the same operands: the yardstick that shows
    what grouping the chain saves."""
    nblk, K = dT.shape[0], (1 if B.dim() == 1 else B.shape[1])
    kc = 1 if B.dim() == 1 else trsm_chunk(K, nb, WL, B.element_size())
    plan = chain_plan(nb, WL, kc, B.element_size())
    X = torch.empty_like(B)
    fn = trsv_win_mod._entry("win_solve_f32" if B.dtype == torch.float32 else "win_solve_f64")
    n = ctypes.c_int64(0)

    def call():
        rc = fn(dT.data_ptr(), P.data_ptr(), None, B.data_ptr(), X.data_ptr(), None, nblk, nb, WL, K, kc, 0, plan.tg,
                plan.tt, plan.stages, torch.cuda.current_stream().cuda_stream, ctypes.addressof(n))
        if rc:
            raise RuntimeError(f"plain-chain window solve failed: CUDA error {rc}")
        return X

    return call


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


def counted(name, fn, want):
    """Run fn; require exactly `want` launches of each kernel named."""
    c0 = read_counts()
    out = fn()
    c1 = read_counts()
    done = {k: c1[k] - c0[k] for k in want}
    if done != want:
        raise AssertionError(f"{name}: launches {done}, want {want}")
    return out


def check_equal(name, got, want):
    """Structure or moved values: equal, element for element."""
    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape or not np.array_equal(g, w):
        raise AssertionError(f"{name}: differs from the reference")
    log(f"  {name}: equal ({g.size} entries)")


def formats_path(ptr, ind, val, x, ref, cant_csr, dev, io_dir):
    """Phase 5d: the storage formats, conversions, the new mv KIDs, the
    format-direct routines, level 1 and Matrix Market I/O on the bench
    operand at full size (and the cant stand-in for the files), each
    against float64 scipy or numpy. Returns the handles phase 6 times."""
    m = n = len(ptr) - 1
    nnz = ind.size
    S = sp.csr_matrix((val.astype(np.float64), ind, ptr), shape=(m, n))
    f32tol, f64tol = MV_TOL["f32"], MV_TOL["f64"]
    x64 = x.double()
    handles = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        log(f"  {label}: {time.perf_counter() - t0:.2f} s")
        return out

    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    handles["coo"] = A = timed("create_coo", lambda: tt.create_coo(m, n, rows, ind, val, device=dev))
    check_mv("COO handle mv (planned through CSR)", tt.mv(1.0, A, GEN, NONE, x, 0.0), ref, f32tol)
    Sc = S.tocsc()
    Sc.sort_indices()
    handles["csc"] = A = timed("create_csc", lambda: tt.create_csc(m, n, Sc.indptr, Sc.indices,
                                                                   Sc.data.astype(np.float32), device=dev))
    _m, _n, _z, cp, ci, cv = timed("export_csc", lambda: tt.export_csc(A))
    check_equal("export_csc col_ptr", cp, Sc.indptr)
    check_equal("export_csc row_ind", ci, Sc.indices)
    check_equal("export_csc val", cv, Sc.data.astype(np.float32))
    check_mv("CSC handle mv (planned through CSR)", tt.mv(1.0, A, GEN, NONE, x, 0.0), ref, f32tol)
    del Sc, cp, ci, cv
    handles["csr"] = base = tt.create_csr(m, n, ptr, ind, val, device=dev)
    handles["bsr"] = B = timed("convert_format -> BSR (block_dim 4)",
                               lambda: tt.convert_format(base, tt.FormatType.bsr, block_dim=4))
    log(f"  BSR: {B.data.nnzb} blocks of 4 x 4, {nbytes(B.data.val) / 1e6:.1f} MB of values")
    for kid in (None, 3):
        check_mv(f"BSR handle mv kid={kid}", tt.mv(1.0, B, GEN, NONE, x, 0.0, kid=kid), ref, f32tol)
    handles["dia"] = D = timed("convert_format -> DIA", lambda: tt.convert_format(base, tt.FormatType.dia))
    log(f"  DIA: {D.data.ndiag} diagonals, {nbytes(D.data.val) / 1e6:.1f} MB of values")
    for kid in (None, 4):
        check_mv(f"DIA handle mv kid={kid}", tt.mv(1.0, D, GEN, NONE, x, 0.0, kid=kid), ref, f32tol)
    handles["ell"] = E = timed("convert_format -> ELL", lambda: tt.convert_format(base, tt.FormatType.ell))
    log(f"  ELL: width {E.data.width}")
    check_mv("ELL handle mv (KID 1)", tt.mv(1.0, E, GEN, NONE, x, 0.0), ref, f32tol)

    # KID 5: the group-window kernel, one launch a call, in f32, the mixed
    # mode (bf16 band) and on a float64 handle
    tt.set_mv_hint_kid(base, NONE, GEN, 1000, 5)
    timed("set_mv_hint_kid + optimize", lambda: tt.optimize(base))
    form = base.plan.exec_form_for(GEN, NONE, kind="bwd")
    log(f"  bwd form of the handle: {bwd_desc(form)}")
    check_mv("mv kid=5 f32", counted("mv kid=5", lambda: tt.mv(1.0, base, GEN, NONE, x, 0.0, kid=5),
                                     {"spmv_bwd_f32": 1, "spmv_bwd_bf16": 0, "spmv_bwd_f64": 0}), ref, f32tol)
    tt.set_precision_mode(base, "mixed")
    ymix = counted("mv kid=5 mixed", lambda: tt.mv(1.0, base, GEN, NONE, x, 0.0, kid=5),
                   {"spmv_bwd_f32": 0, "spmv_bwd_bf16": 1, "spmv_bwd_f64": 0}).double().cpu().numpy()
    tt.set_precision_mode(base, "full")
    # docs/precision.md: one bf16 rounding of the band's operand per product
    bound = 2.0**-8 * (abs(S) @ np.abs(x64.cpu().numpy())) + row_nnz(ptr) * 2.0**-23 * np.abs(ref)
    worst = float(np.max(np.abs(ymix - ref) / bound))
    log(f"  mv kid=5 mixed (bf16 band): max |err| / documented bound {worst:.3f} (must be <= 1)")
    if not (np.all(np.isfinite(ymix)) and worst <= 1.0):
        raise AssertionError("mixed-precision kid=5 mv outside the documented error bound")
    handles["csr64"] = A64 = tt.create_csr(m, n, ptr, ind, val.astype(np.float64), device=dev)
    tt.set_mv_hint_kid(A64, NONE, GEN, 1000, 5)
    tt.optimize(A64)
    check_mv("mv kid=5 float64 handle", counted("mv kid=5 f64", lambda: tt.mv(1.0, A64, GEN, NONE, x64, 0.0, kid=5),
                                                {"spmv_bwd_f32": 0, "spmv_bwd_bf16": 0, "spmv_bwd_f64": 1}),
             ref, f64tol)
    yin = torch.from_numpy(np.random.default_rng(89).standard_normal(m).astype(np.float32)).to(dev)
    check_mv("mv kid=5 alpha=1.5 beta=-0.5", tt.mv(1.5, base, GEN, NONE, x, -0.5, yin, kid=5),
             1.5 * ref - 0.5 * yin.double().cpu().numpy(), f32tol)
    # KIDs 6 (the diag form), 10 (sliced ELL) and 11 (the host engine)
    for kid in (6, 10, 11):
        y = counted(f"mv kid={kid}", lambda: tt.mv(1.0, base, GEN, NONE, x, 0.0, kid=kid),
                    {"spmv_bwd_f32": 0, "spmv_bwd_f64": 0})
        if kid == 11 and y.device.type != "cpu":
            raise AssertionError("the host engine returned a device tensor")
        check_mv(f"mv kid={kid}", y, ref, f32tol)

    # the format-direct routines on the raw arrays (tensors on the card)
    vt = torch.from_numpy(val).to(dev)
    check_mv("csrmv", tt.csrmv(NONE, 1.0, m, n, nnz, vt, ind, ptr, GEN, x, 0.0), ref, f32tol)
    check_mv("csrmv transpose", tt.csrmv(tt.Operation.transpose, 1.0, m, n, nnz, vt, ind, ptr, GEN, x, 0.0),
             S.T @ x64.cpu().numpy(), f32tol)
    check_mv("diamv", tt.diamv(NONE, 1.0, m, n, nnz, D.data.val, D.data.dist, D.data.ndiag, GEN, x, 0.0), ref,
             f32tol)
    bd = B.data
    check_mv("bsrmv", tt.bsrmv(NONE, 1.0, bd.mb, -(-n // 4), 4, bd.val, bd.ind, bd.ptr, GEN, x, 0.0)[:m], ref,
             f32tol)
    check_mv("ellmv", tt.ellmv(NONE, 1.0, m, n, nnz, E.data.val, E.data.ind, E.data.width, GEN, x, 0.0), ref,
             f32tol)
    del vt

    # level 1: a sparse vector of 2^22 entries against a dense y of 2^24
    rng = np.random.default_rng(97)
    n1, k1 = 1 << 24, 1 << 22
    idx = rng.choice(n1, k1, replace=False)
    xs_h = rng.standard_normal(k1).astype(np.float32)
    y_h = rng.standard_normal(n1).astype(np.float32)
    it, xs_d, y_d = torch.from_numpy(idx).to(dev), torch.from_numpy(xs_h).to(dev), torch.from_numpy(y_h).to(dev)
    x64h, y64h = xs_h.astype(np.float64), y_h.astype(np.float64)
    want = y64h.copy()
    want[idx] += 1.5 * x64h
    check_mv("axpyi", tt.axpyi(1.5, xs_d, it, y_d), want, f32tol)
    dot_scale = float(np.sum(np.abs(x64h * y64h[idx])))
    for name, got, exact in (("doti", tt.doti(xs_d, it, y_d), float(np.sum(x64h * y64h[idx]))),):
        err = abs(float(got) - exact) / dot_scale
        log(f"  {name}: |d - d*| / sum |x y| {err:.3e} (tol {f32tol:.3e})")
        if not err <= f32tol:
            raise AssertionError(f"{name} disagrees with float64 numpy")
    xc_h = (xs_h + 1j * rng.standard_normal(k1)).astype(np.complex64)
    yc_h = (y_h + 1j * rng.standard_normal(n1)).astype(np.complex64)
    xc_d, yc_d = torch.from_numpy(xc_h).to(dev), torch.from_numpy(yc_h).to(dev)
    prod = yc_h.astype(np.complex128)[idx]
    for name, fn, exact in (("dotci", tt.dotci, np.sum(np.conj(xc_h.astype(np.complex128)) * prod)),
                            ("dotui", tt.dotui, np.sum(xc_h.astype(np.complex128) * prod))):
        err = abs(complex(fn(xc_d, it, yc_d)) - exact) / float(np.sum(np.abs(xc_h.astype(np.complex128) * prod)))
        log(f"  {name}: |d - d*| / sum |x y| {err:.3e} (tol {f32tol:.3e})")
        if not err <= f32tol:
            raise AssertionError(f"{name} disagrees with complex128 numpy")
    del xc_d, yc_d, xc_h, yc_h, prod
    check_equal("gthr", tt.gthr(y_d, it).cpu().numpy(), y_h[idx])
    gx, gy = tt.gthrz(y_d, it)
    zeroed = y_h.copy()
    zeroed[idx] = 0
    check_equal("gthrz gathered", gx.cpu().numpy(), y_h[idx])
    check_equal("gthrz zeroed", gy.cpu().numpy(), zeroed)
    scat = y_h.copy()
    scat[idx] = xs_h
    check_equal("sctr", tt.sctr(xs_d, it, y_d).cpu().numpy(), scat)
    check_equal("gthrs (stride 4)", tt.gthrs(y_d, 4).cpu().numpy(), y_h[::4])
    scat = y_h.copy()
    scat[: 4 * k1 : 4] = xs_h
    check_equal("sctrs (stride 4)", tt.sctrs(xs_d, 4, y_d).cpu().numpy(), scat)
    rx, ry = tt.roti(xs_d, it, y_d, 0.6, 0.8)
    want_y = y64h.copy()
    want_y[idx] = 0.6 * y64h[idx] - 0.8 * x64h
    check_mv("roti x", rx, 0.6 * x64h + 0.8 * y64h[idx], f32tol)
    check_mv("roti y", ry, want_y, f32tol)
    del it, xs_d, y_d, gx, gy, rx, ry, scat, zeroed, want, want_y

    # Matrix Market round trips: the cant stand-in, and a symmetric file of
    # its lower triangle written by scipy
    cptr, cind, cval = cant_csr
    cm = len(cptr) - 1
    Ccant = tt.create_csr(cm, cm, cptr, cind, cval, device=dev)
    io_dir.mkdir(exist_ok=True)
    path = io_dir / "cant.mtx"
    try:
        timed(f"write_mtx (cant stand-in, {cind.size} entries)", lambda: write_mtx(str(path), Ccant))
        back = timed("read_mtx", lambda: read_mtx(str(path), device=dev))
        _m, _n, _z, bp, bi, bv = tt.export_csr(back)
        check_equal("cant round trip row_ptr", bp, cptr)
        check_equal("cant round trip col_ind", bi, cind)
        check_equal("cant round trip values (f32 written with 17 digits)", bv, cval.astype(np.float64))
        lower = sp.tril(sp.csr_matrix((cval.astype(np.float64), cind, cptr), shape=(cm, cm))).tocoo()
        full = (lower + sp.tril(lower, -1).T).tocsr()
        full.sort_indices()
        scipy.io.mmwrite(str(path), lower, symmetry="symmetric")
        sym = timed("read_mtx (scipy-written symmetric lower triangle)", lambda: read_mtx(str(path), device=dev))
        _m, _n, _z, sp_, si, sv = tt.export_csr(sym)
        check_equal("symmetric expansion row_ptr", sp_, full.indptr)
        check_equal("symmetric expansion col_ind", si, full.indices)
        check_equal("symmetric expansion values", sv, full.data)
        xc = torch.from_numpy(np.random.default_rng(101).standard_normal(cm)).to(dev)
        check_mv("mv on the read symmetric handle", tt.mv(1.0, sym, GEN, NONE, xc, 0.0), full @ xc.cpu().numpy(),
                 f64tol)
    finally:
        path.unlink(missing_ok=True)
    return handles


def measurement_path(ptr, ind, val, x, ref, dev, trace_dir):
    """Phase 5e: the measurement path of bench.py:220-350 on the port. The
    bench operand goes through create_csr -> set_mv_hint(nop=1000) ->
    optimize to its bandt form; the form's tile-major band (bandt_tiles,
    TM_TILES) runs through the tile-major kernels and its block windows
    (band_mxu_dt) through the block-window SpMV, each plus the form's peel
    spill, in f32 (against float64 scipy A x) and with a bf16 band (against
    docs/precision.md's bound), one launch a call; the streaming-read probe
    sums the form's band slab (against a float64 sum). Each kernel is then
    timed by profiling.chain_bench (host clock, one synchronise a chunk) and
    put against the context's published peak by profiling.roofline, and
    one profiling.trace of the kernels is written to trace_dir."""
    m = n = len(ptr) - 1
    S = sp.csr_matrix((val.astype(np.float64), ind, ptr), shape=(m, n))
    t0 = time.perf_counter()
    A = tt.create_csr(m, n, ptr, ind, val, device=dev)
    tt.set_mv_hint(A, NONE, GEN, nop=1000)
    form = tt.optimize(A).exec_form_for(GEN, NONE, kind="bandt")
    tiles = {"f32": form.bandt_tiles(TM_TILES), "bf16": form.bandt_tiles(TM_TILES, bf16=True)}
    wins = {"f32": form.band_mxu_dt(), "bf16": form.band_mxu_dt(bf16=True)}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"  create_csr + set_mv_hint + optimize + tile-major band + block windows: {time.perf_counter() - t0:.2f} s; "
        f"bandt W={form.bwd_W} start={form.bandt_start} padL={form.bwd_padL} spilled {form.sp_ind.numel()}; "
        f"tiles {tuple(tiles['f32'].shape)}, windows {tuple(wins['f32'].shape)}")
    spill = (form.sp_val, form.sp_ind, form.sp_rows)
    args = (form.bandt_start, form.bwd_padL, m)
    none = {k: 0 for k in MEASURE_PATH}
    # docs/precision.md: per bf16 rounding of a product's operands,
    # |y - y*| <= 2^-8 sum_j |a_ij x_j| + nnz_row eps_f32 |y*|
    sax = abs(S) @ np.abs(x.double().cpu().numpy())
    nz = row_nnz(ptr)
    for inst in ("f32", "bf16"):
        vt3, dt = tiles[inst], wins[inst]
        for kernel, call, roundings in (
            (f"band_spmv_tiles_{inst}", lambda: spmv_bandt_tiles(vt3, x, *spill, *args), 1),
            (f"band_spmv_tiles_dbuf_{inst}", lambda: spmv_bandt_tiles(vt3, x, *spill, *args, dbuf=True), 1),
            (f"spmv_band_mxu_{inst}", lambda: spmv_bandmxu(dt, x, *spill, *args, form.bwd_W), 2),  # x rounds too
        ):
            y = counted(kernel, call, dict(none, **{kernel: 1}))
            if inst == "f32":
                check_mv(f"{kernel} + peel spill vs float64 scipy A x", y, ref, MV_TOL["f32"])
                continue
            g = y.double().cpu().numpy()
            worst = float(np.max(np.abs(g - ref) / (roundings * 2.0**-8 * sax + nz * 2.0**-23 * np.abs(ref))))
            log(f"  {kernel} + peel spill: max |err| / documented bound ({roundings} bf16 rounding(s)) "
                f"{worst:.3f} (must be <= 1)")
            if not (np.all(np.isfinite(g)) and worst <= 1.0):
                raise AssertionError(f"{kernel}: outside the documented error bound")
    slab = form.bwd_val
    total = counted("stream_read_f32", lambda: stream_read(slab), dict(none, stream_read_f32=1))
    check_mv(f"stream_read_f32 on the band slab {tuple(slab.shape)} vs a float64 sum", total,
             np.asarray(float(slab.double().sum())), MV_TOL["f32"])

    io = nbytes(x) + m * 4  # x read and y written once
    timed = {
        **{f"band_spmv_tiles_{i}": (lambda v=v: band_spmv_tiles(v, x, *args), nbytes(v) + io) for i, v in tiles.items()},
        **{f"band_spmv_tiles_dbuf_{i}": (lambda v=v: band_spmv_tiles_dbuf(v, x, *args), nbytes(v) + io)
           for i, v in tiles.items()},
        # the windows' parallelogram, the bytes the kernel needs
        **{f"spmv_band_mxu_{i}": (lambda d=d: spmv_band_mxu(d, x, *args, form.bwd_W),
                                  d.shape[0] * 128 * form.bwd_W * d.element_size() + io) for i, d in wins.items()},
        "stream_read_f32": (lambda: stream_read(slab), nbytes(slab)),
    }
    for kernel, (fn, moved) in timed.items():
        r = profiling.chain_bench(fn, name=kernel, iters=50, chunks=5)
        roof = profiling.roofline(moved, r.t_median)
        log(f"  {kernel}: {r.t_median * 1e3:.4f} ms a call (profiling.chain_bench, host clock, median of "
            f"{len(r.times)} chunks), {moved / 1e6:.1f} MB: {roof['achieved_gbps']:.1f} GB/s = "
            f"{roof['fraction_of_peak']:.3f} of the published {roof['peak_gbps']} GB/s (profiling.roofline)")
    with profiling.trace(str(trace_dir)):
        for fn, _moved in timed.values():
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    events = json.loads((Path(trace_dir) / "trace.json").read_text()).get("traceEvents", [])
    kern = sorted({e.get("name", "")[:40] for e in events if e.get("cat") == "kernel"})
    log(f"  profiling.trace: {trace_dir}/trace.json, {len(events)} events, device kernels {kern}")


def synthetic_chain_form(kind, nblk, nb, m, seed, dtype, dev, offs=None, W=None, unit=False):
    """A dwin or gather TrsvForm of chosen shape from random values, carried
    by interop.trsv_form_from_jax as the JAX package's arrays would be: the
    diagonal blocks 4 I (or I, unit) plus 0.1-scaled strictly lower noise,
    identity rows past m; the left part 0.1-scaled noise on entries left of
    each block (offs[d] > r for dwin; columns below the block for gather),
    zero elsewhere and past m."""
    rng = np.random.default_rng(seed)
    m_pad = nblk * nb
    D = np.tril(0.1 * rng.standard_normal((nblk, nb, nb)), -1) + (1.0 if unit else 4.0) * np.eye(nb)
    rows = np.arange(m_pad).reshape(nblk, nb)
    D[rows >= m] = 0.0
    D[:, np.arange(nb), np.arange(nb)] = np.where(rows >= m, 1.0, D[:, np.arange(nb), np.arange(nb)])
    arrays = dict(D=D.astype(dtype), nb=nb, nblk=nblk, m=m, reversed_=False, unit_diag=unit, kind=kind)
    if kind == "dwin":
        offs = np.asarray(offs)
        Dv = 0.1 * rng.standard_normal((nblk, len(offs), nb))
        Dv[:, np.arange(nb)[None, :] >= offs[:, None]] = 0.0  # entries inside the block live in D
        Dv[(rows >= m)[:, None, :].repeat(len(offs), 1)] = 0.0
        arrays.update(Lval=Dv.astype(dtype), dwin_offs=offs, WL=max(8, -(-int(offs.max()) // 8) * 8))
    else:
        blk0 = (np.arange(nblk) * nb)[:, None, None]
        Lind = (rng.integers(0, np.maximum(blk0, 1), (nblk, nb, W)) * (blk0 > 0)).astype(np.int32)
        Lval = np.where(blk0 > 0, 0.1 * rng.standard_normal((nblk, nb, W)), 0.0)
        Lval[rows >= m] = 0.0
        arrays.update(Lval=Lval.astype(dtype), Lind=Lind, WL=0)
    return interop.trsv_form_from_jax(arrays, device=dev)


def check_chain_form(form, label, K, errs):
    """The chain kernel of a form against its plain version on a random
    right-hand side ((m_pad,) for K = 1, else (m_pad, K)), twice for the
    same bits."""
    dT, left = form.operands()
    inst = "f32" if dT.dtype == torch.float32 else "f64"
    kernel = f"trsv_{form.kind}_{inst}"
    shape = (form.m_pad,) if K == 1 else (form.m_pad, K)
    b = torch.from_numpy(np.random.default_rng(K).standard_normal(shape)).to(dT.device, dT.dtype)
    full = f"{label} (nb={form.nb}, nblk={form.nblk}, {form.kind}"
    if form.kind == "dwin":
        full += f" ndg={len(form.dwin_offs)} WL={form.WL}) K={K}"
        got = same_bits(kernel, full, lambda: trsv_dwin(dT, left, form.offsets(), b, form.nb, form.WL))
        want = trsv_dwin_plain(dT.transpose(1, 2), left, b, form.nb, form.WL, form.dwin_offs)
    else:
        full += f" W={left.shape[2]}) K={K}"
        got = same_bits(kernel, full, lambda: trsv_gather(dT, form.Lind, left, b, form.nb))
        want = trsv_gather_plain(dT.transpose(1, 2), form.Lind, left, b, form.nb)
    compare(kernel, full, got, want, errs)


def chain_kernel_checks(H, H64, Q, Q64, dev, errs):
    """Phase 3's checks of the blocked-solve chain kernel: the dwin form on
    the ILU0 L and U factors of the 104^3 stencil (f32 and f64, K = 1 and
    K_SM), the gather form on the scatter operand's lower and upper
    triangles (m = 262,144; its solves stay bounded: 4.0 on the diagonal
    against about four N(0, 1) entries a row left of it, so the operand
    needs no dominant diagonal made for it), and small edge forms: one
    block, a ragged last block, an offset past m_pad, a unit diagonal.
    Returns the ILU0 states of H and H64."""
    states = []
    for handle in (H, H64):
        t0 = time.perf_counter()
        st_ = ilu0_factorize(handle)
        ops = [f.operands() for f in (st_.l_form, st_.u_form)]
        torch.cuda.synchronize()
        f = st_.l_form
        log(f"  stencil ILU0 ({handle.dtype}): ilu0_factorize + operands {time.perf_counter() - t0:.2f} s; L and U "
            f"{st_.l_form.kind}/{st_.u_form.kind}, nb={f.nb} nblk={f.nblk} ndg={len(f.dwin_offs)} WL={f.WL}")
        if (st_.l_form.kind, st_.u_form.kind) != ("dwin", "dwin"):
            raise AssertionError("the stencil's ILU0 factors did not take dwin forms")
        del ops
        states.append(st_)
    for st_ in states:
        for name, form in (("L", st_.l_form), ("U", st_.u_form)):
            for K in (1, K_SM):
                check_chain_form(form, f"104^3 stencil ILU0 {name}", K, errs)
    for handle in (Q, Q64):
        for tri in (LOWER, UPPER):
            form = trsv_form_for(handle.plan or tt.optimize(handle), tri, NONE)
            if form.kind != "gather":
                raise AssertionError(f"the scatter operand's triangle took {form.kind}, want gather")
            for K in (1, K_SM):
                check_chain_form(form, f"scatter {tri.fill_mode.name}", K, errs)
            form._ops = None  # the inverted blocks, dropped
    for dtype in (np.float32, np.float64):
        edges = [
            ("one block, ragged", synthetic_chain_form("dwin", 1, 64, 50, 1, dtype, dev, offs=(3, 9, 40))),
            ("ragged last block", synthetic_chain_form("dwin", 8, 128, 1000, 2, dtype, dev, offs=(1, 127, 128, 300))),
            ("an offset past m_pad", synthetic_chain_form("dwin", 8, 128, 1024, 3, dtype, dev, offs=(1, 130, 5000))),
            ("unit diagonal", synthetic_chain_form("dwin", 8, 128, 1024, 4, dtype, dev, offs=(2, 200), unit=True)),
            ("one block", synthetic_chain_form("gather", 1, 64, 64, 5, dtype, dev, W=3)),
            ("ragged last block", synthetic_chain_form("gather", 9, 96, 800, 6, dtype, dev, W=5)),
            ("unit diagonal", synthetic_chain_form("gather", 8, 128, 1024, 7, dtype, dev, W=2, unit=True)),
        ]
        for label, form in edges:
            for K in (1, 3):
                check_chain_form(form, f"edge: {label}", K, errs)
    return states


def check_level_form(form, label, K, errs):
    """The level kernel on a LevelForm against its plain version on a
    random right-hand side ((m,) for K = 1, else (m, K)), twice for the
    same bits."""
    kernel = f"trsv_level_{INST[form.lval.dtype]}"
    shape = (form.m,) if K == 1 else (form.m, K)
    rng = np.random.default_rng(K)
    b = rng.standard_normal(shape)
    if form.lval.dtype.is_complex:
        b = b + 1j * rng.standard_normal(shape)
    b = torch.from_numpy(b).to(form.lval.device, form.lval.dtype)
    full = f"{label} (m={form.m}, {form.nlev} levels, {form.lcol.numel()} strict entries) K={K}"
    got = same_bits(kernel, full, lambda: trsv_level(form, b))
    compare(kernel, full, got, trsv_level_plain(form, b), errs)


def level_kernel_checks(hst, hst64, Q, Q64, errs):
    """Phase 3's checks of the level-solve kernel: the level forms of the
    104^3 stencil's ILU0 L and U factors (f32 and f64, K = 1 and K_SM; the
    forms the ILU0 apply takes on the card, cached on the factors' states)
    and of the scatter operand's lower and upper triangles (cached on their
    plans, as trsv takes them)."""
    for st_ in (hst, hst64):
        t0 = time.perf_counter()
        forms = _level_forms(st_)
        log(f"  stencil ILU0 level forms ({st_.lu.dtype}): {time.perf_counter() - t0:.2f} s, "
            f"{forms[0].nlev} / {forms[1].nlev} levels")
        for name, form in zip(("L", "U"), forms):
            for K in (1, K_SM):
                check_level_form(form, f"104^3 stencil ILU0 {name}", K, errs)
    for handle in (Q, Q64):
        for tri in (LOWER, UPPER):
            form = ttri.trsv_level_form_for(handle.plan, tri, NONE)
            for K in (1, K_SM):
                check_level_form(form, f"scatter {tri.fill_mode.name}", K, errs)


def widen_level_form(form, dtype):
    """A LevelForm with its values in `dtype` (its structure shared), with
    its own ready flags."""
    return dataclasses.replace(
        form, lval=form.lval.to(dtype), dinv=form.dinv.to(dtype), _ready=None, _epoch=0,
        _run_vals=tuple((lv.to(dtype), di.to(dtype)) for lv, di in form._run_vals))


def complex_stencil(hptr, hind, hval, dtype):
    """The stencil's values shifted by i SIGMA I, in `dtype`."""
    rows = np.repeat(np.arange(len(hptr) - 1), np.diff(hptr))
    return (hval.astype(np.float64) + 1j * SIGMA * (rows == hind)).astype(dtype)


def complex_level_checks(Hc, errs):
    """Phase 3's checks of the level kernel's complex instances: the level
    forms of the complex stencil's ILU0 L and U factors (722 levels each),
    complex64, and complex128 on the same forms' values widened, K = 1 and
    K_SM, each twice for the same bits. Returns the complex64 ILU0 state
    (phase 5g applies it)."""
    t0 = time.perf_counter()
    stc = tt.ilu0_factorize(Hc)
    t_f = time.perf_counter() - t0
    t0 = time.perf_counter()
    forms = _level_forms(stc)
    log(f"  complex stencil (A + {SIGMA} i I) ILU0: factorize {t_f:.2f} s (forms {stc.l_form.kind} / "
        f"{stc.u_form.kind}), level forms {time.perf_counter() - t0:.2f} s, {forms[0].nlev} / {forms[1].nlev} levels")
    for name, form in zip(("L", "U"), forms):
        for f_ in (form, widen_level_form(form, torch.complex128)):
            for K in (1, K_SM):
                check_level_form(f_, f"complex 104^3 stencil ILU0 {name}", K, errs)
    return stc


def stencil_solvers(H, H64, hst, hptr, hind, hval, dev, rtol, res_tol):
    """Phase 5 on the 104^3 stencil, through the entry points:
    ilu0_factorize (cached from phase 3), ilu_smoother (the default: two
    level-kernel launches; kid=0: two dwin launches), pcg_solve with precond
    "ilu0" and "sgs" (a true relative residual <= res_tol, each iteration one
    apply: two level-kernel launches and no chain launch), symgs / symgs_mv
    (the level kernel) and sorv (the level kernel, through the same gate)
    against a float64 scipy sweep, trsv by default (the level kernel) and
    kid=0, 1, 2, and trsv on the float64 handle (both f64 instances).
    Returns the iteration counts."""
    mh = len(hptr) - 1
    Sh = sp.csr_matrix((hval.astype(np.float64), hind, hptr), shape=(mh, mh))
    Lh, Uh, Dh = sp.tril(Sh, -1).tocsr(), sp.triu(Sh, 1).tocsr(), sp.diags(Sh.diagonal())
    b = np.random.default_rng(71).standard_normal(mh).astype(np.float32)
    b_d, bref = torch.from_numpy(b).to(dev), b.astype(np.float64)
    f32tol = expected_precision(torch.float32)
    if tt.ilu0_factorize(H) is not hst:
        raise AssertionError("ilu0_factorize did not return the handle's cached factors")
    # the mv rule's diag branch: the stencil and its strict triangles (the
    # SGS sweeps' matvecs) take the diag form (mv KID 6), not the route
    strict_l = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower,
                                   diag_type=tt.DiagType.zero)
    forms = {"A": H.plan.exec_form_for(GEN, NONE), "strict L": H.plan.exec_form_for(strict_l, NONE)}
    log("  stencil mv forms: " + ", ".join(f"{k} {f.kind} ({len(f.dia_offs_static or ())} diagonals)"
                                          for k, f in forms.items()))
    if any(f.kind != "diag" for f in forms.values()):
        raise AssertionError(f"the stencil's default mv forms are {[f.kind for f in forms.values()]}, want diag")
    check_mv("stencil mv (diag form)", tt.mv(1.0, H, GEN, NONE, b_d, 0.0), Sh @ bref, f32tol)
    lu = hst.lu.double().cpu().numpy()
    rows = np.repeat(np.arange(mh), np.diff(hptr))
    low = hind < rows
    Lf = sp.csr_matrix((np.r_[lu[low], np.ones(mh)], (np.r_[rows[low], np.arange(mh)], np.r_[hind[low], np.arange(mh)])),
                       shape=(mh, mh))
    Uf = sp.csr_matrix((lu[~low], (rows[~low], hind[~low])), shape=(mh, mh))
    LU = spla.aslinearoperator(Lf) @ spla.aslinearoperator(Uf)
    for kid, want in ((None, {"trsv_level_f32": 2, "trsv_dwin_f32": 0}),
                      (0, {"trsv_level_f32": 0, "trsv_dwin_f32": 2})):
        xs = counted(f"stencil ilu_smoother kid={kid}", lambda: tt.ilu_smoother(H, GEN, b_d, kid=kid), want)
        check_residual(f"stencil ilu_smoother kid={kid}: L (U x) = b", LU, xs, bref, f32tol)
    iters = {}
    for precond in ("ilu0", "sgs"):
        c0 = read_counts()
        t0 = time.perf_counter()
        xp, k, rnorm = tt.pcg_solve(H, b_d, rtol=rtol, maxit=1000, precond=precond)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        c1 = read_counts()
        dl, dc = c1["trsv_level_f32"] - c0["trsv_level_f32"], c1["trsv_dwin_f32"] - c0["trsv_dwin_f32"]
        true_res = float(np.linalg.norm(bref - Sh @ xp.double().cpu().numpy()) / np.linalg.norm(bref))
        log(f"  stencil pcg precond={precond}: {k} iterations in {t_solve:.3f} s (set-up included), ||r||={rnorm:.3e}, "
            f"true rel residual {true_res:.3e} (tol {res_tol:.1e}), level-kernel launches {dl}, dwin launches {dc}")
        if not (k < 1000 and np.isfinite(true_res) and true_res <= res_tol):
            raise AssertionError(f"stencil CG precond={precond}: not converged to the tolerance")
        if (dl, dc) != (2 * k, 0):
            raise AssertionError(f"stencil CG precond={precond}: {dl} level / {dc} dwin launches in {k} iterations, "
                                 f"want {2 * k} / 0")
        iters[precond] = k
    # one symmetric Gauss-Seidel sweep (symgs_ref) and one forward SOR
    # sweep, each against scipy in float64
    x0 = np.random.default_rng(73).standard_normal(mh).astype(np.float32)
    x0_d = torch.from_numpy(x0).to(dev)
    x0r = x0.astype(np.float64)
    x1 = spla.spsolve_triangular((Lh + Dh).tocsr(), bref - 0.5 * (Uh @ x0r), lower=True)
    want = spla.spsolve_triangular((Uh + Dh).tocsr(), bref - Lh @ x1, lower=False)
    c0 = read_counts()
    check_mv("stencil symgs (alpha 0.5)", tt.symgs(NONE, H, GEN, 0.5, b_d, x0_d), want, f32tol)
    xg, yg = tt.symgs_mv(NONE, H, GEN, 0.5, b_d, x0_d)
    check_mv("stencil symgs_mv: x", xg, want, f32tol)
    check_mv("stencil symgs_mv: y = A x", yg, Sh @ want, f32tol)
    omega, alpha = 1.2, 0.7
    want = spla.spsolve_triangular((Dh + omega * Lh).tocsr(),
                                   omega * bref - (omega * Uh + (omega - 1.0) * Dh) @ (alpha * x0r), lower=True)
    check_mv(f"stencil sorv (omega {omega}, alpha {alpha})", tt.sorv(tt.SorType.forward, GEN, H, omega, alpha, x0_d, b_d),
             want, f32tol)
    c1 = read_counts()
    done = {k: c1[k] - c0[k] for k in ("trsv_level_f32", "trsv_dwin_f32")}
    if done != {"trsv_level_f32": 5, "trsv_dwin_f32": 0}:
        raise AssertionError(f"symgs, symgs_mv, sorv made {done} launches, want 5 level (two sweeps each, one "
                             "for sorv's (D + omega L) solve) and no dwin")
    # the sv engines on the stencil's lower triangle: the default (the level
    # kernel), kid 0 (the chain kernel), 1 (the level kernel), 2 (host)
    x_0 = counted("stencil trsv kid=0", lambda: tt.trsv(1.0, H, LOWER, NONE, b_d, kid=0),
                  {"trsv_dwin_f32": 1, "trsv_level_f32": 0})
    ref0 = x_0.double().cpu().numpy()
    check_residual("stencil trsv kid=0 (dwin)", sp.tril(Sh).tocsr(), x_0, bref, f32tol)
    for kid, want in ((None, {"trsv_dwin_f32": 0, "trsv_level_f32": 1}), (1, {"trsv_dwin_f32": 0, "trsv_level_f32": 1}),
                      (2, {"trsv_dwin_f32": 0, "trsv_level_f32": 0})):
        check_mv(f"stencil trsv kid={kid} against kid=0",
                 counted(f"stencil trsv kid={kid}", lambda: tt.trsv(1.0, H, LOWER, NONE, b_d, kid=kid), want), ref0,
                 f32tol)
    nlev = H.plan.levels[("trsv_level", tt.FillMode.lower, tt.DiagType.non_unit, NONE)].nlev
    log(f"  stencil level form: {nlev} levels; the default's engine: "
        f"{ttri.sv_engine_for(H.plan, LOWER, NONE, dev)}")
    for kid, want in ((None, {"trsv_level_f64": 1, "trsv_dwin_f64": 0}), (0, {"trsv_level_f64": 0, "trsv_dwin_f64": 1})):
        check_residual(f"stencil trsv f64 upper non-unit kid={kid} (reversed form)", sp.triu(Sh).tocsr(),
                       counted(f"stencil f64 trsv kid={kid}", lambda: tt.trsv(1.0, H64, UPPER, NONE, b_d.double(),
                                                                              kid=kid), want),
                       bref, expected_precision(torch.float64))
    return iters


def launches_of(fn):
    """The counters' growth over one call of fn (nonzero entries only)."""
    c0 = read_counts()
    fn()
    torch.cuda.synchronize()
    c1 = read_counts()
    return {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}


def expect_launches(name, delta, parts):
    """Hold the counters' growth over a solve (delta) to what its counts
    imply: the sum of n times each unit call's launches, for parts of
    (n, unit launches, label)."""
    want = {}
    for n_, unit, _label in parts:
        for k, v in unit.items():
            want[k] = want.get(k, 0) + n_ * v
    got = {k: v for k, v in delta.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{name}: launches {got}, want {want} = "
                             + " + ".join(f"{n_} {label} x {unit}" for n_, unit, label in parts))
    log(f"  {name}: launches {got} = " + " + ".join(f"{n_} {label}" for n_, _unit, label in parts))


def fused_gmres_launches(name, delta, it, restart, per_mv, per_apply=None):
    """The fused GMRES's launches: one matvec for the initial residual, one
    a cycle and one a step; the preconditioner once a step and once a
    cycle (on V y). A cycle that starts converged (its true residual under
    the tolerance where the estimate was not) takes no step, so the cycles
    are ceil(it / restart), or one more."""
    errs_ = []
    for cyc in (-(-it // restart), -(-it // restart) + 1):
        parts = [(1 + cyc + it, per_mv, "matvecs (1 + cycles + steps)")]
        if per_apply is not None:
            parts.append((it + cyc, per_apply, "applies (steps + cycles)"))
        try:
            expect_launches(f"{name} ({cyc} cycles)", delta, parts)
            return cyc
        except AssertionError as e:
            errs_.append(str(e))
    raise AssertionError("; ".join(errs_))


def itsol_run(A, b, opts, dtype, precond=None, matvec=None):
    """One forward solve through an itsol handle on b's device:
    (x, iterations, cycles, launches, seconds). The monitoring callback
    counts the stopping-criterion bounces: a GMRES solve's cycles."""
    h = tt.itsol_init(dtype, device=b.device)
    for key, v in opts.items():
        tt.itsol_option_set(h, key, v)
    bounces = []

    def monitor(u, rinfo):
        bounces.append(int(rinfo[30]))
        return 0

    c0 = read_counts()
    t0 = time.perf_counter()
    n = b.shape[0]
    if matvec is None:
        x, rinfo, status = tt.itsol_solve(h, n, A, GEN, b, precond=precond, monitoring=monitor)
    else:
        x, rinfo, status = tt.itsol_solve_operator(h, n, matvec, b, precond=precond, monitoring=monitor)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    c1 = read_counts()
    if status != tt.Status.success:
        raise AssertionError(f"itsol solve {opts} ended with {status.name}")
    if x.device != b.device:
        raise AssertionError(f"itsol solve returned x on {x.device}, b on {b.device}")
    return x, int(rinfo[30]), len(bounces), {k: c1[k] - c0[k] for k in c1}, t


def solver_framework(nonsym, H, hptr, hind, hval, wptr, wind, wval, dev, rtol, sgs_iters):
    """Phase 5f: the iterative-solver framework through its entry points.

    On the nonsymmetric bench operand (the bench profile with the SPD
    operand's Gershgorin shift, not symmetrised; bandt, ILU0 on win forms):
    itsol_solve GMRES with ILU0 in f32 and on a float64 handle (the band
    kernel's f64 instance, the f64 window solves), itsol_solve GMRES with
    no preconditioner at restart 4 (at the default 20 it converges inside
    one cycle: several cycles run only at a shorter restart), pgmres_solve
    with "ilu0" and with none, itsol_rci_solve driven by hand with mv and a
    Jacobi User preconditioner, itsol_solve_operator and
    make_gmres_operator on `lambda v: mv(...)`; on the 104^3 stencil
    itsol_solve CG with "cg preconditioner" = "sgs" (its symgs sweeps on
    the level kernel); on the webbase stand-in with the same shift
    (gen, its spill on the route) pgmres_solve with none, in permuted
    space. Each solve: a true relative residual by a float64 scipy product
    <= 10 rtol, the launches its counts imply, the RCI and fused forms of a
    method within restart (GMRES) or 1 (CG) iterations, the matrix-free
    and matrix paths equal. Returns what phase 6 times."""
    res_tol = 10 * rtol
    Sn, nptr, nind, nval = nonsym
    m = len(nptr) - 1
    GM = {"iterative method": "GMRES", "gmres rel tolerance": rtol, "gmres abs tolerance": 0.0}
    t0 = time.perf_counter()
    N = tt.create_csr(m, m, nptr, nind, nval, device=dev)
    tt.set_mv_hint(N, NONE, GEN, nop=1000)
    tt.set_lu_smoother_hint(N, NONE, GEN, nop=1000)
    tt.optimize(N)
    nform = N.plan.exec_form_for(GEN, NONE)
    nst = tt.ilu0_factorize(N)
    torch.cuda.synchronize()
    kinds = None if nst.l_form is None else (nst.l_form.kind, nst.u_form.kind)
    log(f"  nonsymmetric bench operand: nnz={Sn.nnz}, plan {nform.kind} (W={nform.bwd_W}), ILU0 forms {kinds}"
        + ("" if kinds is None else f" (nb={nst.l_form.nb}, WL={nst.l_form.WL}, nblk={nst.l_form.nblk})")
        + f"; create_csr + hints + optimize + ilu0_factorize {time.perf_counter() - t0:.2f} s")
    if nform.kind != "bandt" or kinds != ("win", "win"):
        raise AssertionError(f"nonsymmetric bench operand planned as {nform.kind} with ILU0 forms {kinds}, "
                             "want bandt and win forms")
    b = np.random.default_rng(79).standard_normal(m).astype(np.float32)
    b_d, bref = torch.from_numpy(b).to(dev), b.astype(np.float64)
    bnorm = float(np.linalg.norm(bref))
    per_mv = launches_of(lambda: tt.mv(1.0, N, GEN, NONE, b_d, 0.0))
    per_ilu = launches_of(lambda: tt.ilu_smoother(N, GEN, b_d))
    log(f"  unit launches: mv {per_mv}, ILU0 apply {per_ilu}")
    out = {"N": N, "b": b_d, "bnorm": bnorm}

    # ILU0-GMRES through itsol_solve, f32 and f64, and pgmres_solve
    x, it, cyc, delta, t = itsol_run(N, b_d, dict(GM, **{"gmres preconditioner": "ILU0"}), torch.float32)
    res = check_residual("itsol ILU0-GMRES f32", Sn, x, bref, res_tol)
    log(f"  itsol ILU0-GMRES f32 (restart 20): {it} iterations, {cyc} cycles in {t:.3f} s, true rel residual "
        f"{res:.3e} (tol {res_tol:.1e})")
    # RCI GMRES: one mv a step and one a cycle (its start), one apply a step
    # (the update reuses the stored preconditioned vectors)
    expect_launches("itsol ILU0-GMRES f32", delta, [(it + cyc, per_mv, "mv (steps + cycles)"),
                                                     (it, per_ilu, "applies (steps)")])
    c0 = read_counts()
    xf, itf, rf = tt.pgmres_solve(N, b_d, rtol=rtol, atol=0.0, restart=20, precond="ilu0")
    torch.cuda.synchronize()
    c1 = read_counts()
    resf = check_residual("pgmres ILU0", Sn, xf, bref, res_tol)
    log(f"  pgmres_solve precond=ilu0: {itf} iterations, estimate {rf:.3e}, true rel residual {resf:.3e}")
    fused_gmres_launches("pgmres ilu0", {k: c1[k] - c0[k] for k in c1}, itf, 20, per_mv, per_ilu)
    if abs(it - itf) > 20:
        raise AssertionError(f"ILU0-GMRES: RCI {it} and fused {itf} iterations differ by more than the restart")
    out["ilu_gmres"] = (itf, rf)
    N64 = tt.create_csr(m, m, nptr, nind, nval.astype(np.float64), device=dev)
    tt.set_mv_hint(N64, NONE, GEN, nop=1000)
    tt.optimize(N64)
    st64 = tt.ilu0_factorize(N64)
    b64 = b_d.double()
    per_mv64 = launches_of(lambda: tt.mv(1.0, N64, GEN, NONE, b64, 0.0))
    per_ilu64 = launches_of(lambda: tt.ilu_smoother(N64, GEN, b64))
    if (st64.l_form.kind, st64.u_form.kind) != ("win", "win"):
        raise AssertionError("float64 nonsymmetric operand: ILU0 forms not win")
    x, it, cyc, delta, t = itsol_run(N64, b64, dict(GM, **{"gmres preconditioner": "ILU0"}), torch.float64)
    res = check_residual("itsol ILU0-GMRES f64", Sn, x, bref, res_tol)
    log(f"  itsol ILU0-GMRES f64: {it} iterations, {cyc} cycles in {t:.3f} s, true rel residual {res:.3e}")
    expect_launches("itsol ILU0-GMRES f64", delta, [(it + cyc, per_mv64, "mv (steps + cycles)"),
                                                     (it, per_ilu64, "applies (steps)")])
    del N64, st64, b64

    # unpreconditioned GMRES: several cycles at restart 4
    g4 = dict(GM, **{"gmres restart iterations": 4})
    x_mat, it_mat, cyc, delta, t = itsol_run(N, b_d, g4, torch.float32)
    res = check_residual("itsol GMRES", Sn, x_mat, bref, res_tol)
    log(f"  itsol GMRES (restart 4): {it_mat} iterations, {cyc} cycles in {t:.3f} s, true rel residual {res:.3e}")
    if cyc < 2:
        raise AssertionError(f"unpreconditioned GMRES at restart 4 took {cyc} cycle(s)")
    expect_launches("itsol GMRES", delta, [(it_mat + cyc, per_mv, "mv (steps + cycles)")])
    c0 = read_counts()
    xf, itf, rf = tt.pgmres_solve(N, b_d, rtol=rtol, atol=0.0, restart=4)
    torch.cuda.synchronize()
    c1 = read_counts()
    resf = check_residual("pgmres none", Sn, xf, bref, res_tol)
    log(f"  pgmres_solve precond=None (restart 4): {itf} iterations, estimate {rf:.3e}, true rel residual {resf:.3e}")
    fused_gmres_launches("pgmres none", {k: c1[k] - c0[k] for k in c1}, itf, 4, per_mv)
    if abs(it_mat - itf) > 4:
        raise AssertionError(f"GMRES: RCI {it_mat} and fused {itf} iterations differ by more than the restart")
    out["gmres"] = (itf, rf)
    # the matrix-free forms: itsol_solve_operator against itsol_solve, and
    # make_gmres_operator against pgmres_solve, on the same mv: the same
    # iterations, x within the f32 model (the same steps; the card's
    # reductions need not repeat their bits)
    matvec = lambda v: tt.mv(1.0, N, GEN, NONE, v, 0.0)  # noqa: E731
    x_op, it_op, _cyc, _delta, _t = itsol_run(None, b_d, g4, torch.float32, matvec=matvec)
    xo, ito, _ro = tt.make_gmres_operator(matvec, maxit=500, restart=4)(b_d, rtol=rtol)
    dx = (near_error(x_op.cpu().numpy(), x_mat.cpu().numpy()), near_error(xo.cpu().numpy(), xf.cpu().numpy()))
    if not (it_op == it_mat and ito == itf and max(dx) <= MV_TOL["f32"]):
        raise AssertionError(f"matrix-free and matrix paths differ: itsol {it_op} / {it_mat}, fused {ito} / {itf} "
                             f"iterations, x by {dx}")
    log(f"  itsol_solve_operator and make_gmres_operator on mv: the matrix paths' iterations ({it_op}, {ito}); "
        f"x apart by {dx[0]:.3e} and {dx[1]:.3e} (bit for bit: {torch.equal(x_op, x_mat)}, {torch.equal(xo, xf)})")

    # the RCI stepper by hand: mv and a Jacobi User preconditioner
    dinv = torch.from_numpy((1.0 / Sn.diagonal()).astype(np.float32)).to(dev)
    h = tt.itsol_init(torch.float32, device=dev)
    for key, v in dict(GM, **{"gmres preconditioner": "User"}).items():
        tt.itsol_option_set(h, key, v)
    tt.itsol_rci_input(h, m, b_d)
    rci = tt.itsol_rci_solve(h)
    jobs = {tt.RciJob.mv: 0, tt.RciJob.precond: 0, tt.RciJob.stopping_criterion: 0}
    c0 = read_counts()
    job, u = rci.step()
    while job != tt.RciJob.stop:
        jobs[job] += 1
        if job == tt.RciJob.mv:
            job, u = rci.step(tt.mv(1.0, N, GEN, NONE, u, 0.0))
        elif job == tt.RciJob.precond:
            job, u = rci.step(dinv * u)
        else:
            job, u = rci.step()
    torch.cuda.synchronize()
    c1 = read_counts()
    h.rci = None
    h.options.unlock_all()
    it = int(h.rinfo[30])
    if rci.status != tt.Status.success or jobs[tt.RciJob.precond] != it:
        raise AssertionError(f"RCI Jacobi-GMRES: status {rci.status.name}, {jobs} for {it} iterations")
    res = check_residual("RCI Jacobi-GMRES", Sn, rci.x, bref, res_tol)
    log(f"  itsol_rci_solve by hand (GMRES, Jacobi User preconditioner): {it} iterations, jobs "
        f"{ {j.name: c for j, c in jobs.items()} }, true rel residual {res:.3e}")
    expect_launches("RCI Jacobi-GMRES", {k: c1[k] - c0[k] for k in c1}, [(jobs[tt.RciJob.mv], per_mv, "mv jobs")])

    # HPCG's stencil: SGS-CG through itsol_solve
    mh = len(hptr) - 1
    Sh = sp.csr_matrix((hval.astype(np.float64), hind, hptr), shape=(mh, mh))
    bh = np.random.default_rng(71).standard_normal(mh).astype(np.float32)
    bh_d = torch.from_numpy(bh).to(dev)
    per_mv_h = launches_of(lambda: tt.mv(1.0, H, GEN, NONE, bh_d, 0.0))
    per_sgs = launches_of(lambda: tt.symgs(NONE, H, GEN, 1.0, bh_d))
    if per_sgs.get("trsv_level_f32") != 2 or per_sgs.get("trsv_dwin_f32", 0):
        raise AssertionError(f"the stencil's SGS apply launched {per_sgs}: want two level solves, no chain")
    log(f"  stencil unit launches: mv {per_mv_h}, SGS apply (symgs) {per_sgs}")
    cg = {"cg preconditioner": "sgs", "cg rel tolerance": rtol, "cg abs tolerance": 0.0}
    x, it, _cyc, delta, t = itsol_run(H, bh_d, cg, torch.float32)
    res = check_residual("itsol SGS-CG (stencil)", Sh, x, bh.astype(np.float64), res_tol)
    log(f"  itsol SGS-CG on the stencil: {it} iterations in {t:.3f} s (pcg_solve sgs: {sgs_iters}), true rel residual "
        f"{res:.3e}")
    # RCI CG: one mv a step and one for the initial residual, one apply a step
    expect_launches("itsol SGS-CG (stencil)", delta, [(it + 1, per_mv_h, "mv (steps + 1)"),
                                                      (it, per_sgs, "applies (steps)")])
    if abs(it - sgs_iters) > 1:
        raise AssertionError(f"itsol SGS-CG took {it} iterations, pcg_solve {sgs_iters}")
    out.update(H=H, bh=bh_d, sgs_cg=it)

    # the webbase stand-in with the shift: permuted-space GMRES
    t0 = time.perf_counter()
    wm = len(wptr) - 1
    Sw, w2ptr, w2ind, w2val = shifted_operand(wptr, wind, wval, wm)
    Wn = tt.create_csr(wm, wm, w2ptr, w2ind, w2val, device=dev)
    tt.set_mv_hint(Wn, NONE, GEN, nop=1000)
    tt.optimize(Wn)
    wform = Wn.plan.exec_form_for(GEN, NONE)
    if not (wform.kind == "gen" and wform.gen_bandt and _spill_route_on(wform, dev)):
        raise AssertionError(f"shifted webbase planned as {wform.kind}, want gen with a routed spill")
    wroute = wform.spill_route()
    torch.cuda.synchronize()
    log(f"  shifted webbase (nnz={w2ind.size}): plan + spill route {time.perf_counter() - t0:.2f} s; W={wform.bwd_W}, "
        f"spilled {wform.sp_ind.numel()}; route {route_desc(wroute)}")
    bw = np.random.default_rng(83).standard_normal(wm).astype(np.float32)
    bw_d = torch.from_numpy(bw).to(dev)
    per_mv_w = launches_of(lambda: tt.mv(1.0, Wn, GEN, NONE, bw_d, 0.0))
    permutes = {"to": 0, "from": 0}
    real = fused_mod._gen_pspace

    def counted_pspace(form):
        mv_p, to_p, from_p = real(form)

        def to_c(v):
            permutes["to"] += 1
            return to_p(v)

        def from_c(v):
            permutes["from"] += 1
            return from_p(v)

        return mv_p, to_c, from_c

    fused_mod._gen_pspace = counted_pspace
    try:
        c0 = read_counts()
        t0 = time.perf_counter()
        xw, itw, rw = tt.pgmres_solve(Wn, bw_d, rtol=rtol, atol=0.0, maxit=3000, restart=20)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        c1 = read_counts()
    finally:
        fused_mod._gen_pspace = real
    res = check_residual("permuted GMRES (webbase)", Sw, xw, bw.astype(np.float64), res_tol)
    log(f"  pgmres_solve permuted space (shifted webbase, restart 20): {itw} iterations in {t:.3f} s, estimate "
        f"{rw:.3e}, true rel residual {res:.3e}; permutes {permutes}")
    if permutes != {"to": 2, "from": 1}:
        raise AssertionError(f"permuted GMRES permuted {permutes}: want b and x0 in once, x out once")
    fused_gmres_launches("permuted GMRES (webbase)", {k: c1[k] - c0[k] for k in c1}, itw, 20, per_mv_w)
    out.update(W=Wn, bw=bw_d, wgmres=(itw, rw))
    return out


def lowprec_complex_path(ptr, ind, val, nonsym, hptr, hind, hval, Hc, hstc, dev, rtol):
    """Phase 5g: bf16 and complex solves through the entry points, at full
    width. bf16: trsv and trsm (K = K_SM) on the lower triangle of the bench
    operand with phase 5f's Gershgorin shift (the raw bench values give a
    triangle no solve holds to a tolerance), its win form on the window
    solves' bf16 instance, against float64 scipy on the bf16 values; mm on
    the bench operand at K = K_MM (bandtm, the band SpMM's bf16 instance, a
    bf16 result). Complex: on the 104^3 stencil shifted by i SIGMA I
    (complex64) trsv, ilu_smoother and sorv (complex omega and alpha), each
    a residual or a float64 scipy sweep, ILU0-GMRES through pgmres_solve and
    through itsol_solve, and SGS-CG through itsol_solve (complex-symmetric:
    unconjugated dots), to a true relative residual <= 10 rtol, their
    sweeps on the level kernel's complex64 instance; trsv on a complex128
    handle of it (the complex128 instance); and ILU0-GMRES on the
    nonsymmetric bench operand in complex64 shifted the same way, whose win
    forms have no complex kernel instance and too many levels for the level
    kernel: the plain route. Each call's launches are the ones its counts
    imply. Returns what phase 6 times."""
    res_tol = 10 * rtol
    bf_tol = expected_precision(torch.bfloat16)
    c_tol = expected_precision(torch.complex64)
    m = len(ptr) - 1
    out = {}
    # bf16 trsv and trsm on the shifted bench operand's lower triangle
    t0 = time.perf_counter()
    _Sn, nptr, nind, nval = nonsym
    v16 = torch.from_numpy(nval).to(torch.bfloat16)
    N16 = tt.create_csr(m, m, nptr, nind, v16, device=dev)
    tt.set_sv_hint(N16, NONE, LOWER, nop=1000)
    tt.set_sm_hint(N16, NONE, LOWER, nop=1000)
    tt.optimize(N16)
    form = trsv_form_for(N16.plan, LOWER, NONE)
    torch.cuda.synchronize()
    log(f"  bf16 shifted bench operand: win form nb={form.nb} WL={form.WL} nblk={form.nblk} ({form.D.dtype}); "
        f"create_csr + hints + optimize + form {time.perf_counter() - t0:.2f} s")
    if form.kind != "win" or form.D.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 bench triangle planned as {form.kind} in {form.D.dtype}, want a bf16 win form")
    Sl16 = sp.tril(sp.csr_matrix((v16.double().numpy(), nind, nptr), shape=(m, m))).tocsr()
    rng = np.random.default_rng(89)
    b16 = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev, torch.bfloat16)
    bref = host64(b16)
    n_sv = solve_launches(form.nblk, form.nb, form.WL, torch.bfloat16)
    x16 = counted("bf16 trsv", lambda: tt.trsv(1.0, N16, LOWER, NONE, b16), {"trsv_win_bf16": n_sv})
    if x16.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 trsv returned {x16.dtype}")
    check_residual("bf16 trsv lower non-unit (shifted bench)", Sl16, x16, bref, bf_tol)
    check_mv("bf16 trsv against float64 scipy", x16, spla.spsolve_triangular(Sl16, bref, lower=True), bf_tol)
    B16 = torch.from_numpy(rng.standard_normal((m, K_SM)).astype(np.float32)).to(dev, torch.bfloat16)
    X16 = counted(f"bf16 trsm K={K_SM}", lambda: tt.trsm(1.0, N16, LOWER, NONE, B16), {"trsm_win_bf16": n_sv})
    residual_cols(f"bf16 trsm lower non-unit K={K_SM} (shifted bench)", Sl16, X16, host64(B16), bf_tol)
    out.update(N16=N16, b16=b16, B16=B16, form16=form)
    # bf16 mm on the bench operand
    A16 = tt.create_csr(m, m, ptr, ind, torch.from_numpy(val).to(torch.bfloat16), device=dev)
    tt.set_mm_hint(A16, NONE, GEN, nop=1000)
    tt.optimize(A16)
    kinds = [f.kind for f in A16.plan.exec_forms.values()]
    if kinds != ["bandtm"]:
        raise AssertionError(f"bf16 bench operand planned for mm as {kinds}, want bandtm")
    Bm16 = torch.from_numpy(np.random.default_rng(SEED_B).standard_normal((m, K_MM)).astype(np.float32)).to(
        dev, torch.bfloat16)
    S16 = sp.csr_matrix((torch.from_numpy(val).to(torch.bfloat16).double().numpy(), ind, ptr), shape=(m, m))
    C16 = counted(f"bf16 mm K={K_MM}", lambda: tt.mm(1.0, A16, GEN, NONE, Bm16, 0.0), {"spmm_band_bf16": 1})
    if C16.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 mm returned {C16.dtype}")
    check_mv(f"bf16 mm K={K_MM} (bandtm) against float64 scipy", C16, S16 @ host64(Bm16), bf_tol)
    out.update(A16=A16, Bm16=Bm16)

    # the complex stencil: trsv, ilu_smoother, sorv (the level kernel, c64)
    mh = len(hptr) - 1
    hcv = complex_stencil(hptr, hind, hval, np.complex64)
    Sc = sp.csr_matrix((hcv.astype(np.complex128), hind, hptr), shape=(mh, mh))
    Lc, Uc, Dc = sp.tril(Sc, -1).tocsr(), sp.triu(Sc, 1).tocsr(), sp.diags(Sc.diagonal())
    crng = np.random.default_rng(97)
    bc = (crng.standard_normal(mh) + 1j * crng.standard_normal(mh)).astype(np.complex64)
    bc_d, bcref = torch.from_numpy(bc).to(dev), bc.astype(np.complex128)
    if tt.ilu0_factorize(Hc) is not hstc:
        raise AssertionError("ilu0_factorize did not return the complex handle's cached factors")
    engine = ttri.sv_engine_for(Hc.plan, LOWER, NONE, dev)
    log(f"  complex stencil: default sv engine {engine}; mv form {Hc.plan.exec_form_for(GEN, NONE).kind}")
    xc = counted("complex64 stencil trsv", lambda: tt.trsv(1.0, Hc, LOWER, NONE, bc_d), {"trsv_level_c64": 1})
    check_residual("complex64 stencil trsv lower non-unit", sp.tril(Sc).tocsr(), xc, bcref, c_tol)
    lu = hstc.lu.to(torch.complex128).cpu().numpy()
    rows = np.repeat(np.arange(mh), np.diff(hptr))
    low = hind < rows
    Lf = sp.csr_matrix((np.r_[lu[low], np.ones(mh)], (np.r_[rows[low], np.arange(mh)],
                        np.r_[hind[low], np.arange(mh)])), shape=(mh, mh))
    Uf = sp.csr_matrix((lu[~low], (rows[~low], hind[~low])), shape=(mh, mh))
    LU = spla.aslinearoperator(Lf) @ spla.aslinearoperator(Uf)
    xs = counted("complex64 stencil ilu_smoother", lambda: tt.ilu_smoother(Hc, GEN, bc_d), {"trsv_level_c64": 2})
    check_residual("complex64 stencil ilu_smoother: L (U x) = b", LU, xs, bcref, c_tol)
    omega, alpha = 1.2 + 0.1j, 0.7 - 0.2j
    x0 = (crng.standard_normal(mh) + 1j * crng.standard_normal(mh)).astype(np.complex64)
    want = spla.spsolve_triangular((Dc + omega * Lc).tocsr(),
                                   omega * bcref - (omega * Uc + (omega - 1.0) * Dc) @ (alpha * x0.astype(np.complex128)),
                                   lower=True)
    check_mv(f"complex64 stencil sorv (omega {omega}, alpha {alpha})",
             counted("complex64 stencil sorv", lambda: tt.sorv(tt.SorType.forward, GEN, Hc, omega, alpha,
                                                                torch.from_numpy(x0).to(dev), bc_d),
                     {"trsv_level_c64": 1}), want, c_tol)
    # ILU0-GMRES through pgmres_solve and itsol_solve, SGS-CG through itsol
    per_mv = launches_of(lambda: tt.mv(1.0, Hc, GEN, NONE, bc_d, 0.0))
    per_ilu = launches_of(lambda: tt.ilu_smoother(Hc, GEN, bc_d))
    per_sgs = launches_of(lambda: tt.symgs(NONE, Hc, GEN, 1.0, bc_d))
    log(f"  complex stencil unit launches: mv {per_mv}, ILU0 apply {per_ilu}, SGS apply {per_sgs}")
    if per_ilu != {"trsv_level_c64": 2} or per_sgs != {"trsv_level_c64": 2}:
        raise AssertionError("the complex stencil's ILU0 and SGS applies must be two complex64 level solves each")
    c0 = read_counts()
    t0 = time.perf_counter()
    xg, itg, rg = tt.pgmres_solve(Hc, bc_d, rtol=rtol, atol=0.0, restart=20, precond="ilu0")
    torch.cuda.synchronize()
    t_g = time.perf_counter() - t0
    c1 = read_counts()
    res = check_residual("complex64 stencil pgmres ILU0", Sc, xg, bcref, res_tol)
    log(f"  complex64 stencil pgmres_solve precond=ilu0: {itg} iterations in {t_g:.3f} s, estimate {rg:.3e}, "
        f"true rel residual {res:.3e} (tol {res_tol:.1e})")
    fused_gmres_launches("complex stencil pgmres ilu0", {k: c1[k] - c0[k] for k in c1}, itg, 20, per_mv, per_ilu)
    GM = {"iterative method": "GMRES", "gmres rel tolerance": rtol, "gmres abs tolerance": 0.0,
          "gmres preconditioner": "ILU0"}
    x, it, cyc, delta, t = itsol_run(Hc, bc_d, GM, torch.complex64)
    res = check_residual("complex64 stencil itsol ILU0-GMRES", Sc, x, bcref, res_tol)
    log(f"  complex64 stencil itsol ILU0-GMRES: {it} iterations, {cyc} cycles in {t:.3f} s, true rel residual "
        f"{res:.3e}")
    expect_launches("complex stencil itsol ILU0-GMRES", delta, [(it + cyc, per_mv, "mv (steps + cycles)"),
                                                                (it, per_ilu, "applies (steps)")])
    if abs(it - itg) > 20:
        raise AssertionError(f"complex ILU0-GMRES: RCI {it} and fused {itg} iterations differ by more than the restart")
    cg = {"iterative method": "CG", "cg preconditioner": "SGS", "cg rel tolerance": rtol, "cg abs tolerance": 0.0}
    x, itc, _cyc, delta, t = itsol_run(Hc, bc_d, cg, torch.complex64)
    res = check_residual("complex64 stencil itsol SGS-CG", Sc, x, bcref, res_tol)
    log(f"  complex64 stencil itsol SGS-CG (unconjugated dots): {itc} iterations in {t:.3f} s, true rel residual "
        f"{res:.3e}")
    expect_launches("complex stencil itsol SGS-CG", delta, [(itc + 1, per_mv, "mv (steps + 1)"),
                                                            (itc, per_sgs, "applies (steps)")])
    out.update(Hc=Hc, bc=bc_d, gmres_c=(itg, rg), bcnorm=float(np.linalg.norm(bcref)), cg_c=itc)
    # complex128: trsv on the stencil's lower triangle (the c128 instance)
    t0 = time.perf_counter()
    Hc128 = tt.create_csr(mh, mh, hptr, hind, hcv.astype(np.complex128), device=dev)
    x128 = counted("complex128 stencil trsv", lambda: tt.trsv(1.0, Hc128, LOWER, NONE, bc_d.to(torch.complex128)),
                   {"trsv_level_c128": 1})
    check_residual("complex128 stencil trsv lower non-unit", sp.tril(Sc).tocsr(), x128, bcref,
                   expected_precision(torch.complex128))
    log(f"  complex128 stencil trsv (level form built on the first call) {time.perf_counter() - t0:.2f} s")
    del Hc128

    # ILU0-GMRES on the complex nonsymmetric bench operand: the plain route
    t0 = time.perf_counter()
    nrows = np.repeat(np.arange(m), np.diff(nptr))
    ncv = (nval.astype(np.float64) + 1j * SIGMA * (nrows == nind)).astype(np.complex64)
    Nc = tt.create_csr(m, m, nptr, nind, ncv, device=dev)
    nst = tt.ilu0_factorize(Nc)
    torch.cuda.synchronize()
    fl = nst.l_form
    nlev = sum(_factor_nlev(nst))
    log(f"  complex64 shifted bench operand: ILU0 forms {fl.kind} / {nst.u_form.kind} (nb={fl.nb}, WL={fl.WL}, "
        f"nblk={fl.nblk}), {nlev} levels in L and U, engine {ttri.pick_sv_engine(fl, lambda: nlev, dev)}; "
        f"create_csr + ilu0_factorize {time.perf_counter() - t0:.2f} s")
    if (fl.kind, nst.u_form.kind) != ("win", "win") or ttri.has_solve_kernel("win", torch.complex64):
        raise AssertionError("the complex bench operand's ILU0 forms must be win forms with no kernel instance")
    bn = (crng.standard_normal(m) + 1j * crng.standard_normal(m)).astype(np.complex64)
    bn_d = torch.from_numpy(bn).to(dev)
    Snc = sp.csr_matrix((ncv.astype(np.complex128), nind, nptr), shape=(m, m))
    if launches_of(lambda: tt.ilu_smoother(Nc, GEN, bn_d)):
        raise AssertionError("the complex bench operand's ILU0 apply launched a kernel: want the plain route")
    t0 = time.perf_counter()
    xn, itn, rn = tt.pgmres_solve(Nc, bn_d, rtol=rtol, atol=0.0, restart=20, precond="ilu0")
    torch.cuda.synchronize()
    res = check_residual("complex64 bench pgmres ILU0 (plain win route)", Snc, xn, bn.astype(np.complex128), res_tol)
    log(f"  complex64 shifted bench pgmres_solve precond=ilu0: {itn} iterations in {time.perf_counter() - t0:.3f} s, "
        f"estimate {rn:.3e}, true rel residual {res:.3e}")
    out.update(Nc=Nc, nst=nst, bn=bn_d)
    return out


def fixed_restart(restart, it, res, bnorm, digits=30.0):
    """The restart r of a fixed-length GMRES timing (rtol = atol = 0, r and
    2 r steps, whole cycles): its f32 Givens estimate falls at about the
    convergent solve's rate (log10(||b|| / res) / it digits a step) and must
    stay `digits` above ||b|| * 1e-30 or so, clear of underflow, else the
    loop stops short. restart where 2 restart steps keep there, else less."""
    rate = max(np.log10(bnorm / max(res, 1e-300)) / max(it, 1), 1e-3)
    steps = digits / rate
    return restart if 2 * restart <= steps else max(1, int(steps // 2))


def solver_timings(sf):
    """Phase 6's solver-framework times: ms an iteration, host clock, the
    difference of two fixed-length solves (rtol = atol = 0), median of
    three turns; one profiler window of two ILU0-GMRES cycles."""
    N, b_d, bnorm = sf["N"], sf["b"], sf["bnorm"]
    out = {}
    for name, precond, restart, key in (("ILU0-GMRES", "ilu0", 20, "ilu_gmres"), ("GMRES", None, 20, "gmres")):
        r = fixed_restart(restart, *sf[key], bnorm)
        t_it, t_all = iteration_ms(lambda kk: tt.pgmres_solve(N, b_d, rtol=0.0, atol=0.0, maxit=kk, restart=r,
                                                              precond=precond)[1], r, 2 * r)
        out[name] = t_it
        log(f"  {name} iteration (pgmres_solve, nonsymmetric bench operand, restart {r}, {r} and {2 * r} steps): "
            f"{t_it:.4f} ms (host clock, median of {[round(t, 4) for t in t_all]})")
        if precond == "ilu0":
            profile_mv(f"ILU0-GMRES, two cycles of {r} steps", lambda: tt.pgmres_solve(
                N, b_d, rtol=0.0, atol=0.0, maxit=2 * r, restart=r, precond="ilu0"), calls=1, top=8)

    def sgs_cg(kk):
        # the RCI CG stops once its count passes the limit: kk - 1 runs kk
        h = tt.itsol_init(torch.float32)
        for key, v in {"cg preconditioner": "sgs", "cg rel tolerance": 0.0, "cg abs tolerance": 0.0,
                       "cg iteration limit": kk - 1}.items():
            tt.itsol_option_set(h, key, v)
        _x, rinfo, _status = tt.itsol_solve(h, sf["bh"].shape[0], sf["H"], GEN, sf["bh"])
        return int(rinfo[30])

    t_it, t_all = iteration_ms(sgs_cg, 2, 6)
    out["SGS-CG"] = t_it
    log(f"  itsol SGS-CG iteration (104^3 stencil): {t_it:.4f} ms (host clock, median of "
        f"{[round(t, 4) for t in t_all]}; {sf['sgs_cg']} iterations to rtol 1e-6)")
    r = fixed_restart(20, *sf["wgmres"], float(sf["bw"].double().norm()))
    t_it, t_all = iteration_ms(lambda kk: tt.pgmres_solve(sf["W"], sf["bw"], rtol=0.0, atol=0.0, maxit=kk,
                                                          restart=r)[1], r, 2 * r)
    out["permuted GMRES"] = t_it
    log(f"  permuted-space GMRES iteration (shifted webbase, restart {r}, {r} and {2 * r} steps): {t_it:.4f} ms "
        f"(host clock, median of {[round(t, 4) for t in t_all]})")
    return out


def lowprec_timings(lp):
    """Phase 6's times of phase 5g's calls: the bf16 trsv, trsm and mm calls
    (CUDA events around back-to-back calls: the call's time, host work
    included), and on the complex stencil an ILU0-GMRES and an itsol SGS-CG
    iteration (host clock, the difference of two fixed-length solves,
    median of three turns) with one profiler window of an ILU0-GMRES cycle."""
    N16, b16, B16 = lp["N16"], lp["b16"], lp["B16"]
    t_sv = cuda_ms(lambda: tt.trsv(1.0, N16, LOWER, NONE, b16), reps=5, inner=3)
    t_sm = cuda_ms(lambda: tt.trsm(1.0, N16, LOWER, NONE, B16), reps=5, inner=3)
    t_mm = cuda_ms(lambda: tt.mm(1.0, lp["A16"], GEN, NONE, lp["Bm16"], 0.0), reps=5, inner=3)
    log(f"  bf16 calls (shifted bench operand): trsv {t_sv:.4f} ms, trsm K={K_SM} {t_sm:.4f} ms; mm K={K_MM} "
        f"(bandtm) {t_mm:.4f} ms")
    Hc, bc = lp["Hc"], lp["bc"]
    r = fixed_restart(20, *lp["gmres_c"], lp["bcnorm"])
    t_it, t_all = iteration_ms(lambda kk: tt.pgmres_solve(Hc, bc, rtol=0.0, atol=0.0, maxit=kk, restart=r,
                                                          precond="ilu0")[1], r, 2 * r)
    log(f"  complex64 stencil ILU0-GMRES iteration (pgmres_solve, restart {r}, {r} and {2 * r} steps): {t_it:.4f} ms "
        f"(host clock, median of {[round(t, 4) for t in t_all]}; {lp['gmres_c'][0]} iterations to rtol 1e-6)")
    profile_mv(f"complex64 stencil ILU0-GMRES, one cycle of {r} steps", lambda: tt.pgmres_solve(
        Hc, bc, rtol=0.0, atol=0.0, maxit=r, restart=r, precond="ilu0"), calls=1, top=6)

    def sgs_cg(kk):
        h = tt.itsol_init(torch.complex64)
        for key, v in {"cg preconditioner": "sgs", "cg rel tolerance": 0.0, "cg abs tolerance": 0.0,
                       "cg iteration limit": kk - 1}.items():
            tt.itsol_option_set(h, key, v)
        _x, rinfo, _status = tt.itsol_solve(h, bc.shape[0], Hc, GEN, bc)
        return int(rinfo[30])

    t_it, t_all = iteration_ms(sgs_cg, 2, 6)
    log(f"  complex64 stencil itsol SGS-CG iteration: {t_it:.4f} ms (host clock, median of "
        f"{[round(t, 4) for t in t_all]}; {lp['cg_c']} iterations to rtol 1e-6)")


def coo_csr(rows, cols, vals, m):
    """(ptr, ind, val) of an m x m COO triangle, sorted by row and column."""
    S = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    S.sort_indices()
    return S.indptr, S.indices, S.data


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
    ptxas = lib.with_suffix(".log").read_text()
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())
    # the route, accumulate, block-window SpMV and SpMM, group-window,
    # window-solve, band GEMM, band SpMM, diagonal SpMM and blocked-solve
    # chain kernels index no register array at run time: no stack frame,
    # no spills
    names = ("benes_pass_kernel", "oh_accum_kernel", "spmv_mxu_kernel", "spmv_bwd_kernel", "win_block_kernel",
             "win_chain_kernel", "win_fix_kernel", "win_round_kernel", "spmm_band_mxu_f32_kernel", "spmm_band_mxu_bf16_kernel",
             "band_gemm_kernel", "spmm_band_kernel", "spmm_diag_kernel", "trsv_blocked_kernel", "trsv_level_kernel")
    res = ptxas_resources(ptxas, names)
    for fn, (frame, stores, loads, regs) in sorted(res.items()):
        short = next(fn[fn.index(nm):] for nm in names if nm in fn)[:48]
        log(f"  {short}: {regs} registers, {frame} bytes stack frame, {stores} / {loads} bytes spill stores / loads")
    missing = [nm for nm in names if not any(nm in fn for fn in res)]
    if missing or any(any(v[:3]) for v in res.values()):
        raise AssertionError(f"kernels with a stack frame or spills, or not found ({missing}): {res}")
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

    # the group-window kernel on the bench operand's bwd form (its peel
    # spill added in the launch), on the small odd-m operand, whose windows
    # start left of column 0 (padL > 0), and on a W = 8 form; no W here is a
    # multiple of 32 (136, 40, 8), so a row's last vectors leave lanes idle;
    # each twice, for the same bits
    bwd32 = bandt_form(ptr, ind, val, dev, kind="bwd")
    log(f"  bench bwd form: {bwd_desc(bwd32)}")
    if not bwd32.has_spill:
        raise AssertionError("the bench bwd form must peel a spill")
    bwd_bf = bwd32.band_bf16()
    bwd64 = bandt_form(ptr, ind, val.astype(np.float64), dev, kind="bwd")
    for kernel, form, band, xv in (("spmv_bwd_f32", bwd32, bwd32.bwd_val, x32),
                                   ("spmv_bwd_bf16", bwd32, bwd_bf, x32),
                                   ("spmv_bwd_f64", bwd64, bwd64.bwd_val, x64)):
        compare(kernel, "bench", same_bits(kernel, "bench", lambda: spmv_bwd(band, xv, *bwd_args(form))),
                plain_bwd(band, xv, form), errs)
    del bwd64
    dptr, dind, dval, dx = diagonal_operand()
    for inst, dt in (("f32", np.float32), ("bf16", np.float32), ("f64", np.float64)):
        for (pp, ii, vv, xx), want_W in (((sptr, sind, sval, sx), 40), ((dptr, dind, dval, dx), 8)):
            sf = bandt_form(pp, ii, vv.astype(dt), dev, kind="bwd")
            if not (sf.has_spill and sf.m % 2 == 1 and sf.bwd_W == want_W and (want_W == 8 or sf.bwd_padL > 0)):
                raise AssertionError(f"small bwd form must be odd-m with a spill, W={want_W} (and padL > 0 "
                                     f"for W=40): {bwd_desc(sf)}")
            band = sf.band_bf16() if inst == "bf16" else sf.bwd_val
            xs = torch.from_numpy(xx.astype(dt)).to(dev)
            label = f"small odd-m{', window left of column 0' if sf.bwd_padL else ''} ({bwd_desc(sf)})"
            compare(f"spmv_bwd_{inst}", label,
                    same_bits(f"spmv_bwd_{inst}", label, lambda: spmv_bwd(band, xs, *bwd_args(sf))),
                    plain_bwd(band, xs, sf), errs)

    # the tile-major kernels and the block-window SpMV on the bench bandt
    # form's tile-major band and block windows, and on the small odd-m
    # form's with start > 0 and padL > 0 (its last tile and block ragged);
    # the streaming-read probe on the band slab and on a 128 MiB buffer
    tiles = {"f32": f32.bandt_tiles(TM_TILES), "bf16": f32.bandt_tiles(TM_TILES, bf16=True)}
    wins = {"f32": f32.band_mxu_dt(), "bf16": f32.band_mxu_dt(bf16=True)}
    sf = bandt_form(sptr, sind, sval.astype(np.float32), dev)
    s_tiles = {"f32": sf.bandt_tiles(TM_TILES), "bf16": sf.bandt_tiles(TM_TILES, bf16=True)}
    s_wins = {"f32": sf.band_mxu_dt(), "bf16": sf.band_mxu_dt(bf16=True)}
    xs = torch.from_numpy(sx.astype(np.float32)).to(dev)
    sargs = (sf.bandt_start + 3, sf.bwd_padL + 3, sf.m)  # the shifts cancel: the same product
    small = (f"small odd-m (m={sf.m}, W={sf.bwd_W}, start={sargs[0]}, padL={sargs[1]}, "
             f"{s_tiles['f32'].shape[0]} tiles of {TM_TILES}, {s_wins['f32'].shape[0]} blocks)")
    log(f"  bench tile-major band {tuple(tiles['f32'].shape)}, block windows {tuple(wins['f32'].shape)}")
    # the block windows at the forms' band widths, twice for the same bits;
    # the bench windows again as a caller with no band width passes them
    # (W = 256); random windows at W = 1 and W = 129 (the widest a window
    # holds) on an odd m with start > 0 and padL > 0
    rng = np.random.default_rng(31)
    for inst in ("f32", "bf16"):
        for label, vt3, dt_, xv, a, Wd in (("bench", tiles[inst], wins[inst], x32, (*args32, m), f32.bwd_W),
                                           (small, s_tiles[inst], s_wins[inst], xs, sargs, sf.bwd_W)):
            compare(f"band_spmv_tiles_{inst}", label, band_spmv_tiles(vt3, xv, *a),
                    band_spmv_tiles_plain(vt3, xv, *a), errs)
            compare(f"band_spmv_tiles_dbuf_{inst}", label, band_spmv_tiles_dbuf(vt3, xv, *a),
                    band_spmv_tiles_plain(vt3, xv, *a), errs)
            kernel = f"spmv_band_mxu_{inst}"
            compare(kernel, f"{label}, W={Wd}", same_bits(kernel, label, lambda: spmv_band_mxu(dt_, xv, *a, Wd)),
                    spmv_band_mxu_plain(dt_, xv, *a), errs)
        compare(kernel, "bench, W=256", spmv_band_mxu(wins[inst], x32, *args32, m, 256),
                spmv_band_mxu_plain(wins[inst], x32, *args32, m), errs)
        for Wr in (1, 129):
            vt_r = torch.from_numpy(rng.standard_normal((4099, Wr)).astype(np.float32)).to(dev)
            dt_r = band_mxu_blocks(vt_r, Wr)
            dt_r = dt_r.to(torch.bfloat16) if inst == "bf16" else dt_r
            label = f"random windows W={Wr} (m=4099, start=3, padL=5)"
            compare(kernel, label, same_bits(kernel, label, lambda: spmv_band_mxu(dt_r, xs, 3, 5, 4099, Wr)),
                    spmv_band_mxu_plain(dt_r, xs, 3, 5, 4099), errs)
    del sf, s_tiles, s_wins, xs, vt_r, dt_r
    cold = torch.from_numpy(np.random.default_rng(7).standard_normal(COLD_VALUES).astype(np.float32)).to(dev)
    for label, v in ((f"band slab {tuple(f32.bwd_val.shape)}", f32.bwd_val), ("128 MiB buffer", cold)):
        got = stream_read(v)
        compare("stream_read_f32", label, got, stream_read_plain(v), errs)
        check_mv(f"stream_read_f32 {label} vs a float64 sum", got, np.asarray(float(v.double().sum())),
                 MV_TOL["f32"])

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
    ilu_ops = {name: form.operands() + (form.solve_ops(),) for name, form in (("L", st.l_form), ("U", st.u_form))}
    torch.cuda.synchronize()
    t_ops = time.perf_counter() - t0
    # the two parts of the forms' operand set-up, each timed again alone
    t_invert = t_pset = 0.0
    for form in (st.l_form, st.u_form):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        invert_diag_blocks(form.D)
        torch.cuda.synchronize()
        t_invert += time.perf_counter() - t0
        dT, lT = form.operands()
        t0 = time.perf_counter()
        win_solve_operands(dT, lT, form.nb, form.WL)
        torch.cuda.synchronize()
        t_pset += time.perf_counter() - t0
    for name, form in (("L", st.l_form), ("U", st.u_form)):
        log(f"  ILU0 {name} form: nb={form.nb} WL={form.WL} nblk={form.nblk} "
            f"reversed={form.reversed_} unit={form.unit_diag} source={form._src_space}")
        if form._src_space != "clean":
            raise AssertionError("the ILU0 forms did not come from the native builder")
    log(f"  ilu0_factorize (C++ IKJ + native form builds + upload) {t_factor:.2f} s; the forms' kernel operands "
        f"(both factors) {t_ops:.2f} s: diagonal-block inversion {t_invert:.3f} s, P = lwT @ dinvT and F "
        f"{t_pset:.3f} s (each timed alone)")
    wrng = np.random.default_rng(17)
    bw = torch.from_numpy(wrng.standard_normal(st.l_form.m_pad).astype(np.float32)).to(dev)
    bw_m = torch.from_numpy(wrng.standard_normal((st.l_form.m_pad, K_SM)).astype(np.float32)).to(dev)
    # each window solve against its plain version, and bit-equal on a second
    # call; the f64 instance on the f32 form's operands in f64, with its own
    # card operands
    for name, form in (("L", st.l_form), ("U", st.u_form)):
        dT, lT, ops = ilu_ops[name]
        nb_, WL_ = form.nb, form.WL
        label = f"ILU0 {name} (nb={nb_}, WL={WL_}, nblk={form.nblk})"
        got = same_bits("trsv_win_f32", label, lambda: trsv_win(dT, lT, bw, nb_, WL_, ops))
        compare("trsv_win_f32", label, got, trsv_win_plain(dT, lT, bw, nb_, WL_), errs)
        log(f"  {label}: the far part of a group (v F_j, j >= a + 2) weighs {far_weight(ops, got, nb_, WL_):.3e} "
            f"of max |x| in the f32 solve; largest tail norm ||T_k||_2 {tail_norm(ops, nb_, WL_):.3e}")
        compare("trsm_win_f32", f"{label} K={K_SM}",
                same_bits("trsm_win_f32", label, lambda: trsm_win(dT, lT, bw_m, nb_, WL_, ops)),
                trsm_win_plain(dT, lT, bw_m, nb_, WL_), errs)
        dT, lT, b64, bm64 = dT.double(), lT.double(), bw.double(), bw_m.double()
        ops = win_solve_operands(dT, lT, nb_, WL_)
        compare("trsv_win_f64", label,
                same_bits("trsv_win_f64", label, lambda: trsv_win(dT, lT, b64, nb_, WL_, ops)),
                trsv_win_plain(dT, lT, b64, nb_, WL_), errs)
        compare("trsm_win_f64", f"{label} K={K_SM}",
                same_bits("trsm_win_f64", label, lambda: trsm_win(dT, lT, bm64, nb_, WL_, ops)),
                trsm_win_plain(dT, lT, bm64, nb_, WL_), errs)
        del dT, lT, ops, b64, bm64
    # the bf16 instance on the ILU0 L form's operands rounded to bf16 (its
    # card operands P and F in f32), K = 1 and K_SM, against the plain
    # version, which rounds where the Pallas kernels round
    dT16, lT16 = (t.to(torch.bfloat16) for t in ilu_ops["L"][:2])
    fL = st.l_form
    ops16 = win_solve_operands(dT16, lT16, fL.nb, fL.WL)
    bw16, bwm16 = bw.to(torch.bfloat16), bw_m.to(torch.bfloat16)
    label = f"ILU0 L in bf16 (nb={fL.nb}, WL={fL.WL}, nblk={fL.nblk}, groups of {ops16.group})"
    got16 = same_bits("trsv_win_bf16", label, lambda: trsv_win(dT16, lT16, bw16, fL.nb, fL.WL, ops16))
    compare("trsv_win_bf16", label, got16, trsv_win_plain(dT16, lT16, bw16, fL.nb, fL.WL), errs)
    log(f"  {label}: against the f32 plain solve on the f32 operands max rel err "
        f"{near_error(host64(got16), host64(trsv_win_plain(*ilu_ops['L'][:2], bw, fL.nb, fL.WL))):.3e}")
    compare("trsm_win_bf16", f"{label} K={K_SM}",
            same_bits("trsm_win_bf16", label, lambda: trsm_win(dT16, lT16, bwm16, fL.nb, fL.WL, ops16)),
            trsm_win_plain(dT16, lT16, bwm16, fL.nb, fL.WL), errs)
    del got16
    # the same shape with tails of spectral norm 0.95: the far part of each
    # group weighs, and a zeroed F must fail the comparison
    fL = st.l_form
    sdinv, slwT = strong_tail_operands(fL.nblk, fL.nb, fL.WL, SEED_STRONG, dev)
    for inst, dt in (("f32", torch.float32), ("f64", torch.float64)):
        dT, lT = sdinv.transpose(1, 2).contiguous().to(dt), slwT.to(dt)
        ops = win_solve_operands(dT, lT, fL.nb, fL.WL)
        bs, bsm = bw.to(dt), bw_m.to(dt)
        label = f"strong tails (nb={fL.nb}, WL={fL.WL}, nblk={fL.nblk}, ||T_k||_2 >= {tail_norm(ops, fL.nb, fL.WL, 'min'):.4f})"
        got = same_bits(f"trsv_win_{inst}", label, lambda: trsv_win(dT, lT, bs, fL.nb, fL.WL, ops))
        compare(f"trsv_win_{inst}", label, got, trsv_win_plain(dT, lT, bs, fL.nb, fL.WL), errs)
        far = far_weight(ops, got, fL.nb, fL.WL)
        log(f"  {label}: the far part of a group weighs {far:.3e} of max |x|")
        if not far >= 100 * KERNEL_TOL["trsv_win_f32"]:
            raise AssertionError(f"strong-tail operands: the far part of a group weighs only {far:.3e}")
        compare(f"trsm_win_{inst}", f"{label} K={K_SM}",
                same_bits(f"trsm_win_{inst}", label, lambda: trsm_win(dT, lT, bsm, fL.nb, fL.WL, ops)),
                trsm_win_plain(dT, lT, bsm, fL.nb, fL.WL), errs)
        if inst == "f32":
            bad = trsv_win(dT, lT, bs, fL.nb, fL.WL, dataclasses.replace(ops, F=torch.zeros_like(ops.F)))
            err = near_error(bad.double().cpu().numpy(), got.double().cpu().numpy())
            log(f"  {label}: with F zeroed (a planted fault) max rel err {err:.3e}")
            if not err > 10 * KERNEL_TOL["trsv_win_f32"]:
                raise AssertionError("strong-tail operands: a zeroed F passes the comparison")
        del dT, lT, ops, bs, bsm
    del sdinv, slwT
    # a real factor whose group chain weighs: ILU0 of the 5-point 2-D
    # Laplacian on a 90^2 grid (a grouped win form), L and U, f32 and f64
    lptr, lind, lval = laplacian_2d(90)
    for inst, dt in (("f32", np.float32), ("f64", np.float64)):
        lm = len(lptr) - 1
        lst = ilu0_factorize(tt.create_csr(lm, lm, lptr, lind, lval.astype(dt), device="cuda"))
        for name, form in (("L", lst.l_form), ("U", lst.u_form)):
            dT, lT = form.operands()
            ops = form.solve_ops()
            if not ops.group > 1:
                raise AssertionError(f"the 90^2 Laplacian's ILU0 {name} form must be grouped, got {ops.group}")
            bs = torch.from_numpy(wrng.standard_normal(form.m_pad).astype(dt)).to(dev)
            label = (f"90^2 Laplacian ILU0 {name} (nb={form.nb}, WL={form.WL}, nblk={form.nblk}, "
                     f"groups of {ops.group})")
            got = same_bits(f"trsv_win_{inst}", label, lambda: trsv_win(dT, lT, bs, form.nb, form.WL, ops))
            compare(f"trsv_win_{inst}", label, got, trsv_win_plain(dT, lT, bs, form.nb, form.WL), errs)
            log(f"  {label}: the far part of a group weighs {far_weight(ops, got, form.nb, form.WL):.3e} of max "
                f"|x|; largest tail norm {tail_norm(ops, form.nb, form.WL):.3e}")
    del lst, dT, lT, ops, bs
    wptr, wind, wval = wide_window_operand()
    for inst, dt in (("f32", np.float32), ("f64", np.float64)):
        Wh = tt.create_csr(len(wptr) - 1, len(wptr) - 1, wptr, wind, wval.astype(dt), device="cuda")
        wf = trsv_form_for(tt.optimize(Wh), LOWER, NONE, nb=64)
        if not (wf.WL > wf.nb and wf.m % 2 == 1):
            raise AssertionError(f"small form must be odd-m with WL > nb, got m={wf.m} WL={wf.WL}")
        dT, lT = wf.operands()
        ops = wf.solve_ops()
        bs = torch.from_numpy(wrng.standard_normal(wf.m_pad).astype(dt)).to(dev)
        label = f"small odd-m (m={wf.m}, nb={wf.nb}, WL={wf.WL}, nblk={wf.nblk})"
        compare(f"trsv_win_{inst}", label,
                same_bits(f"trsv_win_{inst}", label, lambda: trsv_win(dT, lT, bs, wf.nb, wf.WL, ops)),
                trsv_win_plain(dT, lT, bs, wf.nb, wf.WL), errs)
        kc = trsm_chunk(300, wf.nb, wf.WL, bs.element_size())
        if not 300 > kc > 0:
            raise AssertionError(f"K=300 must need several column chunks, got chunk {kc}")
        bs = torch.from_numpy(wrng.standard_normal((wf.m_pad, 300)).astype(dt)).to(dev)
        compare(f"trsm_win_{inst}", f"{label} K=300 ({-(-300 // kc)} chunks of {kc})",
                same_bits(f"trsm_win_{inst}", label, lambda: trsm_win(dT, lT, bs, wf.nb, wf.WL, ops)),
                trsm_win_plain(dT, lT, bs, wf.nb, wf.WL), errs)
    del Wh, wf, dT, lT, ops, bs

    # the SpMM kernels on the bench operand's bandtm form
    Bm = torch.from_numpy(np.random.default_rng(SEED_B).standard_normal((n, K_MM)).astype(np.float32)).to(dev)
    Bm64 = Bm.double()
    tm32 = bandt_form(ptr, ind, val, dev, kind="bandtm")
    tm64 = bandt_form(ptr, ind, val.astype(np.float64), dev, kind="bandtm")
    targs = (tm32.bandt_start, tm32.bwd_padL)
    log(f"  bench bandtm form: W={tm32.bwd_W} padL={tm32.bwd_padL} start={tm32.bandt_start} "
        f"spill={0 if not tm32.has_spill else tm32.sp_ind.numel()}")
    for kernel, v_, B_ in (("spmm_band_f32", tm32.bwd_val, Bm), ("spmm_band_f64", tm64.bwd_val, Bm64)):
        label = f"bench K={K_MM}"
        compare(kernel, label, same_bits(kernel, label, lambda: spmm_band(v_, B_, *targs)),
                spmm_band_plain(v_, B_, *targs), errs)
    # random bands at W = 1 and at the planner's cap, K = 300 (several
    # column chunks), m below one 128-row tile and off a multiple of it
    brng = np.random.default_rng(41)
    for inst, dt in (("f32", np.float32), ("f64", np.float64)):
        for mr, Wr, Kr in ((90, 1, 300), (4099, band_max_w(torch.float32 if inst == "f32" else torch.float64), 300)):
            v_r = torch.from_numpy(brng.standard_normal((mr, Wr)).astype(dt)).to(dev)
            B_r = torch.from_numpy(brng.standard_normal((mr + 7, Kr)).astype(dt)).to(dev)
            label = f"random band W={Wr} (m={mr}, K={Kr}, start=3, padL={Wr // 2})"
            compare(f"spmm_band_{inst}", label, same_bits(f"spmm_band_{inst}", label,
                                                          lambda: spmm_band(v_r, B_r, 3, Wr // 2)),
                    spmm_band_plain(v_r, B_r, 3, Wr // 2), errs)
    # the bf16 band instance (a bf16 handle's bandtm form: B and C f32) on
    # the bench band rounded to bf16, and on random bands at W = 2 and at
    # the cap (400), K = 300
    v16 = tm32.bwd_val.to(torch.bfloat16)
    label = f"bench bf16 band K={K_MM}"
    compare("spmm_band_bf16", label, same_bits("spmm_band_bf16", label, lambda: spmm_band(v16, Bm, *targs)),
            spmm_band_plain(v16, Bm, *targs), errs)
    for mr, Wr, Kr in ((90, 2, 300), (4099, band_max_w(torch.bfloat16), 300)):
        v_r = torch.from_numpy(brng.standard_normal((mr, Wr)).astype(np.float32)).to(dev, torch.bfloat16)
        B_r = torch.from_numpy(brng.standard_normal((mr + 7, Kr)).astype(np.float32)).to(dev)
        label = f"random bf16 band W={Wr} (m={mr}, K={Kr}, start=3, padL={Wr // 2})"
        compare("spmm_band_bf16", label, same_bits("spmm_band_bf16", label, lambda: spmm_band(v_r, B_r, 3, Wr // 2)),
                spmm_band_plain(v_r, B_r, 3, Wr // 2), errs)
    del v_r, B_r
    dt32, dtbf = tm32.band_mxu_dt(), tm32.band_mxu_dt(bf16=True)
    W_mm = tm32.bwd_W
    # the block-window kernel at the form's band width (and W = 256, as a
    # caller with none passes it), twice for the same bits; random windows
    # at W = 1, 64 and 128 on an odd m with start > 0 and padL > 0, and K = 9
    # (4-byte B copies)
    mrng = np.random.default_rng(37)
    for kernel, dt_ in (("spmm_band_mxu_f32", dt32), ("spmm_band_mxu_bf16", dtbf)):
        label = f"bench K={K_MM} (nblk={dt_.shape[0]}, W={W_mm})"
        compare(kernel, label, same_bits(kernel, label, lambda: spmm_band_mxu(dt_, Bm, *targs, m, W_mm)),
                spmm_band_mxu_plain(dt_, Bm, *targs, m), errs)
        compare(kernel, f"bench K={K_MM}, W=256", spmm_band_mxu(dt_, Bm, *targs, m, 256),
                spmm_band_mxu_plain(dt_, Bm, *targs, m), errs)
        for Wr, Kr in ((1, K_MM), (64, 9), (128, K_MM)):
            vt_r = torch.from_numpy(mrng.standard_normal((4099, Wr)).astype(np.float32)).to(dev)
            dt_r = band_mxu_blocks(vt_r, Wr).to(dt_.dtype)
            B_r = torch.from_numpy(mrng.standard_normal((4100, Kr)).astype(np.float32)).to(dev)
            label = f"random windows W={Wr} (m=4099, K={Kr}, start=3, padL=5)"
            compare(kernel, label, same_bits(kernel, label, lambda: spmm_band_mxu(dt_r, B_r, 3, 5, 4099, Wr)),
                    spmm_band_mxu_plain(dt_r, B_r, 3, 5, 4099), errs)
    del vt_r, dt_r, B_r
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
    hoffs = hf.dia_offs_static
    for kernel, dv, Bx in (("spmm_diag_f32", hf.dia_val, Bh), ("spmm_diag_bf16", hf.dia_bf16(), Bh),
                           ("spmm_diag_f64", hv64, Bh64)):
        label = f"stencil K={K_MM} (windows {diag_schedule(hoffs, kernel[10:], dev).windows})"
        compare(kernel, label, same_bits(kernel, label, lambda: spmm_diag(dv, hf.dia_offs, Bx, offs_static=hoffs)),
                spmm_diag_plain(dv, hf.dia_offs, Bx), errs)
    dptr, dind, dval = diag_operand()
    for inst, dt in (("f32", np.float32), ("bf16", np.float32), ("f64", np.float64)):
        df = bandt_form(dptr, dind, dval.astype(dt), dev, kind="diag")
        if not (df.m % 2 == 1 and df.dia_offs_static[0] < 0):
            raise AssertionError("small diag operand must be odd-m with a negative offset")
        dv = df.dia_bf16() if inst == "bf16" else df.dia_val
        Bs = torch.from_numpy(np.random.default_rng(37).standard_normal((df.n, 13)).astype(dt)).to(dev)
        compare(f"spmm_diag_{inst}", f"small odd-m K=13 (m={df.m}, offsets {df.dia_offs_static})",
                spmm_diag(dv, df.dia_offs, Bs), spmm_diag_plain(dv, df.dia_offs, Bs), errs)
    # 192 diagonals; a lone far diagonal with offsets past +-n; the 12^3
    # stencil at K = 1, 13 and 300, each called twice for the same bits
    st12 = tuple((dz * 12 + dy) * 12 + dx for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    drng = np.random.default_rng(43)
    for mr, nr, offs_r, Kr in ((5000, 5000, tuple(range(-96, 96)), 64), (1999, 1500, (-3000, -1, 0, 5, 1900), 300),
                               (1728, 1728, st12, 1), (1727, 1728, st12, 13), (1728, 1728, st12, 300)):
        for inst, dt in (("f32", np.float32), ("bf16", np.float32), ("f64", np.float64)):
            dv_r = torch.from_numpy(drng.standard_normal((len(offs_r), mr)).astype(dt)).to(dev)
            dv_r = dv_r.to(torch.bfloat16) if inst == "bf16" else dv_r
            B_r = torch.from_numpy(drng.standard_normal((nr, Kr)).astype(dt)).to(dev)
            od_r = torch.tensor(offs_r, device=dev)
            label = (f"{len(offs_r)} offsets {offs_r[0]}..{offs_r[-1]} (m={mr}, n={nr}, K={Kr}, windows "
                     f"{len(diag_schedule(offs_r, inst, dev).windows)})")
            compare(f"spmm_diag_{inst}", label,
                    same_bits(f"spmm_diag_{inst}", label, lambda: spmm_diag(dv_r, od_r, B_r, offs_static=offs_r)),
                    spmm_diag_plain(dv_r, od_r, B_r), errs)
    del dv_r, B_r

    # the spill-route kernels: on the webbase stand-in's gen spill (through
    # its handle, planned by optimize), on one stripe of the scatter
    # operand's whole-matrix route, and on a small ragged case
    def check_route_kernels(label, sr, xv, yv, sorted_rows=True):
        """Select, route (in route_launches launches), accumulate, each
        against its plain version; on a plan with row-sorted chunks (every
        plan of the planner) the accumulate's two calls give the same bits."""
        contrib = oh_select(xv, sr.sel_idx, sr.sel_val, sr.sel_blk, n_out=sr.n)
        compare("oh_select_f32", label, contrib, oh_select_plain(xv, sr.sel_idx, sr.sel_val, sr.sel_blk, sr.n), errs)
        c0 = benes_route.launches["f32"]
        routed = apply_route(contrib, sr.masks, sr.masks_packed, sr.k)
        done = benes_route.launches["f32"] - c0
        compare("benes_route_f32", f"{label} (k={sr.k}, {done} launches)", routed,
                apply_benes(contrib, route_masks(sr.masks, sr.masks_packed, sr.k), sr.k), errs)
        if done != route_launches(sr):
            raise AssertionError(f"{label}: {done} route launches, want {route_launches(sr)}")
        args = (sr.acc_idx, sr.acc_cid, sr.acc_start, sr.n_acc_tiles, yv)
        got = oh_accum(routed, *args)
        compare("oh_accum_f32", label, got, oh_accum_plain(routed, *args), errs)
        if sorted_rows:
            if not torch.equal(oh_accum(routed, *args), got):
                raise AssertionError(f"oh_accum_f32 {label}: two calls on a row-sorted plan differ")
            log(f"  oh_accum_f32 {label}: two calls bit-equal")

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
    # one above the path's largest route: k = 22 (outer stages around four
    # packed subnetworks) in its scheduled launches, and again with the
    # passes' shared memory capped at 96 KB, which splits passes A and C
    k22 = 22
    src22 = rrng.permutation(1 << k22)
    t0 = time.perf_counter()
    o22, p22 = (torch.from_numpy(a).to(dev) for a in plan_route_arrays(k22, native.benes_plan(k22, src22)))
    v22 = torch.from_numpy(rrng.standard_normal(1 << k22).astype(np.float32)).to(dev)
    log(f"  k=22 route plan: {time.perf_counter() - t0:.2f} s")
    want22 = benes_apply_plain(v22, o22, p22, k22)
    for cap in (benes_mod.PASS_SMEM, 96 * 1024):
        saved, benes_mod.PASS_SMEM = benes_mod.PASS_SMEM, cap
        try:
            c0 = benes_route.launches["f32"]
            got22 = benes_apply(v22, o22, p22, k22)
            done = benes_route.launches["f32"] - c0
        finally:
            benes_mod.PASS_SMEM = saved
        compare("benes_route_f32", f"k=22 random permutation, passes within {cap} B ({done} launches)", got22,
                want22, errs)
        if done != len(route_passes(k22, 2, smem=cap)) or (cap < saved) != (done > 3):
            raise AssertionError(f"benes_route_f32 k=22: {done} launches within {cap} B of shared memory")
    if not torch.equal(got22.cpu(), v22.cpu()[torch.from_numpy(src22)]):
        raise AssertionError("benes_route_f32 k=22: the route does not realise its permutation")
    del o22, p22, v22, want22, got22
    # the accumulate on a hot row: block 0 holds 40 entries of row 0 (the
    # pad tail's row) at its head and 1,500 of row 17 across its two chunks;
    # and on chunks whose rows are out of order (a row in several runs)
    hot = np.sort(np.r_[np.zeros(40, np.int64), np.full(1500, 17), rrng.integers(18, 1024, 100),
                        rrng.integers(1024, 5000, 3000)])
    unsorted = rrng.integers(0, 6000, 5000)
    for label, rows_, m_, sorted_rows in (("hot row", hot, 5000, True), ("rows out of order", unsorted, 6000, False)):
        sr_ = build_spill_route(rows_, rrng.integers(0, m_, rows_.size),
                                torch.from_numpy(rrng.standard_normal(rows_.size).astype(np.float32)).to(dev), m_)
        if label == "hot row" and int(sr_.acc_start[1] - sr_.acc_start[0]) != 2:
            raise AssertionError("the hot-row case must give y block 0 two chunks")
        check_route_kernels(label, sr_, torch.from_numpy(rrng.standard_normal(m_).astype(np.float32)).to(dev),
                            torch.from_numpy(rrng.standard_normal(m_).astype(np.float32)).to(dev), sorted_rows)

    # the band GEMM kernel on the band plans of four products A.A
    t0 = time.perf_counter()
    cm, _cn, cptr_, cind_, cval_ = cant(np.random.default_rng(7))
    log(f"  cant stand-in built in {time.perf_counter() - t0:.1f} s (m={cm}, nnz={cind_.size})")
    gcant = gemm_plan("cant A.A", cptr_, cind_, cval_)
    gsuite = gemm_plan("suite SpGEMM operand A.A", *suite_banded(np.random.default_rng(7), 65536, 65536, 32, 16),
                       force=True)
    gright = gemm_plan("small, window right of the diagonal", *offset_band(3001, 130, 200, 9, 71))
    gleft = gemm_plan("small, window far left of the diagonal", *offset_band(5000, -300, 100, 9, 73))
    if not (gright[0].d0 > 0 and 3001 % gright[0].G):
        raise AssertionError(f"the small case must have d0 > 0 and m off G, got d0={gright[0].d0}")
    if not gleft[0].d0 < -1:
        raise AssertionError(f"the left case must put the first groups' streams out of range, d0={gleft[0].d0}")
    # each plan's bands as they are (most warp steps skip) and, on the small
    # d0 > 0 plan, filled with random values (no step skips), twice for the
    # same bits
    drng = np.random.default_rng(43)
    dense = tuple(torch.from_numpy(drng.standard_normal(tuple(t.shape)).astype(np.float32)).to(dev)
                  for t in (gright[0].formA.bwd_val, gright[0].formB.bwd_val))
    for label, bp, pair in (("cant A.A", gcant[0], None), ("suite A.A", gsuite[0], None),
                            ("small d0 > 0, m off G", gright[0], None),
                            ("small d0 > 0, dense bands", gright[0], dense),
                            ("small streams out of range", gleft[0], None)):
        a, b = (bp.formA.bwd_val, bp.formB.bwd_val) if pair is None else pair
        taken, visited = band_gemm_steps(a, b, bp.WC, bp.d0, bp.stream_ranges)
        log(f"  band_gemm {label}: {taken} of {visited} warp steps taken, {visited - taken} skipped")
        for inst, (x_, y_) in (("f32", (a, b)), ("f64", (a.double(), b.double()))):
            kernel = f"band_gemm_{inst}"
            full = f"{label} (nblk={bp.nblk}, WC={bp.WC}, {bp.nstream} streams)"
            compare(kernel, full, same_bits(kernel, full, lambda: band_gemm(x_, y_, bp.WC, bp.d0, bp.stream_ranges)),
                    band_gemm_plain(x_, y_, bp.WC, bp.d0, bp.stream_ranges), errs)
    del gsuite, gright, gleft, dense

    # the blocked-solve chain kernel on the stencil's ILU0 factors (f32 and
    # f64 handles), the scatter operand's triangles and small edge forms
    t0 = time.perf_counter()
    Hd = tt.create_csr(mh, mh, hptr, hind, hval.astype(np.float64), device="cuda")
    Qd = tt.create_csr(qm, qm, qptr, qind, qval.astype(np.float64), device="cuda")
    hst, hst64 = chain_kernel_checks(H, Hd, Qh, Qd, dev, errs)
    log(f"  blocked-solve chain kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    level_kernel_checks(hst, hst64, Qh, Qd, errs)
    log(f"  level-solve kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    Hc = tt.create_csr(mh, mh, hptr, hind, complex_stencil(hptr, hind, hval, np.complex64), device="cuda")
    hstc = complex_level_checks(Hc, errs)
    log(f"  complex level-solve kernel checks: {time.perf_counter() - t0:.1f} s")

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
        # preconditioner adds two window solves (each its passes' launches,
        # five on these grouped forms) and, for SGS, its strict-lower mv
        want_sv = 0 if precond is None else sv_launches[precond] * k
        if nb_l != band_per_iter * k + 1 or ns_l != want_sv:
            raise AssertionError(
                f"CG precond={precond} launched {nb_l} band / {ns_l} trsv kernels in {k} iterations, "
                f"want {band_per_iter * k + 1} / {want_sv}"
            )
        iters[precond] = k

    log(f"  SPD operand W={cform.bwd_W}")
    sgs_forms = [trsv_form_for(C.plan, LOWER, NONE), trsv_form_for(C.plan, UPPER, NONE)]
    sv_launches = {pre: sum(solve_launches(f.nblk, f.nb, f.WL) for f in forms)
                   for pre, forms in (("ilu0", (st.l_form, st.u_form)), ("sgs", sgs_forms))}
    log(f"  window-solve launches per preconditioner apply: {sv_launches}")
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
    want_sm = sum(solve_launches(f.nblk, f.nb, f.WL) for f in (sgs_forms[0], st.l_form, st.u_form))
    if trsm_win.launches["f32"] - c0 != want_sm:
        raise AssertionError(f"trsm + 2-D ilu_smoother made {trsm_win.launches['f32'] - c0} multi-RHS "
                             f"launches, want {want_sm}: 1 + 2 solves, each its passes")
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
    f64_form = trsv_form_for(C64.plan, UPPER, NONE)
    want_sm = solve_launches(f64_form.nblk, f64_form.nb, f64_form.WL)
    if trsm_win.launches["f64"] - c0 != want_sm:
        raise AssertionError(f"trsm f64 made {trsm_win.launches['f64'] - c0} multi-RHS launches, want one "
                             f"solve's {want_sm}")
    del C64
    phase("phase 5, 104^3 stencil: ilu0_factorize, ilu_smoother, ILU0- and SGS-PCG, symgs, symgs_mv, sorv, "
          "trsv kids 0-2, f64 trsv")
    stencil_iters = stencil_solvers(H, Hd, hst, hptr, hind, hval, dev, rtol, res_tol)
    launches = read_counts()
    log(f"  main-path launches: {launches}")
    for kernel, count in launches.items():
        if count == 0 and kernel not in GEN_PATH + SPGEMM_PATH + FORMATS_PATH + MEASURE_PATH + LOWPREC_PATH:
            raise AssertionError(f"kernel {kernel} never launched on the main path")

    # 5b. the general-structure path, counted on its own
    phase("phase 5b: general-structure path (webbase gen + spill route, scatter route, permuted-space CG)")
    reset_counts()
    Sw = sp.csr_matrix((wval.astype(np.float64), wind, wptr), shape=(wm, wm))
    xw = np.random.default_rng(47).standard_normal(wm).astype(np.float32)
    xw_d = torch.from_numpy(xw).to(dev)
    refw = Sw @ xw.astype(np.float64)
    per_call = {"band_spmv_f32": 1, "oh_select_f32": 1, "oh_accum_f32": 1, "benes_route_f32": route_launches(wroute)}

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
    # the scatter operand's triangles: the default takes the level kernel
    # (29 and 27 levels against 4,096 chain blocks), kid=0 the gather forms
    # on the chain kernel
    bq = np.random.default_rng(89).standard_normal(qm)
    for handle, tri, Tq, inst, dt_ in ((Qh, LOWER, sp.tril(Sq), "f32", torch.float32),
                                       (Qd, UPPER, sp.triu(Sq), "f64", torch.float64)):
        for kid, want in ((None, {f"trsv_level_{inst}": 1, f"trsv_gather_{inst}": 0}),
                          (0, {f"trsv_level_{inst}": 0, f"trsv_gather_{inst}": 1})):
            check_residual(f"scatter trsv {inst} {tri.fill_mode.name} kid={kid}", Tq.tocsr(),
                           counted(f"scatter trsv {inst} kid={kid}",
                                   lambda: tt.trsv(1.0, handle, tri, NONE, torch.from_numpy(bq).to(dev, dt_), kid=kid),
                                   want), bq, expected_precision(dt_))
    gen_launches = read_counts()
    log(f"  general-structure path launches: {gen_launches}")
    for kernel in GEN_PATH:
        if gen_launches[kernel] == 0:
            raise AssertionError(f"kernel {kernel} never launched on the general-structure path")
        launches[kernel] = gen_launches[kernel]

    # 5c. the SpGEMM path, counted on its own
    phase("phase 5c: SpGEMM on the cant stand-in (sp2m two-stage, lazy product, chained mv, spmm, csr2m, syrk)")
    reset_counts()
    t0 = time.perf_counter()
    Sc = sp.csr_matrix((cval_.astype(np.float64), cind_, cptr_), shape=(cm, cm))
    SS = Sc @ Sc
    xc = np.random.default_rng(79).standard_normal(cm).astype(np.float32)
    xc_d = torch.from_numpy(xc).to(dev)
    refc = Sc @ (Sc @ xc.astype(np.float64))
    log(f"  float64 scipy A.A ({SS.nnz} stored entries) and A (A x): {time.perf_counter() - t0:.1f} s")
    gemm_call = {"band_gemm_f32": 1, "band_gemm_f64": 0}
    no_gemm = {"band_gemm_f32": 0, "band_gemm_f64": 0}
    f32tol = MV_TOL["f32"]

    def check_product(name, C, scale, tol=f32tol):
        """export_csr of product C against scale x float64 scipy A.A."""
        _m, _n, nnzC, pc, ic, vc = tt.export_csr(C)
        if C.values_pending or nnzC != refvals.size:
            raise AssertionError(f"{name}: export left the values pending or changed the pattern")
        err = near_error(vc.astype(np.float64), scale * refvals)
        log(f"  {name}: values vs float64 scipy A.A on the product's pattern, max rel err {err:.3e} (tol {tol:.3e})")
        if not (np.all(np.isfinite(vc)) and err <= tol):
            raise AssertionError(f"{name}: the product disagrees with float64 scipy")

    Ac = tt.create_csr(cm, cm, cptr_, cind_, cval_, device="cuda")
    t0 = time.perf_counter()
    Cc = counted("sp2m nnz_count", lambda: tt.sp2m(NONE, GEN, Ac, NONE, GEN, Ac, request=tt.Request.nnz_count),
                 no_gemm)
    t_sym = time.perf_counter() - t0
    cplan = Cc._spgemm_plan
    if cplan.band is None or cplan.pa is not None:
        raise AssertionError("the cant product did not take the band engine (pattern-only symbolic stage)")
    _m, _n, _nz, pC, iC, _v = tt.export_csr(Cc)
    refvals = on_pattern(pC, iC, SS, cm)
    log(f"  sp2m nnz_count: {t_sym:.2f} s (native pattern, band plan, band relayout); nnzC={Cc.nnz} "
        f"(scipy keeps {SS.nnz}), P={cplan.P}; band G={cplan.band.G} WA={cplan.band.WA} WC={cplan.band.WC} "
        f"nstream={cplan.band.nstream}")
    t0 = time.perf_counter()
    Cc = counted("sp2m finalize", lambda: tt.sp2m(NONE, GEN, Ac, NONE, GEN, Ac, request=tt.Request.finalize, C=Cc),
                 gemm_call)
    torch.cuda.synchronize()
    log(f"  sp2m finalize: {time.perf_counter() - t0:.2f} s (first: the band refresh included)")
    if not Cc.values_pending:
        raise AssertionError("the finalized band product is not pending")
    check_mv("chained mv on the pending product vs float64 scipy A (A x)",
             counted("chained mv", lambda: tt.mv(1.0, Cc, GEN, NONE, xc_d, 0.0), no_gemm), refc, f32tol)
    if not Cc.values_pending or Cc.plan is not None:
        raise AssertionError("the chained mv materialized the product's values")
    check_product("export_csr after finalize", Cc, 1.0)
    tt.update_values(Ac, 2.0 * cval_)
    counted("sp2m finalize after update_values",
            lambda: tt.sp2m(NONE, GEN, Ac, NONE, GEN, Ac, request=tt.Request.finalize, C=Cc), gemm_call)
    check_product("finalize after update_values(A, 2 val): 4x", Cc, 4.0)
    check_product("spmm(A, A)", counted("spmm", lambda: tt.spmm(Ac, Ac), gemm_call), 4.0)
    check_product("csr2m", counted("csr2m", lambda: tt.csr2m(NONE, GEN, Ac, NONE, GEN, Ac), gemm_call), 4.0)
    Ac64 = tt.create_csr(cm, cm, cptr_, cind_, cval_.astype(np.float64), device="cuda")
    check_product("spmm on a float64 handle (f64 instance)",
                  counted("spmm f64", lambda: tt.spmm(Ac64, Ac64), {"band_gemm_f32": 0, "band_gemm_f64": 1}), 1.0,
                  MV_TOL["f64"])
    del Ac64
    t0 = time.perf_counter()
    Su = counted("syrk", lambda: tt.syrk(NONE, Ac), gemm_call)
    if Su._spgemm_plan.band is None:
        raise AssertionError("syrk on the cant stand-in did not take the band engine")
    _m, _n, _nu, pu, iu, vu = tt.export_csr(Su)
    if np.any(iu < np.repeat(np.arange(cm), np.diff(pu))):
        raise AssertionError("syrk stored entries below the diagonal")
    # the stand-in's values are symmetric but its corner couplings are not
    erru = near_error(vu.astype(np.float64), 4.0 * on_pattern(pu, iu, sp.triu(Sc @ Sc.T), cm))
    log(f"  syrk upper on the band engine ({time.perf_counter() - t0:.2f} s, the full expansion symbolic stage "
        f"included): max rel err {erru:.3e} vs float64 scipy (tol {f32tol:.3e})")
    if not erru <= f32tol:
        raise AssertionError("syrk disagrees with float64 scipy")
    del Su, pu, iu, vu
    tt.update_values(Ac, cval_)
    # a product no band plan takes (the scatter operand's Q.Q): operands on
    # the card stay there, on the device expansion engine
    t0 = time.perf_counter()
    SQQ = Sq @ Sq
    Cq = counted("sp2m without a band plan", lambda: tt.sp2m(NONE, GEN, Qh, NONE, GEN, Qh), no_gemm)
    qplan = Cq._spgemm_plan
    if qplan.band is not None or getattr(qplan, "_dev_trip", None) is None:
        raise AssertionError("the scatter product did not run on the device expansion engine")
    _m, _n, _nq, pq, iq, vq = tt.export_csr(Cq)
    errq = near_error(vq.astype(np.float64), on_pattern(pq, iq, SQQ, qm))
    log(f"  sp2m Q.Q of the scatter operand (no band plan, P={qplan.P}, nnzC={qplan.nnz}; "
        f"{time.perf_counter() - t0:.2f} s with scipy's): device expansion engine, max rel err {errq:.3e} vs "
        f"float64 scipy (tol {f32tol:.3e})")
    if not (np.all(np.isfinite(vq)) and errq <= f32tol):
        raise AssertionError("the scatter product disagrees with float64 scipy")
    del SQQ, pq, iq, vq
    spg_launches = read_counts()
    log(f"  SpGEMM path launches: {({k: spg_launches[k] for k in SPGEMM_PATH})}")
    for kernel in SPGEMM_PATH:
        if spg_launches[kernel] == 0:
            raise AssertionError(f"kernel {kernel} never launched on the SpGEMM path")
        launches[kernel] = spg_launches[kernel]

    # 5d. the formats path, counted on its own
    phase("phase 5d: storage formats, conversions, mv KIDs 3-6/10/11, format-direct mv, level 1, Matrix Market I/O")
    reset_counts()
    fh = formats_path(ptr, ind, val, x32, ref, (cptr_, cind_, cval_), dev, Path(__file__).resolve().parent / "_smoke")
    fmt_launches = read_counts()
    log(f"  formats path launches: {({k: fmt_launches[k] for k in FORMATS_PATH})}")
    for kernel in FORMATS_PATH:
        if fmt_launches[kernel] == 0:
            raise AssertionError(f"kernel {kernel} never launched on the formats path")
        launches[kernel] = fmt_launches[kernel]

    # 5e. the measurement path, counted on its own
    phase("phase 5e: measurement path (create_csr -> set_mv_hint -> optimize -> bandt tiles and block windows, "
          "#5-#7, stream_read, utils/profiling.py)")
    reset_counts()
    measurement_path(ptr, ind, val, x32, ref, dev, Path(__file__).resolve().parent / "_smoke" / "trace")
    meas_launches = read_counts()
    log(f"  measurement path launches: {({k: meas_launches[k] for k in MEASURE_PATH})}")
    for kernel in MEASURE_PATH:
        if meas_launches[kernel] == 0:
            raise AssertionError(f"kernel {kernel} never launched on the measurement path")
        launches[kernel] = meas_launches[kernel]

    # 5f. the solver framework, counted on its own
    phase("phase 5f: solver framework (itsol RCI and forward interfaces, options, restarted GMRES, matrix-free "
          "operators)")
    # the nonsymmetric bench operand of phases 5f and 5g, built once
    nonsym = shifted_operand(ptr, ind, val, m)
    reset_counts()
    sf = solver_framework(nonsym, H, hptr, hind, hval, wptr, wind, wval, dev, rtol, stencil_iters["sgs"])
    sf_launches = read_counts()
    log(f"  solver framework launches: {({k: sf_launches[k] for k in SOLVER_PATH})}")
    for kernel in SOLVER_PATH:
        if sf_launches[kernel] == 0:
            raise AssertionError(f"kernel {kernel} never launched on the solver framework's path")

    # 5g. bf16 and complex solves, counted on their own
    phase("phase 5g: bf16 trsv, trsm and mm (bench operand); complex64 trsv, ilu_smoother, sorv, ILU0-GMRES "
          "(pgmres, itsol) and SGS-CG (itsol) on the 104^3 stencil + i I; complex128 trsv; complex ILU0-GMRES on "
          "the bench operand (plain route)")
    reset_counts()
    lp = lowprec_complex_path(ptr, ind, val, nonsym, hptr, hind, hval, Hc, hstc, dev, rtol)
    lp_launches = read_counts()
    log(f"  bf16 and complex path launches: {({k: lp_launches[k] for k in LOWPREC_PATH})}")
    for kernel in LOWPREC_PATH:
        if lp_launches[kernel] == 0:
            raise AssertionError(f"kernel {kernel} never launched on the bf16 and complex path")
        launches[kernel] = lp_launches[kernel]

    # 6. timing
    phase("phase 6: timing (CUDA events or host clock, median of repeats)")
    peak = ctx.hbm_gbps
    ms, plain_ms, bounds, lib = {}, {}, {}, {}

    def turns(kernel, kern, plain, kreps=(15, 10), preps=(15, 10), kwarm=3, pwarm=1):
        """plain, kernel, kernel, plain: compare within one call, in turns."""
        p1 = cuda_ms(plain, reps=preps[0], inner=preps[1], warm=pwarm, backlog=True)
        k1 = cuda_ms(kern, reps=kreps[0], inner=kreps[1], warm=kwarm, backlog=True)
        k2 = cuda_ms(kern, reps=kreps[0], inner=kreps[1], warm=kwarm, backlog=True)
        p2 = cuda_ms(plain, reps=preps[0], inner=preps[1], warm=pwarm, backlog=True)
        ms[kernel], plain_ms[kernel] = min(k1, k2), min(p1, p2)
        return k1, k2, p1, p2

    def note(kernel, nbytes_, need, flops, lib_fn=None, lib_kw=None, need_flops=None):
        """Record the kernel's bound and its library yardstick; log them.
        nbytes_ counts the stored operands once each, zero padding included
        (the block windows: their parallelogram; the window solves: dinvT's
        upper triangle, the half of the inverted blocks that is not zero), the bound_ms of the
        kernels line; need counts only their nonzero
        entries, the function's own bytes, logged beside it, with
        need_flops (default flops) the operations on those entries."""
        inst = kernel.rsplit("_", 1)[1]
        bounds[kernel] = bound_of(nbytes_, flops, inst, peak)
        need_ms, need_by = bound_of(need, flops if need_flops is None else need_flops, inst, peak)
        err = "no library call computes this instance's function"
        lib[kernel] = None
        if lib_fn is not None:
            lib[kernel], err = library_ms(lib_fn, **dict(lib_kw or {}, backlog=True))
        lib_s = f"{lib[kernel]:.4f} ms" if lib[kernel] is not None else f"none ({err})"
        log(f"  {kernel}: kernel {ms[kernel]:.4f} ms, plain {plain_ms[kernel]:.4f} ms, library {lib_s}, "
            f"bound {bounds[kernel][0]:.4f} ms ({bounds[kernel][1]}; {nbytes_ / 1e6:.1f} MB, "
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
    flush = torch.empty(COLD_VALUES, dtype=torch.float32, device=dev)

    def cold_note(kernel, kern, lib_fn, need):
        """The kernel and its library call cold (after writing the 128 MiB
        flush buffer, as the main path's other operands evict it), beside
        their warm times and the rate of the `need` bytes."""
        t_k = cold_ms(kern, flush)
        t_l = cold_ms(lib_fn, flush) if lib_fn is not None else None
        lib_s = f"{t_l:.4f} ms" if t_l is not None else "none"
        log(f"  {kernel} cold (after writing {nbytes(flush) / 2**20:.0f} MiB): kernel {t_k:.4f} ms = "
            f"{need / t_k / 1e6:.1f} GB/s of the {need / 1e6:.1f} MB it needs, library {lib_s}; warm kernel "
            f"{ms[kernel]:.4f} ms = {need / ms[kernel] / 1e6:.1f} GB/s; bound {bounds[kernel][0]:.4f} ms")

    # the group-window kernel on the bench bwd form, against the same CSR
    # products; the bf16 instance has no library call of its function;
    # warm and cold
    bwd64 = bandt_form(ptr, ind, val.astype(np.float64), dev, kind="bwd")
    for kernel, form, band, xv, lib_fn in (("spmv_bwd_f32", bwd32, bwd32.bwd_val, x32, lambda: A32 @ x32),
                                           ("spmv_bwd_bf16", bwd32, bwd_bf, x32, None),
                                           ("spmv_bwd_f64", bwd64, bwd64.bwd_val, x64, lambda: A64 @ x64)):
        bargs = bwd_args(form)
        turns(kernel, lambda: spmv_bwd(band, xv, *bargs), lambda: plain_bwd(band, xv, form))
        log(f"  {kernel}: band stream {nbytes(band) / ms[kernel] / 1e6:.1f} GB/s "
            f"({nbytes(band) / ms[kernel] / 1e6 / peak:.3f} of peak {peak} GB/s)")
        # x and y once, the spill's four arrays; the band stored (padding
        # zeros included) or its nonzeros only
        io = nbytes(xv, form.sp_val, form.sp_ind, form.sp_rows, form.sp_gptr) + m * xv.element_size()
        note(kernel, nbytes(band) + io, nz_bytes(band) + io, 2 * band.numel() + 2 * form.sp_ind.numel(), lib_fn)
        cold_note(kernel, lambda: spmv_bwd(band, xv, *bargs), lib_fn, nbytes(band) + io)
    del bwd64
    # the tile-major kernels and the block-window SpMV on the bench form's
    # operands, against the same CSR product (no library call computes a
    # bf16 band's product with f32 x). The tile-major bound counts the
    # stored band; the block-window bound counts the windows' parallelogram
    # 0 <= c - s < W (128 W values a block), the bytes and operations the
    # function needs of them, beside (logged) the stored windows' bound,
    # whose zero triangles the TPU kernel reads and multiplies
    io = nbytes(x32) + m * 4
    Wm = f32.bwd_W
    for inst in ("f32", "bf16"):
        lib_fn = (lambda: A32 @ x32) if inst == "f32" else None
        for kernel, op in ((f"band_spmv_tiles_{inst}", tiles[inst]), (f"band_spmv_tiles_dbuf_{inst}", tiles[inst])):
            kern = band_spmv_tiles if "dbuf" not in kernel else band_spmv_tiles_dbuf
            turns(kernel, lambda: kern(op, x32, *args32, m), lambda: band_spmv_tiles_plain(op, x32, *args32, m))
            log(f"  {kernel}: operand stream {nbytes(op) / ms[kernel] / 1e6:.1f} GB/s "
                f"({nbytes(op) / ms[kernel] / 1e6 / peak:.3f} of peak {peak} GB/s)")
            note(kernel, nbytes(op) + io, nz_bytes(op) + io, 2 * op.numel(), lib_fn)
        kernel, op = f"spmv_band_mxu_{inst}", wins[inst]
        turns(kernel, lambda: spmv_band_mxu(op, x32, *args32, m, Wm), lambda: spmv_band_mxu_plain(op, x32, *args32, m))
        para = op.shape[0] * 128 * Wm  # values of the parallelogram
        need = para * op.element_size() + io
        stored_ms, stored_by = bound_of(nbytes(op) + io, 2 * op.numel(), inst, peak)
        log(f"  {kernel}: parallelogram stream {para * op.element_size() / ms[kernel] / 1e6:.1f} GB/s "
            f"({para * op.element_size() / ms[kernel] / 1e6 / peak:.3f} of peak {peak} GB/s); the stored windows' "
            f"bound {stored_ms:.4f} ms ({stored_by}; {nbytes(op) / 1e6:.1f} MB) = {stored_ms / ms[kernel]:.3f}")
        note(kernel, need, nz_bytes(op) + io, 2 * para, lib_fn)
        cold_note(kernel, lambda: spmv_band_mxu(op, x32, *args32, m, Wm), lib_fn, need)
        # the same windows read as narrower or wider bands: W = 1 reads next
        # to nothing, so its time is the launch's latency floor
        sweep = {Ws: cuda_ms(lambda Ws=Ws: spmv_band_mxu(op, x32, *args32, m, Ws), backlog=True)
                 for Ws in (1, 64, Wm, 256)}
        log(f"  {kernel} warm by the band width it is told (the bench windows): "
            + ", ".join(f"W={Ws} {t:.4f} ms" for Ws, t in sweep.items())
            + f"; W={Wm} against W=64: {(para - op.shape[0] * 128 * 64) * op.element_size() / 1e6:.1f} MB more "
            f"in {sweep[Wm] - sweep[64]:.4f} ms more")
    del flush
    # the read probe: on the 128 MiB buffer (logged), then on the band slab
    # (the kernels line: the main path's operand); torch.sum is the yardstick
    t_cold = [cuda_ms(f, backlog=True) for f in (lambda: stream_read(cold), lambda: stream_read_plain(cold),
                                                 lambda: cold.sum())]
    log(f"  stream_read_f32 on the 128 MiB buffer: kernel {t_cold[0]:.4f} ms = {nbytes(cold) / t_cold[0] / 1e6:.1f} "
        f"GB/s ({nbytes(cold) / t_cold[0] / 1e6 / peak:.3f} of peak {peak} GB/s), plain {t_cold[1]:.4f} ms, "
        f"torch.sum {t_cold[2]:.4f} ms = {nbytes(cold) / t_cold[2] / 1e6:.1f} GB/s")
    slab = f32.bwd_val
    turns("stream_read_f32", lambda: stream_read(slab), lambda: stream_read_plain(slab))
    log(f"  stream_read_f32 on the band slab {tuple(slab.shape)}: {nbytes(slab) / ms['stream_read_f32'] / 1e6:.1f} "
        f"GB/s ({nbytes(slab) / ms['stream_read_f32'] / 1e6 / peak:.3f} of peak {peak} GB/s)")
    note("stream_read_f32", nbytes(slab), nz_bytes(slab), slab.numel(), lambda: slab.sum())
    del cold, tiles, wins
    fL = st.l_form
    dT32, lT32, ops32 = ilu_ops["L"]
    dT64, lT64, b64, bm64 = dT32.double(), lT32.double(), bw.double(), bw_m.double()
    ops64 = win_solve_operands(dT64, lT64, fL.nb, fL.WL)
    Lf.sort_indices()
    L32 = csr_tensor(Lf.indptr, Lf.indices, Lf.data, dev, torch.float32)
    L64 = csr_tensor(Lf.indptr, Lf.indices, Lf.data, dev, torch.float64)
    # a step: the triangular nb x nb inverted block and the WL x nb window
    step_flops = 2 * (fL.nb * (fL.nb + 1) // 2 + fL.WL * fL.nb) * fL.nblk
    for inst, (dT, lT, ops, bb, bmm, Lt) in (("f32", (dT32, lT32, ops32, bw, bw_m, L32)),
                                             ("f64", (dT64, lT64, ops64, b64, bm64, L64))):
        # the plain loops walk 1024 blocks from Python: few repeats
        kernel = f"trsv_win_{inst}"
        turns(kernel, lambda: trsv_win(dT, lT, bb, fL.nb, fL.WL, ops),
              lambda: trsv_win_plain(dT, lT, bb, fL.nb, fL.WL), kreps=(15, 5), preps=(1, 1), kwarm=2, pwarm=0)
        win_passes(kernel, lambda: trsv_win(dT, lT, bb, fL.nb, fL.WL, ops), fL, 1, dT.element_size())
        plain_chain_note(kernel, plain_chain_solve(dT, ops.P, bb, fL.nb, fL.WL), fL)
        op_bytes = nbytes(dT, lT)
        log(f"  {kernel} (ILU0 L form, nb={fL.nb} WL={fL.WL} nblk={fL.nblk}): operand stream "
            f"{op_bytes / ms[kernel] / 1e6:.1f} GB/s ({op_bytes / ms[kernel] / 1e6 / peak:.4f} of peak {peak} GB/s; "
            f"{op_bytes / 1e6:.1f} MB per solve)")
        # the bound counts what the function needs of its operands: dinvT's
        # upper triangle (the inverted blocks' nonzero half; the stored zero
        # half is never read), lwT, b and x; logged beside the bound of the
        # stored operands once each
        tri_bytes = fL.nblk * fL.nb * (fL.nb + 1) // 2 * dT.element_size()
        stored = op_bytes + 2 * nbytes(bb)
        log(f"  {kernel}: stored operands once each {stored / 1e6:.1f} MB, bound "
            f"{bound_of(stored, step_flops, inst, peak)[0]:.4f} ms; the triangle, lwT, b and x "
            f"{(tri_bytes + nbytes(lT, bb, bb)) / 1e6:.1f} MB")
        # the library solve re-analyses the triangle each call (seconds): the
        # first call's own time
        one = dict(once=True)
        op_need = nz_bytes(dT, lT)
        note(kernel, tri_bytes + nbytes(lT) + 2 * nbytes(bb), op_need + 2 * nbytes(bb), step_flops,
             lambda: torch.triangular_solve(bb[:, None], Lt, upper=False, unitriangular=True), one)
        kernel = f"trsm_win_{inst}"
        turns(kernel, lambda: trsm_win(dT, lT, bmm, fL.nb, fL.WL, ops),
              lambda: trsm_win_plain(dT, lT, bmm, fL.nb, fL.WL), kreps=(15, 5), preps=(1, 1), kwarm=2, pwarm=0)
        win_passes(kernel, lambda: trsm_win(dT, lT, bmm, fL.nb, fL.WL, ops), fL, K_SM, dT.element_size())
        plain_chain_note(kernel, plain_chain_solve(dT, ops.P, bmm, fL.nb, fL.WL), fL)
        stored = op_bytes + 2 * nbytes(bmm)
        log(f"  {kernel}: stored operands once each {stored / 1e6:.1f} MB, bound "
            f"{bound_of(stored, step_flops * K_SM, inst, peak)[0]:.4f} ms")
        note(kernel, tri_bytes + nbytes(lT) + 2 * nbytes(bmm), op_need + 2 * nbytes(bmm), step_flops * K_SM,
             lambda: torch.triangular_solve(bmm, Lt, upper=False, unitriangular=True), one)
        log(f"  {kernel}: K={K_SM} solve costs {ms[kernel] / ms[f'trsv_win_{inst}']:.2f}x the K=1 solve")
    del dT64, lT64, ops64, b64, bm64
    # the bf16 instance on the same form's operands in bf16: its bound counts
    # the bf16 triangle of dinvT, lwT, b and x; bf16 products at the tensor
    # cores' rate; cuSPARSE has no bf16 triangular solve (library: none)
    tri16 = fL.nblk * fL.nb * (fL.nb + 1) // 2 * 2
    for kernel, call, plain, bb, K in (
            ("trsv_win_bf16", lambda: trsv_win(dT16, lT16, bw16, fL.nb, fL.WL, ops16),
             lambda: trsv_win_plain(dT16, lT16, bw16, fL.nb, fL.WL), bw16, 1),
            ("trsm_win_bf16", lambda: trsm_win(dT16, lT16, bwm16, fL.nb, fL.WL, ops16),
             lambda: trsm_win_plain(dT16, lT16, bwm16, fL.nb, fL.WL), bwm16, K_SM)):
        turns(kernel, call, plain, kreps=(15, 5), preps=(1, 1), kwarm=2, pwarm=0)
        win_passes(kernel, call, fL, K, 4, rounds=True)
        note(kernel, tri16 + nbytes(lT16) + 2 * nbytes(bb), nz_bytes(dT16, lT16) + 2 * nbytes(bb), step_flops * K)
        log(f"  {kernel}: {ms[kernel] / ms[kernel.replace('bf16', 'f32')]:.2f}x the f32 instance's time")
    mm_flops = 2 * tm32.bwd_val.numel() * K_MM
    for inst, v, Bx, Ax in (("f32", tm32.bwd_val, Bm, A32), ("f64", tm64.bwd_val, Bm64, A64)):
        kernel = f"spmm_band_{inst}"
        turns(kernel, lambda: spmm_band(v, Bx, *targs), lambda: spmm_band_plain(v, Bx, *targs),
              kreps=(15, 5), preps=(3, 1))
        c_bytes = nbytes(Bx) * m // n
        note(kernel, nbytes(v, Bx) + c_bytes, nz_bytes(v, Bx) + c_bytes, mm_flops,
             lambda: torch.sparse.mm(Ax, Bx), dict(reps=5, inner=2))
        es = v.element_size()
        Wb = v.shape[1]
        log(f"  {kernel}: tile {BAND_TM} rows x {256 // es} columns, band chunks of {BAND_JC[es]} j in a "
            f"{BAND_STAGES}-stage ring, B through a {BAND_RING}-row ring ({(BAND_TM + Wb - 1) / BAND_TM:.2f} reads a "
            f"B row at W={Wb}); {m * K_MM * Wb / ms[kernel] / 1e9:.1f} G FMA/s")
    # the bf16 band instance (B and C f32): bf16 widens to f32 exactly, so
    # cuSPARSE's f32 product on the bench CSR with its values rounded to
    # bf16 computes the same function (f32 sums) in one library call
    kernel = "spmm_band_bf16"
    turns(kernel, lambda: spmm_band(v16, Bm, *targs), lambda: spmm_band_plain(v16, Bm, *targs),
          kreps=(15, 5), preps=(3, 1))
    c_bytes = nbytes(Bm) * m // n
    A16w = csr_tensor(ptr, ind, torch.from_numpy(val.astype(np.float32)).to(torch.bfloat16).float().numpy(), dev,
                      torch.float32)
    note(kernel, nbytes(v16, Bm) + c_bytes, nz_bytes(v16, Bm) + c_bytes, mm_flops,
         lambda: torch.sparse.mm(A16w, Bm), dict(reps=5, inner=2))
    log(f"  {kernel}: band chunks of {BAND_JC[2]} j (column pairs); {ms[kernel] / ms['spmm_band_f32']:.2f}x the f32 "
        f"instance's time; {m * K_MM * v16.shape[1] / ms[kernel] / 1e9:.1f} G FMA/s")
    for inst, dt_ in (("f32", dt32), ("bf16", dtbf)):
        kernel = f"spmm_band_mxu_{inst}"
        turns(kernel, lambda: spmm_band_mxu(dt_, Bm, *targs, m, W_mm),
              lambda: spmm_band_mxu_plain(dt_, Bm, *targs, m), kreps=(15, 5), preps=(3, 2))
        # the same band product as spmm_band: the bound counts the windows'
        # parallelogram 0 <= c - s < W (128 W values a block), B and C, what
        # the function needs; the stored windows' bound (zero triangles and
        # all, which the TPU kernel read and multiplied) is logged beside it
        para = dt_.shape[0] * 128 * W_mm * dt_.element_size()
        note(kernel, para + nbytes(Bm) + m * K_MM * 4, nz_bytes(dt_, Bm) + m * K_MM * 4, mm_flops,
             (lambda: torch.sparse.mm(A32, Bm)) if inst == "f32" else None, dict(reps=5, inner=2))
        stored_ms, stored_by = bound_of(nbytes(dt_, Bm) + m * K_MM * 4, mm_flops, inst, peak)
        walk = [hi - lo for _a, _b, lo, hi in mxu_walk(W_mm, inst == "bf16")]
        log(f"  {kernel}: stored windows' bound {stored_ms:.4f} ms ({stored_by}) = "
            f"{stored_ms / ms[kernel]:.3f}; window rows walked by each {128 // len(walk)} rows: "
            f"{walk} of 256")
    H32 = csr_tensor(hptr, hind, hval, dev, torch.float32)
    H64 = csr_tensor(hptr, hind, hval, dev, torch.float64)
    for inst, dv, Bx, Hx in (("f32", hf.dia_val, Bh, H32), ("bf16", hf.dia_bf16(), Bh, None),
                             ("f64", hv64, Bh64, H64)):
        kernel = f"spmm_diag_{inst}"
        turns(kernel, lambda: spmm_diag(dv, hf.dia_offs, Bx, offs_static=hoffs),
              lambda: spmm_diag_plain(dv, hf.dia_offs, Bx), kreps=(15, 5), preps=(3, 1))
        c_bytes = nbytes(hf.dia_offs) + mh * K_MM * Bx.element_size()
        note(kernel, nbytes(dv, Bx) + c_bytes, nz_bytes(dv, Bx) + c_bytes, 2 * dv.numel() * K_MM,
             (lambda: torch.sparse.mm(Hx, Bx)) if Hx is not None else None, dict(reps=5, inner=2))
        sched = diag_schedule(hoffs, inst, dev)
        b_st, v_st = sched.staged_bytes(mh, K_MM, Bx.element_size())
        wins = [(hoffs[d0], hoffs[d1 - 1]) for d0, d1 in sched.windows]
        staged = b_st + v_st + mh * K_MM * Bx.element_size()
        log(f"  {kernel}: {len(wins)} windows (offsets {wins}), tiles of {sched.rows} rows x 128 bytes, stages of "
            f"{sched.stage_bytes} bytes; staged per call: B {b_st / 1e9:.3f} GB ({b_st / nbytes(Bx):.2f}x B), "
            f"values {v_st / 1e9:.3f} GB; staged and written {staged / ms[kernel] / 1e6:.1f} GB/s")
    del A64, H64, hv64, Bh64
    gbytes = {  # bench.py:60 useful bytes; bf16 credited as the f32 op
        "f32": ((m + 1 + nnz) * 4 + (nnz + n + m) * 4) / 1e9,
        "f64": ((m + 1 + nnz) * 4 + (nnz + n + m) * 8) / 1e9,
    }
    t_mv = cuda_ms(lambda: tt.mv(1.0, A, GEN, NONE, x32, 0.0))
    tt.set_precision_mode(A, "mixed")
    t_mv_mixed = cuda_ms(lambda: tt.mv(1.0, A, GEN, NONE, x32, 0.0))
    tt.set_precision_mode(A, "full")
    t_mv5 = cuda_ms(lambda: tt.mv(1.0, fh["csr"], GEN, NONE, x32, 0.0, kid=5))
    tt.set_precision_mode(fh["csr"], "mixed")
    t_mv5_mixed = cuda_ms(lambda: tt.mv(1.0, fh["csr"], GEN, NONE, x32, 0.0, kid=5))
    tt.set_precision_mode(fh["csr"], "full")
    for name, t, gb in (("mv f32", t_mv, gbytes["f32"]), ("mv bf16 band", t_mv_mixed, gbytes["f32"]),
                        ("mv kid=5 f32 (bwd form)", t_mv5, gbytes["f32"]),
                        ("mv kid=5 mixed (bf16 bwd band)", t_mv5_mixed, gbytes["f32"])):
        eff = gb / (t / 1e3)
        log(f"  {name}: {t:.4f} ms/call, effective {eff:.1f} GB/s = {eff / peak:.3f} of peak "
            f"{peak} GB/s (bench.py:60 useful bytes)")
    t_mv5_64 = cuda_ms(lambda: tt.mv(1.0, fh["csr64"], GEN, NONE, x64, 0.0, kid=5))
    log(f"  mv kid=5 float64 handle: {t_mv5_64:.4f} ms/call, effective "
        f"{gbytes['f64'] / (t_mv5_64 / 1e3):.1f} GB/s (bench.py:60 useful bytes)")
    for name, key, kid in (("COO handle (through CSR: bandt)", "coo", None), ("CSC handle (through CSR)", "csc", None),
                           ("BSR handle kid=3", "bsr", 3), ("DIA handle kid=4", "dia", 4),
                           ("ELL handle kid=1", "ell", None), ("CSR kid=6 (diag form)", "csr", 6),
                           ("CSR kid=10 (sell)", "csr", 10)):
        t = cuda_ms(lambda: tt.mv(1.0, fh[key], GEN, NONE, x32, 0.0, kid=kid), reps=7, inner=3)
        log(f"  mv {name}: {t:.4f} ms/call, effective {gbytes['f32'] / (t / 1e3):.1f} GB/s "
            f"(bench.py:60 useful bytes, f32)")
    t0 = time.perf_counter()
    tt.mv(1.0, fh["csr"], GEN, NONE, x32, 0.0, kid=11)
    log(f"  mv kid=11 (host engine, its host copies included): {(time.perf_counter() - t0) * 1e3:.1f} ms on the "
        "host clock")
    del fh
    # mm: useful bytes (m+1+nnz)*4 + (nnz + (n+m)*K)*vsize, the mv formula with K columns
    for name, handle, Bx, mrows, nz, kid in (("mm bench (bandtm)", Amm, Bm, m, nnz, None),
                                             ("mm bench kid=5 (block windows)", Amm, Bm, m, nnz, 5),
                                             ("mm stencil (diag)", H, Bh, mh, hind.size, None)):
        t = cuda_ms(lambda: tt.mm(1.0, handle, GEN, NONE, Bx, 0.0, kid=kid), reps=15, inner=5)
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
    log(f"  set-up: ilu0_factorize {t_factor:.2f} s + the forms' kernel operands {t_ops:.2f} s (diagonal-block "
        f"inversion {t_invert:.3f} s, P = lwT @ dinvT and F {t_pset:.3f} s, each timed alone)")

    # the blocked-solve chain kernel: one dwin solve of the stencil's ILU0 L
    # factor and one gather solve of the scatter operand's lower triangle,
    # each instance against its plain version and the library's sparse
    # triangular solve (cuSPARSE through torch.triangular_solve on the CSR
    # triangle, which analyses it anew each call: its first call's own time,
    # as for the window solves). The bound counts what the function needs:
    # dinvT's upper triangle, the left operand (Dv, or Lval and Lind), b and
    # x; beside it (logged) the nonzero bound: the triangle's strict entries
    # (value and int32 index), its diagonal, b and x
    one = dict(once=True)
    t_level, t_step = {}, {}  # the gate's constants as measured here, us
    hrows = np.repeat(np.arange(mh), np.diff(hptr))
    hlow = hind < hrows
    for inst, st_, dt_ in (("f32", hst, torch.float32), ("f64", hst64, torch.float64)):
        form = st_.l_form
        dT, Dv = form.operands()
        offs_t = form.offsets()
        bb = torch.from_numpy(np.random.default_rng(79).standard_normal(form.m_pad)).to(dev, dt_)
        kernel = f"trsv_dwin_{inst}"
        turns(kernel, lambda: trsv_dwin(dT, Dv, offs_t, bb, form.nb, form.WL),
              lambda: trsv_dwin_plain(dT.transpose(1, 2), Dv, bb, form.nb, form.WL, form.dwin_offs),
              kreps=(9, 3), preps=(1, 1), kwarm=1, pwarm=0)
        lu = st_.lu.double().cpu().numpy()
        Lt = csr_tensor(*coo_csr(np.r_[hrows[hlow], np.arange(mh)], np.r_[hind[hlow], np.arange(mh)],
                                     np.r_[lu[hlow], np.ones(mh)], mh), dev, dt_)
        tri_bytes = form.nblk * form.nb * (form.nb + 1) // 2 * dT.element_size()
        io = 2 * mh * dT.element_size()
        flops = 2 * form.nblk * (form.nb * (form.nb + 1) // 2 + Dv.shape[1] * form.nb)
        nz_need = int(hlow.sum()) * (dT.element_size() + 4) + io
        note(kernel, tri_bytes + nbytes(Dv, offs_t) + io, nz_need, flops,
             lambda: torch.triangular_solve(bb[:mh, None], Lt, upper=False, unitriangular=True), one,
             need_flops=2 * int(hlow.sum()))
        log(f"  {kernel} (stencil ILU0 L, nb={form.nb} nblk={form.nblk} ndg={Dv.shape[1]} WL={form.WL}): "
            f"{ms[kernel] * 1e3 / form.nblk:.3f} us a step; plain {plain_ms[kernel] * 1e3 / form.nblk:.3f} us a step")
        # the level kernel on the factor's level form, the same b and library call
        lform, lkernel, bl = _level_forms(st_)[0], f"trsv_level_{inst}", bb[:mh]
        turns(lkernel, lambda: trsv_level(lform, bl), lambda: trsv_level_plain(lform, bl),
              kreps=(9, 5), preps=(1, 1), kwarm=1, pwarm=0)
        lbytes = level_bytes(lform, bl)
        note(lkernel, lbytes, lbytes, 2 * lform.lcol.numel() + 2 * mh,
             lambda: torch.triangular_solve(bb[:mh, None], Lt, upper=False, unitriangular=True), one)
        t_level[inst], t_step[inst] = ms[lkernel] * 1e3 / lform.nlev, ms[kernel] * 1e3 / form.nblk
        log(f"  {lkernel} (stencil ILU0 L, {lform.nlev} levels, {lform.lcol.numel()} strict entries): "
            f"{t_level[inst]:.3f} us a level; {ms[kernel] / ms[lkernel]:.2f}x faster than the chain, "
            f"the library's solve {ratio(lib[lkernel], ms[lkernel])}x its time")
        del Lt
    # the chain forms' block size (planner/triangular.py adaptive_nb): one
    # solve of the stencil's lower triangle, f32, K = 1, at nb = 32 to 256,
    # each form built at that width (CHAIN_NB lifted for the sweep)
    chain_nb, ttri.CHAIN_NB = ttri.CHAIN_NB, 256
    for nb_ in (32, 64, 128, 256):
        key = ("trsv", LOWER.fill_mode, LOWER.diag_type, NONE, nb_)
        kept = H.plan.levels.pop(key, None)  # a cached form of this key may be narrower
        f_ = trsv_form_for(H.plan, LOWER, NONE, nb=nb_)
        if f_.kind == "dwin":
            dT_, Dv_ = f_.operands()
            b_ = torch.ones(f_.m_pad, dtype=torch.float32, device=dev)
            t = cuda_ms(lambda: trsv_dwin(dT_, Dv_, f_.offsets(), b_, nb_, f_.WL), reps=3, inner=1, warm=1,
                        backlog=True)
            log(f"  dwin solve of the stencil's lower triangle at nb={nb_} ({f_.nblk} blocks): {t:.4f} ms, "
                f"{t * 1e3 / f_.nblk:.3f} us a step")
            del dT_, Dv_
        H.plan.levels.pop(key)
        if kept is not None:
            H.plan.levels[key] = kept
        del f_
    ttri.CHAIN_NB = chain_nb
    # the level kernel's dependency round trip: a bidiagonal chain, one
    # level a row, so a solve is m dependent rounds; the latency floor of a
    # level solve is nlev times it
    mc = 20000
    Cb = sp.diags([np.full(mc - 1, -0.5), np.full(mc, 2.0)], [-1, 0]).tocsr()
    cform = build_level_form(Cb.indptr, Cb.indices, np.arange(Cb.nnz), mc, False, False,
                             torch.from_numpy(Cb.data.astype(np.float32)).to(dev))
    bc = torch.ones(mc, dtype=torch.float32, device=dev)
    t_trip = cuda_ms(lambda: trsv_level(cform, bc), reps=5, inner=3, warm=1, backlog=True) / mc
    nlev_h = _level_forms(hst)[0].nlev
    log(f"  trsv_level_f32 dependency round trip (bidiagonal, {mc} levels): {t_trip * 1e3:.3f} us a level; "
        f"the stencil factor's latency floor {nlev_h} x {t_trip * 1e3:.3f} us = {nlev_h * t_trip:.4f} ms")
    log(f"  the sv gate's constants as measured (f32 / f64): t_level {t_level['f32']:.3f} / {t_level['f64']:.3f} us "
        f"a level, t_step {t_step['f32']:.3f} / {t_step['f64']:.3f} us a step; the planner's T_LEVEL_US "
        f"{ttri.T_LEVEL_US}, T_STEP_US {ttri.T_STEP_US}")
    del cform, Cb
    # the level kernel's complex instances on the complex stencil's ILU0 L
    # (complex128: the same form's values widened), against their plain
    # version and cuSPARSE's complex triangular solve on the CSR triangle; a
    # complex multiply-add is 8 real operations
    lu_c = hstc.lu.to(torch.complex128).cpu().numpy()
    lform_c = _level_forms(hstc)[0]
    for inst, dt_, lf in (("c64", torch.complex64, lform_c),
                          ("c128", torch.complex128, widen_level_form(lform_c, torch.complex128))):
        kernel = f"trsv_level_{inst}"
        crng = np.random.default_rng(101)
        bl = torch.from_numpy(crng.standard_normal(mh) + 1j * crng.standard_normal(mh)).to(dev, dt_)
        turns(kernel, lambda: trsv_level(lf, bl), lambda: trsv_level_plain(lf, bl),
              kreps=(9, 5), preps=(1, 1), kwarm=1, pwarm=0)
        Lt = csr_tensor(*coo_csr(np.r_[hrows[hlow], np.arange(mh)], np.r_[hind[hlow], np.arange(mh)],
                                 np.r_[lu_c[hlow], np.ones(mh)], mh), dev, dt_)
        lbytes = level_bytes(lf, bl)
        note(kernel, lbytes, lbytes, 8 * lf.lcol.numel() + 8 * mh,
             lambda: torch.triangular_solve(bl[:, None], Lt, upper=False, unitriangular=True), one)
        log(f"  {kernel} (complex stencil ILU0 L, {lf.nlev} levels): {ms[kernel] * 1e3 / lf.nlev:.3f} us a level; "
            f"{ms[kernel] / ms[kernel.replace(inst, 'f32' if inst == 'c64' else 'f64')]:.2f}x the real instance's "
            f"time; the library's solve {ratio(lib[kernel], ms[kernel])}x its time")
        del Lt
    # mv KID 6, the stencil's mv form since the mv rule's diag branch: the
    # plain spmv_diag (no hand kernel yet), against cuSPARSE CSR @ x and the
    # bytes it must move (the 27 diagonals once, x read and y written)
    hdf = H.plan.exec_form_for(GEN, NONE)
    xh = torch.from_numpy(np.random.default_rng(103).standard_normal(mh).astype(np.float32)).to(dev)
    t_diag = cuda_ms(lambda: spmv_diag(hdf.dia_val, hdf.dia_offs, xh, mh, hdf.dia_L, hdf.dia_n_pad), backlog=True)
    t_mv_h = cuda_ms(lambda: tt.mv(1.0, H, GEN, NONE, xh, 0.0))
    t_lib_h, err = library_ms(lambda: H32 @ xh, backlog=True)
    d_bytes = nbytes(hdf.dia_val, xh) + mh * 4
    d_nz = nz_bytes(hdf.dia_val) + nbytes(xh) + mh * 4
    t_b, by = bound_of(d_bytes, 2 * hdf.dia_val.numel(), "f32", peak)
    log(f"  mv KID 6 (plain spmv_diag) on the stencil's diag form ({hdf.dia_val.shape[0]} diagonals): "
        f"{t_diag:.4f} ms, mv call {t_mv_h:.4f} ms, cuSPARSE CSR @ x "
        f"{f'{t_lib_h:.4f} ms' if t_lib_h is not None else err}; bound {t_b:.4f} ms ({by}; {d_bytes / 1e6:.1f} MB) "
        f"= {t_b / t_diag:.3f}; nonzeros only {bound_of(d_nz, 2 * hind.size, 'f32', peak)[0]:.4f} ms")
    profile_mv("stencil mv (diag form, plain spmv_diag)", lambda: tt.mv(1.0, H, GEN, NONE, xh, 0.0), calls=5)
    # the complex plain win route: one ILU0 L solve of the complex bench
    # operand (the plain block loop on the card: no complex window kernel)
    fl_c = lp["nst"].l_form
    rc = torch.zeros(fl_c.m_pad, dtype=torch.complex64, device=dev)
    rc[:m] = lp["bn"]
    t_plain_c = cuda_ms(lambda: fl_c.solve(rc), reps=3, inner=1, warm=1)
    dT_c, lT_c = fl_c.operands()
    c_bytes = fl_c.nblk * fl_c.nb * (fl_c.nb + 1) // 2 * 8 + nbytes(lT_c) + 2 * nbytes(rc)
    t_b, by = bound_of(c_bytes, 8 * fl_c.nblk * (fl_c.nb * (fl_c.nb + 1) // 2 + fl_c.WL * fl_c.nb), "c64", peak)
    log(f"  complex64 win solve, the plain route (bench ILU0 L, nb={fl_c.nb} WL={fl_c.WL} nblk={fl_c.nblk}): "
        f"{t_plain_c:.4f} ms a solve, {t_plain_c * 1e3 / fl_c.nblk:.2f} us a block; the bytes' bound "
        f"{t_b:.4f} ms ({by}); the f32 kernel on the f32 form {ms['trsv_win_f32']:.4f} ms")
    del dT_c, lT_c, rc
    Sq = sp.csr_matrix((qval.astype(np.float64), qind, qptr), shape=(qm, qm))
    Sql = sp.tril(Sq).tocsr()
    for inst, handle, dt_ in (("f32", Qh, torch.float32), ("f64", Qd, torch.float64)):
        form = trsv_form_for(handle.plan, LOWER, NONE)
        dT, Lv = form.operands()
        bq = torch.from_numpy(np.random.default_rng(83).standard_normal(form.m_pad)).to(dev, dt_)
        kernel = f"trsv_gather_{inst}"
        turns(kernel, lambda: trsv_gather(dT, form.Lind, Lv, bq, form.nb),
              lambda: trsv_gather_plain(dT.transpose(1, 2), form.Lind, Lv, bq, form.nb),
              kreps=(9, 3), preps=(1, 1), kwarm=1, pwarm=0)
        Qlt = csr_tensor(Sql.indptr, Sql.indices, Sql.data, dev, dt_)
        tri_bytes = form.nblk * form.nb * (form.nb + 1) // 2 * dT.element_size()
        io = 2 * qm * dT.element_size()
        n_left = int(torch.count_nonzero(Lv))
        flops = 2 * form.nblk * form.nb * (form.nb + 1) // 2 + 2 * n_left
        nz_need = (Sql.nnz - qm) * (dT.element_size() + 4) + qm * dT.element_size() + io
        note(kernel, tri_bytes + nbytes(Lv, form.Lind) + io, nz_need, flops,
             lambda: torch.triangular_solve(bq[:qm, None], Qlt, upper=False), one, need_flops=2 * Sql.nnz)
        log(f"  {kernel} (scatter lower, nb={form.nb} nblk={form.nblk} W={Lv.shape[2]}): "
            f"{ms[kernel] * 1e3 / form.nblk:.3f} us a step")
        # the level kernel on the triangle's level form (logged beside the
        # stencil's, which the kernels line carries)
        lform, bl = ttri.trsv_level_form_for(handle.plan, LOWER, NONE), bq[:qm]
        t_k = cuda_ms(lambda: trsv_level(lform, bl), reps=9, inner=5, warm=1, backlog=True)
        t_p = cuda_ms(lambda: trsv_level_plain(lform, bl), reps=3, inner=1, warm=1, backlog=True)
        t_b, by = bound_of(level_bytes(lform, bl), 2 * lform.lcol.numel() + 2 * qm, inst, peak)
        log(f"  trsv_level_{inst} (scatter lower, {lform.nlev} levels, {lform.lcol.numel()} strict entries): kernel "
            f"{t_k:.4f} ms ({t_k * 1e3 / lform.nlev:.3f} us a level), plain {t_p:.4f} ms, library "
            f"{ratio(lib[kernel], 1.0)} ms, "
            f"bound {t_b:.4f} ms ({by}), latency floor {lform.nlev * t_trip:.4f} ms; chain {ms[kernel]:.4f} ms")
        del Qlt
    # the sv engines and the stencil's preconditioned CG iterations
    bs_d = torch.from_numpy(np.random.default_rng(71).standard_normal(mh).astype(np.float32)).to(dev)
    for kid, what in ((None, "the default: level kernel"), (0, "dwin chain kernel"), (1, "level kernel"),
                      (2, "host engine")):
        t = cuda_ms(lambda: tt.trsv(1.0, H, LOWER, NONE, bs_d, kid=kid), reps=3, inner=1, warm=1)
        log(f"  stencil trsv kid={kid} (lower, {what}): {t:.4f} ms/call")
    profile_mv("stencil trsv (the default: level kernel)", lambda: tt.trsv(1.0, H, LOWER, NONE, bs_d), calls=3)
    for kid, what in ((None, "two level-kernel solves"), (0, "two dwin solves")):
        t_hsm = cuda_ms(lambda: tt.ilu_smoother(H, GEN, bs_d, kid=kid), reps=3, inner=1, warm=1)
        log(f"  stencil ilu_smoother kid={kid}: {t_hsm:.4f} ms/call ({what})")
    # the preconditioned iterations by the default (the level kernel) and,
    # in turn, with the gate closed (the chain kernel, the solve before it)
    devices = ttri.SV_LEVEL_DEVICES
    for precond in ("ilu0", "sgs"):
        for label, gate_devices in (("level kernel", devices), ("chain kernel, gate closed", ())):
            ttri.SV_LEVEL_DEVICES = gate_devices
            t_it, t_all = iteration_ms(
                lambda kk: tt.pcg_solve(H, bs_d, rtol=0.0, maxit=kk, precond=precond)[1], 2, 6)
            log(f"  stencil {precond.upper()}-PCG iteration ({label}): {t_it:.4f} ms (host clock, median of "
                f"{[round(t, 4) for t in t_all]}; {stencil_iters[precond]} iterations to rtol {rtol:g})")
    ttri.SV_LEVEL_DEVICES = devices
    t_it, t_all = iteration_ms(lambda kk: tt.pcg_solve(H, bs_d, rtol=0.0, maxit=kk)[1], 5, 25)
    log(f"  stencil CG iteration (no preconditioner): {t_it:.4f} ms (host clock, median of "
        f"{[round(t, 4) for t in t_all]})")
    profile_mv("stencil ILU0-PCG iteration (2 fixed iterations)",
               lambda: tt.pcg_solve(H, bs_d, rtol=0.0, maxit=2, precond="ilu0"), calls=1, top=6)
    profile_mv("stencil SGS-PCG iteration (2 fixed iterations)",
               lambda: tt.pcg_solve(H, bs_d, rtol=0.0, maxit=2, precond="sgs"), calls=1, top=6)
    profile_mv("stencil CG iteration (5 fixed iterations)", lambda: tt.pcg_solve(H, bs_d, rtol=0.0, maxit=5),
               calls=1, top=6)

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
    # cold: a gen mv streams its 2.9 GB band between two routes, so the
    # route's and the accumulate's operands come from device memory, not L2
    flush = torch.empty(COLD_VALUES, dtype=torch.float32, device=dev)
    for kernel, kern, lib_fn in (
        ("benes_route_f32", lambda: apply_route(contrib, sr.masks, sr.masks_packed, sr.k), lambda: contrib[perm]),
        ("oh_accum_f32", lambda: oh_accum(routed, *acc_args), lambda: y_lib.index_add_(0, acc_rows, acc_vals)),
    ):
        t_cold, t_cold_lib = cold_ms(kern, flush), cold_ms(lib_fn, flush)
        log(f"  {kernel} cold (after writing {nbytes(flush) / 2**20:.0f} MiB): kernel {t_cold:.4f} ms, library "
            f"{t_cold_lib:.4f} ms; warm kernel {ms[kernel]:.4f} ms, library {lib[kernel]:.4f} ms; bound "
            f"{bounds[kernel][0]:.4f} ms")
    # the route's passes one at a time (in place), their sum against the
    # whole route (the gaps between its launches), a pass of one stage (its
    # load and store phases alone) and a plain copy of v
    w_ = contrib.clone()
    d_ = int(sr.masks_packed.shape[0]).bit_length() - 1
    full = route_passes(sr.k, d_, smem=benes_mod.PASS_SMEM)
    one = benes_mod.RoutePass(full[0].c, full[0].blo, full[0].bhi, full[0].rows[:1], ((full[0].stages[0][0], 0, 0),),
                              (0,))
    pass_ms = {}
    try:
        for label, sub in [(f"pass {i}", (p_,)) for i, p_ in enumerate(full)] + [("one stage, one mask row", (one,))]:
            benes_mod.route_passes = lambda *_a, _s=sub, **_k: _s
            pass_ms[label] = (cuda_ms(lambda: benes_apply(w_, sr.masks, sr.masks_packed, sr.k, out=w_), backlog=True),
                              cold_ms(lambda: benes_apply(w_, sr.masks, sr.masks_packed, sr.k, out=w_), flush))
    finally:
        benes_mod.route_passes = route_passes
    t_copy = cuda_ms(lambda: contrib.clone(), backlog=True)
    log(f"  benes_route_f32 by pass (warm / cold ms): "
        + "; ".join(f"{k_} {w:.4f} / {c_:.4f}" for k_, (w, c_) in pass_ms.items())
        + f"; sum of the passes {sum(pass_ms[f'pass {i}'][0] for i in range(len(full))):.4f} warm against the "
        f"route's {ms['benes_route_f32']:.4f}; v.clone() {t_copy:.4f}")
    del masks_full, perm, acc_rows, acc_vals, y_lib, flush, w_
    t_engine = cuda_ms(lambda: spill_route_apply(xs_d, ys_d, sr))
    t_tail = cuda_ms(lambda: ys_d.clone().index_add_(0, wform.sp_rows, wform.sp_val * xs_d[wform.sp_ind]))
    d_engine = cuda_ms(lambda: spill_route_apply(xs_d, ys_d, sr), backlog=True)
    d_tail = cuda_ms(lambda: ys_d.clone().index_add_(0, wform.sp_rows, wform.sp_val * xs_d[wform.sp_ind]),
                     backlog=True)
    log(f"  webbase spill of {n_spill} entries: select + route + accumulate {t_engine:.4f} ms a call "
        f"({d_engine:.4f} ms device time, {route_launches(sr) + 2} launches) vs the gather + index_add_ tail "
        f"{t_tail:.4f} ms a call ({d_tail:.4f} ms device time; the port's path below the gate)")
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

    # the band GEMM kernel on the cant A.A plan; cuSPARSE SpGEMM (torch.sparse
    # CSR @ CSR) of the same product as the yardstick
    bp, P_c, nnzC_c, t_pat_c, t_relay_c = gcant
    del gcant
    # the band work, zeros included: per stream, its slab rows times WB for
    # every group whose block is in range
    band_flops = 2 * bp.G * bp.WB * sum(
        (hi - lo) * (min(bp.nblk, bp.nblk - (bp.d0 + s)) - max(0, -(bp.d0 + s)))
        for s, (lo, hi, _br) in enumerate(bp.stream_ranges) if hi > lo)
    a32, b32 = bp.formA.bwd_val, bp.formB.bwd_val
    for inst, tdt in (("f32", torch.float32), ("f64", torch.float64)):
        kernel = f"band_gemm_{inst}"
        x_, y_ = a32.to(tdt), b32.to(tdt)
        turns(kernel, lambda: band_gemm(x_, y_, bp.WC, bp.d0, bp.stream_ranges),
              lambda: band_gemm_plain(x_, y_, bp.WC, bp.d0, bp.stream_ranges), kreps=(5, 4), preps=(3, 2))
        At = csr_tensor(cptr_, cind_, cval_, dev, tdt)
        esz = x_.element_size()
        # the bound: the operands and the C band once each, and the FMAs of
        # the warp steps whose fragments both hold a nonzero (32 x 32 x 8
        # each), what the kernel's skip leaves; the full band's bound, zeros
        # included, is logged beside it
        taken, visited = band_gemm_steps(x_, y_, bp.WC, bp.d0, bp.stream_ranges)
        step_flops = 2 * 32 * 32 * 8 * taken
        band_bytes = nbytes(x_, y_) + bp.nblk * bp.G * bp.WC * esz
        note(kernel, band_bytes, nz_bytes(x_, y_) + nnzC_c * esz, step_flops, lambda: At @ At, dict(reps=3, inner=1),
             need_flops=2 * P_c)
        full_ms, full_by = bound_of(band_bytes, band_flops, inst, peak)
        log(f"  {kernel}: {taken} of {visited} warp steps taken ({step_flops / 1e9:.2f} GFLOP); the full band's "
            f"bound {full_ms:.4f} ms ({full_by}) = {full_ms / ms[kernel]:.3f}")
        log(f"  {kernel}: {band_flops / ms[kernel] / 1e9:.1f} GFLOP/s of band work ({band_flops / 1e9:.2f} GFLOP, "
            f"zeros included), {2 * P_c / ms[kernel] / 1e9:.1f} GFLOP/s of the product's {P_c} scalar products")
        del x_, y_, At
    del a32, b32, bp
    fin = lambda: tt.sp2m(NONE, GEN, Ac, NONE, GEN, Ac, request=tt.Request.finalize, C=Cc)  # noqa: E731
    t_fin = cuda_ms(fin, reps=5, inner=2, warm=1)
    cb = cplan.band._last_cband
    t_ext = cuda_ms(lambda: extract_values(cplan.band, cb), reps=9, inner=5)
    t_cmv = cuda_ms(lambda: tt.mv(1.0, Cc, GEN, NONE, xc_d, 0.0), reps=9, inner=5)
    if not Cc.values_pending:
        raise AssertionError("timing the chained mv materialized the product")
    log(f"  cant A.A: sp2m finalize (lazy: the band GEMM, no extraction) {t_fin:.4f} ms a call; the extraction "
        f"gather of {nnzC_c} values {t_ext:.4f} ms; chained mv on the pending product's band {t_cmv:.4f} ms; "
        f"host set-up: native pattern {t_pat_c:.2f} s, band relayout (plan maps + operand scatter) "
        f"{t_relay_c:.2f} s, the whole nnz_count stage {t_sym:.2f} s")
    profile_mv("sp2m finalize (cant A.A)", fin, calls=3)
    del cb
    # the numeric engines of a product without a band plan (scatter Q.Q):
    # the device expansion engine (the card's default) against the host
    # engine (pinned: values down, the threaded C++ numeric, C up) and
    # cuSPARSE SpGEMM, the data for the card's engine gate
    fin_q = lambda: tt.sp2m(NONE, GEN, Qh, NONE, GEN, Qh, request=tt.Request.finalize, C=Cq)  # noqa: E731
    t_qdev = cuda_ms(fin_q, reps=5, inner=2, warm=1)
    qplan._host_engine = True
    t_qhost = cuda_ms(fin_q, reps=3, inner=1, warm=1)
    qplan._host_engine = False
    Qt = csr_tensor(qptr, qind, qval, dev, torch.float32)
    t_qlib, err = library_ms(lambda: Qt @ Qt, reps=3, inner=1)
    lib_s = f"{t_qlib:.4f} ms" if t_qlib is not None else f"none ({err})"
    log(f"  scatter Q.Q (no band plan; P={qplan.P}, nnzC={qplan.nnz}): sp2m finalize on the device expansion "
        f"engine {t_qdev:.4f} ms, on the host engine (pinned) {t_qhost:.4f} ms; cuSPARSE SpGEMM {lib_s}")
    profile_mv("sp2m finalize (scatter Q.Q, device expansion engine)", fin_q, calls=3)
    del Qt
    # the solver framework's iterations (phase 5f's operands), phase 5g's
    solver_timings(sf)
    lowprec_timings(lp)
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
