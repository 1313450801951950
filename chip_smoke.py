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
   - the window-solve kernel on the ILU0 L and U forms of the SPD operand
     (the bench profile symmetrised plus a Gershgorin diagonal shift,
     25,296,970 nnz; nb = 256, WL = 64, nblk = 1024) in f32 and f64, and on
     a small odd-m form whose window reaches back over several blocks;
4. drive the main path: create_csr(device="cuda") -> set_mv_hint(nop=1000)
   -> optimize -> mv (default form, kid=8, kid=12, alpha/beta with y, the
   mixed bf16 band, a float64 handle), each checked against a float64 scipy
   CSR reference;
5. solvers on the SPD operand, on a handle made by create_csr ->
   set_mv_hint / set_sv_hint / set_lu_smoother_hint -> optimize:
   pcg_solve(rtol=1e-6) with no preconditioner (one band launch per
   iteration); trsv lower non-unit in f32 and upper non-unit on a float64
   handle, each checked by its f64 scipy residual; ilu_smoother, checked by
   the residual of L (U x) = b with the port's own factors; and
   pcg_solve(precond="ilu0") and ("sgs"), each in fewer iterations than
   with none, with a true relative residual <= 1e-5 and the launch counts
   the composition implies;
6. time kernel vs plain version, one mv call, one CG iteration, one
   ilu_smoother call and one ILU0-PCG iteration with CUDA events or the
   host clock (median of repeats), with the kernels' stream rates against
   the card's published HBM peak, and the set-up seconds of ilu0_factorize.

Launch counts are reset just before phase 4 and read after phase 5. The
second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import native
from aoclsparse_tpu_torch.kernels import build
from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv, band_spmv_plain, spmv_bandt
from aoclsparse_tpu_torch.kernels.trsv_win import trsv_win, trsv_win_plain
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
}
#: mv against the float64 reference: the operand dtype's model tolerance
MV_TOL = {"f32": expected_precision(torch.float32), "f64": expected_precision(torch.float64)}


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


def row_nnz(ptr):
    return np.diff(ptr).astype(np.float64)


def bandt_form(ptr, ind, val, dev):
    A = tt.create_csr(len(ptr) - 1, len(ptr) - 1, ptr, ind, val, device=dev)
    form = tt.optimize(A).exec_form_for(GEN, NONE, kind="bandt")
    if form.kind != "bandt":
        raise AssertionError(f"operand planned as {form.kind}, want bandt")
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
    log("phase 3: kernel vs plain version")
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
    for name, form in (("L", st.l_form), ("U", st.u_form)):
        dT, lT = ilu_ops[name]
        label = f"ILU0 {name} (nb={form.nb}, WL={form.WL}, nblk={form.nblk})"
        compare("trsv_win_f32", label, trsv_win(dT, lT, bw, form.nb, form.WL),
                trsv_win_plain(dT, lT, bw, form.nb, form.WL), errs)
        dT, lT, b64 = dT.double(), lT.double(), bw.double()
        compare("trsv_win_f64", label, trsv_win(dT, lT, b64, form.nb, form.WL),
                trsv_win_plain(dT, lT, b64, form.nb, form.WL), errs)
        del dT, lT, b64
    wptr, wind, wval = wide_window_operand()
    for inst, dt in (("f32", np.float32), ("f64", np.float64)):
        Wh = tt.create_csr(len(wptr) - 1, len(wptr) - 1, wptr, wind, wval.astype(dt), device="cuda")
        wf = trsv_form_for(tt.optimize(Wh), LOWER, NONE, nb=64)
        if not (wf.WL > wf.nb and wf.m % 2 == 1):
            raise AssertionError(f"small form must be odd-m with WL > nb, got m={wf.m} WL={wf.WL}")
        dT, lT = wf.operands()
        bs = torch.from_numpy(wrng.standard_normal(wf.m_pad).astype(dt)).to(dev)
        compare(f"trsv_win_{inst}", f"small odd-m (m={wf.m}, nb={wf.nb}, WL={wf.WL}, nblk={wf.nblk})",
                trsv_win(dT, lT, bs, wf.nb, wf.WL), trsv_win_plain(dT, lT, bs, wf.nb, wf.WL), errs)
    del Wh, wf, dT, lT, bs

    # 4. the main path, counted
    log("phase 4: main path (create_csr -> set_mv_hint -> optimize -> mv)")
    S = sp.csr_matrix((val.astype(np.float64), ind, ptr), shape=(m, n))
    ref = S @ x.astype(np.float64)
    for counts in (band_spmv.launches, trsv_win.launches):
        for k in counts:
            counts[k] = 0
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

    # 5. solvers on the SPD operand
    log("phase 5: CG (pcg_solve, precond=None), trsv, ilu_smoother, ILU0- and SGS-PCG")
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
    run_pcg("ilu0", 1)
    run_pcg("sgs", 2)
    for precond in ("ilu0", "sgs"):
        if not iters[precond] < iters[None]:
            raise AssertionError(f"precond={precond} took {iters[precond]} iterations, none {iters[None]}")
    C64 = tt.create_csr(m, n, cptr, cind, cval.astype(np.float64), device="cuda")
    tt.set_sv_hint(C64, NONE, UPPER, nop=1000)
    tt.optimize(C64)
    check_residual("trsv f64 upper non-unit (reversed form)", sp.triu(Sspd).tocsr(),
                   tt.trsv(1.0, C64, UPPER, NONE, b_d.double()), bref, expected_precision(torch.float64))
    del C64
    launches = {f"band_spmv_{k}": v for k, v in band_spmv.launches.items()}
    launches.update({f"trsv_win_{k}": v for k, v in trsv_win.launches.items()})
    log(f"  main-path launches: {launches}")
    for kernel, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {kernel} never launched on the main path")

    # 6. timing
    log("phase 6: timing (CUDA events or host clock, median of repeats)")
    peak = ctx.hbm_gbps
    ms, plain_ms = {}, {}
    f64 = bandt_form(ptr, ind, val.astype(np.float64), dev)
    cases = {
        "band_spmv_f32": (f32.bwd_val, x32, args32),
        "band_spmv_bf16": (vt_bf, x32, args32),
        "band_spmv_f64": (f64.bwd_val, x64, (f64.bandt_start, f64.bwd_padL)),
    }
    for kernel, (vt, xv, args) in cases.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = cuda_ms(lambda: band_spmv_plain(vt, xv, *args))
        k1 = cuda_ms(lambda: band_spmv(vt, xv, *args))
        k2 = cuda_ms(lambda: band_spmv(vt, xv, *args))
        p2 = cuda_ms(lambda: band_spmv_plain(vt, xv, *args))
        ms[kernel], plain_ms[kernel] = min(k1, k2), min(p1, p2)
        band_bytes = vt.numel() * vt.element_size()
        log(f"  {kernel}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
            f"band stream {band_bytes / ms[kernel] / 1e6:.1f} GB/s "
            f"({band_bytes / ms[kernel] / 1e6 / peak:.3f} of peak {peak} GB/s)")
    del f64
    fL = st.l_form
    dT32, lT32 = ilu_ops["L"]
    b32 = bw
    dT64, lT64, b64 = dT32.double(), lT32.double(), bw.double()
    for kernel, (dT, lT, bb) in (("trsv_win_f32", (dT32, lT32, b32)), ("trsv_win_f64", (dT64, lT64, b64))):
        def kern():
            return trsv_win(dT, lT, bb, fL.nb, fL.WL)

        def plain():
            return trsv_win_plain(dT, lT, bb, fL.nb, fL.WL)

        # the plain loop walks 1024 blocks from Python: few repeats
        p1 = cuda_ms(plain, reps=3, inner=1, warm=1)
        k1 = cuda_ms(kern, reps=5, inner=2, warm=1)
        k2 = cuda_ms(kern, reps=5, inner=2, warm=1)
        p2 = cuda_ms(plain, reps=3, inner=1, warm=1)
        ms[kernel], plain_ms[kernel] = min(k1, k2), min(p1, p2)
        op_bytes = dT.numel() * dT.element_size() + lT.numel() * lT.element_size()
        log(f"  {kernel} (ILU0 L form, nb={fL.nb} WL={fL.WL} nblk={fL.nblk}): kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {p1:.4f}/{p2:.4f} ms, operand stream {op_bytes / ms[kernel] / 1e6:.1f} GB/s "
            f"({op_bytes / ms[kernel] / 1e6 / peak:.4f} of peak {peak} GB/s; "
            f"{op_bytes / 1e6:.1f} MB per solve)")
    del dT64, lT64, b64
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
