#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (aoclsparse_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (PATH, CUDA_HOME or /usr/local/cuda). It
imports nothing of JAX or of the JAX package. Phases, each raising on
failure (exit code != 0, no result line):

1. require a CUDA card; print nvidia-smi's name and power limit;
2. build the kernels from aoclsparse_tpu_torch/csrc with nvcc (sm_90a);
3. hold each band-kernel instance against its plain PyTorch version: on the
   bench operand (m = n = 262144, 64 nnz/row, half-bandwidth 64, seed 7,
   built as bench.py:220-233) in f32, bf16 band and f64, and on a small
   odd-m operand with a peel spill in f32 and f64;
4. drive the main path: create_csr(device="cuda") -> set_mv_hint(nop=1000)
   -> optimize -> mv (default form, kid=8, kid=12, alpha/beta with y, the
   mixed bf16 band, a float64 handle), each checked against a float64 scipy
   CSR reference;
5. CG: pcg_solve(rtol=1e-6) on an SPD operand of the same size (the bench
   profile symmetrised, plus a Gershgorin diagonal shift), checked by its
   true residual, with one band-kernel launch per iteration;
6. time kernel vs plain version, one mv call and one CG iteration with CUDA
   events (median of repeats) and print effective GB/s by bench.py's
   useful-byte formula against the card's published HBM peak.

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
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels import build
from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv, band_spmv_plain, spmv_bandt
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
SOURCE = "aoclsparse_tpu_torch/csrc/band_spmv.cu"
#: instance -> the TPU kernel it replaces (file:line of the Pallas function)
REPLACES = {
    "f32": "aoclsparse_tpu/kernels/pallas/spmv.py:531",  # pallas_spmv_band_t, KID 8
    "bf16": "aoclsparse_tpu/kernels/pallas/spmv.py:626",  # pallas_spmv_band_v, KID 12
    "f64": "aoclsparse_tpu/kernels/pallas/spmv.py:899",  # pallas_spmv_band_v_df, KID 13
}
#: kernel vs plain: the same products summed in another order, so the
#: accumulation dtype's model tolerance (utils/tolerances.py, scale 1);
#: the bf16 instance accumulates in f32 over the same bf16 band values
KERNEL_TOL = {
    "f32": expected_precision(torch.float32),
    "bf16": expected_precision(torch.float32),
    "f64": expected_precision(torch.float64),
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


def compare(name, got, want, errs):
    torch.cuda.synchronize()
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    if not (np.all(np.isfinite(g)) and g.shape == w.shape):
        raise AssertionError(f"{name}: non-finite or misshapen kernel output")
    rel = near_error(g, w)
    abs_err = float(np.max(np.abs(g - w))) if g.size else 0.0
    inst = name.split()[0]
    errs[inst] = max(errs.get(inst, 0.0), abs_err)
    ok = rel <= KERNEL_TOL[inst]
    log(f"  {name}: max rel err {rel:.3e} (tol {KERNEL_TOL[inst]:.3e}) max abs {abs_err:.3e}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")


def check_mv(name, got, ref, tol):
    g = got.double().cpu().numpy()
    if not (np.all(np.isfinite(g)) and g.shape == ref.shape):
        raise AssertionError(f"{name}: non-finite or misshapen mv output")
    err = near_error(g, ref)
    log(f"  {name}: max rel err vs f64 reference {err:.3e} (tol {tol:.3e})")
    if err > tol:
        raise AssertionError(f"{name}: mv disagrees with the float64 reference")


def cuda_ms(fn, reps=15, inner=10):
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    by CUDA events, after a warm-up."""
    for _ in range(3):
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


def main() -> int:
    # 1. the card
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke needs one NVIDIA card")
        return 1
    dev = torch.device("cuda", 0)
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
    compare("f32 bench", band_spmv(f32.bwd_val, x32, *args32),
            band_spmv_plain(f32.bwd_val, x32, *args32), errs)
    compare("bf16 bench", band_spmv(vt_bf, x32, *args32), band_spmv_plain(vt_bf, x32, *args32), errs)
    f64 = bandt_form(ptr, ind, val.astype(np.float64), dev)
    x64 = x32.double()
    args64 = (f64.bandt_start, f64.bwd_padL)
    compare("f64 bench", band_spmv(f64.bwd_val, x64, *args64),
            band_spmv_plain(f64.bwd_val, x64, *args64), errs)
    sptr, sind, sval, sx = spill_operand()
    for inst, dt in (("f32", np.float32), ("f64", np.float64)):
        sf = bandt_form(sptr, sind, sval.astype(dt), dev)
        if not (sf.has_spill and sf.m % 2 == 1):
            raise AssertionError("small operand must be odd-m with a spill")
        xs = torch.from_numpy(sx.astype(dt)).to(dev)
        got = spmv_bandt(sf.bwd_val, xs, sf.sp_val, sf.sp_ind, sf.sp_rows,
                         start=sf.bandt_start, padL=sf.bwd_padL)
        compare(f"{inst} small odd-m + spill (m={sf.m}, W={sf.bwd_W}, "
                f"spill={sf.sp_ind.numel()})", got, plain_bandt(sf.bwd_val, xs, sf), errs)
    del f64

    # 4. the main path, counted
    log("phase 4: main path (create_csr -> set_mv_hint -> optimize -> mv)")
    S = sp.csr_matrix((val.astype(np.float64), ind, ptr), shape=(m, n))
    ref = S @ x.astype(np.float64)
    for k in band_spmv.launches:
        band_spmv.launches[k] = 0
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

    # 5. CG on an SPD operand of the same size
    log("phase 5: CG (pcg_solve, precond=None)")
    Ssym = ((S + S.T) * 0.5).tocsr()
    Ssym = (Ssym + sp.diags(np.asarray(abs(Ssym).sum(axis=1)).ravel() + 1.0)).tocsr()
    Ssym.sort_indices()
    sval32 = Ssym.data.astype(np.float32)
    Sspd = sp.csr_matrix((sval32.astype(np.float64), Ssym.indices, Ssym.indptr), shape=(m, n))
    C = tt.create_csr(m, n, Ssym.indptr.astype(np.int64), Ssym.indices.astype(np.int32),
                      sval32, device="cuda")
    tt.set_mv_hint(C, NONE, GEN, nop=1000)
    cform = tt.optimize(C).exec_form_for(GEN, NONE)
    if cform.kind != "bandt":
        raise AssertionError(f"SPD operand planned as {cform.kind}")
    b = np.random.default_rng(5).standard_normal(m).astype(np.float32)
    b_d = torch.from_numpy(b).to(dev)
    rtol = 1e-6
    n0 = band_spmv.launches["f32"]
    t0 = time.perf_counter()
    xs, iters, rnorm = tt.pcg_solve(C, b_d, rtol=rtol, maxit=1000)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    cg_launches = band_spmv.launches["f32"] - n0
    true_res = float(np.linalg.norm(b - Sspd @ xs.double().cpu().numpy()) / np.linalg.norm(b))
    # f32 CG: the recursive residual drifts from the true one by O(eps_f32 *
    # cond(A)); cond <= (2R+1)/1 for the Gershgorin shift, so allow 10x rtol
    res_tol = 10 * rtol
    log(f"  SPD operand nnz={Ssym.nnz} W={cform.bwd_W}: {iters} iterations in {t_cg:.3f} s, "
        f"||r||={rnorm:.3e}, true rel residual {true_res:.3e} (tol {res_tol:.1e}), "
        f"band launches {cg_launches}")
    if not (iters < 1000 and rnorm <= rtol * np.linalg.norm(b) * 1.0001):
        raise AssertionError("CG did not converge")
    if not (np.isfinite(true_res) and true_res <= res_tol):
        raise AssertionError("CG true residual above tolerance")
    if cg_launches != iters + 1:  # one per iteration + the initial residual
        raise AssertionError(f"CG launched the band kernel {cg_launches} times in {iters} iterations")
    launches = dict(band_spmv.launches)
    log(f"  main-path launches: {launches}")
    for inst, count in launches.items():
        if count == 0:
            raise AssertionError(f"band kernel instance {inst} never launched on the main path")

    # 6. timing
    log("phase 6: timing (CUDA events, median of repeats)")
    peak = ctx.hbm_gbps
    ms, plain_ms = {}, {}
    f64 = bandt_form(ptr, ind, val.astype(np.float64), dev)
    cases = {
        "f32": (f32.bwd_val, x32, args32),
        "bf16": (vt_bf, x32, args32),
        "f64": (f64.bwd_val, x64, (f64.bandt_start, f64.bwd_padL)),
    }
    for inst, (vt, xv, args) in cases.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = cuda_ms(lambda: band_spmv_plain(vt, xv, *args))
        k1 = cuda_ms(lambda: band_spmv(vt, xv, *args))
        k2 = cuda_ms(lambda: band_spmv(vt, xv, *args))
        p2 = cuda_ms(lambda: band_spmv_plain(vt, xv, *args))
        ms[inst], plain_ms[inst] = min(k1, k2), min(p1, p2)
        band_bytes = vt.numel() * vt.element_size()
        log(f"  band_spmv_{inst}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
            f"band stream {band_bytes / ms[inst] / 1e6:.1f} GB/s "
            f"({band_bytes / ms[inst] / 1e6 / peak:.3f} of peak {peak} GB/s)")
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
    # one CG iteration: the difference of two fixed-length solves (rtol=0)
    k_lo, k_hi = 10, 60
    t_iter = []
    for _ in range(3):
        tk = {}
        for kk in (k_lo, k_hi):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, done, _ = tt.pcg_solve(C, b_d, rtol=0.0, maxit=kk)
            torch.cuda.synchronize()
            tk[kk] = time.perf_counter() - t0
            if done != kk:
                raise AssertionError(f"fixed-length CG ran {done} of {kk} iterations")
        t_iter.append((tk[k_hi] - tk[k_lo]) / (k_hi - k_lo) * 1e3)
    log(f"  CG iteration: {statistics.median(t_iter):.4f} ms (host clock, median of "
        f"{[round(t, 4) for t in t_iter]}; includes one host read per iteration)")

    kernels = [
        {
            "name": f"band_spmv_{inst}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[inst],
            "launches": launches[inst],
            "max_abs_err": errs[inst],
            "ms": ms[inst],
            "plain_ms": plain_ms[inst],
        }
        for inst in ("f32", "bf16", "f64")
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
