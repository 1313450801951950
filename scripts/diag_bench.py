#!/usr/bin/env python3
"""Time mv KID 6 on one card: the diagonal SpMV kernel (csrc/spmv_diag.cu)
on HPCG's stencil, the stencil's mv call and PCG iterations, and the forms
the mv rule's diag branch weighs (diag, bandt, segsum).

    python3 scripts/diag_bench.py [--label NAME] [--turns 3] [--check]
                                  [--rows] [--mv] [--pcg] [--rule] [--cross]
                                  [--quick]

Needs one CUDA card. Imports the port and chip_smoke.py (its operand
generators and its CUDA-event timer) from the root of the checkout the
script sits in. To time a second checkout in the same call, copy the script
into it and run it there (`cp scripts/diag_bench.py <tree>/scripts/ && cd
<tree> && python3 scripts/diag_bench.py --label parent`); in a tree whose
port has no diagonal kernel (kernels/spmv_diag.py) the kernel's rows are
left out and the rest is timed as that tree runs it.

The stencil: HPCG's 27-point stencil on a 104^3 grid (chip_smoke.stencil27,
m = 1,124,864, 27 diagonals), its default mv form (`diag`) and its strict
lower triangle's (13 diagonals, the SGS apply's second matvec).

- default: the kernel alone (kernels/spmv_diag.py spmv_diag, as the
  package builds it: 4 rows a thread) on the stencil's diag form in f32, bf16 (the values and x
  rounded) and f64 (widened), and on the strict lower triangle in f32,
  beside the plain version (kernels/plain_spmv.py spmv_diag), cuSPARSE's
  CSR @ x (bf16: cuSPARSE f32 on the bf16-rounded CSR and x, the same
  function) and the byte bound (kernels/spmv_diag.py diag_bytes at the
  published HBM peak); device time, behind a device spin
  (chip_smoke.cuda_ms), the lowest of --turns turns with each turn's value;
  the launches of one call.
- --check: the kernel against the plain version (f32, f64: expected
  precision; bf16: against f32 sums of the same bf16 values rounded once,
  four bf16 units in the last place), and its bits on a second call.
- --rows: the kernel at 1, 2, 4 and 8 rows a thread on the stencil (f32,
  f64) and the strict lower triangle (f32): R = 4 is the package's build,
  the others csrc/spmv_diag.cu built alone with -DSPMV_DIAG_R=R into
  _smoke/diag_rows/ (all nvcc started together), each held against the
  plain version with --check.
- --mv: the stencil's default mv call (call time, the host's dispatch
  included; and its device time) and the strict lower triangle's.
- --pcg: HPCG's CG, ILU0-PCG and SGS-PCG iterations on the stencil (f32,
  default engines; chip_smoke.iteration_ms: two fixed-length solves, host
  clock).
- --rule: mv calls and kernels of the forms the diag branch weighs, each
  pinned by its KID (6 diag, 8 bandt, 0 segsum; the handle's default
  form logged): the stencil; the bench band (bench.py:220-233: a window
  of 128, and 255 diagonals under the kid=6 pin, since the window of its
  first and last rows is clipped); a band of 32 and one of 80 diagonals in
  a window of 128 (m = 262,144, every slot stored); and diagonal operands
  with the stencil's 27 offsets at m = 1,124,864 whose diagonals keep
  a seeded 1/p of their slots (p = 1, 2, 4, 8, 16: p = 16 is the diag
  test's padding limit, planner/plan.py `_diag_ok`), 96 offsets at p = 16
  and 192 at p = 8 (its wide limit); and the 27-offset operands at p = 1,
  4 / 3 and 2 with float64 values.
- --cross: the same, on operands near `diag_beats_csr`'s crossovers
  alone: the 27 offsets at 1.5, 1.6, 1.7 and 1.8 stored slots a nonzero in
  float64, and at 1.8, 2.0 and 2.2 in float32 (keeping 1/p of the
  off-centre slots, p = 26 / (27 / s - 1)).
- --quick: the stencil f32 only.

Prints the card's name and power limit and one JSON object a
measurement, and writes them to the gitignored _smoke/diag_bench_<label>.jsonl.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import aoclsparse_tpu_torch as tt  # noqa: E402
from aoclsparse_tpu_torch.kernels.plain_spmv import spmv_diag as spmv_diag_plain  # noqa: E402
from aoclsparse_tpu_torch.kernels.spmv_csr import spmv_csr  # noqa: E402
from aoclsparse_tpu_torch.planner.plan import choose_mv_format, get_plan  # noqa: E402
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error  # noqa: E402

import chip_smoke as cs  # noqa: E402

HAS_KERNEL = importlib.util.find_spec("aoclsparse_tpu_torch.kernels.spmv_diag") is not None
if HAS_KERNEL:
    from aoclsparse_tpu_torch.kernels import spmv_diag as dk  # noqa: E402

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
STRICT_L = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower,
                               diag_type=tt.DiagType.zero)
PEAK_GBPS = 3350.0
ROWS = (1, 2, 4, 8)
#: rows a thread of the package's build (csrc/spmv_diag.cu SPMV_DIAG_R)
BUILT_R = 4
_VARIANTS = {}


def rows_variants():
    """csrc/spmv_diag.cu built alone at each R of ROWS but BUILT_R (one
    nvcc each, started together), loaded with ctypes: {R: CDLL}."""
    if _VARIANTS:
        return _VARIANTS
    from aoclsparse_tpu_torch.kernels import build

    out_dir = ROOT / "_smoke" / "diag_rows"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.CSRC_DIR / "spmv_diag.cu"
    libs = {R: out_dir / f"spmv_diag_R{R}.so" for R in ROWS if R != BUILT_R}
    procs = {R: subprocess.Popen([build._nvcc(), *build.GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                                  "-shared", f"-DSPMV_DIAG_R={R}", "-o", str(lib), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for R, lib in libs.items()}
    for R, proc in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -DSPMV_DIAG_R={R} failed:\n{stdout}\n{stderr}")
        _VARIANTS[R] = ctypes.CDLL(str(libs[R]))
    return _VARIANTS


def variant_call(R, dv, offs, x, m):
    """One launch of the R-rows-a-thread build on dv's instance, as the
    wrapper launches the package's."""
    name = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float64: "f64"}[dv.dtype]
    fn = getattr(rows_variants()[R], f"spmv_diag_{name}")
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call():
        y = torch.empty(m, dtype=dv.dtype, device=x.device)
        rc = fn(dv.data_ptr(), offs.data_ptr(), dv.shape[0], x.data_ptr(), y.data_ptr(), m, x.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"spmv_diag_{name} at R={R}: CUDA error {rc}")
        return y

    return call


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    out.write(line + "\n")


def best(fn, turns, **kw):
    vals = [cs.cuda_ms(fn, **kw) for _ in range(turns)]
    return min(vals), vals


def bound_ms(nbytes):
    return nbytes / (PEAK_GBPS * 1e6)


def diag_operand(m, offs, p, seed, dtype=np.float32):
    """(ptr, ind, val) of an m x m matrix on the sorted offsets `offs`:
    each diagonal keeps a seeded 1/p of its in-range slots (the main
    diagonal all of them, 30.0; the rest uniform in [-1, 1]), values of
    `dtype`."""
    rng = np.random.default_rng(seed)
    i = np.arange(m, dtype=np.int64)
    offs = np.asarray(sorted(offs), dtype=np.int64)
    cols = i[:, None] + offs[None, :]
    keep = (cols >= 0) & (cols < m) & ((rng.random((m, offs.size)) < 1.0 / p) | (offs[None, :] == 0))
    ptr = np.concatenate([[0], np.cumsum(keep.sum(1))])
    c = cols[keep]
    rows = np.repeat(i, keep.sum(1))
    val = np.where(c == rows, 30.0, rng.uniform(-1.0, 1.0, c.size)).astype(dtype)
    return ptr, c.astype(np.int32), val


def handle(ptr, ind, val, dev):
    m = len(ptr) - 1
    A = tt.create_csr(m, m, ptr, ind, val, device=dev)
    tt.set_mv_hint(A, NONE, GEN, nop=1000)
    tt.optimize(A)
    return A


def kernel_rows(name, form, x, lib, turns, rows_sweep, check, label, out, dtype_tag):
    """The kernel (every R of ROWS where rows_sweep, else the package's
    build), the plain version and the library call on one diag form."""
    dv, offs = form.dia_val, form.dia_offs
    m, L, n_pad = form.m, form.dia_L, form.dia_n_pad
    rec = {"label": label, "case": f"{name} {dtype_tag}", "ndiag": int(dv.shape[0]), "m": m}
    if HAS_KERNEL:
        nbytes = dk.diag_bytes(dv, form.dia_offs_static, x.shape[0])
        rec["bound_ms"] = bound_ms(nbytes)
        rec["bytes"] = nbytes
        c0 = dict(dk.spmv_diag.launches)
        dk.spmv_diag(dv, offs, x, m, L, n_pad)
        torch.cuda.synchronize()
        rec["launches"] = sum(dk.spmv_diag.launches.values()) - sum(c0.values())
        if check:
            a = dk.spmv_diag(dv, offs, x, m, L, n_pad)
            b = dk.spmv_diag(dv, offs, x, m, L, n_pad)
            if dv.dtype == torch.bfloat16:
                want = spmv_diag_plain(dv.float(), offs, x.float(), m, L, n_pad).to(dv.dtype)
                tol = 4 * 2.0**-7
            else:
                want, tol = spmv_diag_plain(dv, offs, x, m, L, n_pad), expected_precision(dv.dtype)
            err = near_error(a.double().cpu().numpy(), want.double().cpu().numpy())
            same = bool(torch.equal(a, b))
            rec.update(max_rel_err=err, tol=tol, same_bits=same)
            if not (err <= tol and same):
                emit(rec, out)
                raise AssertionError(f"{name} {dtype_tag}: kernel err {err} (tol {tol}), same bits {same}")
        for R in (ROWS if rows_sweep else (BUILT_R,)):
            fn = (lambda: dk.spmv_diag(dv, offs, x, m, L, n_pad)) if R == BUILT_R else variant_call(R, dv, offs, x, m)
            if check and R != BUILT_R:
                a, b = fn(), fn()
                torch.cuda.synchronize()
                if not torch.equal(a, b) or near_error(a.double().cpu().numpy(), want.double().cpu().numpy()) > tol:
                    raise AssertionError(f"{name} {dtype_tag}: the R={R} build disagrees with the plain version")
            t, vals = best(fn, turns, reps=9, inner=10, backlog=True)
            rec[f"ms_R{R}"], rec[f"turns_R{R}"] = t, vals
        rec["ms"] = rec[f"ms_R{BUILT_R}"]
        rec["of_bound"] = rec["bound_ms"] / rec["ms"]
    rec["plain_ms"], rec["plain_turns"] = best(lambda: spmv_diag_plain(dv, offs, x, m, L, n_pad), min(turns, 2),
                                               reps=5, inner=3, backlog=True)
    if lib is not None:
        rec["library_ms"], rec["library_turns"] = best(lib, turns, reps=9, inner=10, backlog=True)
    emit(rec, out)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--rows", action="store_true")
    ap.add_argument("--mv", action="store_true")
    ap.add_argument("--pcg", action="store_true")
    ap.add_argument("--rule", action="store_true")
    ap.add_argument("--cross", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    print(f"port from {Path(tt.__file__).resolve().parent}; diagonal kernel: {HAS_KERNEL}", flush=True)
    (ROOT / "_smoke").mkdir(exist_ok=True)
    turns = args.turns
    with open(ROOT / "_smoke" / f"diag_bench_{args.label}.jsonl", "a") as out:
        t0 = time.perf_counter()
        hptr, hind, hval = cs.stencil27()
        mh = len(hptr) - 1
        H = handle(hptr, hind, hval, dev)
        hf = get_plan(H).exec_form_for(GEN, NONE)
        lf = get_plan(H).exec_form_for(STRICT_L, NONE)
        print(f"stencil 104^3 planned in {time.perf_counter() - t0:.1f} s: default form {hf.kind} "
              f"({len(hf.dia_offs_static or ())} diagonals), strict L {lf.kind} "
              f"({len(lf.dia_offs_static or ())} diagonals)", flush=True)
        xh = torch.from_numpy(np.random.default_rng(103).standard_normal(mh).astype(np.float32)).to(dev)
        H32 = cs.csr_tensor(hptr, hind, hval, dev, torch.float32)
        kernel_rows("stencil", hf, xh, lambda: H32 @ xh, turns, args.rows, args.check, args.label, out, "f32")
        if not args.quick:
            rows_l = np.repeat(np.arange(mh), np.diff(hptr))
            low = hind < rows_l
            Lptr = np.concatenate([[0], np.cumsum(np.bincount(rows_l[low], minlength=mh))])
            L32 = cs.csr_tensor(Lptr, hind[low], hval[low], dev, torch.float32)
            kernel_rows("stencil strict L", lf, xh, lambda: L32 @ xh, turns, args.rows, args.check, args.label, out,
                        "f32")
            del L32
            # bf16: the values and x rounded; cuSPARSE f32 on the rounded CSR
            # and x computes the kernel's function (f32 sums)
            h16 = hf.dia_val.to(torch.bfloat16)
            f16 = type("F", (), dict(dia_val=h16, dia_offs=hf.dia_offs, dia_offs_static=hf.dia_offs_static,
                                     m=hf.m, dia_L=hf.dia_L, dia_n_pad=hf.dia_n_pad))
            x16 = xh.to(torch.bfloat16)
            H16r = cs.csr_tensor(hptr, hind, torch.from_numpy(hval).to(torch.bfloat16).float().numpy(), dev,
                                 torch.float32)
            x16r = x16.float()
            kernel_rows("stencil", f16, x16, lambda: H16r @ x16r, turns, False, args.check, args.label, out, "bf16")
            del H16r, h16
            f64 = type("F", (), dict(dia_val=hf.dia_val.double(), dia_offs=hf.dia_offs,
                                     dia_offs_static=hf.dia_offs_static, m=hf.m, dia_L=hf.dia_L,
                                     dia_n_pad=hf.dia_n_pad))
            x64 = xh.double()
            H64 = cs.csr_tensor(hptr, hind, hval, dev, torch.float64)
            kernel_rows("stencil", f64, x64, lambda: H64 @ x64, turns, args.rows, args.check, args.label, out, "f64")
            del H64, f64
        if args.mv:
            for name, descr in (("stencil", GEN), ("stencil strict L", STRICT_L)):
                call = lambda d=descr: tt.mv(1.0, H, d, NONE, xh, 0.0)  # noqa: E731
                t_call, v_call = best(call, turns, reps=9, inner=10)
                t_dev, v_dev = best(call, turns, reps=9, inner=10, backlog=True)
                emit({"label": args.label, "case": f"{name} mv call", "ms": t_call, "turns": v_call,
                      "device_ms": t_dev, "device_turns": v_dev}, out)
        if args.pcg:
            bs = torch.from_numpy(np.random.default_rng(71).standard_normal(mh).astype(np.float32)).to(dev)
            for precond in (None, "ilu0", "sgs"):
                tt.pcg_solve(H, bs, rtol=0.0, maxit=1, precond=precond)  # builds the forms and the preconditioner

                def solve(kk, precond=precond):
                    return tt.pcg_solve(H, bs, rtol=0.0, maxit=kk, precond=precond)[1]

                t_it, t_all = cs.iteration_ms(solve, *((4, 16) if precond else (10, 60)), turns=turns)
                emit({"label": args.label, "case": f"stencil {(precond or 'none').upper()}-PCG iteration", "ms": t_it,
                      "turns": t_all}, out)
        if args.rule or args.cross:
            rule(H, hptr, hind, hval, xh, dev, turns, args.label, out, cross=args.cross and not args.rule)
    return 0


def rule(H, hptr, hind, hval, xh, dev, turns, label, out, cross=False):
    """The diag branch's candidates on each operand, by KID pins (only the
    operands near the crossovers where `cross`)."""
    bptr, bind, bval, _bx = cs.bench_operand()
    nx = 104
    st_offs = tuple((dz * nx + dy) * nx + dx for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    rng = np.random.default_rng(5)
    wide = tuple(sorted(rng.choice(np.arange(-20000, 20001), 191, replace=False).tolist() + [0]))
    wide = tuple(sorted(set(wide)))
    ops = [("stencil", lambda: (hptr, hind, hval)), ("bench band", lambda: (bptr, bind, bval)),
           ("band 32 of 128", lambda: diag_operand(262144, range(-64, 64, 4), 1, 21)),
           ("band 80 of 128", lambda: diag_operand(262144, sorted(np.random.default_rng(22).choice(
               np.arange(-64, 64), 80, replace=False).tolist()), 1, 22))]
    ops += [(f"27 offsets p={p}", lambda p=p: diag_operand(1124864, st_offs, p, 30 + p)) for p in (1, 2, 4, 8, 16)]
    ops += [("96 offsets p=16", lambda: diag_operand(1124864, sorted(set(np.random.default_rng(40).choice(
        np.arange(-20000, 20001), 95, replace=False).tolist()) | {0}), 16, 41)),
            ("192 offsets p=8", lambda: diag_operand(1124864, wide, 8, 42))]
    ops += [(f"27 offsets p={p:.3g} f64", lambda p=p: diag_operand(1124864, st_offs, p, 50, np.float64))
            for p in (1.0, 4 / 3, 2.0)]
    if cross:
        ops = [(f"27 offsets s={s_} {tag}", lambda s_=s_, dt=dt: diag_operand(1124864, st_offs, 26 / (27 / s_ - 1),
                                                                            60, dt))
               for tag, dt, ss in (("f64", np.float64, (1.5, 1.6, 1.7, 1.8)), ("f32", np.float32, (1.8, 2.0, 2.2)))
               for s_ in ss]
    for name, make in ops:
        t0 = time.perf_counter()
        ptr, ind, val = make()
        m = len(ptr) - 1
        A = H if name == "stencil" else handle(ptr, ind, val, dev)
        plan = get_plan(A)
        eff = plan.effective_for(GEN, NONE)
        x = xh if m == xh.shape[0] else torch.from_numpy(
            np.random.default_rng(9).standard_normal(m).astype(np.float32)).to(dev)
        x = x.to(A.dtype)
        rec = {"label": label, "case": f"rule {name}", "m": m, "nnz": int(ind.size),
               "default": plan.exec_form_for(GEN, NONE).kind, "rule_cuda": choose_mv_format(eff, device=dev),
               "plan_s": time.perf_counter() - t0}
        for kid, kind in ((6, "diag"), (8, "bandt"), (0, "segsum")):
            try:
                form = plan.exec_form_for(GEN, NONE, kind=kind)
            except tt.AoclSparseError as e:
                rec[kind] = f"refused: {e}"
                continue
            if form is None or form.kind != kind:
                rec[kind] = f"form {None if form is None else form.kind}"
                continue
            call = lambda k=kid: tt.mv(1.0, A, GEN, NONE, x, 0.0, kid=k)  # noqa: E731
            r = {"call_ms": best(call, turns, reps=7, inner=5)[0],
                 "device_ms": best(call, turns, reps=7, inner=5, backlog=True)[0]}
            if kind == "diag":
                r["ndiag"] = len(form.dia_offs_static)
                r["padding"] = len(form.dia_offs_static) * m / max(ind.size, 1)
                if HAS_KERNEL:
                    r["bytes"] = dk.diag_bytes(form.dia_val, form.dia_offs_static, m)
                    r["kernel_ms"] = best(lambda: dk.spmv_diag(form.dia_val, form.dia_offs, x, m, form.dia_L,
                                                               form.dia_n_pad), turns, reps=7, inner=5,
                                          backlog=True)[0]
            elif kind == "segsum":
                vs = x.element_size()
                r["bytes"] = int(ind.size) * (4 + vs) + (m + 1) * 4 + 2 * m * vs
                r["kernel_ms"] = best(lambda: spmv_csr(form.ptr, form.ind, form.val, x, form.csr_blocks), turns,
                                      reps=7, inner=5, backlog=True)[0]
            else:
                r["W"] = int(form.bwd_W)
                r["bytes"] = int(form.bwd_val.numel()) * 4 + 2 * m * 4
            r["bound_ms"] = bound_ms(r["bytes"]) if "bytes" in r else None
            rec[kind] = r
            del form
        emit(rec, out)
        if A is not H:
            del A
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
