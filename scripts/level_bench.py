#!/usr/bin/env python3
"""Time the level-solve kernel (sv KID 1, csrc/trsv_level.cu) on one card,
and the card's floor for one dependency hop.

    python3 scripts/level_bench.py [--label NAME] [--turns 3] [--hop]
                                   [--check] [--sweep] [--pcg] [--quick]

Needs one CUDA card. Imports the port from the directory on PYTHONPATH
first, so a second checkout of the port can be timed in the same call
beside this one (`PYTHONPATH=<other tree> python3 scripts/level_bench.py
--label parent`), and this repository's chip_smoke.py for its operand
generators and its CUDA-event timer. The triangles (chip_smoke.py's):

- stencil: the lower ILU0 factor of HPCG's 27-point stencil on a 104^3
  grid (722 levels, 14,333,068 strict entries), f32 and f64 (the f32
  factor's values widened);
- complex: the lower ILU0 factor of the stencil + i I (chip_smoke.py's
  complex stencil), complex64 and complex128 (widened);
- scatter: the lower triangle of the scatter operand (m = 262,144, the
  diagonal plus 8 random columns a row, seed 23; 29 levels), f32 and f64;
- chain: a bidiagonal of 20,000 rows, one level a row (f32): a deep
  triangle's time a level.

Each is solved at K = 1 and, the stencil and scatter, at K = 16 (trsm's
width), the kernel alone by CUDA events behind a device spin (device time;
chip_smoke.cuda_ms), --turns turns, the lowest kept with every turn's
value. Records give the launches of one solve, the level count and the
byte bound (chip_smoke.level_bytes at the published HBM peak).

--hop: the card's floor for one hop (chip_smoke.hop_floor, this tree's
port only: two CTAs on two SMs pass a counter through one 64-bit word,
relaxed and release / acquire, and two warps of one CTA through a relaxed
shared word); nlev x hop is a level solve's latency floor.
--check: the kernel against its plain version (expected_precision) and its
own bits on a second call and on the smallest and largest grid
(LEVEL_SLACK 0 and 1e9), each triangle, K = 1 and 16.
--sweep: this tree's grid (kernels/trsv_level.py LEVEL_SLACK, the grid's
warps a row of the mean level) over SWEEP, on the stencil (f32, f64), the
scatter and the chain triangles at K = 1 and 16.
--pcg: HPCG's ILU0- and SGS-PCG iteration on the 104^3 stencil (f32, the
default engines; chip_smoke.iteration_ms: two fixed-length solves, host
clock).
--quick: the stencil, scatter and chain f32 only, K = 1 (--sweep: f32).

Prints the card's name and power limit and one JSON object a measurement,
and writes them to the gitignored _smoke/level_bench_<label>.jsonl.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT))  # chip_smoke's generators; the port comes from PYTHONPATH first

import aoclsparse_tpu_torch as tt  # noqa: E402
from aoclsparse_tpu_torch.kernels import trsv_level as tl  # noqa: E402
from aoclsparse_tpu_torch.planner import triangular as ttri  # noqa: E402
from aoclsparse_tpu_torch.solvers.ilu import _level_forms  # noqa: E402
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error  # noqa: E402

import chip_smoke as cs  # noqa: E402

NONE = tt.Operation.none
LOWER = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
PEAK_GBPS = 3350.0
#: the sweep's grids: the grid's warps a row of the mean level (0: a CTA an
#: SM; 1e9: all the card holds)
SWEEP = (0.0, 1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 1e9)


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def rhs(m, K, dtype, dev, seed=5):
    rng = np.random.default_rng(seed)
    shape = (m,) if K == 1 else (m, K)
    b = rng.standard_normal(shape)
    if dtype.is_complex:
        b = b + 1j * rng.standard_normal(shape)
    return torch.from_numpy(b).to(dev, dtype)


def triangles(dev, quick):
    """name -> LevelForm, built through the port's entry points."""
    t0 = time.perf_counter()
    hptr, hind, hval = cs.stencil27()
    mh = len(hptr) - 1
    H = tt.create_csr(mh, mh, hptr, hind, hval.astype(np.float32), device=dev)
    st = tt.ilu0_factorize(H)
    out = {"stencil f32": _level_forms(st)[0]}
    if not quick:
        out["stencil f64"] = cs.widen_level_form(out["stencil f32"], torch.float64)
        Hc = tt.create_csr(mh, mh, hptr, hind, cs.complex_stencil(hptr, hind, hval, np.complex64), device=dev)
        lc = _level_forms(tt.ilu0_factorize(Hc))[0]
        out["complex c64"] = lc
        out["complex c128"] = cs.widen_level_form(lc, torch.complex128)
    qptr, qind, qval = cs.scatter_operand()
    qm = len(qptr) - 1
    Q = tt.create_csr(qm, qm, qptr, qind, qval.astype(np.float32), device=dev)
    tt.optimize(Q)
    out["scatter f32"] = ttri.trsv_level_form_for(Q.plan, LOWER, NONE)
    mc = 20000
    if not quick:
        out["scatter f64"] = cs.widen_level_form(out["scatter f32"], torch.float64)
    Cb = sp.diags([np.full(mc - 1, -0.5), np.full(mc, 2.0)], [-1, 0]).tocsr()
    out["chain f32"] = tl.build_level_form(Cb.indptr, Cb.indices, np.arange(Cb.nnz), mc, False, False,
                                           torch.from_numpy(Cb.data.astype(np.float32)).to(dev))
    print(f"triangles built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} ({f.m} rows, {f.nlev} levels)" for k, f in out.items()), flush=True)
    return out, (H, hptr, hind, hval)


def launches_of(form, b):
    before = sum(tl.trsv_level.launches.values())
    tl.trsv_level(form, b)
    torch.cuda.synchronize()
    return sum(tl.trsv_level.launches.values()) - before


def time_form(form, b, turns):
    vals = [cs.cuda_ms(lambda: tl.trsv_level(form, b), reps=7, inner=5, warm=1, backlog=True) for _ in range(turns)]
    return min(vals), vals


def emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    out.write(line + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--hop", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--pcg", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(card(), flush=True)
    print(f"port from {Path(tl.__file__).resolve().parent.parent}", flush=True)
    (ROOT / "_smoke").mkdir(exist_ok=True)
    with open(ROOT / "_smoke" / f"level_bench_{args.label}.jsonl", "a") as out:
        if args.hop:
            for what, us in cs.hop_floor(dev).items():
                emit({"label": args.label, "case": f"hop {what}", "us_a_hop": us}, out)
        forms, (H, *_s) = triangles(dev, args.quick)
        for name, form in forms.items():
            for K in ((1,) if args.quick or name.startswith(("complex", "chain")) else (1, 16)):
                b = rhs(form.m, K, form.lval.dtype, dev)
                if args.check:
                    got = tl.trsv_level(form, b)
                    again = tl.trsv_level(form, b)
                    err = near_error(got.cpu().numpy(), tl.trsv_level_plain(form, b).cpu().numpy())
                    same = [bool(torch.equal(got, again))]
                    if hasattr(tl, "LEVEL_SLACK"):
                        keep = tl.LEVEL_SLACK
                        for slack in (0.0, 1e9):
                            tl.LEVEL_SLACK = slack
                            same.append(bool(torch.equal(got, tl.trsv_level(form, b))))
                        tl.LEVEL_SLACK = keep
                    torch.cuda.synchronize()
                    ok = err <= expected_precision(form.lval.dtype) and all(same)
                    emit({"label": args.label, "case": f"check {name} K={K}", "max_rel_err": err, "same_bits": same,
                          "ok": ok}, out)
                    if not ok:
                        raise AssertionError(f"{name} K={K}: err {err}, same bits {same}")
                ms, vals = time_form(form, b, args.turns)
                t_b = cs.level_bytes(form, b) / (PEAK_GBPS * 1e6)
                emit({"label": args.label, "case": f"{name} K={K}", "ms": ms, "turns": vals, "nlev": form.nlev,
                      "us_a_level": ms * 1e3 / form.nlev, "launches": launches_of(form, b), "bound_ms": t_b}, out)
        if args.sweep and hasattr(tl, "LEVEL_SLACK"):
            keep = tl.LEVEL_SLACK
            for name in ("stencil f32", "stencil f64", "scatter f32", "chain f32"):
                form = forms.get(name)
                for K in (1, 16) if form is not None else ():
                    b = rhs(form.m, K, form.lval.dtype, dev)
                    for slack in SWEEP:
                        tl.LEVEL_SLACK = slack
                        ms, vals = time_form(form, b, args.turns)
                        grid = tl.grid_for(form.m, form.nlev, *tl._resident(tl._INSTANCES[form.lval.dtype][2], K, dev))
                        emit({"label": args.label, "case": f"sweep {name} K={K}", "LEVEL_SLACK": slack, "grid": grid,
                              "ms": ms, "turns": vals}, out)
            tl.LEVEL_SLACK = keep
        if args.pcg:
            bs = torch.from_numpy(np.random.default_rng(71).standard_normal(H.shape[0]).astype(np.float32)).to(dev)
            for precond in ("ilu0", "sgs"):
                tt.pcg_solve(H, bs, rtol=0.0, maxit=1, precond=precond)  # builds the mv form and the preconditioner
                def solve(kk):
                    return tt.pcg_solve(H, bs, rtol=0.0, maxit=kk, precond=precond)[1]

                t_it, t_all = cs.iteration_ms(solve, 2, 6, turns=3)
                emit({"label": args.label, "case": f"stencil {precond.upper()}-PCG iteration", "ms": t_it,
                      "turns": t_all}, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
