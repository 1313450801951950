#!/usr/bin/env python3
"""Time the blocked-solve chain kernel (csrc/trsv_blocked.cu) on one card.

    python3 scripts/chain_bench.py [--label NAME] [--library] [--nb 32,64,128]
                                   [--triangles stencil,scatter,scircuit] [--dtypes f32,f64]

Needs one CUDA card. Imports the port from the directory on PYTHONPATH
first (so a second checkout, for example the parent commit unpacked into
a gitignored directory, can be timed in the same call beside this one)
and this repository's chip_smoke.py for its operand generators and its
CUDA-event timer. For each triangle and dtype it builds the dwin or
gather form the planner gives the triangle and times `TrsvForm.solve` on
one right-hand side, which is one launch of the chain kernel, behind a
device spin (chip_smoke.cuda_ms with backlog: the device's time alone);
and with --library `torch.triangular_solve` on the same CSR triangle
(cuSPARSE, its analysis redone each call: one call's own time, after a
call that sets cuSPARSE up) as a yardstick.
The triangles:

- stencil: the ILU0 L factor of HPCG's 27-point stencil on 104^3 (the
  dwin form, unit lower);
- scatter: the lower triangle of chip_smoke's scatter operand (m =
  262,144, the diagonal plus 8 uniform random columns a row; gather);
- scircuit: the lower triangle of the scircuit stand-in (m = 170,998,
  benchmarks/realmat.py:151-176 as chip_smoke copies it, seed 7) with the
  diagonal boost 80 of benchmarks/run_real.py:54 (gather); and its ILU0 L.

A minimal dependent step (chip_smoke.minimal_chain_form: a gather form
whose blocks hold one left entry, row 0 on the previous block's last row,
and identity diagonal blocks) at nb = 32, 64 and 128 gives the latency
floor a step. --nb times the stencil and scircuit triangles at other
block sizes, the planner's caps on a chain form's block (CHAIN_NB,
CHAIN_NB_WIDE) lifted for the sweep. Prints one JSON object a measurement, with the card's name and power
limit, and writes them to the gitignored _smoke/chain_bench_<label>.jsonl.
"""

from __future__ import annotations

import argparse
import contextlib
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
from aoclsparse_tpu_torch.planner import triangular as ttri  # noqa: E402
from aoclsparse_tpu_torch.solvers.ilu import ilu0_factorize  # noqa: E402

import chip_smoke as cs  # noqa: E402

LOWER = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
NONE = tt.Operation.none
DT = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16, "c64": torch.complex64,
      "c128": torch.complex128}


def emit(out, rec):
    print(json.dumps(rec), flush=True)
    out.write(json.dumps(rec) + "\n")
    out.flush()


def handle(ptr, ind, val, dtype, dev):
    """A CSR handle of `dtype` on the card (a complex one: the values plus
    i I, the shifted twin)."""
    m = len(ptr) - 1
    v = torch.from_numpy(np.asarray(val, dtype=np.float64))
    if dtype.is_complex:
        rows = np.repeat(np.arange(m), np.diff(ptr))
        v = v.to(torch.complex128) + 1j * torch.from_numpy((rows == np.asarray(ind)).astype(np.float64))
    return tt.create_csr(m, m, ptr, ind, v.to(dtype), device=dev)


def lower_csr(ptr, ind, val, dev, dtype, unit=False):
    """The lower triangle as a torch CSR on the card (the unit diagonal
    written out for a unit factor)."""
    m = len(ptr) - 1
    S = sp.csr_matrix((np.asarray(val, dtype=np.float64), ind, ptr), shape=(m, m))
    L = sp.tril(S, -1 if unit else 0).tocsr()
    if unit:
        L = (L + sp.eye(m)).tocsr()
    L.sort_indices()
    return cs.csr_tensor(L.indptr, L.indices, L.data, dev, dtype)


@contextlib.contextmanager
def lifted_cap(nb):
    """The planner's chain-form block caps lifted to nb for a sweep."""
    kept = (ttri.CHAIN_NB, ttri.CHAIN_NB_WIDE)
    ttri.CHAIN_NB, ttri.CHAIN_NB_WIDE = max(nb, kept[0]), max(nb, kept[1])
    try:
        yield
    finally:
        ttri.CHAIN_NB, ttri.CHAIN_NB_WIDE = kept


def time_form(form, dtype, dev, reps=5):
    b = torch.ones(form.m_pad, dtype=dtype, device=dev)
    form.solve(b)
    torch.cuda.synchronize()
    return cs.cuda_ms(lambda: form.solve(b), reps=reps, inner=3, warm=1, backlog=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="run")
    ap.add_argument("--nb", default="")
    ap.add_argument("--triangles", default="stencil,scatter,scircuit")
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--library", action="store_true", help="also time torch.triangular_solve")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: chain_bench needs one NVIDIA card")
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    (ROOT / "_smoke").mkdir(exist_ok=True)
    out = open(ROOT / "_smoke" / f"chain_bench_{args.label}.jsonl", "w")
    base = dict(label=args.label, card=smi, port=str(Path(tt.__file__).resolve().parent))
    t0 = time.perf_counter()

    def run(name, form, dtype, lib_fn=None):
        t = time_form(form, dtype, dev)
        rec = dict(base, triangle=name, dtype=str(dtype).split(".")[-1], kind=form.kind, nb=form.nb,
                   nblk=form.nblk, ms=t, us_step=t * 1e3 / form.nblk)
        if form.kind == "gather":
            rec["W"] = int(form.Lval.shape[2])
        emit(out, rec)
        if lib_fn is not None and args.library:
            cs.library_ms(lib_fn, once=True)  # cuSPARSE's first call in the process sets it up
            t_lib, err = cs.library_ms(lib_fn, once=True)
            emit(out, dict(base, triangle=name, dtype=str(dtype).split(".")[-1], library_ms=t_lib, error=err))

    tris = args.triangles.split(",")
    for inst in args.dtypes.split(","):
        dtype = DT[inst]
        for nb in (32, 64, 128):
            f = cs.minimal_chain_form(4096, nb, dtype, dev)
            run(f"minimal step nb={nb}", f, dtype)
        if "scircuit" in tris:
            _m, _n, ptr, ind, val = cs.scircuit(np.random.default_rng(7), diag_boost=80.0)
            A = handle(ptr, ind, val, dtype, dev)
            form = ttri.trsv_form_for(tt.optimize(A), LOWER, NONE)
            Lt = lower_csr(ptr, ind, val, dev, dtype)
            bl = torch.ones(len(ptr) - 1, 1, dtype=dtype, device=dev)
            run("scircuit lower", form, dtype, lambda: torch.triangular_solve(bl, Lt, upper=False))
            st = ilu0_factorize(A)
            run("scircuit ILU0 L", st.l_form, dtype)
            for nb in [int(v) for v in args.nb.split(",") if v]:
                with lifted_cap(nb):
                    f = ttri.trsv_form_for(A.plan, LOWER, NONE, nb=nb)
                run(f"scircuit lower nb={nb}", f, dtype)
            del A, Lt, form, st
        if "scatter" in tris:
            ptr, ind, val = cs.scatter_operand()
            A = handle(ptr, ind, val, dtype, dev)
            form = ttri.trsv_form_for(tt.optimize(A), LOWER, NONE)
            Lt = lower_csr(ptr, ind, val, dev, dtype)
            bl = torch.ones(len(ptr) - 1, 1, dtype=dtype, device=dev)
            run("scatter lower", form, dtype, lambda: torch.triangular_solve(bl, Lt, upper=False))
            del A, Lt, form
        if "stencil" in tris:
            ptr, ind, val = cs.stencil27(104)
            A = handle(ptr, ind, val, dtype, dev)
            st = ilu0_factorize(A)
            lu = st.lu.double().cpu().numpy()
            Lt = lower_csr(ptr, ind, lu, dev, dtype, unit=True)
            bl = torch.ones(len(ptr) - 1, 1, dtype=dtype, device=dev)
            run("stencil ILU0 L", st.l_form, dtype,
                lambda: torch.triangular_solve(bl, Lt, upper=False, unitriangular=True))
            for nb in [int(v) for v in args.nb.split(",") if v]:
                with lifted_cap(nb):
                    f = ttri.trsv_form_for(tt.optimize(A), LOWER, NONE, nb=nb)
                if f.kind == "dwin":
                    run(f"stencil lower nb={nb}", f, dtype)
            del A, Lt, st
        torch.cuda.empty_cache()
    emit(out, dict(base, seconds=time.perf_counter() - t0))
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
