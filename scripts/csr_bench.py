#!/usr/bin/env python3
"""Time general-structure mv on one card: the CSR row-gather kernel (mv
KID 0, csrc/spmv_csr.cu) alone and the default mv call against cuSPARSE,
call against call, in each value type (float32, float64, complex64,
complex128); in float32 also the gen and route pins.

    python3 scripts/csr_bench.py [--label NAME] [--turns 4]
                                 [--operands webbase,scatter,scircuit,permuted,band]

Needs one CUDA card. Imports the port from the directory on PYTHONPATH
first (so a second checkout of the port can be timed in the same call
beside this one: `PYTHONPATH=<other tree> python3 scripts/csr_bench.py`;
a segsum form with the kernel's earlier schedule, a sub-warp width and a
long-row list, is timed through that tree's wrapper as it stands) and this
repository's chip_smoke.py for its operand generators and its CUDA-event
timer. The operands (chip_smoke.py's):

- webbase: the webbase-1M stand-in (seed 7);
- scatter: the diagonal plus 8 random columns a row, m = 262,144 (seed 23);
- scircuit: the scircuit stand-in (seed 7);
- permuted: the bench band operand (m = 262,144, 64 entries a row,
  half-bandwidth 64, seed 7) under a random symmetric permutation (seed
  97), where the gen form's RCM recovers the band;
- band: the bench band operand itself, whose default is `bandt` (the band
  kernel #1): the CSR kernel there by kid=0.

Complex values are the operand's values plus i times a second draw (seed
65), as chip_smoke.py's complex scircuit twins. Each handle is planned by
default (set_mv_hint, optimize). Then --turns turns, in alternating order,
each a median of 7 repeats of the mean of 5 back-to-back calls by CUDA
events (chip_smoke.cuda_ms): the CSR kernel alone on the handle's segsum
form and cuSPARSE (torch.sparse CSR @ x) behind a device spin (device
time); the default mv call and cuSPARSE's call without one (call time, the
host's dispatch included). In float32 also the gen call by kid=7 and, on
webbase and the permuted band, the same gen form planted in the default
slot (the slot autotune_mv writes); on scatter its whole-matrix route
there. Each record gives the kernel launches of one default mv call
(the CSR kernel's counter) and the byte bound (chip_smoke.csr_bytes at the
published HBM peak). Prints the card's name and power limit and one JSON
object a measurement (the lowest turn, every turn's value), and writes them
to the gitignored _smoke/csr_bench_<label>.jsonl.
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
from aoclsparse_tpu_torch.kernels.spmv_csr import spmv_csr  # noqa: E402

import chip_smoke as cs  # noqa: E402

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64),
          "c64": (np.complex64, torch.complex64), "c128": (np.complex128, torch.complex128)}


def operand(name):
    """(ptr, ind, val) of operand `name`, float32 values."""
    if name == "webbase":
        _m, _n, ptr, ind, val = cs.webbase_1m(np.random.default_rng(7))
    elif name == "scatter":
        ptr, ind, val = cs.scatter_operand()
    elif name == "scircuit":
        _m, _n, ptr, ind, val = cs.scircuit(np.random.default_rng(7))
    else:
        ptr, ind, val, _x = cs.bench_operand()
        if name == "permuted":
            m = len(ptr) - 1
            perm = np.random.default_rng(97).permutation(m)
            S = sp.csr_matrix((val, ind, ptr), shape=(m, m))[perm][:, perm].tocsr()
            S.sort_indices()
            ptr, ind, val = S.indptr, S.indices, S.data
    return ptr, ind, np.asarray(val, dtype=np.float32)


def typed(val, npdt):
    """The operand's values in `npdt`: complex ones gain i times a second draw."""
    if np.issubdtype(npdt, np.complexfloating):
        return (val + 1j * np.random.default_rng(65).standard_normal(val.size)).astype(npdt)
    return val.astype(npdt)


def kernel_call(seg, x):
    """The CSR kernel alone on a segsum form, through the wrapper of the
    port that built the form."""
    if hasattr(seg, "csr_blocks"):
        return spmv_csr(seg.ptr, seg.ind, seg.val, x, seg.csr_blocks)
    return spmv_csr(seg.ptr, seg.ind, seg.val, x, seg.csr_long, seg.csr_lanes)


def schedule(seg):
    if hasattr(seg, "csr_blocks"):
        from aoclsparse_tpu_torch.kernels.spmv_csr import block_stats

        return dict(zip(("blocks", "one_row_blocks"), block_stats(seg.csr_blocks)))
    return {"lanes": seg.csr_lanes, "long_rows": int(seg.csr_long.numel())}


def launches_of(fn):
    """The CSR kernel's launches in one call of fn."""
    before = sum(spmv_csr.launches.values())
    fn()
    torch.cuda.synchronize()
    return sum(spmv_csr.launches.values()) - before


def calls_of(name, A, dev, tdt):
    """The timed calls on handle A: {label: (fn, device time?)}, and notes."""
    m = A.shape[0]
    x = torch.from_numpy(typed(np.random.default_rng(41).standard_normal(m), DTYPES[tdt][0])).to(dev)
    plan = tt.optimize(A)
    default = plan.exec_form_for(GEN, NONE)
    seg = plan.exec_form_for(GEN, NONE, kind="segsum")
    notes = {"default": default.kind, **schedule(seg), "csr_bytes": cs.csr_bytes(seg, x)}
    At = cs.csr_tensor(seg.ptr.cpu().numpy(), seg.ind.cpu().numpy(), seg.val.cpu().numpy(), dev, seg.val.dtype)
    calls = {
        "CSR kernel": (lambda: kernel_call(seg, x), True),
        "cuSPARSE": (lambda: At @ x, True),
        "mv default": (lambda: tt.mv(1.0, A, GEN, NONE, x, 0.0), False),
        "cuSPARSE call": (lambda: At @ x, False),
    }
    notes["launches_default_call"] = launches_of(calls["mv default"][0])
    if default.kind != "segsum":
        calls["mv kid=0"] = (lambda: tt.mv(1.0, A, GEN, NONE, x, 0.0, kid=0), False)
        notes["launches_kid0_call"] = launches_of(calls["mv kid=0"][0])
    if tdt != "f32":
        return calls, notes
    t0 = time.perf_counter()
    if name == "scatter":
        route = plan.exec_form_for(GEN, NONE, kind="route")
        torch.cuda.synchronize()
        notes["route_form_s"] = time.perf_counter() - t0
        calls["mv route in the default slot"] = (lambda: cs.pinned_call(A, route, x), False)
    elif name != "band":
        gen = plan.gen_form_for(GEN, NONE)
        torch.cuda.synchronize()
        notes["gen_form_s"] = time.perf_counter() - t0
        if gen is None:
            notes["gen"] = "rejected by _build_gen"
        else:
            notes["gen"] = {"W": int(gen.bwd_W), "B": int(gen.gen_B),
                            "spilled": 0 if gen.sp_ind is None else int(gen.sp_ind.numel())}
            calls["mv kid=7"] = (lambda: tt.mv(1.0, A, GEN, NONE, x, 0.0, kid=7), False)
            if name in ("webbase", "permuted"):
                calls["mv gen in the default slot"] = (lambda: cs.pinned_call(A, gen, x), False)
    return calls, notes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="run")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--operands", default="webbase,scatter,scircuit,permuted,band")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: csr_bench needs one NVIDIA card")
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    peak = tt.get_context().hbm_gbps
    (ROOT / "_smoke").mkdir(exist_ok=True)
    base = dict(label=args.label, card=smi, port=str(Path(tt.__file__).resolve().parent))
    with open(ROOT / "_smoke" / f"csr_bench_{args.label}.jsonl", "w") as out:
        for name in args.operands.split(","):
            ptr, ind, val = operand(name)
            m = len(ptr) - 1
            for tdt in DTYPES:
                t0 = time.perf_counter()
                A = tt.create_csr(m, m, ptr, ind, typed(val, DTYPES[tdt][0]), device=dev)
                tt.set_mv_hint(A, NONE, GEN, nop=1000)
                calls, notes = calls_of(name, A, dev, tdt)
                notes["plan_s"] = time.perf_counter() - t0
                notes["bound_ms"] = notes["csr_bytes"] / (peak * 1e9) * 1e3
                runs = {k: [] for k in calls}
                for turn in range(args.turns):
                    for key in (list(calls) if turn % 2 == 0 else list(reversed(calls))):
                        fn, spin = calls[key]
                        runs[key].append(cs.cuda_ms(fn, reps=7, inner=5, backlog=spin))
                ms = {k: min(v) for k, v in runs.items()}
                rec = dict(base, operand=name, dtype=tdt, m=m, nnz=int(ind.size), **notes, ms=ms,
                           kernel_share_of_bound=notes["bound_ms"] / ms["CSR kernel"], turns=runs)
                print(json.dumps(rec), flush=True)
                out.write(json.dumps(rec) + "\n")
                del A, calls
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
