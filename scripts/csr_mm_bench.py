#!/usr/bin/env python3
"""Time general-structure mm on one card: the CSR SpMM kernel (mm KID 0,
csrc/spmm_csr.cu) alone against its plain version and cuSPARSE, and the
default mm call against the pins a user reaches, call against call; and the
crossover of the card's mm rule between the gen composite (mm KID 6) and
the kernel.

    python3 scripts/csr_mm_bench.py [--label NAME] [--turns 2] [--ks 8,64,256]
                                    [--operands webbase,scircuit,scatter]
                                    [--dtypes f32,f64,c64,c128,bf16]
                                    [--cross] [--thin 1,2,4,8,16]
                                    [--cross-dtypes f32,f64,bf16]

Needs one CUDA card. Imports the port and chip_smoke.py from the directory
on PYTHONPATH first, so a second checkout can be timed in the same call
beside this one (`PYTHONPATH=<other tree> python3 scripts/csr_mm_bench.py
--label parent`); a tree without the kernel (kernels/spmm_csr.py) times its
mm calls only. The operands are chip_smoke.py's: the webbase-1M stand-in
(seed 7), the scircuit stand-in (seed 7), the scatter operand (m =
262,144, the diagonal plus 8 random columns a row, seed 23); complex values
are the values plus i times a second draw (seed 65), bf16 the values
rounded. B is a seeded standard normal (m, K).

For each operand, value type and K: in turns, alternating their order, each
the median of repeats of the mean of back-to-back calls by CUDA events
(chip_smoke.cuda_ms): the kernel alone on the handle's segsum form, its
plain version and cuSPARSE (torch.sparse CSR @ B; bf16: the f32 product on
the bf16-rounded values) behind a device spin (device time); the default mm
call, the gen call by kid=6 where KID 6's gate takes the form, the gather
form the JAX rule picks (kid=1 or 2) and cuSPARSE's call without one (call
time, the host's dispatch included). Each record gives the default's form,
the kernel's launches in one default call, the gen band's width and slots
a nonzero, and the byte bound: the CSR, B and C once each at the published
HBM peak.

--cross: the bench band operand (m = 262,144, 64 entries a row,
half-bandwidth 64, seed 7) under a random symmetric permutation (seed 97),
where the gen form's block RCM recovers a band, each entry kept with
probability 1/p (seed 99) for p in --thin: the gen band's slots a nonzero
grow with p. At K = 64, in each of --cross-dtypes: the mm call by kid=6
(gen) against kid=0 (the kernel), in turns; the crossover of
planner/plan.py GEN_CSR_SLOTS is where they tie.

Prints the card's name and power limit and one JSON object a measurement
(the lowest turn, every turn's value), and writes them to the gitignored
_smoke/csr_mm_bench_<label>.jsonl.
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
from aoclsparse_tpu_torch.planner import plan as tplan  # noqa: E402
from aoclsparse_tpu_torch.planner.plan import gather_fallback_kind, gen_mm_ok  # noqa: E402

import chip_smoke as cs  # noqa: E402

try:
    from aoclsparse_tpu_torch.kernels.spmm_csr import spmm_csr, spmm_csr_plain
except ImportError:  # a tree without the kernel: its mm calls only
    spmm_csr = spmm_csr_plain = None

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
KEY = (GEN.type, GEN.fill_mode, GEN.diag_type, NONE)
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64),
          "c64": (np.complex64, torch.complex64), "c128": (np.complex128, torch.complex128),
          "bf16": (np.float32, torch.bfloat16)}


def operand(name):
    """(ptr, ind, val) of operand `name`, float32 values."""
    if name == "webbase":
        _m, _n, ptr, ind, val = cs.webbase_1m(np.random.default_rng(7))
    elif name == "scircuit":
        _m, _n, ptr, ind, val = cs.scircuit(np.random.default_rng(7))
    elif name == "scatter":
        ptr, ind, val = cs.scatter_operand()
    else:
        raise ValueError(name)
    return ptr, ind, np.asarray(val, dtype=np.float32)


def permuted_band(thin):
    """The bench band under a random symmetric permutation (seed 97), each
    entry kept with probability 1 / thin (seed 99)."""
    ptr, ind, val, _x = cs.bench_operand()
    m = len(ptr) - 1
    perm = np.random.default_rng(97).permutation(m)
    S = sp.csr_matrix((val, ind, ptr), shape=(m, m))[perm][:, perm].tocsr()
    if thin > 1:
        S = S.tocoo()
        keep = np.random.default_rng(99).random(S.nnz) < 1.0 / thin
        S = sp.csr_matrix((S.data[keep], (S.row[keep], S.col[keep])), shape=(m, m))
    S.sort_indices()
    return S.indptr, S.indices, np.asarray(S.data, dtype=np.float32)


def typed(val, tdt):
    npdt, dt = DTYPES[tdt]
    if np.issubdtype(npdt, np.complexfloating):
        return torch.from_numpy((val + 1j * np.random.default_rng(65).standard_normal(val.size)).astype(npdt))
    return torch.from_numpy(val.astype(npdt)).to(dt)


def b_matrix(n, k, tdt, dev):
    npdt, dt = DTYPES[tdt]
    rng = np.random.default_rng(23)
    b = rng.standard_normal((n, k))
    if np.issubdtype(npdt, np.complexfloating):
        b = b + 1j * rng.standard_normal((n, k))
    return torch.from_numpy(b.astype(npdt)).to(dev, dt)


def launches_of(fn):
    """The CSR SpMM kernel's launches in one call of fn."""
    if spmm_csr is None:
        return None
    before = sum(spmm_csr.launches.values())
    fn()
    torch.cuda.synchronize()
    return sum(spmm_csr.launches.values()) - before


def gen_notes(plan):
    """The gen form's band (built if need be) and KID 6's gate."""
    t0 = time.perf_counter()
    form = plan.gen_form_for(GEN, NONE)
    torch.cuda.synchronize()
    if form is None:
        return None, {"gen": "rejected by _build_gen"}
    eff = plan.effective_for(GEN, NONE)
    return form, {"gen": {"W": int(form.bwd_W), "m_pad": int(form.gen_m_pad), "layout_bandt": bool(form.gen_bandt),
                          "slots_a_nonzero": form.gen_m_pad * form.bwd_W / eff.nnz, "gate": gen_mm_ok(form),
                          "build_s": time.perf_counter() - t0}}


def run_turns(calls, turns, reps=7, inner=5):
    runs = {k: [] for k in calls}
    for turn in range(turns):
        for key in (list(calls) if turn % 2 == 0 else list(reversed(calls))):
            fn, spin = calls[key]
            runs[key].append(cs.cuda_ms(fn, reps=reps, inner=inner, backlog=spin))
    return {k: min(v) for k, v in runs.items()}, runs


def bench_operand(name, tdt, ks, turns, dev, peak, out, base):
    ptr, ind, val = operand(name)
    m = len(ptr) - 1
    A = tt.create_csr(m, m, ptr, ind, typed(val, tdt), device=dev)
    tt.set_mm_hint(A, NONE, GEN, nop=1000)
    t0 = time.perf_counter()
    plan = tt.optimize(A)
    torch.cuda.synchronize()
    notes = {"plan_s": time.perf_counter() - t0}
    seg = plan.exec_form_for(GEN, NONE, kind="segsum")
    gen, gn = gen_notes(plan) if tdt in ("f32", "f64", "bf16") else (None, {})
    notes.update(gn)
    eff = plan.effective_for(GEN, NONE)
    gkind = gather_fallback_kind(eff)
    vals = seg.val.float() if tdt == "bf16" else seg.val
    At = cs.csr_tensor(seg.ptr.cpu().numpy(), seg.ind.cpu().numpy(), vals.cpu().numpy(), dev, vals.dtype)
    for k in ks:
        B = b_matrix(m, k, tdt, dev)
        Bk = B.float() if tdt == "bf16" else B
        calls = {}
        if spmm_csr is not None:
            calls["kernel"] = (lambda: spmm_csr(seg.ptr, seg.ind, seg.val, Bk, seg.csr_blocks), True)
            calls["plain"] = (lambda: spmm_csr_plain(seg.ptr, seg.ind, seg.val, Bk, seg.segsum_rows()), True)
        calls["cuSPARSE"] = (lambda: At @ Bk, True)
        calls["mm default"] = (lambda: tt.mm(1.0, A, GEN, NONE, B, 0.0), False)
        if gen is not None and gen_mm_ok(gen):
            calls["mm kid=6 (gen)"] = (lambda: tt.mm(1.0, A, GEN, NONE, B, 0.0, kid=6), False)
        if tdt not in ("bf16",):
            gk = {"ell": 1, "ellhyb": 2}.get(gkind)
            if gk is not None:
                calls[f"mm kid={gk} ({gkind})"] = (lambda gk=gk: tt.mm(1.0, A, GEN, NONE, B, 0.0, kid=gk), False)
        calls["cuSPARSE call"] = (lambda: At @ Bk, False)
        default_kind = plan.mm_kinds.get(KEY)
        launches = launches_of(calls["mm default"][0])
        default_kind = plan.mm_kinds.get(KEY, default_kind)
        ms, runs = run_turns(calls, turns)
        vsize = seg.val.element_size()
        nbytes = (cs.nbytes(seg.ptr, seg.ind, seg.val) + (B.shape[0] + m) * k * Bk.element_size())
        bound = nbytes / (peak * 1e9) * 1e3
        rec = dict(base, operand=name, dtype=tdt, K=k, m=m, nnz=int(ind.size), default=default_kind,
                   gather_kind=gkind, launches_default_call=launches, bound_ms=bound, bytes=nbytes,
                   gathered_b_bytes=int(ind.size) * k * Bk.element_size(), value_bytes=vsize, ms=ms, turns=runs,
                   **notes)
        if "kernel" in ms:
            rec["kernel_share_of_bound"] = bound / ms["kernel"]
        print(json.dumps(rec), flush=True)
        out.write(json.dumps(rec) + "\n")
        del B, Bk, calls
        torch.cuda.empty_cache()
    del A, At, plan, seg, gen


def bench_cross(thins, tdts, turns, dev, out, base):
    k = 64
    for thin in thins:
        ptr, ind, val = permuted_band(thin)
        m = len(ptr) - 1
        for tdt in tdts:
            A = tt.create_csr(m, m, ptr, ind, typed(val, tdt), device=dev)
            plan = tplan.get_plan(A)
            gen, notes = gen_notes(plan)
            rec = dict(base, cross=True, thin=thin, dtype=tdt, K=k, m=m, nnz=int(ind.size), **notes)
            if gen is not None and gen_mm_ok(gen):
                B = b_matrix(m, k, tdt, dev)
                calls = {"mm kid=6 (gen)": (lambda: tt.mm(1.0, A, GEN, NONE, B, 0.0, kid=6), False),
                         "mm kid=0 (segsum)": (lambda: tt.mm(1.0, A, GEN, NONE, B, 0.0, kid=0), False)}
                ms, runs = run_turns(calls, turns)
                tt.mm(1.0, A, GEN, NONE, B, 0.0)
                rec.update(ms=ms, turns=runs, gen_over_segsum=ms["mm kid=6 (gen)"] / ms["mm kid=0 (segsum)"],
                           default=plan.mm_kinds.get(KEY))
                del B, calls
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
            del A, plan, gen
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="run")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--ks", default="8,64,256")
    ap.add_argument("--operands", default="webbase,scircuit,scatter")
    ap.add_argument("--dtypes", default="f32")
    ap.add_argument("--cross", action="store_true")
    ap.add_argument("--thin", default="1,2,4,8,16")
    ap.add_argument("--cross-dtypes", default="f32,f64,bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: csr_mm_bench needs one NVIDIA card")
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    peak = tt.get_context().hbm_gbps
    (ROOT / "_smoke").mkdir(exist_ok=True)
    base = dict(label=args.label, card=smi, port=str(Path(tt.__file__).resolve().parent))
    with open(ROOT / "_smoke" / f"csr_mm_bench_{args.label}.jsonl", "w") as out:
        if args.operands:
            for name in args.operands.split(","):
                for tdt in args.dtypes.split(","):
                    ks = [int(k) for k in args.ks.split(",")] if tdt == "f32" else [64]
                    bench_operand(name, tdt, ks, args.turns, dev, peak, out, base)
        if args.cross:
            bench_cross([float(t) for t in args.thin.split(",")], args.cross_dtypes.split(","), args.turns, dev, out,
                        base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
