#!/usr/bin/env python3
"""Sweep the CSR row-gather kernel's tile (csrc/spmv_csr.cu `Tile`, the
entries a block of several rows holds at most) on one card: the evidence
for kernels/spmv_csr.py `tile_of`.

    python3 scripts/csr_tiles.py [--tiles 2048,1024] [--turns 3]
        [--cases webbase:f32,webbase:f64,webbase:c128,scatter:f32,scatter:f64,scatter:c64,
                 scircuit:f32,scircuit:c64,permuted:f32,permuted:f64,band:f32,band:f64]

Needs one CUDA card and nvcc. For each tile it compiles a copy of
csrc/spmv_csr.cu in which every value type takes that tile (and half as
many rows a block), one nvcc each, all started together, into the
gitignored _smoke/csr_tiles/, and prints each copy's registers. Each case
(an operand of scripts/csr_bench.py in one value type) is planned by
default; each copy then runs on the case's segsum form with the schedule
csr_blocks(ptr, tile, tile // 2), is held against the plain version, and
is timed alone behind a device spin (chip_smoke.cuda_ms: the median of 7
repeats of the mean of 5 calls, the lowest of --turns turns in
alternating order) beside cuSPARSE (torch.sparse CSR @ x). Prints the
card's name and power limit and one JSON object a case, and writes them to
_smoke/csr_tiles.jsonl.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT))
sys.path.append(str(ROOT / "scripts"))

import aoclsparse_tpu_torch as tt  # noqa: E402
from aoclsparse_tpu_torch.kernels import build  # noqa: E402
from aoclsparse_tpu_torch.kernels import spmv_csr as K  # noqa: E402
from aoclsparse_tpu_torch.planner import plan as tplan  # noqa: E402

import chip_smoke as cs  # noqa: E402
import csr_bench as cb  # noqa: E402

#: the line of csrc/spmv_csr.cu that sets the tile by value size
TILE_LINE = "static constexpr int entries = sizeof(T) > 4 ? 1024 : 2048;"
OUT = ROOT / "_smoke" / "csr_tiles"


def build_copies(tiles):
    """{tile: ctypes library} of copies of the source at each tile."""
    src = (build.CSRC_DIR / "spmv_csr.cu").read_text()
    if TILE_LINE not in src:
        raise RuntimeError(f"csrc/spmv_csr.cu no longer holds {TILE_LINE!r}")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tile in tiles:
        cu = OUT / f"spmv_csr_tile{tile}.cu"
        cu.write_text(src.replace(TILE_LINE, f"static constexpr int entries = {tile};"))
        procs[tile] = subprocess.Popen(
            [build._nvcc(), *build.GENCODE, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-o", str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tile, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the tile-{tile} copy:\n{log}")
        res = cs.ptxas_resources(log, ("spmv_csr_blocks_kernel",))
        print(f"tile {tile}: registers {sorted(v[3] for v in res.values())}, spills "
              f"{sorted({v[1] + v[2] for v in res.values()})}", flush=True)
        libs[tile] = ctypes.CDLL(str(OUT / f"spmv_csr_tile{tile}.so"))
    return libs


def copy_call(lib, seg, x, blocks):
    """One launch of a copy's kernel on the segsum form's operands."""
    fn = getattr(lib, K._INSTANCES[seg.val.dtype][1])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.empty(seg.m, dtype=seg.val.dtype, device=x.device)
    rc = fn(seg.ptr.data_ptr(), seg.ind.data_ptr(), seg.val.data_ptr(), x.data_ptr(), y.data_ptr(), blocks.data_ptr(),
            blocks.shape[0] - 1, int(seg.ptr.dtype == torch.int64), int(seg.ind.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return y


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", default="2048,1024")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--cases", default="webbase:f32,webbase:f64,webbase:c128,scatter:f32,scatter:f64,scatter:c64,"
                                       "scircuit:f32,scircuit:c64,permuted:f32,permuted:f64,band:f32,band:f64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: csr_tiles needs one NVIDIA card")
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_copies([int(t) for t in args.tiles.split(",")])
    GEN, NONE = tt.MatrixDescriptor(), tt.Operation.none
    with open(ROOT / "_smoke" / "csr_tiles.jsonl", "w") as out:
        for case in args.cases.split(","):
            name, tdt = case.split(":")
            ptr, ind, val = cb.operand(name)
            m = len(ptr) - 1
            A = tt.create_csr(m, m, ptr, ind, cb.typed(val, cb.DTYPES[tdt][0]), device=dev)
            seg = tplan.get_plan(A).exec_form_for(GEN, NONE, kind="segsum")
            x = torch.from_numpy(cb.typed(np.random.default_rng(41).standard_normal(m), cb.DTYPES[tdt][0])).to(dev)
            want = K.spmv_csr_plain(seg.ptr, seg.ind, seg.val, x, seg.segsum_rows())
            calls, err, nblk = {}, {}, {}
            for tile, lib in libs.items():
                blocks = torch.from_numpy(K.csr_blocks(seg.ptr.cpu().numpy(), tile, tile // 2)).to(dev)
                calls[f"tile {tile}"] = lambda lib=lib, blocks=blocks: copy_call(lib, seg, x, blocks)
                got = calls[f"tile {tile}"]()
                err[f"tile {tile}"] = float((got - want).abs().max() / max(float(want.abs().max()), 1.0))
                nblk[f"tile {tile}"] = blocks.shape[0] - 1
            At = cs.csr_tensor(seg.ptr.cpu().numpy(), seg.ind.cpu().numpy(), seg.val.cpu().numpy(), dev,
                               seg.val.dtype)
            calls["cuSPARSE"] = lambda: At @ x
            runs = {k: [] for k in calls}
            for turn in range(args.turns):
                for key in (list(calls) if turn % 2 == 0 else list(reversed(calls))):
                    runs[key].append(cs.cuda_ms(calls[key], reps=7, inner=5, backlog=True))
            rec = dict(card=smi, operand=name, dtype=tdt, m=m, nnz=int(ind.size), package_tile=K.tile_of(seg.val.dtype)[0],
                       ms={k: min(v) for k, v in runs.items()}, max_rel_err=err, blocks=nblk, turns=runs)
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
            del A, At, calls
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
