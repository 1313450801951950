"""Diagonal-form SpMM: the hand-written Hopper kernel of the ``diag`` form
and its plain PyTorch version.

Contract (``csrc/spmm_diag.cu``, built by ``kernels/build.py``):

    C[i, :] = sum_d dvals[d, i] * B[i + offs[d], :],   0 <= i < m

over the (ndiag, m) diagonal values and sorted int64 offsets of the
planner's diag form; B rows outside [0, n) contribute 0. Instances: dvals
f32 / B f32, dvals bf16 / B f32 (the mixed mode, f32 accumulation), dvals
f64 / B f64; C is float32, or float64 for f64.

It replaces the JAX package's ``pallas_spmm_diag``
(kernels/pallas/spmv.py:446, mm KID 7) and the dispatcher around it
(kernels/xla/spmm.py:263-332), whose unrolled and scan XLA variants exist
for the TPU's VMEM budget; the plain version here is their arithmetic.

The kernel runs a schedule built once per offset set (`diag_schedule`):
`diag_windows` groups the sorted offsets into windows whose B rows and
values fit one shared-memory stage, `diag_runs` splits each window into
runs of at most `RUN_MAX` consecutive offsets, and the two go to the card
as one small int64 table.

`spmm_diag` has one rule: a CPU tensor takes `spmm_diag_plain`, a CUDA
tensor launches the kernel or raises. `spmm_diag.launches` counts kernel
launches per instance.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ..core.types import AoclSparseError, Status
from .build import MAX_SMEM, load_library

__all__ = [
    "DIAG_ROWS",
    "DiagSchedule",
    "RUN_MAX",
    "STAGES",
    "STAGE_BUDGET",
    "diag_runs",
    "diag_schedule",
    "diag_windows",
    "spmm_diag",
    "spmm_diag_plain",
]

#: (values dtype, B dtype) -> (instance name, C entry point)
_INSTANCES = {
    (torch.float32, torch.float32): ("f32", "spmm_diag_f32"),
    (torch.bfloat16, torch.float32): ("bf16", "spmm_diag_bf16"),
    (torch.float64, torch.float64): ("f64", "spmm_diag_f64"),
}

#: rows of one CTA tile, by instance (csrc/spmm_diag.cu: one thread per
#: 8 rows and 16 bytes of a 128-byte column chunk)
DIAG_ROWS = {"f32": 512, "bf16": 512, "f64": 384}
#: staged bytes of one B row: a 128-byte column chunk (32 f32 / 16 f64 columns)
ROW_BYTES = 128
#: most offsets of one run (the kernel's unrolled run lengths 1..4)
RUN_MAX = 4
#: stages of the kernel's shared-memory ring (csrc/spmm_diag.cu kStages),
#: and the bytes one stage may take
STAGES = 2
STAGE_BUDGET = MAX_SMEM // STAGES

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [
            ctypes.c_int64
        ] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _stage_bytes(nd: int, span: int, rows: int, val_bytes: int, row_bytes: int) -> int:
    """Bytes of one stage: nd x rows values, then rows + span B rows
    (rounded up to 128 so that the ring's second stage stays aligned)."""
    return -(-(nd * rows * val_bytes + (rows + span) * row_bytes) // 128) * 128


def diag_windows(offs: Sequence[int], rows: int, budget: int = STAGE_BUDGET, val_bytes: int = 4,
                 row_bytes: int = ROW_BYTES) -> List[Tuple[int, int]]:
    """Group sorted offsets into windows [(d0, d1)] of consecutive
    diagonals d0 <= d < d1, in order. An offset joins the open window while
    its gap to the window's last offset is below `rows` (so the window's
    staged B rows are shared, not just adjacent) and the window's stage,
    (d1 - d0) x rows values of val_bytes and (last - first + rows) B rows of
    row_bytes, fits `budget` bytes; otherwise it opens the next window. A
    lone offset always makes a window of its own."""
    offs = [int(o) for o in offs]
    if any(b <= a for a, b in zip(offs, offs[1:])):
        raise AoclSparseError(Status.invalid_value, "diagonal offsets must be strictly increasing")
    if offs and _stage_bytes(1, 0, rows, val_bytes, row_bytes) > budget:
        raise AoclSparseError(Status.invalid_size, f"a {rows}-row stage does not fit {budget} bytes")
    out, d0 = [], 0
    for d in range(1, len(offs) + 1):
        if d < len(offs) and offs[d] - offs[d - 1] < rows and _stage_bytes(
            d + 1 - d0, offs[d] - offs[d0], rows, val_bytes, row_bytes
        ) <= budget:
            continue
        out.append((d0, d))
        d0 = d
    return out


def diag_runs(offs: Sequence[int], d0: int, d1: int) -> List[Tuple[int, int, int]]:
    """Runs [(dd, c, p)] of window [d0, d1): c <= RUN_MAX consecutive
    offsets from d0 + dd on, whose first sits p rows into the window's
    stage (offs[d0 + dd] - offs[d0]), in increasing offset order."""
    out, d = [], d0
    while d < d1:
        c = 1
        while c < RUN_MAX and d + c < d1 and offs[d + c] == offs[d] + c:
            c += 1
        out.append((d - d0, c, int(offs[d]) - int(offs[d0])))
        d += c
    return out


@dataclass(frozen=True)
class DiagSchedule:
    """The diagonal kernel's schedule for one offset set and instance: its
    windows [(d0, d1)], their spans (last - first offset) and runs, the CTA
    tile's rows, the bytes of one ring stage, and the int64 table the kernel
    reads: per window (first offset, d0, d1 - d0, span, first run, end run),
    then per run (dd, c, p)."""

    windows: Tuple[Tuple[int, int], ...]
    spans: Tuple[int, ...]
    runs: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    rows: int
    stage_bytes: int
    val_bytes: int
    table: torch.Tensor

    def staged_bytes(self, m: int, K: int, elem_bytes: int) -> Tuple[int, int]:
        """(B bytes, value bytes) the kernel stages in one call on (m, K)
        operands: every row tile and 128-byte column chunk stages each
        window's rows + span B rows and nd x rows values."""
        tiles = -(-m // self.rows) * -(-K // (ROW_BYTES // elem_bytes))
        b = sum((self.rows + sp) * ROW_BYTES for sp in self.spans)
        v = sum((d1 - d0) * self.rows * self.val_bytes for d0, d1 in self.windows)
        return tiles * b, tiles * v


def diag_schedule(offs: Sequence[int], inst: str, device=None) -> DiagSchedule:
    """The schedule of `offs` (sorted) for instance `inst` ("f32", "bf16",
    "f64"), its table on `device`; built once per (offsets, instance,
    device) and cached."""
    return _schedule(tuple(int(o) for o in offs), inst, None if device is None else torch.device(device))


@functools.lru_cache(maxsize=256)
def _schedule(offs: Tuple[int, ...], inst: str, device) -> DiagSchedule:
    rows = DIAG_ROWS[inst]
    val_bytes = {"f32": 4, "bf16": 2, "f64": 8}[inst]
    wins = diag_windows(offs, rows, STAGE_BUDGET, val_bytes)
    runs = [diag_runs(offs, d0, d1) for d0, d1 in wins]
    spans = [offs[d1 - 1] - offs[d0] for d0, d1 in wins]
    wtab, rtab, r0 = [], [], 0
    for (d0, d1), sp, rw in zip(wins, spans, runs):
        wtab.append((offs[d0], d0, d1 - d0, sp, r0, r0 + len(rw)))
        rtab.extend(rw)
        r0 += len(rw)
    flat = [x for row in wtab for x in row] + [x for row in rtab for x in row]
    stage = max((_stage_bytes(d1 - d0, sp, rows, val_bytes, ROW_BYTES) for (d0, d1), sp in zip(wins, spans)),
                default=0)
    return DiagSchedule(tuple(wins), tuple(spans), tuple(tuple(r) for r in runs), rows, stage, val_bytes,
                        torch.tensor(flat, dtype=torch.int64, device=device))


def _check(dvals: torch.Tensor, offs: torch.Tensor, B: torch.Tensor):
    inst = _INSTANCES.get((dvals.dtype, B.dtype))
    if inst is None:
        raise AoclSparseError(
            Status.wrong_type, f"diag SpMM kernel has no instance for {dvals.dtype} with B {B.dtype}"
        )
    if dvals.dim() != 2 or B.dim() != 2 or offs.dim() != 1 or offs.shape[0] != dvals.shape[0]:
        raise AoclSparseError(
            Status.invalid_size,
            f"want dvals (ndiag, m), offs (ndiag,), B (n, K); got {tuple(dvals.shape)}, "
            f"{tuple(offs.shape)}, {tuple(B.shape)}",
        )
    if offs.dtype != torch.int64:
        raise AoclSparseError(Status.wrong_type, f"offsets must be int64, got {offs.dtype}")
    if not (dvals.device == offs.device == B.device):
        raise AoclSparseError(Status.invalid_value, "operands on different devices")
    if not (dvals.is_contiguous() and offs.is_contiguous() and B.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "operands must be contiguous")
    return inst


def spmm_diag_plain(dvals: torch.Tensor, offs: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: one shifted row slice of B per
    diagonal, scaled by its values, summed in offset order."""
    ndiag, m = dvals.shape
    n, K = B.shape
    acc = torch.float64 if B.dtype == torch.float64 else torch.float32
    C = torch.zeros(m, K, dtype=acc, device=B.device)
    for d, off in enumerate(offs.tolist()):
        lo, hi = max(0, -off), min(m, n - off)
        if hi > lo:
            C[lo:hi] += dvals[d, lo:hi, None].to(acc) * B[lo + off : hi + off].to(acc)
    return C


def spmm_diag(dvals: torch.Tensor, offs: torch.Tensor, B: torch.Tensor, offs_static=None) -> torch.Tensor:
    """C = A_dia @ B by the contract above: the plain version on a CPU
    tensor, one kernel launch on a CUDA tensor (current stream, not
    synchronised). `offs_static`, the offsets as Python ints (the diag
    form's `dia_offs_static`), finds the cached schedule without reading
    `offs` back from the card."""
    name, symbol = _check(dvals, offs, B)
    if B.device.type == "cpu":
        return spmm_diag_plain(dvals, offs, B)
    if B.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no diag SpMM kernel for {B.device}")
    ndiag, m = dvals.shape
    n, K = B.shape
    C = torch.empty(m, K, dtype=B.dtype, device=B.device)
    if m == 0 or K == 0:
        return C
    if ndiag == 0:
        return C.zero_()
    if offs_static is None:
        offs_static = offs.tolist()
    elif len(offs_static) != ndiag:
        raise AoclSparseError(Status.invalid_size, f"{len(offs_static)} static offsets for {ndiag} diagonals")
    sched = diag_schedule(offs_static, name, B.device)
    with torch.cuda.device(B.device):
        rc = _entry(symbol)(
            dvals.data_ptr(), sched.table.data_ptr(), len(sched.windows), B.data_ptr(), C.data_ptr(), m, n, K,
            sched.stage_bytes, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"spmm_diag_{name} launch failed: CUDA error {rc}")
    spmm_diag.launches[name] += 1
    return C


spmm_diag.launches = {name: 0 for name, _sym in _INSTANCES.values()}
