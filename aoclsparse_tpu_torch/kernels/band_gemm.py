"""Band x band SpGEMM numeric stage: the hand-written Hopper kernel and its
plain PyTorch version.

Contract (``csrc/band_gemm.cu``, built by ``kernels/build.py``): over A
(nblk, G, WA) and B (nblk, G, WB), the G-row-group windows of the two
operands, and the streams ``ranges`` ((rho_lo, rho_hi, br_lo) per stream s,
at most MAX_STREAMS), C (nblk, G, WC) is

    C[g, :, G*s : G*s+WB] = sum over streams s with rho_lo < rho_hi of
                            A[g, :, rho_lo:rho_hi] @ B[g+d0+s, br_lo : br_lo+(rho_hi-rho_lo), :]

where a block index g+d0+s outside [0, nblk) contributes nothing and every
other element of C is 0. Instances: f32 (exact f32 FMA, no TF32: the JAX
package's Precision.HIGHEST pin) on the CUDA cores, and f64 on the f64
tensor cores (mma.sync m8n8k4: IEEE f64 products, summed in another
order).

The kernel's schedule: a CTA owns a 64 x 128 tile of one C_g, a warp a
32 x 32 sub-tile of it; they walk each meeting stream's slab in chunks of
32 slab rows, steps of 8, and a warp skips a step when its A fragment
(32 rows x 8) or its B fragment (8 x 32 columns) holds no nonzero.
`band_gemm_steps` counts the warp steps that schedule visits and takes on
given operands; a skipped step's products all have a zero factor, so only
an Inf or NaN that such a zero meets tells the two apart (NaN in the full
product).

It replaces the JAX package's ``pallas_band_gemm``
(kernels/pallas/spgemm.py:38). The plain version is its scan engine
``_band_gemm_scan`` (kernels/xla/spgemm_band.py:184) written per stream:
one batched ``torch.matmul`` over the groups whose block is in range, in
the accumulation dtype.

`band_gemm` has one rule: a CPU tensor takes `band_gemm_plain`, a CUDA
tensor launches the kernel (one launch a call) or raises; there is no
fallback. `band_gemm.launches` counts kernel launches per instance.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library

__all__ = ["MAX_STREAMS", "band_gemm", "band_gemm_plain", "band_gemm_steps"]

#: the planner's stream cap (kernels/spgemm_band.py), the kernel's too
MAX_STREAMS = 6
#: the kernel's CTA tile (rows, columns), warp tile, chunk and step depths
#: (csrc/band_gemm.cu kTM, kTN, 32, kKC, kKS)
TILE_M, TILE_N, WARP, CHUNK, STEP = 64, 128, 32, 32, 8

_INSTANCES = {torch.float32: ("f32", "band_gemm_f32"), torch.float64: ("f64", "band_gemm_f64")}

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(A: torch.Tensor, B: torch.Tensor, WC: int, ranges: Sequence[Tuple[int, int, int]]):
    inst = _INSTANCES.get(A.dtype)
    if inst is None or B.dtype != A.dtype:
        raise AoclSparseError(
            Status.wrong_type, f"band GEMM kernel has instances for f32 and f64 pairs, got {A.dtype} and {B.dtype}"
        )
    if A.dim() != 3 or B.dim() != 3 or A.shape[:2] != B.shape[:2]:
        raise AoclSparseError(
            Status.invalid_size, f"want A (nblk, G, WA) and B (nblk, G, WB), got {tuple(A.shape)}, {tuple(B.shape)}"
        )
    if A.device != B.device:
        raise AoclSparseError(Status.invalid_value, "band GEMM operands on different devices")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "band GEMM operands must be contiguous")
    G, WA, WB = A.shape[1], A.shape[2], B.shape[2]
    if len(ranges) > MAX_STREAMS:
        raise AoclSparseError(Status.invalid_size, f"{len(ranges)} streams, the kernel takes {MAX_STREAMS}")
    for s, (lo, hi, br) in enumerate(ranges):
        if hi > lo and not (0 <= lo and hi <= WA and 0 <= br and br + hi - lo <= G and G * s + WB <= WC):
            raise AoclSparseError(
                Status.invalid_value,
                f"stream {s} ({lo}, {hi}, {br}) leaves A's window ({WA}), the group ({G}) or C's ({WC})",
            )
    return inst


def band_gemm_plain(A: torch.Tensor, B: torch.Tensor, WC: int, d0: int, ranges) -> torch.Tensor:
    """The contract in plain PyTorch: per stream, one batched product over
    the groups whose B block is in range, added into C's stream columns."""
    nblk, G, _WA = A.shape
    WB = B.shape[2]
    acc = torch.float64 if A.dtype == torch.float64 else torch.float32
    C = torch.zeros(nblk, G, WC, dtype=acc, device=A.device)
    for s, (lo, hi, br) in enumerate(ranges):
        off = d0 + s
        g0, g1 = max(0, -off), min(nblk, nblk - off)
        if hi <= lo or g1 <= g0:
            continue
        C[g0:g1, :, G * s : G * s + WB] += torch.matmul(
            A[g0:g1, :, lo:hi].to(acc), B[g0 + off : g1 + off, br : br + hi - lo].to(acc)
        )
    return C.to(A.dtype)


def band_gemm(A: torch.Tensor, B: torch.Tensor, WC: int, d0: int, ranges) -> torch.Tensor:
    """C band (nblk, G, WC) by the contract above: the plain version on a
    CPU tensor, one kernel launch on a CUDA tensor (current stream, not
    synchronised)."""
    name, symbol = _check(A, B, WC, ranges)
    if A.device.type == "cpu":
        return band_gemm_plain(A, B, WC, d0, ranges)
    if A.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no band GEMM kernel for {A.device}")
    nblk, G, WA = A.shape
    C = torch.empty(nblk, G, WC, dtype=A.dtype, device=A.device)
    if C.numel() == 0:
        return C
    flat = [int(v) for r in ranges for v in r]
    arr = (ctypes.c_int32 * max(len(flat), 1))(*flat)
    with torch.cuda.device(A.device):
        rc = _entry(symbol)(
            A.data_ptr(), B.data_ptr(), C.data_ptr(), nblk, G, WA, B.shape[2], WC, int(d0),
            ctypes.cast(arr, ctypes.c_void_p), len(ranges), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"band_gemm_{name} launch failed: CUDA error {rc}")
    band_gemm.launches[name] += 1
    return C


band_gemm.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def _steps_nonzero(A, B, WC, lo, hi, br, s):
    """(A_nz (nblk, rows / 32, steps), B_nz (nblk, steps, columns / 32)):
    whether each warp fragment of stream s's slab holds a nonzero, over the
    kernel's zero-padded tiles (C's columns in whole CTA tiles)."""
    nblk, G, _WA = A.shape
    WB = B.shape[2]
    nrow, ncol = -(-G // TILE_M), -(-WC // TILE_N)
    kpad = -(-(hi - lo) // CHUNK) * CHUNK
    a = torch.zeros(nblk, nrow * TILE_M, kpad, dtype=torch.bool, device=A.device)
    a[:, :G, : hi - lo] = A[:, :, lo:hi] != 0
    a_nz = a.view(nblk, nrow * TILE_M // WARP, WARP, kpad // STEP, STEP).any(4).any(2)
    b = torch.zeros(nblk, kpad, ncol * TILE_N, dtype=torch.bool, device=A.device)
    b[:, : hi - lo, G * s : G * s + WB] = B[:, br : br + hi - lo] != 0
    b_nz = b.view(nblk, kpad // STEP, STEP, ncol * TILE_N // WARP, WARP).any(4).any(2)
    return a_nz, b_nz


def band_gemm_steps(A: torch.Tensor, B: torch.Tensor, WC: int, d0: int, ranges) -> Tuple[int, int]:
    """(taken, visited): the warp steps (32 C rows x 32 C columns x 8 slab
    rows) that the kernel's schedule visits on these operands, and those
    whose vote finds a nonzero in both fragments. A taken step costs
    32 * 32 * 8 FMAs; every other product of the band has a zero factor."""
    nblk, G, _WA = A.shape
    WB = B.shape[2]
    ncol = -(-WC // TILE_N)
    taken = visited = 0
    for s, (lo, hi, br) in enumerate(ranges):
        off = d0 + s
        g0, g1 = max(0, -off), min(nblk, nblk - off)
        if hi <= lo or g1 <= g0:
            continue
        tiles = [t for t in range(ncol) if G * s < TILE_N * (t + 1) and G * s + WB > TILE_N * t]
        a_nz, b_nz = _steps_nonzero(A, B, WC, lo, hi, br, s)
        pairs = torch.einsum("grt,gtc->grc", a_nz[g0:g1].float(), b_nz[g0 + off : g1 + off].float())
        per = TILE_N // WARP
        cols = torch.tensor([t * per + j for t in tiles for j in range(per)], device=A.device)
        taken += int(pairs[:, :, cols].long().sum().item())
        visited += (g1 - g0) * a_nz.shape[1] * cols.numel() * a_nz.shape[2]
    return taken, visited
