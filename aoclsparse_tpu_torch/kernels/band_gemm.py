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
package's Precision.HIGHEST pin) and f64.

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

__all__ = ["MAX_STREAMS", "band_gemm", "band_gemm_plain"]

#: the planner's stream cap (kernels/spgemm_band.py), the kernel's too
MAX_STREAMS = 6

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
