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

`spmm_diag` has one rule: a CPU tensor takes `spmm_diag_plain`, a CUDA
tensor launches the kernel or raises. `spmm_diag.launches` counts kernel
launches per instance.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library

__all__ = ["spmm_diag", "spmm_diag_plain"]

#: (values dtype, B dtype) -> (instance name, C entry point)
_INSTANCES = {
    (torch.float32, torch.float32): ("f32", "spmm_diag_f32"),
    (torch.bfloat16, torch.float32): ("bf16", "spmm_diag_bf16"),
    (torch.float64, torch.float64): ("f64", "spmm_diag_f64"),
}

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [
            ctypes.c_int64
        ] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


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


def spmm_diag(dvals: torch.Tensor, offs: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C = A_dia @ B by the contract above: the plain version on a CPU
    tensor, one kernel launch on a CUDA tensor (current stream, not
    synchronised)."""
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
    with torch.cuda.device(B.device):
        rc = _entry(symbol)(
            dvals.data_ptr(), offs.data_ptr(), ndiag, B.data_ptr(), C.data_ptr(), m, n, K,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"spmm_diag_{name} launch failed: CUDA error {rc}")
    spmm_diag.launches[name] += 1
    return C


spmm_diag.launches = {name: 0 for name, _sym in _INSTANCES.values()}
