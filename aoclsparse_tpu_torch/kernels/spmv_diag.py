"""Diagonal-form SpMV: the hand-written Hopper kernel of the ``diag`` form
(mv KID 6) and the KID 6 dispatch.

Contract (``csrc/spmv_diag.cu``, built by ``kernels/build.py``):

    y[i] = sum_d dvals[d, i] * x[i + offs[d]],   0 <= i < m,

over the (ndiag, m) row-aligned diagonal values and the sorted int64
offsets of the planner's diag form, the terms whose column falls outside
[0, n) left out (n = x's length). That is the plain version's
``xp[offs[d] + L + i]``, with x zero-padded by L in front to n_pad
(``kernels/plain_spmv.py`` `spmv_diag`), without the padded copy: every
slot whose column lies in range is multiplied, stored zeros included, so
``0 * Inf`` gives NaN where the plain version and the JAX package give it.
Instances: dvals and x float32, bfloat16 (f32 sums, y rounded once to
bfloat16) or float64; y in that dtype.

It replaces no Pallas kernel: it is the hand kernel of the JAX package's
XLA formulation ``spmv_diag`` (kernels/xla/spmv.py:606, its unrolled
slices and its scan), one fused kernel on a TPU. The plain version stays
``kernels/plain_spmv.py`` `spmv_diag`, which the CPU runs.

Bound: bytes. The values of every slot whose column lies in range are
read once, x once, y written once (`diag_bytes`, at most ndiag * m * vsize
+ (n + m) * vsize); on HPCG's 104^3 stencil in f32 129.7 MB, 0.0387 ms at
3,350 GB/s. The design streams the values once,
coalesced and evict-first, a CTA of 256 threads owning 4 * 256
consecutive rows (4 rows a thread, the kernel's compile-time R), and reads
x through L1 and L2, where it stays.

`spmv_diag` has one rule: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel (one launch, none where m = 0) or raises; it
checks every operand. `spmv_diag.launches` counts kernel launches per
instance. `spmv_diag_any`, the registry's KID 6 function, is the same
rule without the checks that the planner's form already holds: on the
card, dtypes the kernel has no instance for raise (complex and float16
values, which reach `diag` only by a kid=6 pin, and values and x of two
dtypes, which `mv` never passes: it casts x to the handle's dtype).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library
from .plain_spmv import spmv_diag as spmv_diag_plain

__all__ = [
    "diag_bytes",
    "spmv_diag",
    "spmv_diag_any",
    "spmv_diag_plain",
]

#: values dtype (x the same) -> (instance name, C entry point)
_INSTANCES = {
    torch.float32: ("f32", "spmv_diag_f32"),
    torch.bfloat16: ("bf16", "spmv_diag_bf16"),
    torch.float64: ("f64", "spmv_diag_f64"),
}
_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def diag_bytes(dvals: torch.Tensor, offs, n: int) -> int:
    """The bytes the function must move: the values of every slot whose
    column lies in [0, n), x once (n values) and y once (m values). `offs`
    is a sequence of ints or a tensor."""
    ndiag, m = dvals.shape
    offs = offs.tolist() if isinstance(offs, torch.Tensor) else offs
    slots = sum(max(0, min(m, n - o) - max(0, -o)) for o in offs)
    return (slots + n + m) * dvals.element_size()


def _check(dvals, offs, x, m: int, L: int, n_pad: int):
    """Validate the operands; return the instance (name, symbol)."""
    inst = _INSTANCES.get(dvals.dtype)
    if inst is None or x.dtype != dvals.dtype:
        raise AoclSparseError(Status.wrong_type, f"diag SpMV kernel has no instance for {dvals.dtype} with x {x.dtype}")
    if offs.dtype != torch.int64:
        raise AoclSparseError(Status.wrong_type, f"offsets must be int64, got {offs.dtype}")
    if dvals.dim() != 2 or offs.dim() != 1 or x.dim() != 1 or offs.shape[0] != dvals.shape[0] or dvals.shape[1] != m:
        raise AoclSparseError(Status.invalid_size, f"want dvals ({offs.shape[0]}, m={m}), offs (ndiag,), x (n,); got "
                              f"{tuple(dvals.shape)}, {tuple(offs.shape)}, {tuple(x.shape)}")
    if L < 0 or n_pad < L + x.shape[0]:
        raise AoclSparseError(Status.invalid_size, f"padding L={L}, n_pad={n_pad} does not hold x of {x.shape[0]}")
    if not (dvals.device == offs.device == x.device):
        raise AoclSparseError(Status.invalid_value, "dvals, offs and x must share a device")
    if not (dvals.is_contiguous() and offs.is_contiguous() and x.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "dvals, offs and x must be contiguous")
    return inst


def _launch(dvals, offs, x, name: str, symbol: str) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands (x's device), on
    the current stream, not synchronised."""
    ndiag, m = dvals.shape
    y = torch.empty(m, dtype=dvals.dtype, device=x.device)
    if m == 0:
        return y
    args = (dvals.data_ptr(), offs.data_ptr(), ndiag, x.data_ptr(), y.data_ptr(), m, x.shape[0])
    index = x.device.index
    if index is None or index == torch.cuda.current_device():
        rc = _entry(symbol)(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):
            rc = _entry(symbol)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmv_diag_{name} launch failed: CUDA error {rc}")
    spmv_diag.launches[name] += 1
    return y


def spmv_diag(dvals, offs, x, m: int, L: int, n_pad: int) -> torch.Tensor:
    """y = A_dia @ x by the contract above, with the plain version's
    arguments (L and n_pad describe its padded x; the kernel reads x
    itself): the plain version on a CPU tensor, the CUDA kernel on a CUDA
    tensor (one launch on the current stream, not synchronised)."""
    name, symbol = _check(dvals, offs, x, m, L, n_pad)
    if x.device.type == "cpu":
        return spmv_diag_plain(dvals, offs, x, m, L, n_pad)
    if x.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no diag SpMV kernel for {x.device}")
    return _launch(dvals, offs, x, name, symbol)


spmv_diag.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def spmv_diag_any(dvals, offs, x, m: int, L: int, n_pad: int) -> torch.Tensor:
    """mv KID 6 over a diag form: on the card the kernel, launched at once
    (the form holds its values and offsets checked, contiguous and on its
    device), or an error where the values and x do not share a dtype it has
    an instance for; on the CPU the plain `spmv_diag`, every dtype."""
    if x.device.type == "cpu":
        return spmv_diag_plain(dvals, offs, x, m, L, n_pad)
    inst = _INSTANCES.get(dvals.dtype)
    if x.device.type != "cuda" or inst is None or x.dtype != dvals.dtype:
        raise AoclSparseError(Status.wrong_type, f"diag SpMV kernel has no instance for {dvals.dtype} with x {x.dtype} "
                              f"on {x.device}")
    return _launch(dvals, offs, x.contiguous(), *inst)
