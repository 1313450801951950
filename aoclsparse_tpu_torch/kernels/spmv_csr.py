"""CSR row-gather SpMV: the hand-written Hopper kernel of the ``segsum``
form (mv KID 0), its plan-time schedule, and the KID 0 dispatch.

Contract (``csrc/spmv_csr.cu``, built by ``kernels/build.py``):

    y[i] = sum_{ptr[i] <= p < ptr[i + 1]} val[p] * x[ind[p]],   0 <= i < m

over the planner's CSR: ``ptr`` and ``ind`` int32 or int64, as the form
holds them; ``val`` and ``x`` of one dtype, float32, float64, complex64 or
complex128; y in that dtype, the sums kept in it.

It replaces no Pallas kernel: it is the hand kernel of the JAX package's
XLA formulation ``spmv_segsum`` (kernels/xla/spmv.py:51, mv KID 0). Its
plain version is ``kernels/plain_spmv.py`` `spmv_segsum` (gather, multiply,
``index_add_`` over the form's row ids).

The schedule is fixed at plan time (`csr_plan`): a sub-warp of
`sub_warp_width` lanes a row, from the mean row length, and the list of
rows longer than ``LONG_ROW_STEPS`` strides of that sub-warp, each of which
a second launch gives a CTA of 256 threads. So a call is one launch, or
two where the list is not empty (`csr_launches`).

`spmv_csr` has one rule: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. `spmv_csr.launches` counts kernel
launches per instance. `spmv_csr_any`, the registry's KID 0 function, adds
the dtype rule: dtypes the kernel has no instance for (bfloat16, float16,
or val and x of two dtypes) take the plain version on any device; the rule
reads the dtypes and nothing else, never the outcome of a build or a
launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import AoclSparseError, Status
from .build import load_library
from .plain_spmv import spmv_segsum

__all__ = [
    "KERNEL_DTYPES",
    "LONG_ROW_STEPS",
    "csr_launches",
    "csr_plan",
    "long_row_min",
    "row_ids_from_ptr",
    "spmv_csr",
    "spmv_csr_any",
    "spmv_csr_plain",
    "sub_warp_width",
]

#: value dtype -> (instance name, C entry point)
_INSTANCES = {
    torch.float32: ("f32", "spmv_csr_f32"),
    torch.float64: ("f64", "spmv_csr_f64"),
    torch.complex64: ("c64", "spmv_csr_c64"),
    torch.complex128: ("c128", "spmv_csr_c128"),
}
#: the value dtypes the kernel has instances for
KERNEL_DTYPES = tuple(_INSTANCES)
_INDEX_DTYPES = (torch.int32, torch.int64)

#: sub-warp widths the kernel has (powers of two)
SUB_WARP_MIN, SUB_WARP_MAX = 2, 32
#: a row longer than this many strides of its sub-warp goes to the
#: long-row launch. A warp lasts as long as its longest row: at the plan's
#: width a row near the mean takes one stride, so a row past 8 would hold
#: its warp (and the SM slot it sits in) 8 times as long. On the webbase
#: stand-in (width 4) that is the 202 rows past 32 entries, 2.9 % of the
#: entries, up to 4,698 long (1,175 strides on 4 lanes, 19 strides of a CTA
#: of 256, four in flight); on scircuit (width 8) its 24 rail rows past 64
LONG_ROW_STEPS = 8

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def sub_warp_width(nnz: int, m: int) -> int:
    """Lanes a row: the least power of two at or above the mean row length,
    within [SUB_WARP_MIN, SUB_WARP_MAX], so a row near the mean takes one
    stride and a warp holds 32 / width rows."""
    mean = int(np.ceil(nnz / m)) if m > 0 else 0
    return min(max(1 << max(mean - 1, 0).bit_length(), SUB_WARP_MIN), SUB_WARP_MAX)


def long_row_min(lanes: int) -> int:
    """Entries above which a row leaves its sub-warp for a CTA of its own."""
    return LONG_ROW_STEPS * lanes


def csr_plan(ptr) -> Tuple[int, np.ndarray]:
    """The kernel's schedule for a CSR with row pointers `ptr` (host):
    (lanes, long_rows), the sub-warp width and the int64 rows longer than
    `long_row_min(lanes)`, in row order."""
    p = np.asarray(ptr, dtype=np.int64)
    m = p.size - 1
    if m <= 0:
        return SUB_WARP_MIN, np.zeros(0, dtype=np.int64)
    lanes = sub_warp_width(int(p[-1] - p[0]), m)
    return lanes, np.nonzero(np.diff(p) > long_row_min(lanes))[0].astype(np.int64)


def csr_launches(m: int, n_long: int) -> int:
    """Kernel launches of one call: the rows launch (m > 0) and the
    long-row launch (a non-empty list)."""
    return int(m > 0) + int(n_long > 0)


def _check(ptr, ind, val, x, long_rows, lanes: int):
    """Validate the operands; return the instance (name, symbol)."""
    inst = _INSTANCES.get(val.dtype)
    if inst is None or x.dtype != val.dtype:
        raise AoclSparseError(Status.wrong_type, f"CSR kernel has no instance for values {val.dtype} with x {x.dtype}")
    if ptr.dtype not in _INDEX_DTYPES or ind.dtype not in _INDEX_DTYPES or long_rows.dtype != torch.int64:
        raise AoclSparseError(Status.wrong_type, "ptr and ind must be int32 or int64, the long rows int64")
    if ptr.dim() != 1 or ind.dim() != 1 or val.dim() != 1 or x.dim() != 1 or long_rows.dim() != 1:
        raise AoclSparseError(Status.invalid_size, "ptr, ind, val, x and the long rows must be vectors")
    if ptr.shape[0] < 1 or ind.shape[0] != val.shape[0]:
        raise AoclSparseError(Status.invalid_size, f"ptr of {ptr.shape[0]}, ind of {ind.shape[0]}, val of "
                              f"{val.shape[0]}: want m + 1 pointers and one index a value")
    if lanes not in (2, 4, 8, 16, 32):
        raise AoclSparseError(Status.invalid_value, f"sub-warp width {lanes}: want a power of two in [2, 32]")
    if any(t.device != x.device for t in (ptr, ind, val, long_rows)):
        raise AoclSparseError(Status.invalid_value, "ptr, ind, val, x and the long rows must share a device")
    if not all(t.is_contiguous() for t in (ptr, ind, val, x, long_rows)):
        raise AoclSparseError(Status.invalid_value, "ptr, ind, val, x and the long rows must be contiguous")
    return inst


def row_ids_from_ptr(ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """The int64 row of each of the `nnz` entries of a CSR with row
    pointers `ptr`, on ptr's device: what the plain gather sums by."""
    m = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(m, device=ptr.device), (ptr[1:] - ptr[:-1]).long(), output_size=nnz)


def spmv_csr_plain(ptr, ind, val, x, row_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: `spmv_segsum` over the row
    ids (derived from ptr where not given)."""
    if row_ids is None:
        row_ids = row_ids_from_ptr(ptr, ind.shape[0])
    return spmv_segsum(ind, val, row_ids, x, ptr.shape[0] - 1)


def spmv_csr(ptr, ind, val, x, long_rows, lanes: int, row_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A @ x over the CSR (ptr, ind, val) by the contract above, with
    the plan's long rows and sub-warp width (`csr_plan`): the plain version
    on a CPU tensor (over `row_ids` where given), the CUDA kernel on a CUDA
    tensor (launched on the current stream, not synchronised)."""
    name, symbol = _check(ptr, ind, val, x, long_rows, lanes)
    if x.device.type == "cpu":
        return spmv_csr_plain(ptr, ind, val, x, row_ids)
    if x.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no CSR kernel for {x.device}")
    m, n_long = ptr.shape[0] - 1, long_rows.shape[0]
    y = torch.empty(m, dtype=val.dtype, device=x.device)
    if m == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _entry(symbol)(
            ptr.data_ptr(),
            ind.data_ptr(),
            val.data_ptr(),
            x.data_ptr(),
            y.data_ptr(),
            long_rows.data_ptr() if n_long else None,
            m,
            n_long,
            long_row_min(lanes),
            lanes,
            int(ptr.dtype == torch.int64),
            int(ind.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"spmv_csr_{name} launch failed: CUDA error {rc}")
    spmv_csr.launches[name] += csr_launches(m, n_long)
    return y


spmv_csr.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def spmv_csr_any(ind, val, row_ids, x, m: int, ptr, long_rows, lanes: int) -> torch.Tensor:
    """mv KID 0 over a segsum form: the kernel where val and x share a dtype
    it has an instance for, else the plain `spmv_segsum` (bfloat16,
    float16, mixed dtypes), by dtype alone. `row_ids` may be None (a form
    on the card keeps none): the plain version then derives them from
    ptr."""
    if val.dtype not in _INSTANCES or x.dtype != val.dtype:
        return spmv_csr_plain(ptr, ind, val, x, row_ids)
    return spmv_csr(ptr, ind, val, x, long_rows, lanes, row_ids)
