"""CSR row-gather SpMV: the hand-written Hopper kernel of the ``segsum``
form (mv KID 0), its plan-time schedule, and the KID 0 dispatch.

Contract (``csrc/spmv_csr.cu``, built by ``kernels/build.py``):

    y[i] = sum_{ptr[i] <= p < ptr[i + 1]} val[p] * x[ind[p]],   0 <= i < m

over the planner's CSR: ``ptr`` and ``ind`` int32 or int64, as the form
holds them; ``val`` and ``x`` of one dtype, float32, float64, complex64,
complex128 or bfloat16; y in that dtype, the sums kept in it, except
bfloat16's, which sum in float32 and round y once.

It replaces no Pallas kernel: it is the hand kernel of the JAX package's
XLA formulation ``spmv_segsum`` (kernels/xla/spmv.py:51, mv KID 0). Its
plain version is ``kernels/plain_spmv.py`` `spmv_segsum` (gather, multiply,
``index_add_`` over the form's row ids).

The schedule is fixed at plan time (`csr_blocks`, after CSR-Adaptive):
consecutive rows cut into blocks of at most a tile of entries and half as
many rows (`tile_of` the value type: 2,048 entries for float32, 1,024
for the wider types), a row past ``LONG_ROW`` entries a block of its own,
as a table of (first row, first entry) pairs. A call is one launch, one CTA a
block, whatever the rows (`csr_launches`: none where m = 0).

`spmv_csr` and `spmv_csr_any`, the registry's KID 0 function, have one
rule: a CPU tensor takes the plain version, in every dtype; a CUDA tensor
launches the kernel, or raises where val and x do not share a dtype it has
an instance for (float16, or two dtypes): no CUDA tensor takes the plain
version. `spmv_csr` checks every operand, for direct callers;
`spmv_csr_any` launches without re-checking what the segsum form
guarantees (its operands' types, shapes and device; `mv` has checked x's).
`spmv_csr.launches` counts kernel launches per instance.

For bfloat16 the plain version, as the kernel, sums in f32 and rounds y
once, where the JAX package's ``spmv_segsum`` sums the bf16 products in
bf16: a deliberate divergence (ROADMAP), within the bf16 model tolerance
on rows of ordinary length.
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
    "LONG_ROW",
    "block_stats",
    "csr_blocks",
    "csr_launches",
    "row_ids_from_ptr",
    "spmv_csr",
    "spmv_csr_any",
    "spmv_csr_plain",
    "tile_of",
]

#: value dtype -> (instance name, C entry point)
_INSTANCES = {
    torch.float32: ("f32", "spmv_csr_f32"),
    torch.float64: ("f64", "spmv_csr_f64"),
    torch.complex64: ("c64", "spmv_csr_c64"),
    torch.complex128: ("c128", "spmv_csr_c128"),
    torch.bfloat16: ("bf16", "spmv_csr_bf16"),
}
#: the value dtypes the kernel has instances for
KERNEL_DTYPES = tuple(_INSTANCES)
_INDEX_DTYPES = (torch.int32, torch.int64)

#: a row with more entries is a block of its own, which the CTA strides
#: from memory: in a block of short rows one thread would sum it alone
#: while the block's other rows take a few additions each. On the webbase
#: stand-in that is its hub rows of 257 to 4,698 entries
LONG_ROW = 256

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def tile_of(dtype: torch.dtype) -> Tuple[int, int]:
    """(entries, rows) a block of several rows holds at most for values of
    `dtype` (csrc/spmv_csr.cu Tile): 8 entries a thread of the CTA's 256
    for values of 4 bytes or fewer (bf16 too), 4 for the wider ones, whose slots hold
    more registers (`scripts/csr_tiles.py` times both on the card); half as
    many rows, the row pointers' shared tile, which a run of empty rows
    fills."""
    entries = 2048 if torch.empty(0, dtype=dtype).element_size() <= 4 else 1024
    return entries, entries // 2


def csr_blocks(ptr, tile: int, max_rows: int) -> np.ndarray:
    """The kernel's schedule for a CSR with row pointers `ptr` (host, any
    integer type; they need not start at 0), at `tile_of` the values'
    dtype: the (nblk + 1, 2) int64 table of each block's (first row, first
    entry), in row order, the last pair (m, ptr[m]). Rows go greedily into
    a block while its entries stay within `tile` and its rows within
    `max_rows`; a row past LONG_ROW entries is a block of its own. m = 0
    gives no block."""
    p = np.asarray(ptr, dtype=np.int64)
    m = p.size - 1
    if m < 0:
        raise AoclSparseError(Status.invalid_size, "row pointers need at least one entry")
    lens = np.diff(p)
    # the first long row at or after each row (m where none is)
    nxt = np.where(lens > LONG_ROW, np.arange(m), m)
    nxt = np.minimum.accumulate(nxt[::-1])[::-1]
    starts = [0]
    r = 0
    while r < m:
        if nxt[r] == r:
            r += 1
        else:
            fit = int(np.searchsorted(p, p[r] + tile, side="right")) - 1
            r = max(min(fit, r + max_rows, int(nxt[r])), r + 1)
        starts.append(r)
    rows = np.asarray(starts, dtype=np.int64)
    return np.stack([rows, p[rows]], axis=1)


def block_stats(blocks) -> Tuple[int, int]:
    """(blocks, blocks of one row) of a schedule (numpy or tensor): the
    CTAs a call launches and those that stride a row from memory."""
    rows = np.asarray(blocks.cpu() if isinstance(blocks, torch.Tensor) else blocks)[:, 0]
    return rows.size - 1, int(np.count_nonzero(np.diff(rows) == 1))


def csr_launches(nblk: int) -> int:
    """Kernel launches of one call on a schedule of `nblk` blocks: one,
    none where there is no block (m = 0)."""
    return int(nblk > 0)


def _check(ptr, ind, val, x, blocks):
    """Validate the operands; return the instance (name, symbol)."""
    inst = _INSTANCES.get(val.dtype)
    if inst is None or x.dtype != val.dtype:
        raise AoclSparseError(Status.wrong_type, f"CSR kernel has no instance for values {val.dtype} with x {x.dtype}")
    if ptr.dtype not in _INDEX_DTYPES or ind.dtype not in _INDEX_DTYPES or blocks.dtype != torch.int64:
        raise AoclSparseError(Status.wrong_type, "ptr and ind must be int32 or int64, the schedule int64")
    if ptr.dim() != 1 or ind.dim() != 1 or val.dim() != 1 or x.dim() != 1:
        raise AoclSparseError(Status.invalid_size, "ptr, ind, val and x must be vectors")
    if ptr.shape[0] < 1 or ind.shape[0] != val.shape[0]:
        raise AoclSparseError(Status.invalid_size, f"ptr of {ptr.shape[0]}, ind of {ind.shape[0]}, val of "
                              f"{val.shape[0]}: want m + 1 pointers and one index a value")
    if blocks.dim() != 2 or blocks.shape[1] != 2 or blocks.shape[0] < 1:
        raise AoclSparseError(Status.invalid_size, f"schedule of shape {tuple(blocks.shape)}: want (blocks + 1, 2) "
                              "from csr_blocks")
    if any(t.device != x.device for t in (ptr, ind, val, blocks)):
        raise AoclSparseError(Status.invalid_value, "ptr, ind, val, x and the schedule must share a device")
    if not all(t.is_contiguous() for t in (ptr, ind, val, x, blocks)):
        raise AoclSparseError(Status.invalid_value, "ptr, ind, val, x and the schedule must be contiguous")
    return inst


def row_ids_from_ptr(ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """The int64 row of each of the `nnz` entries of a CSR with row
    pointers `ptr`, on ptr's device: what the plain gather sums by."""
    m = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(m, device=ptr.device), (ptr[1:] - ptr[:-1]).long(), output_size=nnz)


def spmv_csr_plain(ptr, ind, val, x, row_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: `spmv_segsum` over the row
    ids (derived from ptr where not given); bf16 values and x sum in f32,
    y rounded to bf16 once, as the kernel does."""
    if row_ids is None:
        row_ids = row_ids_from_ptr(ptr, ind.shape[0])
    if val.dtype == torch.bfloat16 and x.dtype == torch.bfloat16:
        return spmv_segsum(ind, val.float(), row_ids, x.float(), ptr.shape[0] - 1).to(torch.bfloat16)
    return spmv_segsum(ind, val, row_ids, x, ptr.shape[0] - 1)


def _launch(ptr, ind, val, x, blocks, name: str, symbol: str) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands (x's device), on
    the current stream, not synchronised."""
    y = torch.empty(ptr.shape[0] - 1, dtype=val.dtype, device=x.device)
    nblk = blocks.shape[0] - 1
    if nblk == 0:
        return y
    args = (ptr.data_ptr(), ind.data_ptr(), val.data_ptr(), x.data_ptr(), y.data_ptr(), blocks.data_ptr(), nblk,
            int(ptr.dtype == torch.int64), int(ind.dtype == torch.int64))
    index = x.device.index
    if index is None or index == torch.cuda.current_device():
        rc = _entry(symbol)(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):
            rc = _entry(symbol)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmv_csr_{name} launch failed: CUDA error {rc}")
    spmv_csr.launches[name] += 1
    return y


def spmv_csr(ptr, ind, val, x, blocks, row_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A @ x over the CSR (ptr, ind, val) by the contract above, on the
    plan's schedule (`csr_blocks(ptr, *tile_of(val.dtype))` on x's device;
    the kernel traps on a block past its tile): the plain version on
    a CPU tensor (over `row_ids` where given), the CUDA kernel on a CUDA
    tensor (one launch on the current stream, not synchronised)."""
    name, symbol = _check(ptr, ind, val, x, blocks)
    if x.device.type == "cpu":
        return spmv_csr_plain(ptr, ind, val, x, row_ids)
    if x.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no CSR kernel for {x.device}")
    return _launch(ptr, ind, val, x, blocks, name, symbol)


spmv_csr.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def spmv_csr_any(ind, val, row_ids, x, m: int, ptr, blocks) -> torch.Tensor:
    """mv KID 0 over a segsum form: on the CPU the plain `spmv_segsum`,
    every dtype (`row_ids` may be None: it then derives them from ptr); on
    the card the kernel, launched at once (the form holds ptr, ind, val and
    the schedule checked and on its device, and mv holds x to it), or an
    error where val and x do not share a dtype it has an instance for."""
    if x.device.type == "cpu":
        return spmv_csr_plain(ptr, ind, val, x, row_ids)
    inst = _INSTANCES.get(val.dtype)
    if x.device.type != "cuda" or inst is None or x.dtype != val.dtype:
        raise AoclSparseError(Status.wrong_type, f"CSR kernel has no instance for values {val.dtype} with x "
                              f"{x.dtype} on {x.device}")
    return _launch(ptr, ind, val, x.contiguous(), blocks, *inst)
