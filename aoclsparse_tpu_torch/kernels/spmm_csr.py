"""CSR SpMM: the hand-written Hopper kernel of the ``segsum`` form (mm KID
0), and the KID 0 dispatch.

Contract (``csrc/spmm_csr.cu``, built by ``kernels/build.py``):

    C[i, :] = sum_{ptr[i] <= p < ptr[i + 1]} val[p] * B[ind[p], :],   0 <= i < m

over the planner's CSR: ``ptr`` and ``ind`` int32 or int64, as the form
holds them; B (n, K) and C (m, K) row-major; ``val`` and B of one dtype,
float32, float64, complex64 or complex128, the sums kept in it, or ``val``
bfloat16 with B float32 (f32 sums, C float32: mm widens a bf16 handle's B,
exactly, as it does for the band forms). C is written, not accumulated.

It replaces no Pallas kernel: it is the hand kernel of the JAX package's
XLA formulation ``spmm_segsum`` (kernels/xla/spmm.py:21, mm KID 0). Its
plain version is ``kernels/spmm_plain.py`` `spmm_segsum` (gather B rows,
scale, ``index_add_`` over the form's row ids).

What bounds it is bytes: the CSR, B and C once each, 0.0286 ms on the
scircuit stand-in at K = 64 f32 and 0.161 ms on the webbase stand-in at
3.35 TB/s. Each entry also gathers a K-wide row of B (nnz * K values), from
L2 where B fits it, from HBM where it does not (webbase's B is 256 MB).
The design reads the CSR once, on the schedule the CSR SpMV kernel already
has (the form's `csr_blocks`, kernels/spmv_csr.py), one CTA a block and
column tiles of 32 lanes (two f32 columns a lane where K is even): a warp a
row, its (index, value) pairs loaded coalesced and broadcast by shuffle,
each B row segment read coalesced, four in flight a lane, the sums in
registers and C stored once; a row past ``LONG_ROW`` entries is split among
the CTA's warps, which meet in shared memory in warp order. No atomics: a
run repeats bit for bit. Every stored entry is multiplied (0 * Inf gives
NaN, as in the JAX formulation).

`spmm_csr` and `spmm_csr_any`, the registry's KID 0 function, have one
rule: a CPU tensor takes the plain version, in every dtype; a CUDA tensor
launches the kernel (one launch a call; none where m, nnz or K is 0, C then
zeros), or raises where (val, B) is not a pair it has an instance for:
no CUDA tensor takes the plain version. A B that is not contiguous (mm's
``order=Order.column`` hands B transposed) is made contiguous once, here,
before the launch. `spmm_csr.launches` counts kernel launches per
instance.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library
from .spmm_plain import spmm_segsum
from .spmv_csr import row_ids_from_ptr

__all__ = ["KERNEL_DTYPES", "MAX_K", "spmm_csr", "spmm_csr_any", "spmm_csr_plain"]

#: (value dtype, B dtype) -> (instance name, C entry point)
_INSTANCES = {
    (torch.float32, torch.float32): ("f32", "spmm_csr_f32"),
    (torch.float64, torch.float64): ("f64", "spmm_csr_f64"),
    (torch.complex64, torch.complex64): ("c64", "spmm_csr_c64"),
    (torch.complex128, torch.complex128): ("c128", "spmm_csr_c128"),
    (torch.bfloat16, torch.float32): ("bf16", "spmm_csr_bf16"),
}
#: the value dtypes the kernel has instances for (bf16 with float32 B)
KERNEL_DTYPES = tuple(v for v, _b in _INSTANCES)
_INDEX_DTYPES = (torch.int32, torch.int64)
#: widest B: the grid's second dimension holds at most 65,535 column tiles
#: of 32 lanes, one value a lane on the narrowest path
MAX_K = 65535 * 32

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(ptr, ind, val, B, blocks):
    """Validate the operands; return the instance (name, symbol)."""
    inst = _INSTANCES.get((val.dtype, B.dtype))
    if inst is None:
        raise AoclSparseError(Status.wrong_type, f"CSR SpMM kernel has no instance for values {val.dtype} with B "
                              f"{B.dtype}")
    if ptr.dtype not in _INDEX_DTYPES or ind.dtype not in _INDEX_DTYPES or blocks.dtype != torch.int64:
        raise AoclSparseError(Status.wrong_type, "ptr and ind must be int32 or int64, the schedule int64")
    if ptr.dim() != 1 or ind.dim() != 1 or val.dim() != 1 or B.dim() != 2:
        raise AoclSparseError(Status.invalid_size, "ptr, ind and val must be vectors, B a matrix")
    if ptr.shape[0] < 1 or ind.shape[0] != val.shape[0]:
        raise AoclSparseError(Status.invalid_size, f"ptr of {ptr.shape[0]}, ind of {ind.shape[0]}, val of "
                              f"{val.shape[0]}: want m + 1 pointers and one index a value")
    if blocks.dim() != 2 or blocks.shape[1] != 2 or blocks.shape[0] < 1:
        raise AoclSparseError(Status.invalid_size, f"schedule of shape {tuple(blocks.shape)}: want (blocks + 1, 2) "
                              "from csr_blocks")
    if B.shape[1] > MAX_K:
        raise AoclSparseError(Status.invalid_size, f"B of {B.shape[1]} columns: the kernel takes at most {MAX_K}")
    if any(t.device != B.device for t in (ptr, ind, val, blocks)):
        raise AoclSparseError(Status.invalid_value, "ptr, ind, val, B and the schedule must share a device")
    if not all(t.is_contiguous() for t in (ptr, ind, val, blocks)):
        raise AoclSparseError(Status.invalid_value, "ptr, ind, val and the schedule must be contiguous")
    return inst


def spmm_csr_plain(ptr, ind, val, B, row_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: `spmm_segsum` over the row
    ids (derived from ptr where not given)."""
    if row_ids is None:
        row_ids = row_ids_from_ptr(ptr, ind.shape[0])
    return spmm_segsum(ind, val, row_ids, B, ptr.shape[0] - 1)


def _launch(ptr, ind, val, B, blocks, name: str, symbol: str) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands (B's device, B
    contiguous), on the current stream, not synchronised."""
    m, K = ptr.shape[0] - 1, B.shape[1]
    nblk = blocks.shape[0] - 1
    if nblk == 0 or K == 0 or ind.shape[0] == 0:
        return torch.zeros(m, K, dtype=B.dtype, device=B.device)
    C = torch.empty(m, K, dtype=B.dtype, device=B.device)
    args = (ptr.data_ptr(), ind.data_ptr(), val.data_ptr(), B.data_ptr(), C.data_ptr(), blocks.data_ptr(), nblk, K,
            int(ptr.dtype == torch.int64), int(ind.dtype == torch.int64))
    index = B.device.index
    if index is None or index == torch.cuda.current_device():
        rc = _entry(symbol)(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):
            rc = _entry(symbol)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_csr_{name} launch failed: CUDA error {rc}")
    spmm_csr.launches[name] += 1
    return C


def spmm_csr(ptr, ind, val, B, blocks, row_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A @ B over the CSR (ptr, ind, val) by the contract above, on the
    plan's schedule (`csr_blocks(ptr, *tile_of(val.dtype))` on B's device):
    the plain version on a CPU tensor (over `row_ids` where given), the
    CUDA kernel on a CUDA tensor (one launch on the current stream, not
    synchronised; B made contiguous first where it is a view)."""
    name, symbol = _check(ptr, ind, val, B, blocks)
    if B.device.type == "cpu":
        return spmm_csr_plain(ptr, ind, val, B, row_ids)
    if B.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no CSR SpMM kernel for {B.device}")
    return _launch(ptr, ind, val, B.contiguous(), blocks, name, symbol)


spmm_csr.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def spmm_csr_any(ind, val, row_ids, B, m: int, ptr, blocks) -> torch.Tensor:
    """mm KID 0 over a segsum form: on the CPU the plain `spmm_segsum`,
    every dtype (`row_ids` may be None: it then derives them from ptr); on
    the card the kernel, launched at once (the form holds ptr, ind, val and
    the schedule checked and on its device; B made contiguous first where
    it is a view), or an error where (val, B) is not a pair it has an
    instance for."""
    if B.device.type == "cpu":
        return spmm_csr_plain(ptr, ind, val, B, row_ids)
    inst = _INSTANCES.get((val.dtype, B.dtype))
    if B.device.type != "cuda" or inst is None:
        raise AoclSparseError(Status.wrong_type, f"CSR SpMM kernel has no instance for values {val.dtype} with B "
                              f"{B.dtype} on {B.device}")
    if B.shape[1] > MAX_K:
        raise AoclSparseError(Status.invalid_size, f"B of {B.shape[1]} columns: the kernel takes at most {MAX_K}")
    return _launch(ptr, ind, val, B.contiguous(), blocks, *inst)
