"""Select and accumulate: the hand-written Hopper kernels of the spill-route
engine's first and last phases, and their plain PyTorch versions.

Contracts (``csrc/spill_route.cu``, built by ``kernels/build.py``), over
1024-slot chunks (the planner's (·, 8, 128) tiles, flattened):

- `oh_select` (replaces ``pallas_oh_select``,
  kernels/pallas/spill_route.py:66):
  contrib[1024 c + s] = sel_val[c, s] * x[1024 sel_blk[c] + sel_idx[c, s]],
  x read as 0 past its end; the result has `n_out` >= 1024 * chunks
  values, zero past the chunks (the route's padding).
- `oh_accum` (replaces ``pallas_oh_accum``, spill_route.py:126): every y
  block b = y_in's block b plus, over the chunks c of b (blk_start[b] <=
  c < blk_start[b + 1]) whose tile acc_cid[c] is below n_real,
  contrib[1024 acc_cid[c] + s] added at row acc_idx[c, s]. The JAX
  package's trailing zero tile (acc_cid == n_real) is skipped, not read.
  The kernel sums each run of equal rows in a chunk by a segmented scan
  and adds it once; on chunks whose rows are sorted (every plan of
  planner/spill_route.py) it gives the same bits on every call.

A CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises. `oh_select.launches` / `oh_accum.launches` count launches. Both
kernels are float32 only, as the engine is (the JAX package gates it so).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library

__all__ = ["oh_accum", "oh_accum_plain", "oh_select", "oh_select_plain"]

CHUNK = 1024

_fns = {}


def _entry(symbol: str, argtypes):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _flat(t: torch.Tensor, dtype, what: str) -> torch.Tensor:
    if t.dtype != dtype:
        raise AoclSparseError(Status.wrong_type, f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise AoclSparseError(Status.invalid_value, f"{what} must be contiguous")
    return t.reshape(-1)


def _aligned(*ts):
    for t in ts:
        if t.data_ptr() % 16:
            raise AoclSparseError(Status.invalid_value, "the spill-route kernels need 16-byte aligned operands")


def _device_of(*ts) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise AoclSparseError(Status.invalid_value, "the spill-route operands must share a device")
    if dev.type not in ("cpu", "cuda"):
        raise AoclSparseError(Status.not_implemented, f"no spill-route kernel for {dev}")
    return dev


def oh_select_plain(x, sel_idx, sel_val, sel_blk, n_out=None) -> torch.Tensor:
    nc = sel_blk.shape[0]
    n_out = nc * CHUNK if n_out is None else n_out
    nx = int(sel_blk.max()) + 1 if nc else 0
    xpad = torch.zeros(max(nx * CHUNK, x.shape[0]), dtype=x.dtype, device=x.device)
    xpad[: x.shape[0]] = x
    cols = sel_blk.to(torch.int64).reshape(-1, 1) * CHUNK + sel_idx.reshape(nc, CHUNK).to(torch.int64)
    out = torch.zeros(n_out, dtype=x.dtype, device=x.device)
    out[: nc * CHUNK] = (sel_val.reshape(nc, CHUNK) * xpad[cols]).reshape(-1)
    return out


def oh_select(x, sel_idx, sel_val, sel_blk, n_out=None) -> torch.Tensor:
    """Contributions of the select chunks, zero-padded to n_out values."""
    dev = _device_of(x, sel_idx, sel_val, sel_blk)
    x = _flat(x, torch.float32, "x")
    idx = _flat(sel_idx, torch.int32, "sel_idx")
    val = _flat(sel_val, torch.float32, "sel_val")
    blk = _flat(sel_blk, torch.int32, "sel_blk")
    nc = blk.shape[0]
    if idx.shape[0] != nc * CHUNK or val.shape[0] != nc * CHUNK:
        raise AoclSparseError(Status.invalid_size, "sel_idx and sel_val must hold 1024 slots a chunk")
    n_out = nc * CHUNK if n_out is None else int(n_out)
    if n_out < nc * CHUNK:
        raise AoclSparseError(Status.invalid_size, f"n_out={n_out} < {nc * CHUNK} select slots")
    if dev.type == "cpu":
        return oh_select_plain(x, idx, val, blk, n_out)
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    out[nc * CHUNK :].zero_()
    _aligned(idx, val, out)
    with torch.cuda.device(dev):
        rc = _entry(
            "oh_select_f32",
            [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p],
        )(
            x.data_ptr(), x.shape[0], idx.data_ptr(), val.data_ptr(), blk.data_ptr(), nc, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"oh_select_f32 launch failed: CUDA error {rc}")
    oh_select.launches["f32"] += 1
    return out


oh_select.launches = {"f32": 0}


def oh_accum_plain(contrib, acc_idx, acc_cid, blk_start, n_real: int, y_in) -> torch.Tensor:
    nyblk = blk_start.shape[0] - 1
    nc = acc_cid.shape[0]
    blk = torch.repeat_interleave(
        torch.arange(nyblk, device=y_in.device), (blk_start[1:] - blk_start[:-1]).to(torch.int64)
    )
    real = acc_cid.to(torch.int64) < n_real
    rows = blk[real].reshape(-1, 1) * CHUNK + acc_idx.reshape(nc, CHUNK)[real].to(torch.int64)
    vals = contrib[: n_real * CHUNK].reshape(-1, CHUNK)[acc_cid[real].to(torch.int64)]
    ypad = torch.zeros(max(nyblk * CHUNK, y_in.shape[0]), dtype=y_in.dtype, device=y_in.device)
    ypad[: y_in.shape[0]] = y_in
    ypad.index_add_(0, rows.reshape(-1), vals.reshape(-1).to(y_in.dtype))
    return ypad[: y_in.shape[0]]


def oh_accum(contrib, acc_idx, acc_cid, blk_start, n_real: int, y_in, out=None) -> torch.Tensor:
    """y_in plus the accumulated chunks, block by block; writes `out` (may
    be y_in) or a new tensor. blk_start (nyblk + 1,) int32 delimits each y
    block's run of the monotone chunk list."""
    dev = _device_of(contrib, acc_idx, acc_cid, blk_start, y_in)
    c = _flat(contrib, torch.float32, "contrib")
    idx = _flat(acc_idx, torch.int32, "acc_idx")
    cid = _flat(acc_cid, torch.int32, "acc_cid")
    start = _flat(blk_start, torch.int32, "blk_start")
    y_in = _flat(y_in, torch.float32, "y_in")
    nyblk = start.shape[0] - 1
    if idx.shape[0] != cid.shape[0] * CHUNK or c.shape[0] < n_real * CHUNK:
        raise AoclSparseError(Status.invalid_size, "acc_idx needs 1024 slots a chunk and contrib n_real tiles")
    if y_in.shape[0] > nyblk * CHUNK:
        raise AoclSparseError(Status.invalid_size, f"y has {y_in.shape[0]} rows, the chunks cover {nyblk * CHUNK}")
    if out is not None and (out.shape != y_in.shape or out.dtype != y_in.dtype or not out.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "out must be a contiguous float32 tensor shaped as y")
    if dev.type == "cpu":
        res = oh_accum_plain(c, idx, cid, start, n_real, y_in)
        return res if out is None else out.copy_(res)
    dst = torch.empty_like(y_in) if out is None else out
    _aligned(c, idx)
    with torch.cuda.device(dev):
        rc = _entry(
            "oh_accum_f32",
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p],
        )(
            c.data_ptr(), idx.data_ptr(), cid.data_ptr(), start.data_ptr(), n_real, y_in.data_ptr(),
            dst.data_ptr(), y_in.shape[0], nyblk, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"oh_accum_f32 launch failed: CUDA error {rc}")
    oh_accum.launches["f32"] += 1
    return dst


oh_accum.launches = {"f32": 0}
