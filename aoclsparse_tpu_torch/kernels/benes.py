"""Benes route: the hand-written Hopper kernel of the spill-route engine's
middle phase, and its plain PyTorch version.

Contract (``csrc/benes.cu``, built by ``kernels/build.py``): `benes_route`
applies the 2k-1 stages of a packed route to v (2^k float32 values, k <=
20), stage t (stride ``route.benes_strides(k)[t]``) setting
v'[i] = v[i ^ s] where bit t % 8 of ``masks_packed[t // 8, i]`` is set.
`benes_stages` applies a list of unpacked stages (one 0/1 mask row and
stride each): the outer stages of a k > 20 route. No arithmetic, so kernel
and plain version agree bit for bit.

It replaces the JAX package's ``pallas_benes_apply``
(kernels/pallas/route_fused.py:73). Stages of stride >= the kernel's tile
(4096 values) run as global passes of up to 4 stages each, the rest in one
shared-memory launch; every launch adds one to `benes_route.launches`
(the one counter of both entry points). A CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library
from .route import apply_benes, benes_strides, stage, unpack_masks

__all__ = ["PASS_GROUP", "TILE_LOG", "benes_route", "benes_route_plain", "benes_stages", "benes_stages_plain"]

#: log2 of the kernel's shared-memory tile: stages of smaller stride run
#: inside one launch
TILE_LOG = 12
#: stages a global pass applies at most
PASS_GROUP = 4

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        if symbol == "benes_tile_f32":
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
        else:
            i64p = ctypes.POINTER(ctypes.c_int64)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [i64p] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def benes_route_plain(v: torch.Tensor, masks_packed: torch.Tensor, k: int) -> torch.Tensor:
    """The route in plain torch: the stage loop over the unpacked masks."""
    return apply_benes(v, unpack_masks(masks_packed, 2 * k - 1), k)


def benes_stages_plain(v: torch.Tensor, rows: torch.Tensor, strides) -> torch.Tensor:
    for t, s in enumerate(strides):
        v = stage(v, rows[t], s)
    return v


def _check(v: torch.Tensor, masks: torch.Tensor, out):
    if v.dtype != torch.float32 or masks.dtype != torch.uint8:
        raise AoclSparseError(
            Status.wrong_type, f"the route kernel takes float32 values and uint8 masks, got {v.dtype}, {masks.dtype}"
        )
    if v.dim() != 1 or masks.dim() != 2 or masks.shape[1] != v.shape[0]:
        raise AoclSparseError(Status.invalid_size, "v must be (n,) and the masks (rows, n)")
    if masks.device != v.device or (out is not None and out.device != v.device):
        raise AoclSparseError(Status.invalid_value, "v, masks and out must share a device")
    if not (v.is_contiguous() and masks.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "v and the masks must be contiguous")
    if out is not None and (out.shape != v.shape or out.dtype != v.dtype or not out.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "out must be a contiguous float32 tensor shaped as v")
    if v.device.type not in ("cpu", "cuda"):
        raise AoclSparseError(Status.not_implemented, f"no route kernel for {v.device}")


def _finish_plain(res: torch.Tensor, out):
    if out is None:
        return res
    out.copy_(res)
    return out


def _pass(src, dst, masks, n, stages):
    """One global pass of (stride, row, bit) stages."""
    g = len(stages)
    arr = [(ctypes.c_int64 * g)(*col) for col in zip(*stages)]
    with torch.cuda.device(src.device):
        rc = _entry("benes_pass_f32")(
            src.data_ptr(), dst.data_ptr(), masks.data_ptr(), n, g, *arr,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"benes_pass_f32 launch failed: CUDA error {rc}")
    benes_route.launches["f32"] += 1


def _passes(src, dst, masks, n, stages):
    """The stages in groups of PASS_GROUP, the first from src, the rest in
    place on dst; returns the tensor holding the result."""
    for i in range(0, len(stages), PASS_GROUP):
        _pass(src, dst, masks, n, stages[i : i + PASS_GROUP])
        src = dst
    return src


def benes_route(v: torch.Tensor, masks_packed: torch.Tensor, k: int, out=None) -> torch.Tensor:
    """Route v (2^k float32, k <= 20) through the packed network; writes
    `out` (may be v) or a new tensor."""
    _check(v, masks_packed, out)
    if not 1 <= k <= 20 or v.shape[0] != 1 << k or masks_packed.shape[0] != -(-(2 * k - 1) // 8):
        raise AoclSparseError(Status.invalid_size, f"a packed route of k={k} takes 2^k values and ceil((2k-1)/8) rows")
    if v.device.type == "cpu":
        return _finish_plain(benes_route_plain(v, masks_packed, k), out)
    dst = torch.empty_like(v) if out is None else out
    n = 1 << k
    tb = min(k, TILE_LOG)
    strides = benes_strides(k)
    S = len(strides)
    pre = [(strides[t], t // 8, t % 8) for t in range(k - tb)]
    post = [(strides[t], t // 8, t % 8) for t in range(k + tb - 1, S)]
    src = _passes(v, dst, masks_packed, n, pre)
    with torch.cuda.device(v.device):
        rc = _entry("benes_tile_f32")(
            src.data_ptr(), dst.data_ptr(), masks_packed.data_ptr(), k, tb,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"benes_tile_f32 launch failed: CUDA error {rc}")
    benes_route.launches["f32"] += 1
    _passes(dst, dst, masks_packed, n, post)
    return dst


benes_route.launches = {"f32": 0}


def benes_stages(v: torch.Tensor, rows: torch.Tensor, strides, out=None) -> torch.Tensor:
    """Apply unpacked stages (rows[t] with stride strides[t]) to v through
    the global-pass entry; writes `out` (may be v) or a new tensor."""
    _check(v, rows, out)
    strides = tuple(int(s) for s in strides)
    if rows.shape[0] != len(strides):
        raise AoclSparseError(Status.invalid_size, f"{rows.shape[0]} mask rows for {len(strides)} strides")
    if v.device.type == "cpu":
        return _finish_plain(benes_stages_plain(v, rows, strides), out)
    dst = torch.empty_like(v) if out is None else out
    if not strides:
        return dst.copy_(v)
    return _passes(v, dst, rows, v.shape[0], [(s, t, 0) for t, s in enumerate(strides)])


benes_stages.launches = benes_route.launches
