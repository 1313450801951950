"""Benes route: the hand-written Hopper kernel of the spill-route engine's
middle phase, its schedule, and its plain PyTorch version.

Contract (``csrc/benes.cu``, built by ``kernels/build.py``): `benes_apply`
routes v (2^k float32 values) through a whole ``(outer, packed)`` plan of
``route.plan_route_arrays`` (k >= 7): the 2k-1 stages, stage t (stride
``route.benes_strides(k)[t]``) setting v'[i] = v[i ^ s] where its mask bit
of i is set. `benes_route` is the same for one packed network (k <= 20).
No arithmetic, so kernel and plain version agree bit for bit.

It replaces the JAX package's ``pallas_benes_apply``
(kernels/pallas/route_fused.py:73) and the staged apply around it. The
kernel runs the passes of `route_passes`: a pass owns a set of address
bits, so each of its CTAs loads the values (and mask bytes) whose free bits
vary, applies the pass's stages in shared memory, four at a time in
registers, and stores them once. A
route takes three launches (one when k <= TILE_LOG); a pass whose set would
not fit in PASS_SMEM bytes splits into more (first at k = 23). Every launch
adds one to `benes_route.launches` (the one counter of both entry points).
A CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from ..core.types import AoclSparseError, Status
from .build import MAX_SMEM, load_library
from .route import apply_benes, route_masks, unpack_masks

__all__ = [
    "PASS_SMEM",
    "RUN_LOG",
    "TILE_LOG",
    "RoutePass",
    "benes_apply",
    "benes_apply_plain",
    "benes_route",
    "benes_route_plain",
    "route_passes",
]

#: log2 of pass B's tile: stages of smaller stride run in one tile pass
TILE_LOG = 13
#: log2 of the runs of consecutive values a pass A / C CTA owns (32 values:
#: one 128-byte line, 32 mask bytes: one sector)
RUN_LOG = 5
#: shared memory a pass may use; a larger set splits the pass
PASS_SMEM = MAX_SMEM
#: the kernel's limits on one pass (csrc/benes.cu kMaxRows, kMaxStages, kMaxGroups)
MAX_ROWS, MAX_STAGES, MAX_GROUPS = 4, 32, 12


@dataclasses.dataclass(frozen=True)
class RoutePass:
    """One launch: the CTAs own address bits [0, c) and [blo, bhi), the
    others fixed by the block index; `rows` are the mask rows read, (0, r)
    row r of the outer stages or (1, r) packed row r of each subnetwork;
    `stages` are (local bit, slot in rows, bit in the row's bytes), in
    stage order, and `ts` the route's stage numbers. The kernel gathers a
    value's bits for the pass into one word, stage s at bit s: `row_words`
    gives, per row, (shift, mask, word) with the row's byte contributing
    ((byte >> shift) & mask) << word. The kernel applies the stages in
    `groups`, (first stage, number) runs of at most four consecutive
    stages of distinct local bits, in registers."""

    c: int
    blo: int
    bhi: int
    rows: Tuple[Tuple[int, int], ...]
    stages: Tuple[Tuple[int, int, int], ...]
    ts: Tuple[int, ...]

    @property
    def free_bits(self) -> int:
        return self.c + self.bhi - self.blo

    def smem(self) -> int:
        """Shared memory of a CTA: a value and a word a slot, one slot in 33
        padding (csrc/benes.cu slot_of)."""
        n = 1 << self.free_bits
        return (n + n // 32) * 8

    @property
    def groups(self):
        out = []
        for s, (lb, _slot, _bit) in enumerate(self.stages):
            if out and out[-1][1] < 4 and lb not in [st[0] for st in self.stages[out[-1][0] : s]]:
                out[-1] = (out[-1][0], out[-1][1] + 1)
            else:
                out.append((s, 1))
        return tuple(out)

    def row_words(self):
        out = []
        for r in range(len(self.rows)):
            ss = [s for s, st in enumerate(self.stages) if st[1] == r]
            bits = [self.stages[s][2] for s in ss]
            if ss != list(range(ss[0], ss[0] + len(ss))) or bits != list(range(bits[0], bits[0] + len(bits))):
                raise ValueError("a mask row's stages must be consecutive, at consecutive bits")
            out.append((bits[0], (1 << len(ss)) - 1, ss[0]))
        return tuple(out)


def _fits(p: RoutePass, smem: int) -> bool:
    return (p.smem() <= smem and len(p.rows) <= MAX_ROWS and len(p.stages) <= MAX_STAGES
            and len(p.groups) <= MAX_GROUPS)


@functools.lru_cache(maxsize=None)
def route_passes(k: int, d: int = 0, tb: int = TILE_LOG, c: int = RUN_LOG, smem: int = MAX_SMEM):
    """The passes of a route of 2^k values split into 2^d packed
    subnetworks (d = 0: one network): A, the stages of stride >= 2^tb in the
    first half; B, every stage of stride < 2^tb in tiles of 2^tb values; C,
    the mirror of A. A and C split into consecutive groups of stages where
    one set would need more than `smem` bytes or more mask rows or stages
    than the kernel takes."""
    kc = k - d
    tb = min(tb, kc)
    S = 2 * k - 1
    if not 2 <= c <= tb:
        raise ValueError(f"route_passes: need 2 <= c <= tb, got c={c}, tb={tb}")

    def stride_bit(t):
        return k - 1 - t if t < k else t - k + 1

    def mask_of(t):  # (row, bit in its bytes)
        if t < d:
            return (0, t), 0
        if t >= S - d:
            return (0, t - S + 2 * d), 0
        return (1, (t - d) // 8), (t - d) % 8

    def make(ts, c_, blo, bhi):
        rows, stages = [], []
        for t in ts:
            row, bit = mask_of(t)
            if row not in rows:
                rows.append(row)
            sb = stride_bit(t)
            stages.append((sb if sb < c_ else sb - blo + c_, rows.index(row), bit))
        return RoutePass(c_, blo, bhi, tuple(rows), tuple(stages), tuple(ts))

    def high(ts):  # consecutive groups of the stride >= 2^tb stages
        out, i = [], 0
        while i < len(ts):
            j = i + 1
            while j < len(ts):
                bits = [stride_bit(t) for t in ts[i : j + 1]]
                p = make(ts[i : j + 1], c, min(bits), max(bits) + 1)
                if not _fits(p, smem):
                    break
                j += 1
            bits = [stride_bit(t) for t in ts[i:j]]
            p = make(ts[i:j], c, min(bits), max(bits) + 1)
            if p.smem() > smem:
                raise ValueError(f"route_passes: one stage at k={k} needs {p.smem()} B of shared memory")
            out.append(p)
            i = j
        return out

    tile = make(range(k - tb, k + tb - 1), tb, tb, tb)
    if not _fits(tile, smem):
        raise ValueError(f"route_passes: a tile of 2^{tb} values does not fit one pass")
    return tuple(high(list(range(0, k - tb))) + [tile] + high(list(range(k + tb - 1, S))))


def benes_route_plain(v: torch.Tensor, masks_packed: torch.Tensor, k: int) -> torch.Tensor:
    """The route in plain torch: the stage loop over the unpacked masks."""
    return apply_benes(v, unpack_masks(masks_packed, 2 * k - 1), k)


def benes_apply_plain(v: torch.Tensor, outer, packed: torch.Tensor, k: int) -> torch.Tensor:
    """A whole plan in plain torch: the stage loop over its (2k-1, 2^k) masks."""
    return apply_benes(v, route_masks(outer, packed, k), k)


_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = load_library().benes_pass_f32
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [ptr] * 4 + [i64] * 7 + [ctypes.POINTER(i64), i64, ctypes.POINTER(i64), ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _pass_arrays(p: RoutePass):
    rows = [x for r, w in zip(p.rows, p.row_words()) for x in r + w]
    groups = []
    for s0, n in p.groups:
        lbs = [st[0] for st in p.stages[s0 : s0 + n]]
        groups += [s0, n] + lbs + [0] * (4 - n)
    return (ctypes.c_int64 * len(rows))(*rows), (ctypes.c_int64 * len(groups))(*groups)


def _check(v: torch.Tensor, outer, packed: torch.Tensor, k: int, out):
    if v.dtype != torch.float32 or packed.dtype != torch.uint8 or (outer is not None and outer.dtype != torch.uint8):
        raise AoclSparseError(
            Status.wrong_type, f"the route kernel takes float32 values and uint8 masks, got {v.dtype}, {packed.dtype}"
        )
    nets = packed.shape[0] if packed.dim() == 3 else 0
    d = nets.bit_length() - 1
    kc = k - d
    n = 1 << k
    if (
        v.dim() != 1
        or v.shape[0] != n
        or nets != 1 << d
        or kc < 7
        or tuple(packed.shape[1:]) != (-(-(2 * kc - 1) // 8), 1 << kc)
        or (d > 0) != (outer is not None)
        or (outer is not None and tuple(outer.shape) != (2 * d, n))
    ):
        raise AoclSparseError(
            Status.invalid_size,
            f"a route of k={k} takes 2^k values, 2^d packed networks (2^d, ceil((2kc-1)/8), 2^kc) with kc = k - d "
            ">= 7, and (2d, 2^k) outer rows when d > 0",
        )
    ts = [t for t in (v, packed, outer, out) if t is not None]
    if any(t.device != v.device for t in ts):
        raise AoclSparseError(Status.invalid_value, "v, masks and out must share a device")
    if not all(t.is_contiguous() for t in ts):
        raise AoclSparseError(Status.invalid_value, "v, the masks and out must be contiguous")
    if out is not None and (out.shape != v.shape or out.dtype != v.dtype):
        raise AoclSparseError(Status.invalid_value, "out must be a float32 tensor shaped as v")
    if v.device.type not in ("cpu", "cuda"):
        raise AoclSparseError(Status.not_implemented, f"no route kernel for {v.device}")
    return d


def benes_apply(v: torch.Tensor, outer, packed: torch.Tensor, k: int, out=None) -> torch.Tensor:
    """Route v (2^k float32) through an (outer, packed) plan: the passes of
    `route_passes`, the first from v, the rest in place; writes `out` (may
    be v) or a new tensor."""
    d = _check(v, outer, packed, k, out)
    if v.device.type == "cpu":
        res = benes_apply_plain(v, outer, packed, k)
        return res if out is None else out.copy_(res)
    if any(t.data_ptr() % 16 for t in (v, packed, outer, out) if t is not None):
        raise AoclSparseError(Status.invalid_value, "the route kernel needs 16-byte aligned operands")
    dst = torch.empty_like(v) if out is None else out
    kc = k - d
    fn = _entry()
    src = v
    stream = torch.cuda.current_stream(v.device).cuda_stream
    outer_ptr = None if outer is None else outer.data_ptr()
    with torch.cuda.device(v.device):
        for p in route_passes(k, d, smem=PASS_SMEM):
            rows, groups = _pass_arrays(p)
            rc = fn(src.data_ptr(), dst.data_ptr(), outer_ptr, packed.data_ptr(), k, kc, packed.shape[1],
                    p.c, p.blo, p.bhi, len(p.rows), rows, len(p.groups), groups, stream)
            if rc != 0:
                raise RuntimeError(f"benes_pass_f32 launch failed: CUDA error {rc}")
            benes_route.launches["f32"] += 1
            src = dst
    return dst


def benes_route(v: torch.Tensor, masks_packed: torch.Tensor, k: int, out=None) -> torch.Tensor:
    """Route v (2^k float32, 7 <= k <= 20) through one packed network;
    writes `out` (may be v) or a new tensor."""
    if masks_packed.dim() != 2 or not 7 <= k <= 20:
        raise AoclSparseError(Status.invalid_size, f"a packed route of k={k} takes 2^k values and ceil((2k-1)/8) rows")
    return benes_apply(v, None, masks_packed[None], k, out=out)


benes_route.launches = {"f32": 0}
benes_apply.launches = benes_route.launches
