"""Streaming-read probe: the hand-written Hopper kernel that sums a float32
slab (``csrc/stream_read.cu``, built by ``kernels/build.py``), and its plain
PyTorch version.

Contract: ``stream_read(v)`` is the float32 sum of every value of the
contiguous float32 tensor ``v`` (an (R, C) slab in the JAX package's use),
returned as a 0-d float32 tensor on v's device. It replaces the JAX
package's ``pallas_stream_read`` (kernels/pallas/spmv.py:364), the
achievable-read-rate calibrator of ``bench.py:320-350``: its time gives the
card's own read rate beside the data-sheet peak.

`stream_read` has one rule: a CPU tensor takes `stream_read_plain`, a CUDA
tensor launches the kernel or raises. ``stream_read.launches`` counts
kernel launches (one a call; the call runs the kernel's two passes).
The library call that computes the same function is ``torch.sum``, which
the port never calls for it.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library

__all__ = ["stream_read", "stream_read_plain"]

#: CTAs of pass 1 an SM (the kernel's pass 2 reduces at most 1024 partials)
CTAS_PER_SM = 4

_fns = {}


def _entry():
    fn = _fns.get("stream_read_f32")
    if fn is None:
        fn = load_library().stream_read_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["stream_read_f32"] = fn
    return fn


def stream_read_plain(v: torch.Tensor, TM: int = 2048) -> torch.Tensor:
    """The JAX kernel's order in plain PyTorch: v seen as (R, C) (a 1-D v
    as one row), C zero-padded to a multiple of TM, the float32 sum of each
    (R, TM) column tile, then the sum of the tile sums."""
    v2 = v.reshape(-1, v.shape[-1]) if v.dim() else v.reshape(1, 1)
    R, C = v2.shape
    ntile = max(1, -(-C // TM))
    pad = torch.zeros(R, ntile * TM, dtype=torch.float32, device=v.device)
    pad[:, :C] = v2
    return pad.reshape(R, ntile, TM).sum(dim=(0, 2)).sum()


def stream_read(v: torch.Tensor) -> torch.Tensor:
    """The float32 sum of v: the plain version on a CPU tensor, one kernel
    launch on a CUDA tensor (current stream, not synchronised). v must be
    float32, contiguous and, on the card, 16-byte aligned."""
    if v.dtype != torch.float32:
        raise AoclSparseError(Status.wrong_type, f"stream_read has an f32 instance only, got {v.dtype}")
    if not v.is_contiguous():
        raise AoclSparseError(Status.invalid_value, "stream_read needs a contiguous tensor")
    if v.device.type == "cpu":
        return stream_read_plain(v)
    if v.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no stream_read kernel for {v.device}")
    if v.data_ptr() % 16:
        raise AoclSparseError(Status.invalid_value, "stream_read needs a 16-byte aligned tensor")
    N = v.numel()
    sms = torch.cuda.get_device_properties(v.device).multi_processor_count
    nblocks = max(1, min(CTAS_PER_SM * sms, 1024, -(-N // (4 * 256))))
    partials = torch.empty(nblocks, dtype=torch.float32, device=v.device)
    out = torch.empty((), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _entry()(v.data_ptr(), partials.data_ptr(), out.data_ptr(), N, nblocks,
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stream_read_f32 launch failed: CUDA error {rc}")
    stream_read.launches["f32"] += 1
    return out


stream_read.launches = {"f32": 0}

