"""Runtime context: the device the library runs on.

PyTorch counterpart of ``aoclsparse_tpu/core/context.py`` (itself the analog
of the reference's cpuid/thread context, aoclsparse_context.hpp:130-379).
It detects the CUDA device, its compute capability and the published HBM
peak of its model, which feeds roofline reporting and never correctness.
Detection runs on first use, never at import.

Env override (the AOCL_ENABLE_INSTRUCTIONS analog):

- ``AOCLSPARSE_TPU_FORCE_KID`` — global kernel-id override (debugging)
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional, Tuple

import torch

__all__ = ["Context", "DEFAULT_DEVICE", "get_context", "reset_context", "resolve_device"]

#: Published peak HBM bandwidth (GB/s) by device-name substring, first match
#: wins (NVIDIA data sheets; SXM parts unless named).
_HBM_GBPS = (
    ("H100 PCIe", 2000.0),
    ("H100", 3350.0),
    ("H200", 4800.0),
)

#: Where tensors go when the caller names no device. CPU is used only when
#: the caller names it.
DEFAULT_DEVICE = torch.device("cuda", 0)


def resolve_device(device) -> torch.device:
    return DEFAULT_DEVICE if device is None else torch.device(device)


@dataclasses.dataclass
class Context:
    platform: str  # "cuda" | "cpu"
    device_kind: str
    sm: Optional[Tuple[int, int]]  # compute capability, None off-GPU
    hbm_gbps: Optional[float]  # published peak, None when unknown
    force_kid: Optional[int]


_lock = threading.Lock()
_ctx: Optional[Context] = None


def _detect() -> Context:
    force_kid = os.environ.get("AOCLSPARSE_TPU_FORCE_KID")
    force_kid = int(force_kid) if force_kid is not None else None
    if not torch.cuda.is_available():
        return Context("cpu", "cpu", None, None, force_kid)
    kind = torch.cuda.get_device_name(0)
    hbm = next((bw for key, bw in _HBM_GBPS if key in kind), None)
    return Context(
        platform="cuda",
        device_kind=kind,
        sm=torch.cuda.get_device_capability(0),
        hbm_gbps=hbm,
        force_kid=force_kid,
    )


def get_context() -> Context:
    global _ctx
    if _ctx is None:
        with _lock:
            if _ctx is None:
                _ctx = _detect()
    return _ctx


def reset_context() -> None:
    """Drop the cached context (tests change the environment)."""
    global _ctx
    with _lock:
        _ctx = None
