"""Auxiliary API: handle-level conversions, introspection and the
per-handle precision policy.

PyTorch counterpart of ``aoclsparse_tpu/core/auxiliary.py:27-138``.
Reference: src/extra/aoclsparse_auxiliary.cpp (enable_instructions :53,
debug_get :116, is_avx512_build) and the handle-level convert_csr /
convert_bsr (conversion/aoclsparse_convert.cpp:1004-1471).
"""

from __future__ import annotations

import os
from typing import Optional

from .context import get_context, reset_context
from .matrix import SparseMatrix
from .types import AoclSparseError, FormatType, Operation, Status

__all__ = [
    "convert_bsr",
    "convert_csr",
    "convert_format",
    "debug_get",
    "enable_instructions",
    "is_tpu_build",
    "set_precision_mode",
]


def convert_csr(h: SparseMatrix, op: Operation = Operation.none) -> SparseMatrix:
    """A new CSR handle holding op(A) (aoclsparse_convert_csr,
    conversion/aoclsparse_convert.cpp:1004), on A's device."""
    from ..convert import conversions as cv

    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix")
    return SparseMatrix(cv.csr_apply_operation(cv.to_csr(h.data), op), FormatType.csr, h.base)


def convert_bsr(h: SparseMatrix, block_dim: int, op: Operation = Operation.none) -> SparseMatrix:
    """A new BSR handle of op(A) in (block_dim, block_dim) blocks
    (aoclsparse_convert_bsr)."""
    from ..convert import conversions as cv

    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix")
    if block_dim <= 0:
        raise AoclSparseError(Status.invalid_size, "block_dim must be positive")
    A = cv.csr_apply_operation(cv.to_csr(h.data), op)
    return SparseMatrix(cv.csr_to_bsr(A, block_dim), FormatType.bsr, h.base)


def convert_format(h: SparseMatrix, fmt: FormatType, op: Operation = Operation.none, **kw) -> SparseMatrix:
    """A new handle of op(A) in `fmt`: CSR, BSR (block_dim=, default 2),
    CSC, COO, ELL or DIA; other formats give not_implemented."""
    from ..convert import conversions as cv

    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    try:
        fmt = FormatType(fmt)
    except ValueError:
        raise AoclSparseError(Status.invalid_value, f"unknown format {fmt!r}") from None
    if fmt == FormatType.csr:
        return convert_csr(h, op)
    if fmt == FormatType.bsr:
        return convert_bsr(h, kw.get("block_dim", 2), op)
    A = cv.csr_apply_operation(cv.to_csr(h.data), op)
    build = {
        FormatType.csc: cv.to_csc,
        FormatType.coo: cv.to_coo,
        FormatType.ell: cv.csr_to_ell,
        FormatType.dia: cv.csr_to_dia,
    }.get(fmt)
    if build is None:
        raise AoclSparseError(Status.not_implemented, f"convert to {fmt.name}")
    return SparseMatrix(build(A), fmt, h.base)


def debug_get() -> dict:
    """Runtime introspection (aoclsparse_debug_get analog: ISA, arch and
    threads there; the device, its HBM peak and the libraries here)."""
    from .. import __version__, native

    ctx = get_context()
    return {
        "version": __version__,
        "platform": ctx.platform,
        "device_kind": ctx.device_kind,
        "compute_capability": ctx.sm,
        "hbm_peak_gbps": ctx.hbm_gbps,
        "native_host_kernels": native.available(),
        "force_kid": ctx.force_kid,
    }


def is_tpu_build() -> bool:
    """aoclsparse_is_avx512_build analog of the JAX package: False here, this
    package runs on CUDA cards."""
    return False


def enable_instructions(mode: Optional[str]) -> None:
    """Kernel-path override (aoclsparse_enable_instructions analog), the JAX
    package's modes: "generic" sets AOCLSPARSE_TPU_FORCE_GENERIC, which
    makes the planner's mv choice a gather form (planner/plan.py
    choose_mv_format) for plans built after it; None, "" or "auto" clears
    it. Each resets the cached context."""
    if mode in (None, "", "auto"):
        os.environ.pop("AOCLSPARSE_TPU_DISABLE_PALLAS", None)
        os.environ.pop("AOCLSPARSE_TPU_FORCE_GENERIC", None)
    elif mode == "generic":
        os.environ["AOCLSPARSE_TPU_FORCE_GENERIC"] = "1"
    else:
        raise AoclSparseError(Status.invalid_value, f"unknown instruction mode '{mode}'")
    reset_context()


def set_precision_mode(h: SparseMatrix, mode: str) -> None:
    """Per-handle precision policy opt-in (docs/precision.md; no reference
    analog — its kernels are fixed-precision by dtype suffix):

      "full"  — every multiply in the operand dtype (default)
      "mixed" — on float32 handles, the band and group-window SpMV (mv KIDs
                12 and 5) stream a bfloat16 copy of the band and accumulate
                in float32, halving the band's bytes at the error bound of
                docs/precision.md; mm streams bf16 block windows, groups and
                diagonals (KIDs 5, 3, 7)

    The AOCLSPARSE_TPU_MIXED_PRECISION variable overrides the mode in both
    directions ("1" forces it on, "0" off)."""
    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    if mode not in ("full", "mixed"):
        raise AoclSparseError(Status.invalid_value, f"unknown precision mode '{mode}'")
    h.precision_mode = mode
