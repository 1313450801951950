"""Auxiliary API: the per-handle precision policy.

PyTorch counterpart of ``aoclsparse_tpu/core/auxiliary.py:121``
(`set_precision_mode`). The rest of that module (handle-level conversions,
introspection) arrives with the slices that need it (ROADMAP.md queue 1).
"""

from __future__ import annotations

from .matrix import SparseMatrix
from .types import AoclSparseError, Status

__all__ = ["set_precision_mode"]


def set_precision_mode(h: SparseMatrix, mode: str) -> None:
    """Per-handle precision policy opt-in (docs/precision.md; no reference
    analog — its kernels are fixed-precision by dtype suffix):

      "full"  — every multiply in the operand dtype (default)
      "mixed" — on float32 handles, the band SpMV (mv KID 12) streams a
                bfloat16 copy of the band and accumulates in float32,
                halving the band's bytes at the error bound of
                docs/precision.md
    """
    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    if mode not in ("full", "mixed"):
        raise AoclSparseError(Status.invalid_value, f"unknown precision mode '{mode}'")
    h.precision_mode = mode
