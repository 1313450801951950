"""Sparse storage formats as tensor dataclasses.

PyTorch counterpart of ``aoclsparse_tpu/core/formats.py``, for CSR only:
the other formats of the JAX package arrive with the slices that use them
(ROADMAP.md queue 1). All index arrays are zero-based; index-base
conversion happens in create/export (core/matrix.py), as the reference
zero-bases when it builds its clean CSR (aoclsparse_csr_util.hpp:764-945).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .types import AoclSparseError, Status, index_dtype

__all__ = ["CSR"]


def _as_idx(a: torch.Tensor) -> torch.Tensor:
    if a.dtype.is_floating_point or a.dtype.is_complex or a.dtype == torch.bool:
        raise AoclSparseError(Status.wrong_type, f"index array has dtype {a.dtype}")
    if a.dtype not in (torch.int32, torch.int64):
        a = a.to(index_dtype)
    return a


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row, the canonical compute format
    (docs/storage.rst:29-47).

    ptr: (m+1,) int — row start offsets; ind: (nnz,) int — column indices;
    val: (nnz,) — values. All three live on one device.
    """

    ptr: torch.Tensor
    ind: torch.Tensor
    val: torch.Tensor
    shape: Tuple[int, int] = (0, 0)

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.ind.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    def __post_init__(self):
        object.__setattr__(self, "ptr", _as_idx(self.ptr))
        object.__setattr__(self, "ind", _as_idx(self.ind))

