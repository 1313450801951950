"""Sparse storage formats as tensor dataclasses.

PyTorch counterpart of ``aoclsparse_tpu/core/formats.py:47-326``: CSR, CSC,
COO, ELL, DIA, BSR, SELL and TCSR with the JAX package's layouts (ELL
(m, width) with -1 padding, DIA (ndiag, m) plus the offsets, BSR
(nnzb, bs, bs) row-major blocks), and `nnz_of`. The tensors of one object
live on one device. All index arrays are zero-based; index-base conversion
happens in create/export (core/matrix.py), as the reference zero-bases when
it builds its clean CSR (aoclsparse_csr_util.hpp:764-945).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .types import AoclSparseError, Status, index_dtype

__all__ = ["BSR", "COO", "CSC", "CSR", "DIA", "ELL", "SELL", "TCSR", "nnz_of"]


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



class _Shaped:
    """m, n, dtype and device of a format whose values sit in `val`."""

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device


@dataclasses.dataclass(frozen=True)
class CSC(_Shaped):
    """Compressed sparse column: the column-compressed arrays of an (m, n)
    matrix, i.e. the CSR arrays of its (n, m) transpose (the reference
    stores CSC as transposed CSR, aoclsparse_auxiliary.cpp:366)."""

    ptr: torch.Tensor  # (n+1,)
    ind: torch.Tensor  # (nnz,) row indices
    val: torch.Tensor
    shape: Tuple[int, int] = (0, 0)

    @property
    def nnz(self) -> int:
        return int(self.ind.shape[0])

    def __post_init__(self):
        object.__setattr__(self, "ptr", _as_idx(self.ptr))
        object.__setattr__(self, "ind", _as_idx(self.ind))


@dataclasses.dataclass(frozen=True)
class COO(_Shaped):
    """Coordinate format (docs/storage.rst COO)."""

    row: torch.Tensor  # (nnz,)
    col: torch.Tensor  # (nnz,)
    val: torch.Tensor  # (nnz,)
    shape: Tuple[int, int] = (0, 0)

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def __post_init__(self):
        object.__setattr__(self, "row", _as_idx(self.row))
        object.__setattr__(self, "col", _as_idx(self.col))


@dataclasses.dataclass(frozen=True)
class ELL(_Shaped):
    """ELLPACK: every row padded to `width`; padding entries carry column
    -1 and value 0 (the reference pads with a -1 sentinel too)."""

    ind: torch.Tensor  # (m, width), -1 padding
    val: torch.Tensor  # (m, width)
    width: int = 0
    shape: Tuple[int, int] = (0, 0)


@dataclasses.dataclass(frozen=True)
class DIA(_Shaped):
    """Diagonal storage: `dist` (ndiag,) offsets (negative below the main
    diagonal) and `val` (ndiag, m), val[k, i] = A[i, i + dist[k]]
    (docs/storage.rst DIA; csr2dia at conversion/aoclsparse_convert.cpp:506)."""

    dist: torch.Tensor  # (ndiag,)
    val: torch.Tensor  # (ndiag, m)
    shape: Tuple[int, int] = (0, 0)

    @property
    def ndiag(self) -> int:
        return int(self.dist.shape[0])


@dataclasses.dataclass(frozen=True)
class BSR(_Shaped):
    """Block sparse row with dense row-major (bs, bs) blocks
    (docs/storage.rst BSR; csr2bsr at conversion/aoclsparse_convert.cpp:592).
    `shape` is the element-level shape."""

    ptr: torch.Tensor  # (mb+1,)
    ind: torch.Tensor  # (nnzb,) block-column indices
    val: torch.Tensor  # (nnzb, bs, bs)
    block_dim: int = 1
    shape: Tuple[int, int] = (0, 0)

    @property
    def mb(self) -> int:
        return int(self.ptr.shape[0]) - 1

    @property
    def nnzb(self) -> int:
        return int(self.ind.shape[0])


@dataclasses.dataclass(frozen=True)
class SELL(_Shaped):
    """Sliced ELL: rows in slices of `slice_rows`, each slice padded to its
    own width (a lane multiple), flattened; `slice_ptr` ((nslices+1,)) holds
    the slice offsets into `ind`/`val`, -1 marks padding."""

    slice_ptr: torch.Tensor
    slice_width: torch.Tensor  # (nslices,)
    ind: torch.Tensor  # (total,)
    val: torch.Tensor  # (total,)
    slice_rows: int = 8
    shape: Tuple[int, int] = (0, 0)

    @property
    def nslices(self) -> int:
        return int(self.slice_width.shape[0])


@dataclasses.dataclass(frozen=True)
class TCSR(_Shaped):
    """Triangular CSR: both triangles stored CSR-style with the diagonal in
    each (the reference's tcsr, aoclsparse_mat_structures.hpp:434-456): per
    row, the L part holds the strictly-lower entries then the diagonal, the
    U part the diagonal then the strictly-upper entries. Square, with a full
    diagonal."""

    ptr_L: torch.Tensor  # (m+1,)
    ind_L: torch.Tensor  # (nnz_lower + m,)
    val_L: torch.Tensor
    ptr_U: torch.Tensor  # (m+1,)
    ind_U: torch.Tensor  # (nnz_upper + m,)
    val_U: torch.Tensor
    shape: Tuple[int, int] = (0, 0)

    @property
    def val(self) -> torch.Tensor:
        return self.val_L

    @property
    def nnz(self) -> int:
        # the diagonal is stored in both triangles and counted once
        return int(self.ind_L.shape[0]) + int(self.ind_U.shape[0]) - self.m


def nnz_of(A) -> int:
    """Stored entries of a format object (the JAX package's nnz_of): padding
    excluded for ELL and SELL, every block entry for BSR, the nonzero
    values for DIA."""
    if isinstance(A, (CSR, CSC, COO, TCSR)):
        return A.nnz
    if isinstance(A, (ELL, SELL)):
        return int((A.ind >= 0).sum())
    if isinstance(A, BSR):
        return A.nnzb * A.block_dim * A.block_dim
    if isinstance(A, DIA):
        return int(torch.count_nonzero(A.val))
    raise AoclSparseError(Status.wrong_type, f"nnz_of: unsupported {type(A)}")
