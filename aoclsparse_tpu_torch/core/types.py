"""Core type system: enums, status codes, exceptions, dtype policy.

PyTorch counterpart of ``aoclsparse_tpu/core/types.py``. The 15-value status
enum, the exception carrying it and every enum keep the JAX package's names
and values, so a caller can move between the two packages without changing
how errors are handled. The dtype helpers speak ``torch.dtype``; numpy dtypes
are accepted wherever a dtype comes in, because host arrays are how operands
arrive.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = [
    "Status",
    "AoclSparseError",
    "Operation",
    "IndexBase",
    "MatrixType",
    "FillMode",
    "DiagType",
    "Order",
    "FormatType",
    "Request",
    "SorType",
    "MemoryPolicy",
    "MatrixSort",
    "IluType",
    "index_dtype",
    "to_torch_dtype",
    "is_complex_dtype",
    "real_dtype_of",
    "check_value_dtype",
]


class Status(enum.IntEnum):
    """Status codes, mirroring aoclsparse_status (aoclsparse_types.h:303-323)."""

    success = 0
    invalid_handle = 1
    not_implemented = 2
    invalid_pointer = 3
    invalid_size = 4
    internal_error = 5
    invalid_value = 6
    invalid_index_value = 7
    maxit = 8
    user_stop = 9
    wrong_type = 10
    memory_error = 11
    numerical_error = 12
    invalid_operation = 13
    unsorted_input = 14
    invalid_kid = 15


class AoclSparseError(Exception):
    """Exception carrying a :class:`Status` (the reference returns the
    status code from every C entry point)."""

    def __init__(self, status: Status, message: str = ""):
        self.status = Status(status)
        super().__init__(f"[{self.status.name}] {message}" if message else self.status.name)


class Operation(enum.IntEnum):
    """Transposition applied to the sparse operand (aoclsparse_operation)."""

    none = 111
    transpose = 112
    conjugate_transpose = 113

    @property
    def short(self) -> str:
        return {111: "n", 112: "t", 113: "h"}[int(self)]


class IndexBase(enum.IntEnum):
    zero = 0
    one = 1


class MatrixType(enum.IntEnum):
    general = 0
    symmetric = 1
    hermitian = 2
    triangular = 3


class FillMode(enum.IntEnum):
    lower = 0
    upper = 1


class DiagType(enum.IntEnum):
    non_unit = 0
    unit = 1
    zero = 2  # structurally-zero diagonal (reference: aoclsparse_diag_type_zero)


class Order(enum.IntEnum):
    """Dense storage order for SpMM / dense outputs."""

    row = 0
    column = 1


class FormatType(enum.IntEnum):
    """Storage formats, numbered as in the JAX package. This package creates
    CSR handles only; the other values exist so that enum round-trips
    between the packages keep their meaning."""

    csr = 0
    csc = 1
    coo = 2
    ell = 3
    dia = 4
    bsr = 5
    ellhyb = 6
    sell = 7
    tcsr = 8


class Request(enum.IntEnum):
    """Two-stage SpGEMM request protocol (aoclsparse_types.h:334-346)."""

    nnz_count = 0
    finalize = 1
    full_computation = 2


class SorType(enum.IntEnum):
    forward = 0
    backward = 1
    symmetric = 2


class MemoryPolicy(enum.IntEnum):
    unrestricted = 0
    restricted = 1


class MatrixSort(enum.IntEnum):
    unknown = 0
    unsorted = 1
    partially_sorted = 2
    fully_sorted = 3


class IluType(enum.IntEnum):
    ilu0 = 0
    ilup = 1  # placeholder, like the reference (types.h:217-222)


# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------

#: Default index dtype of device index arrays; int64 is accepted as given.
index_dtype = torch.int32

_SUPPORTED = (
    torch.float32,
    torch.float64,
    torch.complex64,
    torch.complex128,
    torch.bfloat16,
    torch.float16,
)

_FROM_NUMPY = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` for a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":  # ml_dtypes' numpy bfloat16
        return torch.bfloat16
    try:
        return _FROM_NUMPY[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise AoclSparseError(Status.wrong_type, f"unsupported dtype {dtype}") from None


def check_value_dtype(dtype) -> torch.dtype:
    dt = to_torch_dtype(dtype)
    if dt not in _SUPPORTED:
        raise AoclSparseError(Status.wrong_type, f"unsupported value dtype {dt}")
    return dt


def is_complex_dtype(dtype) -> bool:
    return to_torch_dtype(dtype).is_complex


def real_dtype_of(dtype) -> torch.dtype:
    dt = to_torch_dtype(dtype)
    if dt == torch.complex64:
        return torch.float32
    if dt == torch.complex128:
        return torch.float64
    return dt
