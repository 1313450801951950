"""Matrix descriptor + DOID classification.

PyTorch counterpart of ``aoclsparse_tpu/core/descr.py``; it holds no arrays,
so the code is the same. Reference: `_aoclsparse_mat_descr`
(library/src/include/aoclsparse_descr.h:37-47) and the DOID classifier
(library/src/include/aoclsparse_mtx_dispatcher.hpp:39-149), which flattens
(matrix_type x fill_mode x operation) into 20 descriptor+operation IDs used
as a registry key by the planner and dispatcher.
"""

from __future__ import annotations

import dataclasses
import enum

from .types import (
    AoclSparseError,
    DiagType,
    FillMode,
    IndexBase,
    MatrixType,
    Operation,
    Status,
    is_complex_dtype,
)

__all__ = ["MatrixDescriptor", "Doid", "get_doid", "trans_doid", "GENERAL"]


@dataclasses.dataclass(frozen=True)
class MatrixDescriptor:
    """Immutable, hashable descriptor (a planner cache key)."""

    type: MatrixType = MatrixType.general
    fill_mode: FillMode = FillMode.lower
    diag_type: DiagType = DiagType.non_unit
    base: IndexBase = IndexBase.zero

    def with_(self, **kw) -> "MatrixDescriptor":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        MatrixType(self.type)
        FillMode(self.fill_mode)
        DiagType(self.diag_type)
        IndexBase(self.base)


GENERAL = MatrixDescriptor()


class Doid(enum.IntEnum):
    """Descriptor+operation IDs (mtx_dispatcher.hpp:39-72 equivalents).

    g=general, s=symmetric, h=hermitian, t=triangular;
    n/t/h = none/transpose/conj-transpose; l/u = lower/upper; c = conjugated.
    """

    gn = 0
    gt = 1
    gh = 2
    gc = 3  # general conjugate (no transpose)
    sl = 4
    su = 5
    slc = 6
    suc = 7
    hl = 8
    hu = 9
    hlc = 10
    huc = 11
    tln = 12
    tlt = 13
    tlh = 14
    tlc = 15
    tun = 16
    tut = 17
    tuh = 18
    tuc = 19


def get_doid(descr: MatrixDescriptor, op: Operation, dtype=None) -> Doid:
    """Flatten (descriptor, operation) into a Doid.

    Mirrors get_doid<T> (mtx_dispatcher.hpp:74-149): for real dtypes,
    conjugate-transpose degrades to transpose and hermitian to symmetric.
    """
    op = Operation(op)
    cplx = is_complex_dtype(dtype) if dtype is not None else True
    if not cplx and op == Operation.conjugate_transpose:
        op = Operation.transpose
    mtype = MatrixType(descr.type)
    if not cplx and mtype == MatrixType.hermitian:
        mtype = MatrixType.symmetric
    lower = FillMode(descr.fill_mode) == FillMode.lower

    if mtype == MatrixType.general:
        return {
            Operation.none: Doid.gn,
            Operation.transpose: Doid.gt,
            Operation.conjugate_transpose: Doid.gh,
        }[op]
    if mtype == MatrixType.symmetric:
        # symmetric: transpose is a no-op; conj-transpose = conjugated symmetric
        if op == Operation.conjugate_transpose:
            return Doid.slc if lower else Doid.suc
        return Doid.sl if lower else Doid.su
    if mtype == MatrixType.hermitian:
        if op == Operation.conjugate_transpose:
            return Doid.hl if lower else Doid.hu  # A^H = A for hermitian
        if op == Operation.transpose:
            return Doid.hlc if lower else Doid.huc  # A^T = conj(A)
        return Doid.hl if lower else Doid.hu
    if mtype == MatrixType.triangular:
        if lower:
            return {
                Operation.none: Doid.tln,
                Operation.transpose: Doid.tlt,
                Operation.conjugate_transpose: Doid.tlh,
            }[op]
        return {
            Operation.none: Doid.tun,
            Operation.transpose: Doid.tut,
            Operation.conjugate_transpose: Doid.tuh,
        }[op]
    raise AoclSparseError(Status.invalid_value, f"bad matrix type {mtype}")


_TRANS_MAP = {
    Doid.gn: Doid.gt,
    Doid.gt: Doid.gn,
    Doid.gh: Doid.gc,
    Doid.gc: Doid.gh,
    Doid.sl: Doid.su,
    Doid.su: Doid.sl,
    Doid.slc: Doid.suc,
    Doid.suc: Doid.slc,
    Doid.hl: Doid.hu,
    Doid.hu: Doid.hl,
    Doid.hlc: Doid.huc,
    Doid.huc: Doid.hlc,
    Doid.tln: Doid.tut,
    Doid.tut: Doid.tln,
    Doid.tlt: Doid.tun,
    Doid.tun: Doid.tlt,
    Doid.tlh: Doid.tuc,
    Doid.tuc: Doid.tlh,
    Doid.tuh: Doid.tlc,
    Doid.tlc: Doid.tuh,
}


def trans_doid(doid: Doid) -> Doid:
    """Map a doid onto the doid that applies when the same data is viewed
    transposed (used to run CSC data through CSR kernels; mirrors
    mtx_dispatcher.hpp trans_doid)."""
    return _TRANS_MAP[Doid(doid)]
