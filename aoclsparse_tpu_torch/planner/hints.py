"""Hint registration API (aoclsparse_set_*_hint family,
library/src/analysis/aoclsparse_analysis.cpp:595-777).

PyTorch counterpart of ``aoclsparse_tpu/planner/hints.py:60-106``. A
setter validates the descriptor/operation and prepends a Hint node to the
handle's hint list; `optimize()` (planner/plan.py) then walks the list and
prebuilds the effective CSR copies and execution forms. A hint's KID
(`set_mv_hint_kid`) is stored and not acted on, as in the JAX planner: the
kid of the call picks the kernel. The triangular
solve forms and the ILU0 factors are built lazily by their first call, as
in the JAX package.
"""

from __future__ import annotations

from typing import Optional

from ..core.descr import MatrixDescriptor
from ..core.matrix import Hint, SparseMatrix
from ..core.types import AoclSparseError, MemoryPolicy, Operation, Status
from ..core.validate import check_base_match

__all__ = [
    "set_2m_hint",
    "set_dotmv_hint",
    "set_lu_smoother_hint",
    "set_memory_hint",
    "set_mm_hint",
    "set_mv_hint",
    "set_mv_hint_kid",
    "set_sm_hint",
    "set_sorv_hint",
    "set_sv_hint",
    "set_symgs_hint",
]


def _set_hint(
    A: SparseMatrix,
    action: str,
    trans: Operation,
    descr: MatrixDescriptor,
    kid: Optional[int],
    nop: int,
) -> None:
    if A is None or descr is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix or descriptor")
    descr.validate()
    Operation(trans)
    # reference: descriptor base must agree with the matrix base
    # (aoclsparse_set_hint, analysis.cpp:612-619)
    check_base_match(A, descr)
    # reference: nop < 0 invalid; nop == 0 only valid with an explicit kid
    # (analysis.cpp:643-646)
    if nop < 0 or (nop == 0 and kid is None):
        raise AoclSparseError(
            Status.invalid_value, "expected_no_of_calls must be > 0 (or a kid given)"
        )
    A.add_hint(Hint(action=action, trans=Operation(trans), descr=descr, kid=kid, nop=nop))


def set_mv_hint(A, trans, descr, nop: int = 1, kid: Optional[int] = None) -> None:
    _set_hint(A, "mv", trans, descr, kid, nop)


def set_mv_hint_kid(A, trans, descr, nop: int, kid: int) -> None:
    """aoclsparse_set_mv_hint_kid: set_mv_hint with the kid required."""
    _set_hint(A, "mv", trans, descr, kid, nop)


def set_dotmv_hint(A, trans, descr, nop: int = 1, kid: Optional[int] = None) -> None:
    _set_hint(A, "dotmv", trans, descr, kid, nop)


def set_2m_hint(A, trans, descr, nop: int = 1, kid: Optional[int] = None) -> None:
    _set_hint(A, "2m", trans, descr, kid, nop)


def set_sv_hint(A, trans, descr, nop: int = 1, kid: Optional[int] = None) -> None:
    _set_hint(A, "sv", trans, descr, kid, nop)


def set_lu_smoother_hint(A, trans, descr, nop: int = 1, kid: Optional[int] = None) -> None:
    _set_hint(A, "lu_smoother", trans, descr, kid, nop)


def set_mm_hint(A, trans, descr, nop: int = 1, kid: Optional[int] = None) -> None:
    _set_hint(A, "mm", trans, descr, kid, nop)


def set_sm_hint(A, trans, descr, nop: int = 1, kid: Optional[int] = None) -> None:
    _set_hint(A, "sm", trans, descr, kid, nop)


def set_symgs_hint(A, trans, descr, nop: int = 1, kid: Optional[int] = None) -> None:
    _set_hint(A, "symgs", trans, descr, kid, nop)


def set_sorv_hint(A, trans, descr, nop: int = 1, kid: Optional[int] = None) -> None:
    _set_hint(A, "sorv", trans, descr, kid, nop)


def set_memory_hint(A, policy: MemoryPolicy) -> None:
    """aoclsparse_set_memory_hint: restricted forbids format copies."""
    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix")
    A.mem_policy = MemoryPolicy(policy)
