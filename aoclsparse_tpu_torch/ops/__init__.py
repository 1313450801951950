"""Sparse BLAS operations."""

from .level2 import MvOperator, csrsv, dotmv, mv, mv_operator, trsv, trsv_strided  # noqa: F401
from .level3 import mm, trsm  # noqa: F401
