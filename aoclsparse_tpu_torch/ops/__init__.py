"""Sparse BLAS operations."""

from .level2 import csrsv, dotmv, mv, trsv, trsv_strided  # noqa: F401
from .level3 import mm, trsm  # noqa: F401
