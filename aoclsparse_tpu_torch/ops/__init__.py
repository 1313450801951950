"""Sparse BLAS operations."""

from .level2 import MvOperator, csrsv, dotmv, mv, mv_operator, trsv, trsv_strided  # noqa: F401
from .level3 import add, csr2m, mm, sp2m, sp2md, spmm, spmmd, sypr, syprd, syrk, syrkd, trsm  # noqa: F401
