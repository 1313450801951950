"""Sparse BLAS operations."""

from .level1 import axpyi, dotci, doti, dotui, gthr, gthrs, gthrz, roti, sctr, sctrs  # noqa: F401
from .level2 import (  # noqa: F401
    MvOperator,
    blkcsrmv,
    bsrmv,
    csrmv,
    csrsv,
    diamv,
    dotmv,
    ellmv,
    ellthybmv,
    elltmv,
    mv,
    mv_operator,
    trsv,
    trsv_strided,
)
from .level3 import add, csr2m, mm, sp2m, sp2md, spmm, spmmd, sypr, syprd, syrk, syrkd, trsm  # noqa: F401
