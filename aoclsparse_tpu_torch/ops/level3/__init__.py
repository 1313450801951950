"""Level-3 operations: SpMM, the multi-RHS triangular solve and the
SpGEMM family."""

from .csrmm import mm  # noqa: F401
from .spgemm import add, csr2m, sp2m, sp2md, spmm, spmmd, sypr, syprd, syrk, syrkd  # noqa: F401
from .trsm import trsm  # noqa: F401
