"""Level-3 operations: SpMM and the multi-RHS triangular solve."""

from .csrmm import mm  # noqa: F401
from .trsm import trsm  # noqa: F401
