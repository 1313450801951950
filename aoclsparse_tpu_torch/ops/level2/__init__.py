"""Level-2 sparse BLAS."""

from .mv import MvOperator, dotmv, mv, mv_operator  # noqa: F401
from .trsv import csrsv, trsv, trsv_strided  # noqa: F401
