"""Level-2 sparse BLAS."""

from .format_mv import blkcsrmv, bsrmv, csrmv, diamv, ellmv, ellthybmv, elltmv  # noqa: F401
from .mv import MvOperator, dotmv, mv, mv_operator  # noqa: F401
from .trsv import csrsv, trsv, trsv_strided  # noqa: F401
