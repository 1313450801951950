"""Level-2 sparse BLAS."""

from .mv import dotmv, mv  # noqa: F401
from .trsv import csrsv, trsv, trsv_strided  # noqa: F401
