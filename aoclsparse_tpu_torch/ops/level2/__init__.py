"""Level-2 sparse BLAS."""

from .mv import dotmv, mv  # noqa: F401
