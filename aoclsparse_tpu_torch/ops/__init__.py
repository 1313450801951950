"""Sparse BLAS operations."""

from .level2 import dotmv, mv  # noqa: F401
