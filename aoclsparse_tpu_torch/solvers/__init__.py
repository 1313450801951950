"""Iterative solvers."""

from .fused import pcg_solve  # noqa: F401
