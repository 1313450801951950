"""Iterative solvers."""

from .fused import pcg_solve  # noqa: F401
from .ilu import ilu0_factorize, ilu_smoother  # noqa: F401
