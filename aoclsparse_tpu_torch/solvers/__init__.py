"""Iterative solvers and smoothers."""

from .fused import pcg_solve  # noqa: F401
from .ilu import ilu0_factorize, ilu_smoother  # noqa: F401
from .sorv import sorv  # noqa: F401
from .symgs import symgs, symgs_mv  # noqa: F401
