"""Planner: hint registration and the hint/optimize analog."""

from .hints import set_lu_smoother_hint, set_mv_hint, set_sv_hint  # noqa: F401
from .plan import get_plan, optimize  # noqa: F401
