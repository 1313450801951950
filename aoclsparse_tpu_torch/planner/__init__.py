"""Planner: hint registration and the hint/optimize analog."""

from .hints import set_mv_hint  # noqa: F401
from .plan import get_plan, optimize  # noqa: F401
