"""Planner: hint registration and the hint/optimize analog."""

from .hints import (  # noqa: F401
    set_lu_smoother_hint,
    set_memory_hint,
    set_mm_hint,
    set_mv_hint,
    set_sm_hint,
    set_sv_hint,
)
from .plan import get_plan, optimize  # noqa: F401
