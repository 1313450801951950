"""Planner: hint registration and the hint/optimize analog."""

from .hints import (  # noqa: F401
    set_2m_hint,
    set_dotmv_hint,
    set_lu_smoother_hint,
    set_memory_hint,
    set_mm_hint,
    set_mv_hint,
    set_mv_hint_kid,
    set_sm_hint,
    set_sorv_hint,
    set_sv_hint,
    set_symgs_hint,
)
from .plan import get_plan, optimize  # noqa: F401
