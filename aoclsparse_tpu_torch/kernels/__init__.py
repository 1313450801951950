"""The kernel wrappers, their plain versions, the registry and the tuners."""

from .autotune import autotune_mm, autotune_mv, autotune_spgemm, autotune_trsv  # noqa: F401
