"""Matrix I/O (Matrix Market, the reference bench harness's input format),
plan snapshots and handle checkpoints."""

from .checkpoint import load_matrix, save_matrix  # noqa: F401
from .mm import read_mtx, read_mtx_arrays, write_mtx  # noqa: F401
from .plancache import load_plan, save_plan  # noqa: F401
