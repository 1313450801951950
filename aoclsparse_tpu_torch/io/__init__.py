"""Matrix I/O (Matrix Market, the reference bench harness's input format)."""

from .mm import read_mtx, read_mtx_arrays, write_mtx  # noqa: F401
