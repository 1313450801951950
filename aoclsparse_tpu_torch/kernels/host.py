"""Host (numpy) SpMV engine, mv KID 11.

PyTorch counterpart of ``aoclsparse_tpu/kernels/host.py``: a vectorized
host CSR SpMV over plan-cached numpy arrays, the role of the reference's
plain scalar kernels (ref_csrmv_gn, level2/aoclsparse_csrmv_kr.hpp:450).
It runs only when a caller asks for it with ``kid=11`` (its registry row has
priority -5, so the Oracle never picks it), and returns a numpy array on the
host.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HOST_MV_KID", "spmv_host_csr"]

#: mv KID of the host engine (kernels/registry.py)
HOST_MV_KID = 11


def spmv_host_csr(ptr: np.ndarray, ind: np.ndarray, val: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y = A @ x over host CSR arrays with np.add.reduceat over the
    non-empty rows only: reduceat returns the element at the start of an
    empty segment instead of 0, so empty rows are left at 0."""
    m = ptr.shape[0] - 1
    dtype = np.result_type(val.dtype, x.dtype)
    y = np.zeros(m, dtype=dtype)
    if ind.shape[0] == 0 or m == 0:
        return y
    prods = (val * x[ind]).astype(dtype, copy=False)
    lens = np.diff(ptr.astype(np.int64))
    nz = lens > 0
    if nz.any():
        y[nz] = np.add.reduceat(prods, ptr[:-1].astype(np.int64)[nz])
    return y
