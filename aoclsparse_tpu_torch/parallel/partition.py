"""Mesh partitioning utilities: nnz-balanced row splits (a copy of the JAX
package's parallel/partition.py; host numpy, no JAX).

The reference's OpenMP row split is static and row-count-based
(level3/aoclsparse_csr2m.cpp:89-101 `start = m*tid/nthreads`); on a mesh
with skewed matrices (power-law rows) that leaves devices idle while one
grinds the heavy rows. The planner instead splits on the CUMULATIVE NNZ
curve so every shard holds ~equal work (SURVEY.md §5.8(i) requirement).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["nnz_balanced_bounds", "pack_balanced_ell"]


def nnz_balanced_bounds(ptr, n_parts: int, align: int = 8) -> np.ndarray:
    """Row boundaries (n_parts+1,) with ~equal nnz per part.

    Boundaries are aligned down to `align` rows (8 by default, the JAX
    package's, so both packages cut the same rows) except the last; monotonicity is enforced so empty parts are legal for extreme
    skew."""
    ptr = np.asarray(ptr, dtype=np.int64)
    m = ptr.size - 1
    nnz = int(ptr[-1])
    targets = (np.arange(1, n_parts) * (nnz / n_parts)).astype(np.int64)
    cuts = np.searchsorted(ptr, targets, side="left")
    cuts = (cuts // align) * align
    bounds = np.concatenate([[0], cuts, [m]])
    return np.maximum.accumulate(bounds)


def pack_balanced_ell(ptr, ind, n_parts: int, bounds=None) -> Tuple:
    """Stack per-part padded-ELL blocks, one a rank.

    Returns (ell_src, ell_ind, rows_per_part, bounds):
      ell_src  (n_parts, mloc, w) int64 positions into the CSR value array
               (-1 = padding) — the value-refresh map,
      ell_ind  (n_parts, mloc, w) int32 column ids (-1 = padding),
      mloc = max rows of any part, w = max row length over the matrix.
    """
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind)
    m = ptr.size - 1
    if bounds is None:
        bounds = nnz_balanced_bounds(ptr, n_parts)
    lens = np.diff(ptr)
    w = max(1, int(lens.max()) if m else 1)
    mloc = max(1, int(np.diff(bounds).max()))
    src = np.full((n_parts, mloc, w), -1, dtype=np.int64)
    out_ind = np.full((n_parts, mloc, w), -1, dtype=np.int32)
    cols_grid = np.arange(w)[None, :]
    for p in range(n_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        if hi <= lo:
            continue
        ll = lens[lo:hi]
        valid = cols_grid < ll[:, None]
        offs = ptr[lo:hi, None] + cols_grid
        s = np.where(valid, offs, -1)
        src[p, : hi - lo] = s
        out_ind[p, : hi - lo] = np.where(valid, ind[np.clip(s, 0, None)], -1)
    return src, out_ind, mloc, bounds
