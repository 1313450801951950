"""Matrix Market I/O.

PyTorch counterpart of ``aoclsparse_tpu/io/mm.py`` (reference: the bench
harness's .mtx reader, tests/include/aoclsparse_init.hpp:451-744). Reads
coordinate real / integer / complex / pattern files with general,
symmetric, hermitian or skew-symmetric storage, and array (dense) files;
the symmetric kinds are expanded to the full pattern, as the reference
reader does. The reader takes a path (``.gz`` read compressed) or the
file's text itself; nothing is fetched.
"""

from __future__ import annotations

import gzip
import io
import warnings
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..convert.conversions import coo_to_csr, to_coo
from ..core.context import resolve_device
from ..core.formats import COO
from ..core.matrix import SparseMatrix, as_values
from ..core.types import AoclSparseError, FormatType, Status
from ..core.validate import host_array

__all__ = ["read_mtx", "read_mtx_arrays", "write_mtx"]


def _open(src):
    """A text stream over a path or over the file's own text."""
    if isinstance(src, str) and src.lstrip().startswith("%%MatrixMarket"):
        return io.StringIO(src)
    p = Path(src)
    return gzip.open(p, "rt") if p.suffix == ".gz" else open(p, "r")


def _parse_tokens(text: str) -> np.ndarray:
    """One C-level parse of a whitespace-separated float stream (np.fromstring's
    text mode, deprecated but far faster than a line loop at SuiteSparse
    scale), with a supported fallback."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return np.fromstring(text, dtype=np.float64, sep=" ")
    except Exception:
        return np.array(text.split(), dtype=np.float64)


def _expand_sym(m, n, row, col, val, sym):
    """Mirror the off-diagonal entries of a symmetric, hermitian (conjugated)
    or skew-symmetric (negated) file."""
    off = row != col
    r2, c2, v2 = col[off], row[off], val[off]
    if sym == "hermitian":
        v2 = np.conj(v2)
    elif sym == "skew-symmetric":
        v2 = -v2
    return np.concatenate([row, r2]), np.concatenate([col, c2]), np.concatenate([val, v2])


def read_mtx_arrays(src) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """Parse a Matrix Market file (path or text) into zero-based COO host
    arrays (m, n, row, col, val), symmetry expanded."""
    with _open(src) as f:
        header = f.readline().strip().split()
        if len(header) < 4 or header[0] != "%%MatrixMarket" or header[1].lower() != "matrix":
            raise AoclSparseError(Status.invalid_value, "bad MatrixMarket header")
        fmt, field = header[2].lower(), header[3].lower()
        sym = header[4].lower() if len(header) > 4 else "general"
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        dims = line.split()
        if fmt == "coordinate":
            m, n, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            width = {"pattern": 2, "complex": 4}.get(field, 3)
            data = np.zeros((0, width))
            if nnz:
                flat = _parse_tokens(f.read())
                if flat.size != nnz * width:
                    raise AoclSparseError(Status.invalid_value, f"expected {nnz} x {width} tokens, got {flat.size}")
                data = flat.reshape(nnz, width)
            row = data[:, 0].astype(np.int64) - 1
            col = data[:, 1].astype(np.int64) - 1
            if field == "pattern":
                val = np.ones(nnz, dtype=np.float64)
            elif field == "complex":
                val = data[:, 2] + 1j * data[:, 3]
            else:
                val = data[:, 2]
        elif fmt == "array":
            m, n = int(dims[0]), int(dims[1])
            flat = np.loadtxt(f, dtype=np.float64)
            flat = flat[:, 0] + 1j * flat[:, 1] if field == "complex" else np.asarray(flat).reshape(-1)
            if sym == "general":
                dense = flat.reshape(n, m).T  # column-major file order
            else:
                # the lower triangle (diagonal included) in column order
                rows_l, cols_l = np.tril_indices(m)
                order = np.lexsort((rows_l, cols_l))
                dense = np.zeros((m, n), dtype=flat.dtype)
                dense[rows_l[order], cols_l[order]] = flat
                mirror = np.tril(dense, -1).T
                if sym == "hermitian":
                    mirror = np.conj(mirror)
                elif sym == "skew-symmetric":
                    mirror = -mirror
                dense = dense + mirror
            row, col = np.nonzero(dense)
            return m, n, row, col, dense[row, col]
        else:
            raise AoclSparseError(Status.not_implemented, f"format '{fmt}'")
    if sym != "general":
        row, col, val = _expand_sym(m, n, row, col, val, sym)
    return m, n, row, col, val


def read_mtx(src, dtype=None, device=None) -> SparseMatrix:
    """A Matrix Market file (path or text) as a zero-based CSR handle on
    `device` (default cuda:0), duplicates summed; `dtype` casts the values
    (numpy dtype)."""
    m, n, row, col, val = read_mtx_arrays(src)
    if dtype is not None:
        val = val.astype(dtype)
    dev = resolve_device(device)
    coo = COO(torch.from_numpy(row.astype(np.int32)).to(dev), torch.from_numpy(col.astype(np.int32)).to(dev),
              as_values(val, dev), shape=(m, n))
    return SparseMatrix(coo_to_csr(coo, sum_duplicates=True), FormatType.csr)


def write_mtx(path, h: SparseMatrix) -> None:
    """Write a handle as a coordinate real (or complex) general file, one
    based, values with 17 significant digits."""
    A = to_coo(h.data)
    val = host_array(A.val)
    cplx = np.iscomplexobj(val)
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {'complex' if cplx else 'real'} general\n")
        f.write(f"{A.m} {A.n} {A.nnz}\n")
        row = host_array(A.row).astype(np.float64) + 1
        col = host_array(A.col).astype(np.float64) + 1
        if cplx:
            np.savetxt(f, np.column_stack([row, col, val.real, val.imag]), fmt="%d %d %.17g %.17g")
        else:
            np.savetxt(f, np.column_stack([row, col, val]), fmt="%d %d %.17g")
