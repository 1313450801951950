"""Scalar NumPy reference implementations used as the correctness oracle.

The port's own copy of ``aoclsparse_tpu/utils/reference.py``, the analog
of the reference's tests/include/aoclsparse_reference.hpp (ref_csrmv at
:517, ref_csr2csc at :36, ref_doti at :867, ...). These are deliberately
naive loop/dense implementations, independent of both packages' planners
and kernels: tests hold the port to them within the tolerance model of
utils/tolerances.py, also where the JAX package itself is at fault
(ROADMAP.md queue 3: its error rows, the deep-DAG triangles).

Everything here consumes plain numpy arrays (zero-based CSR unless noted);
a caller holding tensors passes ``t.cpu().numpy()``.
"""

from __future__ import annotations

import numpy as np

from ..core.descr import MatrixDescriptor
from ..core.types import DiagType, FillMode, MatrixType, Operation

__all__ = [
    "csr_to_dense",
    "effective_dense",
    "ref_mv",
    "ref_trsv",
    "ref_mm",
    "ref_add",
    "ref_spgemm_dense",
    "ref_ilu0",
    "ref_sor",
    "ref_symgs",
]


def csr_to_dense(m, n, ptr, ind, val, dtype=None):
    """Materialize a raw CSR triple densely, summing duplicates."""
    dt = dtype if dtype is not None else np.asarray(val).dtype
    A = np.zeros((m, n), dtype=dt)
    ptr = np.asarray(ptr)
    ind = np.asarray(ind)
    val = np.asarray(val)
    for i in range(m):
        for k in range(int(ptr[i]), int(ptr[i + 1])):
            A[i, int(ind[k])] += val[k]
    return A


def effective_dense(m, n, ptr, ind, val, descr: MatrixDescriptor):
    """Dense matrix the descriptor semantics imply (the op the user asked for).

    symmetric/hermitian: take the descr.fill_mode triangle (incl. diagonal) and
    mirror it; triangular: take the triangle only, honoring diag_type (unit
    diag replaces stored diagonal with 1; zero diag drops it). Matches the
    reference's descriptor interpretation in aoclsparse_mv.cpp:52-176.
    """
    A = csr_to_dense(m, n, ptr, ind, val)
    t = MatrixType(descr.type)
    if t == MatrixType.general:
        return A
    lower = FillMode(descr.fill_mode) == FillMode.lower
    tri = np.tril(A) if lower else np.triu(A)
    if t == MatrixType.symmetric:
        off = np.tril(A, -1) if lower else np.triu(A, 1)
        return tri + off.T
    if t == MatrixType.hermitian:
        off = np.tril(A, -1) if lower else np.triu(A, 1)
        out = tri + np.conj(off.T)
        # hermitian diagonal is real by definition
        np.fill_diagonal(out, np.real(np.diag(out)))
        return out
    # triangular
    if DiagType(descr.diag_type) == DiagType.unit:
        np.fill_diagonal(tri, 1)
    elif DiagType(descr.diag_type) == DiagType.zero:
        np.fill_diagonal(tri, 0)
    return tri


def _apply_op(A, op: Operation):
    op = Operation(op)
    if op == Operation.transpose:
        return A.T
    if op == Operation.conjugate_transpose:
        return np.conj(A.T)
    return A


def ref_mv(alpha, m, n, ptr, ind, val, descr, op, x, beta, y):
    """y = alpha * op(A) x + beta * y (ref_csrmv analog)."""
    A = _apply_op(effective_dense(m, n, ptr, ind, val, descr), op)
    y = np.asarray(y)
    return alpha * (A @ np.asarray(x)) + beta * y


def ref_trsv(alpha, m, ptr, ind, val, descr, op, b):
    """Solve op(tri(A)) x = alpha*b by dense substitution."""
    A = _apply_op(effective_dense(m, m, ptr, ind, val, descr), op)
    b = alpha * np.asarray(b).astype(A.dtype)
    x = np.zeros_like(b)
    # determine effective orientation after op
    n = m
    lower_eff = np.allclose(np.triu(A, 1), 0)
    if lower_eff:
        for i in range(n):
            s = A[i, :i] @ x[:i]
            x[i] = (b[i] - s) / A[i, i]
    else:
        for i in range(n - 1, -1, -1):
            s = A[i, i + 1 :] @ x[i + 1 :]
            x[i] = (b[i] - s) / A[i, i]
    return x


def ref_mm(alpha, m, n, ptr, ind, val, descr, op, B, beta, C):
    """C = alpha * op(A) @ B + beta * C (csrmm analog), dense B/C."""
    A = _apply_op(effective_dense(m, n, ptr, ind, val, descr), op)
    return alpha * (A @ np.asarray(B)) + beta * np.asarray(C)


def ref_add(alpha, m, n, ptrA, indA, valA, opA, ptrB, indB, valB):
    """C = alpha*op(A) + B densely."""
    A = _apply_op(csr_to_dense(m, n, ptrA, indA, valA), opA)
    B = csr_to_dense(*(A.shape), ptrB, indB, valB)
    return alpha * A + B


def ref_spgemm_dense(opA, mA, nA, ptrA, indA, valA, opB, mB, nB, ptrB, indB, valB):
    A = _apply_op(csr_to_dense(mA, nA, ptrA, indA, valA), opA)
    B = _apply_op(csr_to_dense(mB, nB, ptrB, indB, valB), opB)
    return A @ B


def ref_ilu0(m, ptr, ind, val):
    """Sequential IKJ ILU(0) on the CSR pattern, returning the combined LU
    values array (unit L below diag, U on/above), mirroring
    aoclsparse_ilu0_factorization (solvers/aoclsparse_ilu0.hpp:37-112)."""
    ptr = np.asarray(ptr)
    ind = np.asarray(ind)
    lu = np.array(val, copy=True)
    diag_ptr = np.full(m, -1, dtype=np.int64)
    col_of = {}
    for i in range(m):
        row = {}
        for k in range(int(ptr[i]), int(ptr[i + 1])):
            row[int(ind[k])] = k
            if int(ind[k]) == i:
                diag_ptr[i] = k
        col_of[i] = row
    for i in range(m):
        for k in range(int(ptr[i]), int(ptr[i + 1])):
            j = int(ind[k])
            if j >= i:
                break
            dj = diag_ptr[j]
            piv = lu[dj]
            if piv == 0:
                raise ZeroDivisionError(f"zero pivot at row {j}")
            lu[k] = lu[k] / piv
            for kk in range(dj + 1, int(ptr[j + 1])):
                jj = int(ind[kk])
                pos = col_of[i].get(jj)
                if pos is not None:
                    lu[pos] -= lu[k] * lu[kk]
    return lu, diag_ptr


def ref_sor(omega, m, ptr, ind, val, x0, b, sweeps=1):
    """Forward SOR sweep(s): x <- x + omega*D^{-1}(b - A x) row-sequentially."""
    A = csr_to_dense(m, m, ptr, ind, val)
    x = np.array(x0, copy=True).astype(A.dtype)
    b = np.asarray(b)
    for _ in range(sweeps):
        for i in range(m):
            r = b[i] - A[i] @ x
            x[i] = x[i] + omega * r / A[i, i]
    return x


def ref_symgs(m, ptr, ind, val, x0, b, sweeps=1):
    """Symmetric Gauss-Seidel: forward then backward sweep."""
    A = csr_to_dense(m, m, ptr, ind, val)
    x = np.array(x0, copy=True).astype(A.dtype)
    b = np.asarray(b)
    for _ in range(sweeps):
        for i in range(m):
            r = b[i] - A[i] @ x
            x[i] = x[i] + r / A[i, i]
        for i in range(m - 1, -1, -1):
            r = b[i] - A[i] @ x
            x[i] = x[i] + r / A[i, i]
    return x
