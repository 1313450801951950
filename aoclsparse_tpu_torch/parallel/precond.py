"""Shard-local preconditioners for the distributed Krylov solvers (a copy
of the JAX package's parallel/precond.py; host numpy, no JAX).

The reference's preconditioners (ILU0/SymGS, itsol options) are single-node
sequential sweeps; on a mesh the standard scalable choice is BLOCK-JACOBI:
M = blockdiag(A_00, A_11, …) with nb×nb diagonal blocks, applied as
z_b = A_bb⁻¹ r_b — embarrassingly shard-local (no collectives, no
loop-carried dependency), SPD whenever A is, and far stronger than diagonal
Jacobi when the coupling inside a block matters (band operands). The block
inverses are precomputed once on the host (planner-style structure work)
and applied on the device as ONE batched matmul per iteration, no gathers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["block_jacobi_inv"]


def block_jacobi_inv(eff, nb: int, m_pad: int) -> np.ndarray:
    """(m_pad//nb, nb, nb) inverses of the nb×nb diagonal blocks of the
    effective CSR `eff` (planner EffectiveCSR or any object with
    ptr/ind/val/shape). Rows past m are padded with identity blocks so the
    apply is a no-op on padding. Vectorized host structure work (repo rule:
    no per-element Python loops); batched `np.linalg.inv` does the rest.

    A singular diagonal block falls back to the pseudo-inverse of its
    diagonal (the reference's near-zero-pivot permissiveness, in spirit:
    never fail the solve for a preconditioner)."""
    m = eff.shape[0]
    if m_pad % nb:
        raise ValueError("m_pad must be a multiple of nb")
    nblk = m_pad // nb
    ptr = np.asarray(eff.ptr, dtype=np.int64)
    ind = np.asarray(eff.ind, dtype=np.int64)
    val = eff.val.detach().cpu().double().numpy() if hasattr(eff.val, "detach") else eff.val
    val = np.asarray(val, dtype=np.float64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr[: m + 1]))
    cols = ind[: rows.shape[0]]
    same = (rows // nb) == (cols // nb)
    r, c, v = rows[same], cols[same], val[: rows.shape[0]][same]
    blocks = np.zeros((nblk, nb, nb), dtype=np.float64)
    np.add.at(blocks, (r // nb, r % nb, c % nb), v)
    # identity on the padding rows (and any all-zero rows inside a block)
    diag_missing = np.abs(np.einsum("bii->bi", blocks)) == 0
    if diag_missing.any():
        bi, di = np.nonzero(diag_missing)
        blocks[bi, di, di] = 1.0
    try:
        inv = np.linalg.inv(blocks)
    except np.linalg.LinAlgError:
        inv = np.empty_like(blocks)
        for i in range(nblk):
            try:
                inv[i] = np.linalg.inv(blocks[i])
            except np.linalg.LinAlgError:
                d = np.einsum("ii->i", blocks[i])
                inv[i] = np.diag(np.where(np.abs(d) > 0, 1.0 / np.where(d == 0, 1.0, d), 1.0))
    return inv
