"""Gather SpMV over the ``segsum``, ``sell``, ``ell`` and ``ellhyb``
execution forms, group-band SpMV over ``bwdg``, diagonal SpMV over ``diag``,
and the native BSR and DIA products, in plain torch.

PyTorch counterpart of ``aoclsparse_tpu/kernels/xla/spmv.py:51-125``
(`spmv_segsum`, which serves `spmv_sell`'s form too, `spmv_ell`, `spmv_ellhyb`, `spmv_bsr`,
`spmv_dia`), :553 (`spmv_bwdg`, mv KID 9) and :606 (`spmv_diag`, mv KID
6). In the JAX package these are XLA-path code, not Pallas kernels, so they
have no hand-written kernel here either. The ell forms are the gen form's
gather fallback (planner/plan.py `gather_fallback_kind`); `bwdg` is the
layout the SpGEMM band engine emits C in, so `mv` on a product runs on it;
`spmv_bsr` and `spmv_dia` serve BSR and DIA handles and the format-direct
routines (ops/level2/format_mv.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .spmm_plain import spmm_ell, spmm_ellhyb

__all__ = [
    "spmv_bsr",
    "spmv_bwdg",
    "spmv_dia",
    "spmv_diag",
    "spmv_ell",
    "spmv_ellhyb",
    "spmv_segsum",
]

#: diagonals gathered at once by spmv_dia and spmv_diag: bounds the
#: (chunk, m) temporary
DIAG_CHUNK = 32


def spmv_segsum(ind, val, row_ids, x, m: int) -> torch.Tensor:
    """y = A @ x via gather + row scatter-add over CSR-ordered entries; also
    the product of the flattened sliced-ELL form (mv KID 10), whose padding
    slots carry value 0 and column 0."""
    y = torch.zeros(m, dtype=torch.promote_types(val.dtype, x.dtype), device=x.device)
    return y.index_add_(0, row_ids, val * x[ind])


def spmv_ell(ell_ind, ell_val, x) -> torch.Tensor:
    """y = A @ x over (m, w) padded rows (padding has index -1): the SpMM
    form with one column."""
    return spmm_ell(ell_ind, ell_val, x[:, None])[:, 0]


def spmv_ellhyb(ell_ind, ell_val, sp_ind, sp_val, sp_rows, x, m: int) -> torch.Tensor:
    """ELL head plus the COO row tails."""
    return spmm_ellhyb(ell_ind, ell_val, sp_ind, sp_val, sp_rows, x[:, None], m)[:, 0]


def spmv_bwdg(band, x, G: int, W: int, rel: int, m: int, mixed: bool = False) -> torch.Tensor:
    """y = A @ x over a G-row-group band, band[g, r, c] = A[G*g + r,
    G*g + rel + c] of shape (nblk, G, W): x is zero-padded so every group's
    window is a strided view, then one batched matvec. mixed rounds both
    operands to bf16 and accumulates in f32, as the JAX package's
    preferred_element_type does, and returns the band's dtype."""
    nblk = band.shape[0]
    padL = max(0, -rel)
    need = G * (nblk - 1) + rel + padL + W  # end of the last window, padded
    xp = torch.nn.functional.pad(x, (padL, max(0, need - padL - x.shape[0])))
    win = xp.as_strided((nblk, W), (G, 1), rel + padL)
    if mixed:
        out = torch.matmul(band.to(torch.bfloat16).float(), win.to(torch.bfloat16).float()[:, :, None])
        return out.reshape(-1)[:m].to(band.dtype)
    return torch.matmul(band, win[:, :, None]).reshape(-1)[:m]


def spmv_bsr(brow, ind, val, x, mb: int, block_dim: int) -> torch.Tensor:
    """BSR SpMV (mv KID 3): each stored (bs, bs) block times its x block,
    one batched matvec, then a scatter-add per block row. `brow` holds the
    block row of each stored block; x is zero-padded to whole blocks (the
    edge blocks of a matrix whose n is not a block multiple). Returns
    mb * bs rows."""
    bs = block_dim
    nnzb = val.shape[0]
    x = torch.nn.functional.pad(x, (0, -x.shape[0] % bs))
    dt = torch.promote_types(val.dtype, x.dtype)
    xb = x[(ind[:, None] * bs + torch.arange(bs, device=x.device)[None, :]).reshape(-1)].reshape(nnzb, bs)
    prod = torch.bmm(val.to(dt), xb.to(dt)[:, :, None])[:, :, 0]
    yb = torch.zeros(mb, bs, dtype=dt, device=x.device).index_add_(0, brow, prod)
    return yb.reshape(mb * bs)


def spmv_dia(dist, val, x, m: int, n: int) -> torch.Tensor:
    """DIA SpMV (mv KID 4): y[i] = sum_k val[k, i] x[i + dist[k]], the terms
    whose column falls outside [0, n) masked out (diamv analog). `dist`
    holds the offsets (a tensor or a sequence); the diagonals are gathered
    DIAG_CHUNK at a time."""
    dt = torch.promote_types(val.dtype, x.dtype)
    y = torch.zeros(m, dtype=dt, device=x.device)
    rows = torch.arange(m, device=x.device)
    offs = torch.as_tensor(dist if isinstance(dist, torch.Tensor) else np.asarray(dist), device=x.device).long()
    for c0 in range(0, len(offs), DIAG_CHUNK):
        cols = rows[None, :] + offs[c0 : c0 + DIAG_CHUNK, None]
        ok = (cols >= 0) & (cols < n)
        xg = x[cols.clamp(0, max(n - 1, 0))] if n else torch.zeros(cols.shape, dtype=x.dtype, device=x.device)
        prod = val[c0 : c0 + DIAG_CHUNK].to(dt) * xg.to(dt)
        y += torch.where(ok, prod, torch.zeros((), dtype=dt, device=x.device)).sum(0)
    return y


def spmv_diag(dvals, offs, x, m: int, L: int, n_pad: int) -> torch.Tensor:
    """Diagonal-form SpMV (mv KID 6) over the planner's ``diag`` form:
    dvals[d, i] = A[i, i + offs[d]], x zero-padded by L in front to n_pad;
    y = sum_d dvals[d] * xp[offs[d] + L : offs[d] + L + m], the diagonals
    gathered DIAG_CHUNK at a time."""
    xp = torch.nn.functional.pad(x, (L, n_pad - L - x.shape[0]))
    base = torch.arange(m, device=x.device) + L
    y = torch.zeros(m, dtype=torch.promote_types(dvals.dtype, x.dtype), device=x.device)
    for c0 in range(0, dvals.shape[0], DIAG_CHUNK):
        win = xp[offs[c0 : c0 + DIAG_CHUNK, None] + base[None, :]]
        y += (dvals[c0 : c0 + DIAG_CHUNK] * win).sum(0)
    return y
