"""Gather SpMV over the ``segsum``, ``ell`` and ``ellhyb`` execution forms,
and group-band SpMV over ``bwdg``, in plain torch.

PyTorch counterpart of ``aoclsparse_tpu/kernels/xla/spmv.py:51-91``
(`spmv_segsum`, `spmv_ell`, `spmv_ellhyb`) and :553 (`spmv_bwdg`, mv KID
9). In the JAX package these are XLA-path code, not Pallas kernels, so they
have no hand-written kernel here either. The ell forms are the gen form's
gather fallback (planner/plan.py `gather_fallback_kind`); `bwdg` is the
layout the SpGEMM band engine emits C in, so `mv` on a product runs on it.
"""

from __future__ import annotations

import torch

from .spmm_plain import spmm_ell, spmm_ellhyb

__all__ = ["spmv_bwdg", "spmv_ell", "spmv_ellhyb", "spmv_segsum"]


def spmv_segsum(ind, val, row_ids, x, m: int) -> torch.Tensor:
    """y = A @ x via gather + row scatter-add over CSR-ordered entries."""
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
