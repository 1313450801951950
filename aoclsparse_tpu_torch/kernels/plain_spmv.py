"""Gather SpMV over the ``segsum``, ``ell`` and ``ellhyb`` execution forms,
in plain torch.

PyTorch counterpart of ``aoclsparse_tpu/kernels/xla/spmv.py:51-91``
(`spmv_segsum`, `spmv_ell`, `spmv_ellhyb`). In the JAX package these are
XLA-path code, not Pallas kernels, so they have no hand-written kernel here
either. The ell forms are the gen form's gather fallback
(planner/plan.py `gather_fallback_kind`).
"""

from __future__ import annotations

import torch

from .spmm_plain import spmm_ell, spmm_ellhyb

__all__ = ["spmv_ell", "spmv_ellhyb", "spmv_segsum"]


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
