"""Gather SpMV over the ``segsum`` execution form, in plain torch.

PyTorch counterpart of ``aoclsparse_tpu/kernels/xla/spmv.py:51``
(`spmv_segsum`). In the JAX package this is XLA-path code, not a Pallas
kernel, so it has no hand-written kernel here either.
"""

from __future__ import annotations

import torch

__all__ = ["spmv_segsum"]


def spmv_segsum(ind, val, row_ids, x, m: int) -> torch.Tensor:
    """y = A @ x via gather + row scatter-add over CSR-ordered entries."""
    y = torch.zeros(m, dtype=torch.promote_types(val.dtype, x.dtype), device=x.device)
    return y.index_add_(0, row_ids, val * x[ind])
