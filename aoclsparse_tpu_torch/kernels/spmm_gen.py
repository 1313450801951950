"""The general-structure SpMM composite (mm KID 6, the ``gen`` form).

PyTorch counterpart of ``aoclsparse_tpu/kernels/xla/spmm.py`` `spmm_gen`
(:110-183): the gen composite of ``kernels/spmv_gen.py`` applied to a dense
right-hand side B (m, k). The planner's split P A P^T = band + hub-column
slab + hub-row slab + spill (planner/plan.py `_build_gen`), one call:

1. Bp = P B: a gather of B's (nblk, Bblk, k) row blocks, and a reverse of
   the flipped ones (never element gathers);
2. Cp = band(Bp): the band SpMM kernel (#8, kernels/spmm_band.py
   `spmm_band`, csrc/spmm_band.cu) on the form's row-aligned (m_pad, W)
   band (`ExecForm.bandt_rows`, the transpose of its (W, m_pad) layout);
3. the spill: a gather of Bp rows and an ``index_add_`` (the JAX package's
   row-sorted segment sum);
4. the slabs: Cp += hub_slab @ B[hub_cols]; Cp[hubr_rows] += hubr_slab @ Bp,
   dense products, as the JAX package leaves them to XLA;
5. C = P^T Cp, the same gather and reverse backwards.

Only the band leg is a kernel. The band kernel takes any K (the JAX
package pads K to 128 around its Pallas leg) and masks B's edges itself.
In a bf16 handle, or with the mixed mode's bf16 band, the band kernel's
bf16 instance reads B and writes C in f32; the spill and slabs follow in
f32 (the caller passes B widened to f32).
"""

from __future__ import annotations

import torch

from .spmm_band import spmm_band
from .spmv_gen import _permute_in, _permute_out

__all__ = ["spmm_gen"]


def spmm_gen(form, B: torch.Tensor, mixed: bool = False) -> torch.Tensor:
    """C = A @ B through the gen composite: one band SpMM launch on the
    card. `form` passes `planner.plan.gen_mm_ok`; `mixed` streams the bf16
    copy of the band (B f32)."""
    Bp = _permute_in(form, B)
    Cp = spmm_band(form.bandt_rows(bf16=mixed), Bp, form.bandt_start, form.bwd_padL)
    if form.has_spill:
        Cp.index_add_(0, form.sp_rows, (form.sp_val[:, None] * Bp[form.sp_ind]).to(Cp.dtype))
    if form.hub_cols is not None and form.hub_cols.shape[0]:
        Cp += form.hub_slab.to(Cp.dtype) @ B[form.hub_cols].to(Cp.dtype)
    if form.hubr_rows is not None and form.hubr_rows.shape[0]:
        Cp.index_add_(0, form.hubr_rows, form.hubr_slab.to(Cp.dtype) @ Bp.to(Cp.dtype))
    return _permute_out(form, Cp)
