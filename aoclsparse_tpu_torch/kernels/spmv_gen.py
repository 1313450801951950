"""The general-structure SpMV composite (the ``gen`` execution form).

PyTorch counterpart of ``aoclsparse_tpu/kernels/xla/spmv.py`` `spmv_gen`
(:227, the G = 8 group-window layout), `spmv_gen_bandt` / `spmv_gen_bandv`
(:499 / :337, the band kernel's layout) and `spmv_gen_bandv_p` (:426, in
permuted space). The planner (planner/plan.py `_build_gen`) splits
P A P^T = band + hub-column slab + hub-row slab + spill, P a block
permutation (B-element blocks moved whole, some reversed). One call:

1. xp = P x: a row gather of the (nblk, B) blocks, and a where-reverse of
   the flipped ones;
2. yp = band(xp): the band kernel (kernels/band_spmv.py, Pallas #1-#3's
   port) on the (W, m_pad) layout, or the G = 8 group windows in plain
   torch (kernels/spmm_plain.py `spmm_bwd` with one column);
3. the spill: the spill-route engine (select, Benes route, accumulate:
   planner/spill_route.py) when ops/level2/mv.py engages it, else a gather
   and an ``index_add_``;
4. the slabs: yp += hub_slab @ x[hub_cols]; yp[hubr_rows] += hubr_slab @ xp
   (dense products outside any kernel, as the JAX package leaves them to
   XLA);
5. y = P^T yp, the same gather and reverse backwards.

The JAX package can also permute by one-hot MXU products (`perm_rows_mm`,
exact through a 3-way bf16 split): a TPU device for a TPU's slow gathers,
with no counterpart here; Hopper gathers the blocks directly.
"""

from __future__ import annotations

from typing import Optional

import torch

from .band_spmv import band_spmv
from .spmm_plain import spmm_bwd

__all__ = ["spmv_gen", "spmv_gen_p", "spmv_route"]


def _flip_mask(form, ndim: int) -> torch.Tensor:
    """The flip flags shaped to broadcast over (nblk, B, ...) blocks."""
    return form.gen_flip.view((-1,) + (1,) * ndim)


def _permute_in(form, x: torch.Tensor) -> torch.Tensor:
    """xp = P x over m_pad rows (x zero-padded); x is (m,) or (m, k)."""
    B, m_pad = form.gen_B, form.gen_m_pad
    xb = torch.zeros((m_pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    xb[: x.shape[0]] = x
    xpb = xb.view((-1, B) + tuple(x.shape[1:]))[form.gen_perm]
    if form.gen_flip is not None:
        xpb = torch.where(_flip_mask(form, x.dim()), xpb.flip(1), xpb)
    return xpb.reshape((m_pad,) + tuple(x.shape[1:]))


def _permute_out(form, yp: torch.Tensor) -> torch.Tensor:
    """y = P^T yp, the first m rows."""
    ypb = yp.view((-1, form.gen_B) + tuple(yp.shape[1:]))
    if form.gen_flip is not None:
        ypb = torch.where(_flip_mask(form, yp.dim()), ypb.flip(1), ypb)
    return ypb[form.gen_out].reshape(yp.shape)[: form.m]


def _core(form, xp: torch.Tensor, x_hub: Optional[torch.Tensor], mixed: bool, route) -> torch.Tensor:
    """yp = (P A P^T) xp, the hub columns' x values given (x_hub)."""
    if form.gen_bandt:
        vt = form.band_bf16() if mixed else form.bwd_val
        xk = xp.float() if vt.dtype == torch.bfloat16 else xp  # the bf16 instance reads f32 x
        yp = band_spmv(vt, xk.contiguous(), form.bandt_start, form.bwd_padL)
    else:
        xpad = torch.zeros(form.bwd_n_pad, dtype=xp.dtype, device=xp.device)
        xpad[form.bwd_padL : form.bwd_padL + xp.shape[0]] = xp
        yp = spmm_bwd(form.bwd_val, xpad[:, None], 8, form.bwd_W, form.bwd_base8, form.bwd_n_pad, mixed)
        yp = yp[: form.gen_m_pad, 0]
    if form.sp_ind is not None and form.sp_ind.shape[0]:
        if route is not None:
            from ..planner.spill_route import spill_route_apply

            yp = spill_route_apply(xp, yp, route, out=yp)
        else:
            yp.index_add_(0, form.sp_rows, (form.sp_val * xp[form.sp_ind]).to(yp.dtype))
    if form.hub_cols is not None and form.hub_cols.shape[0]:
        slab = form.hub_slab
        if mixed and not form.gen_bandt:  # the JAX package's spmv_gen rounds its hubs too
            slab, x_hub = slab.to(torch.bfloat16).to(slab.dtype), x_hub.to(torch.bfloat16).to(slab.dtype)
        yp += (slab @ x_hub).to(yp.dtype)
    if form.hubr_rows is not None and form.hubr_rows.shape[0]:
        slab, xr = form.hubr_slab, xp
        if mixed and not form.gen_bandt:
            slab, xr = slab.to(torch.bfloat16).to(slab.dtype), xr.to(torch.bfloat16).to(slab.dtype)
        yp.index_add_(0, form.hubr_rows, (slab @ xr).to(yp.dtype))
    return yp


def spmv_gen(form, x: torch.Tensor, mixed: bool = False, route=None) -> torch.Tensor:
    """y = A x through the gen composite (mv KID 7); `route` is the form's
    SpillRoute when the spill rides the engine, else None."""
    xp = _permute_in(form, x)
    x_hub = x[form.hub_cols] if form.hub_cols is not None and form.hub_cols.shape[0] else None
    return _permute_out(form, _core(form, xp, x_hub, mixed, route))


def spmv_gen_p(form, xp: torch.Tensor, mixed: bool = False, route=None) -> torch.Tensor:
    """yp = (P A P^T) xp in permuted space, for iteration: no permutes, the
    hub columns read from xp at their permuted positions. Padding rows
    give exact zeros."""
    hub_p = form.gen_perm_maps()[2]
    return _core(form, xp, xp[hub_p] if hub_p is not None else None, mixed, route)


def spmv_route(route, x: torch.Tensor, m: int) -> torch.Tensor:
    """y = A x through the whole-matrix route form (mv KID 14): every entry
    selected, routed and accumulated, stripe by stripe past 2^18 entries."""
    from ..planner.spill_route import StripedRoute, spill_route_apply, striped_route_apply

    if isinstance(route, StripedRoute):
        return striped_route_apply(x, route)[:m]
    return spill_route_apply(x, torch.zeros(m, dtype=x.dtype, device=x.device), route)
