"""Gather- and group-form SpMM in plain PyTorch: mm KIDs 0-3.

Counterparts of the JAX package's XLA formulations
(kernels/xla/spmm.py:20-90 ``spmm_segsum``, ``spmm_ell``, ``spmm_ellhyb``;
:185-220 ``spmm_bwd``). They are no TPU kernels there and stay plain torch
here. The gather forms build an (nnz, k) or (m, w, k) product tile; to bound
its memory, wide right-hand sides run in column chunks whose tile stays
under CHUNK_ELEMS elements (the JAX package's default budget).
"""

from __future__ import annotations

import torch

__all__ = ["add_spill", "spmm_bwd", "spmm_ell", "spmm_ellhyb", "spmm_segsum", "CHUNK_ELEMS"]

#: elements of one product tile (kernels/xla/spmm.py:30)
CHUNK_ELEMS = 64_000_000


def _chunks(k: int, tile_rows: int):
    """Column ranges whose (tile_rows, kc) tiles stay under CHUNK_ELEMS."""
    kc = max(CHUNK_ELEMS // max(tile_rows, 1) // 8 * 8, 8)
    return [(c, min(c + kc, k)) for c in range(0, k, kc)]


def spmm_segsum(ind, val, row_ids, B, m: int) -> torch.Tensor:
    """C = A @ B over COO-by-row triplets: gather B rows, scale, and
    scatter-add into the output rows."""
    C = torch.zeros(m, B.shape[1], dtype=torch.promote_types(val.dtype, B.dtype), device=B.device)
    for lo, hi in _chunks(B.shape[1], ind.shape[0]):
        C[:, lo:hi].index_add_(0, row_ids, val[:, None] * B[ind, lo:hi])
    return C


def spmm_ell(ind, val, B) -> torch.Tensor:
    """Padded-row form: gather (m, w, k) tiles of B, mask the padding
    (ind < 0), reduce over w."""
    m, w = ind.shape
    valid = (ind >= 0)[..., None]
    ind_c = ind.clamp(min=0)
    out = torch.empty(m, B.shape[1], dtype=torch.promote_types(val.dtype, B.dtype), device=B.device)
    for lo, hi in _chunks(B.shape[1], m * w):
        prods = val[..., None] * B[ind_c, lo:hi]
        out[:, lo:hi] = torch.where(valid, prods, torch.zeros((), dtype=prods.dtype, device=B.device)).sum(1)
    return out


def add_spill(C, B, sp_val, sp_ind, sp_rows) -> torch.Tensor:
    """C[sp_rows] += sp_val * B[sp_ind] rows (entries, for a 1-D B and C),
    in place: the entries a form leaves out of its regular part (the peel
    spill, ellhyb's row tails)."""
    if sp_ind is not None and sp_ind.shape[0]:
        v = sp_val if B.dim() == 1 else sp_val[:, None]
        C.index_add_(0, sp_rows, (v * B[sp_ind]).to(C.dtype))
    return C


def spmm_ellhyb(ell_ind, ell_val, sp_ind, sp_val, sp_rows, B, m: int) -> torch.Tensor:
    """ell over the common row width plus the row tails as a scatter-add."""
    return add_spill(spmm_ell(ell_ind, ell_val, B), B, sp_val, sp_ind, sp_rows)


def spmm_bwd(grp_val, Bp, G: int, Wg: int, base: int, n_pad: int, mixed: bool = False) -> torch.Tensor:
    """Group-banded SpMM (mm KID 3): group g's (G, Wg) window times the Wg
    rows of the padded B starting at G * (g + base), one batched product.
    mixed rounds both operands to bf16 and accumulates in f32, as the JAX
    package's preferred_element_type does."""
    ngrp = grp_val.shape[0]
    k = Bp.shape[1]
    if Bp.shape[0] < n_pad:
        raise ValueError(f"padded B has {Bp.shape[0]} rows, want {n_pad}")
    Bp = Bp.contiguous()
    wins = Bp.as_strided((ngrp, Wg, k), (G * k, k, 1), Bp.storage_offset() + G * base * k)
    out_dtype = grp_val.dtype
    if mixed:
        grp_val = grp_val.to(torch.bfloat16).float()
        wins = wins.to(torch.bfloat16).float()
    return torch.matmul(grp_val, wins).reshape(ngrp * G, k).to(out_dtype)
