"""Distributed multi-RHS triangular solve (the JAX package's
parallel/trsm.py).

The reference parallelises TRSM over the right-hand-side columns with
OpenMP (level3/aoclsparse_trsm.hpp:149); here B's columns are split over
the ranks while every rank holds the whole blocked form, and each rank
solves its columns with no collective at all. The local solve is the
form's own (planner/triangular.py `TrsvForm.solve`): on the card the
multi-RHS window solve (kernel #14, csrc/trsv_win.cu) for a ``win`` form
(the single-RHS one, #13, where a rank holds one column) and the
blocked-solve chain kernel (csrc/trsv_blocked.cu) for ``dwin`` and
``gather`` forms; their plain versions on the CPU.
"""

from __future__ import annotations

import torch

from ..core.types import AoclSparseError, Status
from .placement import Mesh, P, Shard, local
from .trsv import _rhs

__all__ = ["dist_trsm"]


def dist_trsm(mesh: Mesh, form, B, axis: str = "x"):
    """Solve L X = B with the blocked TrsvForm, B (m, k) columns sharded.
    The form must sit on mesh.device. Returns X as a Shard of this rank's
    columns (dim 1)."""
    if torch.device(form.device) != torch.device(mesh.device):
        raise AoclSparseError(
            Status.invalid_value, f"the form is on {form.device}, the mesh's blocks on {mesh.device}"
        )
    n_dev = mesh.shape[axis]
    dtype = form.dtype or form.D.dtype
    B2 = _rhs(B, dtype, mesh.device)
    m, k = B2.shape
    k_pad = -(-k // n_dev) * n_dev
    if form.reversed_:
        B2 = B2.flip(0)
    B2 = torch.nn.functional.pad(B2, (0, k_pad - k, 0, form.m_pad - m))
    Bl = local(B2, mesh, P(None, axis))
    X = form.solve(Bl.contiguous())[:m]
    if form.reversed_:
        X = X.flip(0)
    kc = k_pad // n_dev
    return Shard(X, mesh.rank * kc, (m, k), 1)
