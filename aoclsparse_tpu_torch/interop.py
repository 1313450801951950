"""State carried across from the JAX package, as host numpy arrays.

These entry points let one operand feed both packages:

- `matrix_from_jax_arrays` takes the arrays that ``aoclsparse_tpu.export_csr``
  returns and builds this package's handle from them.
- `bandt_form_from_jax` takes numpy copies of a JAX ``bandt`` ExecForm's
  arrays and builds this package's ExecForm, so the band kernel can be held
  against the JAX kernels on the very same band, apart from the planner.
- `trsv_form_from_jax` takes numpy copies of a JAX ``win`` TrsvForm's
  arrays and builds this package's TrsvForm, so the window-solve kernel can
  solve the very same blocks.
- `mm_form_from_jax` does the same for the SpMM forms ``bandtm``, ``diag``,
  ``bwdg``, ``ell`` and ``ellhyb``.
- `gen_form_from_jax` does it for the general-structure ``gen`` form (block
  permutation, band, hub slabs, spill), and `spill_route_from_jax` for a
  JAX ``SpillRoute``, so the select, accumulate and route kernels run on
  the JAX planner's very operands.

None imports JAX: the arrays arrive as numpy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.context import resolve_device
from .core.matrix import SparseMatrix, as_values, create_csr
from .core.types import IndexBase
from .planner.plan import ExecForm
from .planner.spill_route import SpillRoute
from .planner.triangular import TrsvForm

__all__ = [
    "matrix_from_jax_arrays",
    "bandt_form_from_jax",
    "gen_form_from_jax",
    "mm_form_from_jax",
    "spill_route_from_jax",
    "trsv_form_from_jax",
]


def matrix_from_jax_arrays(
    m, n, ptr, ind, val, device=None, base: IndexBase = IndexBase.zero
) -> SparseMatrix:
    """CSR handle from ``aoclsparse_tpu.export_csr``'s (ptr, ind, val)."""
    return create_csr(m, n, np.asarray(ptr), np.asarray(ind), np.asarray(val), base, device)


def bandt_form_from_jax(form_arrays: Mapping, device=None) -> ExecForm:
    """This package's ``bandt`` ExecForm from a JAX one's arrays: keys
    ``bwd_val`` ((W, m)), ``sp_val``/``sp_ind``/``sp_rows`` (None or empty
    when there is no spill), ``bwd_W``, ``bwd_padL`` and ``bandt_start``,
    and optionally ``n`` (default m). The form carries no scatter maps, so
    it serves mv but not a value refresh."""
    dev = resolve_device(device)
    vt = as_values(np.ascontiguousarray(form_arrays["bwd_val"]), dev)
    W, m = vt.shape
    if int(form_arrays["bwd_W"]) != W:
        raise ValueError(f"bwd_W={form_arrays['bwd_W']} but bwd_val has {W} rows")
    sp_ind = form_arrays.get("sp_ind")
    spilled = sp_ind is not None and np.asarray(sp_ind).size > 0

    def idx(key):
        return torch.from_numpy(np.ascontiguousarray(form_arrays[key], dtype=np.int64)).to(dev)

    return ExecForm(
        kind="bandt",
        m=m,
        n=int(form_arrays.get("n", m)),
        bwd_val=vt,
        bwd_W=W,
        bwd_padL=int(form_arrays["bwd_padL"]),
        bandt_start=int(form_arrays["bandt_start"]),
        sp_val=as_values(np.asarray(form_arrays["sp_val"]), dev) if spilled else None,
        sp_ind=idx("sp_ind") if spilled else None,
        sp_rows=idx("sp_rows") if spilled else None,
    )


def trsv_form_from_jax(arrays: Mapping, device=None) -> TrsvForm:
    """This package's ``win`` TrsvForm from a JAX one's arrays: keys ``D``
    ((nblk, nb, nb)), ``Lval`` ((nblk, nb, WL)), ``nb``, ``nblk``, ``m``,
    ``WL``, ``reversed_`` and ``unit_diag``. The form carries no scatter
    maps, so it serves solves but not a value refresh."""
    dev = resolve_device(device)
    D = as_values(np.ascontiguousarray(arrays["D"]), dev)
    Lval = as_values(np.ascontiguousarray(arrays["Lval"]), dev)
    nb, nblk, WL = int(arrays["nb"]), int(arrays["nblk"]), int(arrays["WL"])
    if tuple(D.shape) != (nblk, nb, nb) or tuple(Lval.shape) != (nblk, nb, WL):
        raise ValueError(f"D {tuple(D.shape)} / Lval {tuple(Lval.shape)} do not match nblk, nb, WL")
    return TrsvForm(
        nb=nb,
        nblk=nblk,
        m=int(arrays["m"]),
        reversed_=bool(arrays["reversed_"]),
        unit_diag=bool(arrays["unit_diag"]),
        D=D,
        Lval=Lval,
        _D_dest=None,
        _D_srcpos=None,
        _D_paddest=None,
        _L_dest=None,
        _L_srcpos=None,
        _L_shape=(nblk, nb, WL),
        device=dev,
        WL=WL,
    )


#: ExecForm fields an SpMM form carries: value tensors, index tensors, ints
_MM_VALUES = ("bwd_val", "dia_val", "ell_val", "sp_val")
_MM_INDICES = ("dia_offs", "ell_ind", "sp_ind", "sp_rows")
_MM_INTS = ("bwd_W", "bwd_G", "bwd_base8", "bwd_n_pad", "bwd_padL", "bandt_start", "dia_L", "dia_n_pad")


def mm_form_from_jax(kind: str, arrays: Mapping, m: int, n: int, device=None) -> ExecForm:
    """This package's SpMM ExecForm of `kind` ("bandtm", "diag", "bwdg",
    "ell" or "ellhyb") from a JAX one's arrays, keyed by the ExecForm field
    names both packages share (those the form has; an empty spill may be
    None). The form carries no scatter maps, so it serves mm but not a
    value refresh."""
    if kind not in ("bandtm", "diag", "bwdg", "ell", "ellhyb"):
        raise ValueError(f"no SpMM form of kind {kind!r}")
    kw = _form_kwargs(arrays, _MM_VALUES, _MM_INDICES, _MM_INTS, resolve_device(device))
    if kind == "diag":
        kw["dia_offs_static"] = tuple(int(o) for o in np.asarray(arrays["dia_offs"]))
    return ExecForm(kind=kind, m=int(m), n=int(n), **kw)


#: ExecForm fields a gen form carries beyond the SpMM ones
_GEN_VALUES = ("hub_slab", "hubr_slab")
_GEN_INDICES = ("gen_perm", "gen_out", "hub_cols", "hubr_rows")
_GEN_INTS = ("gen_B", "gen_m_pad")


def _form_kwargs(arrays: Mapping, values, indices, ints, dev) -> dict:
    kw = {}
    for key in values + indices:
        a = arrays.get(key)
        if a is None or (key.startswith("sp_") and np.asarray(a).size == 0):
            continue
        a = np.ascontiguousarray(a)
        kw[key] = torch.from_numpy(a.astype(np.int64)).to(dev) if key in indices else as_values(a, dev)
    kw.update({key: int(arrays[key]) for key in ints if key in arrays})
    return kw


def gen_form_from_jax(arrays: Mapping, m: int, n: int, device=None) -> ExecForm:
    """This package's ``gen`` ExecForm from a JAX one's arrays, keyed by the
    field names both packages share: the band (``bwd_val``, in the (W, m_pad)
    layout when ``gen_bandt`` is true, else (m_pad/8, 8, W)), its geometry,
    ``gen_perm``/``gen_out``/``gen_flip``, the hub slabs and the spill. The
    form carries no scatter maps, so it serves mv but not a value
    refresh."""
    dev = resolve_device(device)
    kw = _form_kwargs(arrays, _MM_VALUES + _GEN_VALUES, _MM_INDICES + _GEN_INDICES, _MM_INTS + _GEN_INTS, dev)
    flip = arrays.get("gen_flip")
    if flip is not None:
        kw["gen_flip"] = torch.from_numpy(np.array(flip, dtype=bool)).to(dev)
    return ExecForm(kind="gen", m=int(m), n=int(n), gen_bandt=bool(arrays["gen_bandt"]), **kw)


def spill_route_from_jax(arrays: Mapping, device=None) -> SpillRoute:
    """This package's SpillRoute from a JAX one's arrays (its dataclass
    fields: the statics ``k``, ``n``, ``nxblk``, ``nyblk``, ``n_sel_tiles``,
    ``n_acc_tiles`` and ``m_pad``, the tiles ``sel_idx``/``sel_val``/
    ``sel_blk``/``acc_idx``/``acc_blk``/``acc_cid`` and the ``masks`` /
    ``masks_packed`` route, either None). The accumulate kernel's
    ``acc_start`` is derived from the monotone ``acc_blk``. Without
    ``_val_slot`` the route serves applies but not a value refresh."""
    dev = resolve_device(device)

    def i32(key):
        return torch.from_numpy(np.array(arrays[key], dtype=np.int32)).to(dev)

    def u8(key):
        a = arrays.get(key)
        return None if a is None else torch.from_numpy(np.array(a, dtype=np.uint8)).to(dev)

    nyblk = int(arrays["nyblk"])
    acc_blk = np.asarray(arrays["acc_blk"])
    slot = arrays.get("_val_slot")
    return SpillRoute(
        **{key: int(arrays[key]) for key in ("k", "n", "nxblk", "n_sel_tiles", "n_acc_tiles", "m_pad")},
        nyblk=nyblk,
        sel_idx=i32("sel_idx"),
        sel_val=as_values(np.ascontiguousarray(arrays["sel_val"]), dev),
        sel_blk=i32("sel_blk"),
        acc_idx=i32("acc_idx"),
        acc_blk=i32("acc_blk"),
        acc_cid=i32("acc_cid"),
        acc_start=torch.from_numpy(np.searchsorted(acc_blk, np.arange(nyblk + 1)).astype(np.int32)).to(dev),
        masks=u8("masks"),
        masks_packed=u8("masks_packed"),
        _val_slot=None if slot is None else torch.from_numpy(np.asarray(slot, dtype=np.int64)).to(dev),
    )
