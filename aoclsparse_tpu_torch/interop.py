"""State carried across from the JAX package, as host numpy arrays.

These entry points let one operand feed both packages:

- `matrix_from_jax_arrays` takes the arrays that ``aoclsparse_tpu.export_csr``
  returns and builds this package's handle from them; `coo_from_jax_arrays`
  and `csc_from_jax_arrays` do it for ``export_coo`` and ``export_csc``, and
  `matrix_from_jax_format` for the fields of a JAX BSR, DIA or ELL handle's
  data.
- `bwd_form_from_jax` takes numpy copies of a JAX ``bwd`` ExecForm's arrays
  (the (nblk, 8, W) group windows, their geometry and the peel spill), so
  the group-window kernel runs on the JAX planner's very band.
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
- `band_gemm_plan_from_jax` does it for a JAX ``BandGemmPlan`` (geometry,
  stream ranges, extraction map and the two operand bands), so the band
  GEMM kernel and its plain version run on the JAX package's band operands.
- `band_from_jax_tiles` gives back the (W, m) band from the JAX package's
  tile-major sublane layout (``band_vert_layout_tiles``), the operand of
  its ``pallas_spmv_band_vc``/``_vd``; `kernels.band_tiles.band_tiles`
  then makes the port's tile-major operand of it. The block windows of
  ``pallas_spmv_band_mxu`` are the same array in both packages.

None imports JAX: the arrays arrive as numpy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.context import resolve_device
from .core.formats import BSR, DIA, ELL
from .core.matrix import SparseMatrix, as_values, create_coo, create_csc, create_csr
from .core.types import FormatType, IndexBase
from .kernels.spgemm_band import BandGemmPlan
from .planner.plan import ExecForm
from .planner.spill_route import SpillRoute
from .planner.triangular import TrsvForm

__all__ = [
    "band_from_jax_tiles",
    "band_gemm_plan_from_jax",
    "bwd_form_from_jax",
    "coo_from_jax_arrays",
    "csc_from_jax_arrays",
    "matrix_from_jax_arrays",
    "matrix_from_jax_format",
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


def coo_from_jax_arrays(m, n, row, col, val, device=None, base: IndexBase = IndexBase.zero) -> SparseMatrix:
    """COO handle from ``aoclsparse_tpu.export_coo``'s (row, col, val)."""
    return create_coo(m, n, np.asarray(row), np.asarray(col), np.asarray(val), base, device)


def csc_from_jax_arrays(m, n, ptr, ind, val, device=None, base: IndexBase = IndexBase.zero) -> SparseMatrix:
    """CSC handle from ``aoclsparse_tpu.export_csc``'s (col_ptr, row_ind, val)."""
    return create_csc(m, n, np.asarray(ptr), np.asarray(ind), np.asarray(val), base, device)


def matrix_from_jax_format(kind: str, fields: Mapping, device=None) -> SparseMatrix:
    """Handle over a JAX BSR, DIA or ELL handle's data (zero-based, as the
    JAX package stores it), from numpy copies of its dataclass fields:
    bsr ``ptr``, ``ind``, ``val`` (nnzb, bs, bs), ``block_dim``, ``shape``;
    dia ``dist``, ``val`` (ndiag, m), ``shape``; ell ``ind``, ``val``
    (m, width), ``width``, ``shape``. The element shape is kept, so a BSR
    converted from a matrix whose size is no block multiple comes across."""
    dev = resolve_device(device)
    shape = tuple(int(v) for v in fields["shape"])

    def idx(key):
        return torch.from_numpy(np.ascontiguousarray(fields[key], dtype=np.int32)).to(dev)

    val = as_values(np.ascontiguousarray(fields["val"]), dev)
    if kind == "bsr":
        data = BSR(idx("ptr"), idx("ind"), val, block_dim=int(fields["block_dim"]), shape=shape)
        return SparseMatrix(data, FormatType.bsr)
    if kind == "dia":
        return SparseMatrix(DIA(idx("dist"), val, shape=shape), FormatType.dia)
    if kind == "ell":
        return SparseMatrix(ELL(idx("ind"), val, width=int(fields["width"]), shape=shape), FormatType.ell)
    raise ValueError(f"no format {kind!r}: bsr, dia or ell")


def bwd_form_from_jax(form_arrays: Mapping, device=None) -> ExecForm:
    """This package's ``bwd`` ExecForm from a JAX one's arrays: keys
    ``bwd_val`` ((nblk, 8, W)), ``bwd_W``, ``bwd_base8``, ``bwd_padL``,
    ``bwd_n_pad``, ``m``, ``n`` and ``sp_val``/``sp_ind``/``sp_rows`` (None
    or empty when there is no spill). The spill's group pointer is derived
    from its sorted rows. The form carries no scatter maps, so it serves mv
    but not a value refresh."""
    from .kernels.spmv_bwd import G, spill_group_ptr

    dev = resolve_device(device)
    band = as_values(np.ascontiguousarray(form_arrays["bwd_val"]), dev)
    nblk, g, W = band.shape
    if g != G or int(form_arrays["bwd_W"]) != W:
        raise ValueError(f"bwd_val has shape {tuple(band.shape)}, want (nblk, {G}, bwd_W={form_arrays['bwd_W']})")
    sp_ind = form_arrays.get("sp_ind")
    spilled = sp_ind is not None and np.asarray(sp_ind).size > 0

    def idx(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)

    return ExecForm(
        kind="bwd",
        m=int(form_arrays["m"]),
        n=int(form_arrays["n"]),
        bwd_val=band,
        bwd_W=W,
        bwd_G=G,
        bwd_base8=int(form_arrays["bwd_base8"]),
        bwd_padL=int(form_arrays["bwd_padL"]),
        bwd_n_pad=int(form_arrays["bwd_n_pad"]),
        sp_val=as_values(np.asarray(form_arrays["sp_val"]), dev) if spilled else None,
        sp_ind=idx(sp_ind) if spilled else None,
        sp_rows=idx(form_arrays["sp_rows"]) if spilled else None,
        sp_gptr=idx(spill_group_ptr(np.asarray(form_arrays["sp_rows"]), nblk)) if spilled else None,
    )


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


def band_from_jax_tiles(vt3, W: int, TM: int, m=None, device=None) -> torch.Tensor:
    """The (W, ntile * TM) band, cut to m columns when m is given, from the
    JAX package's (ntile, W * 8, TM / 8) tile-major layout, whose row
    j * 8 + s, column c of tile t holds vt[j, t * TM + s * TM / 8 + c]: the
    inverse of its ``band_vert_layout_tiles``."""
    band = as_values(np.asarray(vt3), resolve_device(device))
    ntile, W8, TMd8 = band.shape
    if W8 != W * 8 or TMd8 * 8 != TM:
        raise ValueError(f"tile layout has shape {tuple(band.shape)}, want (ntile, {W * 8}, {TM // 8})")
    vt = band.reshape(ntile, W, TM).transpose(0, 1).reshape(W, ntile * TM)
    return vt[:, :m].contiguous() if m is not None else vt


def trsv_form_from_jax(arrays: Mapping, device=None) -> TrsvForm:
    """This package's TrsvForm from a JAX one's arrays: keys ``D``
    ((nblk, nb, nb)), ``Lval``, ``nb``, ``nblk``, ``m``, ``WL``,
    ``reversed_`` and ``unit_diag``, and ``kind`` ("win" when absent). Lval
    is (nblk, nb, WL) for ``win``, (nblk, ndg, nb) for ``dwin``, which also
    takes ``dwin_offs`` (its ndg offsets), and (nblk, nb, W) for ``gather``,
    which also takes ``Lind`` (nblk, nb, W). The form carries no scatter
    maps, so it serves solves but not a value refresh."""
    dev = resolve_device(device)
    kind = str(arrays.get("kind", "win"))
    D = as_values(np.ascontiguousarray(arrays["D"]), dev)
    Lval = as_values(np.ascontiguousarray(arrays["Lval"]), dev)
    nb, nblk, WL = int(arrays["nb"]), int(arrays["nblk"]), int(arrays["WL"])
    Lind, offs = None, None
    if kind == "win":
        want = (nblk, nb, WL)
    elif kind == "dwin":
        offs = tuple(int(o) for o in np.asarray(arrays["dwin_offs"]))
        want = (nblk, len(offs), nb)
    elif kind == "gather":
        Lind = torch.from_numpy(np.array(arrays["Lind"], dtype=np.int32)).to(dev)
        want = (nblk, nb, Lval.shape[2] if Lval.dim() == 3 else -1)
        if tuple(Lind.shape) != want:
            raise ValueError(f"Lind {tuple(Lind.shape)} does not match Lval {tuple(Lval.shape)}")
    else:
        raise ValueError(f"no TrsvForm of kind {kind!r}")
    if tuple(D.shape) != (nblk, nb, nb) or tuple(Lval.shape) != want:
        raise ValueError(f"D {tuple(D.shape)} / Lval {tuple(Lval.shape)} do not match the {kind} form's {want}")
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
        _L_shape=tuple(Lval.shape),
        device=dev,
        kind=kind,
        WL=WL,
        Lind=Lind,
        dwin_offs=offs,
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


#: BandGemmPlan's integer fields (the same names in both packages)
_BAND_GEMM_INTS = ("G", "WA", "WB", "WC", "d0", "sl0", "nstream", "relC", "nblk")


def band_gemm_plan_from_jax(arrays: Mapping, device=None) -> BandGemmPlan:
    """This package's BandGemmPlan from a JAX one: its integer geometry,
    ``stream_ranges``, ``extract_idx`` and the operand bands ``bwd_val_A``
    and ``bwd_val_B`` ((nblk, G, WA) and (nblk, G, WB)) as numpy. The
    operand forms carry no scatter maps, so the plan serves the numeric
    stage on these bands but not a value refresh."""
    dev = resolve_device(device)
    geo = {key: int(arrays[key]) for key in _BAND_GEMM_INTS}
    forms = []
    for side, W in (("A", geo["WA"]), ("B", geo["WB"])):
        band = as_values(np.ascontiguousarray(arrays[f"bwd_val_{side}"]), dev)
        if tuple(band.shape) != (geo["nblk"], geo["G"], W):
            raise ValueError(f"bwd_val_{side} has shape {tuple(band.shape)}, want {(geo['nblk'], geo['G'], W)}")
        forms.append(ExecForm(kind="bwdg", m=geo["nblk"] * geo["G"], n=0, bwd_val=band, bwd_W=W, bwd_G=geo["G"]))
    return BandGemmPlan(
        **geo,
        stream_ranges=tuple(tuple(int(v) for v in r) for r in arrays["stream_ranges"]),
        extract_idx=np.asarray(arrays["extract_idx"], dtype=np.int64),
        formA=forms[0],
        formB=forms[1],
    )
