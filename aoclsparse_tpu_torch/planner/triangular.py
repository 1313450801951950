"""Blocked triangular-solve planning.

PyTorch counterpart of ``aoclsparse_tpu/planner/triangular.py`` for the
``win`` form. The reference's TRSV is a sequential per-row sweep
(level2/aoclsparse_trsv_kt.cpp:65); the planner re-architects it as a chain
of row blocks of nb rows,

    x_k = D_k^{-1} (b_k - Lwin_k @ x[blk0 - WL, blk0)),

with D_k the dense (nb, nb) diagonal block and Lwin_k the dense (nb, WL)
window of the block's left-of-diagonal entries. Upper triangles solve on
reversed indices (reversing rows and columns turns U into L), applied to
the structure on the host. Each form inverts its diagonal blocks once per
values on the device and, on the card, builds the kernels' window products
(kernels/trsv_win.py `win_solve_operands`) once per values too, so a solve
is one call of the window-solve kernels (kernels/trsv_win.py,
csrc/trsv_win.cu), with one right-hand side or many.

Structure work is host numpy (or the host C++ builder, native/), once per
(triangle, operation, nb); every value-dependent array keeps scatter maps
into its value source, so `TrsvForm.refresh` rebuilds the operands on the
device from new values without re-planning.

Not ported yet (ROADMAP.md queue 1 item 12): the ``gather`` (padded-ELL)
and ``dwin`` (diagonal-window) forms, which the JAX package builds when the
dense window would be too large, and the level and host engines. Building
such a triangle raises ``not_implemented``; nothing falls back silently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.descr import MatrixDescriptor
from ..core.types import (
    AoclSparseError,
    DiagType,
    FillMode,
    MatrixType,
    Operation,
    Status,
    to_torch_dtype,
)
from ..kernels.trsv_win import DTYPES as SOLVE_DTYPES
from ..kernels.trsv_win import WinSolveOps, trsm_win, trsv_win, win_solve_operands
from .plan import CleanCSR, EffectiveCSR, Plan, _dev_index, build_effective_csr

__all__ = [
    "TrsvForm",
    "adaptive_nb",
    "build_trsv_form",
    "build_trsv_form_native",
    "check_solve_dtype",
    "invert_diag_blocks",
    "trsv_form_for",
]

DEFAULT_BLOCK = 64
#: the widest left window a ``win`` form may carry (the JAX package's cap)
MAX_WL = 8192

_ITEM12 = "ROADMAP.md queue 1 item 12"


def check_solve_dtype(dtype) -> None:
    """Real f32/f64 triangles only; bf16 and complex are not ported yet."""
    if to_torch_dtype(dtype) not in SOLVE_DTYPES:
        raise AoclSparseError(
            Status.not_implemented,
            f"triangular solves of {dtype} are not ported yet ({_ITEM12})",
        )


def adaptive_nb(m: int, dtype=None) -> int:
    """Block size. The JAX package aims at about 512 scan steps, then, where
    its Pallas solve can run, takes min(256, max(128, base)) for m >= 1024
    (planner/triangular.py:52-68). The port always has its kernel for f32
    and f64, so it takes that branch for them: a step streams nb*nb + WL*nb
    values, and smaller blocks cut the dense diagonal-block traffic."""
    base = int(min(512, max(DEFAULT_BLOCK, 1 << int(np.ceil(np.log2(max(m / 512, 1)))))))
    if m >= 8 * 128 and (dtype is None or to_torch_dtype(dtype) in SOLVE_DTYPES):
        return int(min(256, max(128, base)))
    return base


def invert_diag_blocks(D: torch.Tensor) -> torch.Tensor:
    """Invert the (nblk, nb, nb) lower-triangular diagonal blocks in one
    batched triangular solve against the identity, on D's device
    (kernels/xla/trsv.py:55 `invert_diag_blocks`). Planner work, once per
    form."""
    nb = D.shape[1]
    eye = torch.eye(nb, dtype=D.dtype, device=D.device).expand(D.shape[0], nb, nb)
    return torch.linalg.solve_triangular(D, eye, upper=False)


@dataclasses.dataclass
class TrsvForm:
    """Blocked lower-triangular operand (after the reversal permutation when
    the triangle was upper), kind ``win``: D (nblk, nb, nb) dense diagonal
    blocks and Lval (nblk, nb, WL) dense left windows ending at each block's
    first row, tensors on the matrix's device."""

    nb: int  # block size
    nblk: int  # number of blocks (m_pad = nblk * nb)
    m: int  # true dimension
    reversed_: bool  # True -> solve on reversed indices (upper source)
    unit_diag: bool
    D: Optional[torch.Tensor]
    Lval: Optional[torch.Tensor]
    # host refresh maps: flat destinations in D / Lval and source positions
    # in the value vector the form was filled from (None for a form carried
    # across from the JAX package, which serves solves only)
    _D_dest: Optional[np.ndarray]
    _D_srcpos: Optional[np.ndarray]
    _D_paddest: Optional[np.ndarray]  # flat positions that get 1.0
    _L_dest: Optional[np.ndarray]
    _L_srcpos: Optional[np.ndarray]
    _L_shape: Tuple
    device: torch.device = torch.device("cpu")
    kind: str = "win"
    WL: int = 0
    #: "eff": maps index an effective CSR's values; "clean": the clean
    #: structure's positions (native builds, e.g. ILU0's factored values)
    _src_space: str = "eff"
    #: lazy kernel operands (dinvT, lwT): the inverted diagonal blocks and
    #: the windows, transposed to the kernel's row-vector layout
    _ops: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    #: lazy card operands of the kernels (`win_solve_operands` of _ops)
    _solve_ops: Optional[WinSolveOps] = None

    @property
    def m_pad(self) -> int:
        return self.nblk * self.nb

    def refresh(self, values) -> None:
        """Refill D and Lval from a value vector over the form's source
        space (a tensor, or a host array), by a scatter on the device; the
        kernel operands derive from them and drop."""
        self._ops = self._solve_ops = None
        dev = self.device
        v = values if isinstance(values, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(values))
        v = v.to(dev)
        D = torch.zeros(self.nblk * self.nb * self.nb, dtype=v.dtype, device=dev)
        D[_dev_index(self._D_dest, dev)] = v[_dev_index(self._D_srcpos, dev)]
        D[_dev_index(self._D_paddest, dev)] = 1.0
        self.D = D.reshape(self.nblk, self.nb, self.nb)
        L = torch.zeros(int(np.prod(self._L_shape)), dtype=v.dtype, device=dev)
        L[_dev_index(self._L_dest, dev)] = v[_dev_index(self._L_srcpos, dev)]
        self.Lval = L.reshape(self._L_shape)

    def operands(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dinvT, lwT) of the window-solve kernel, built once per form."""
        if self._ops is None:
            dinvT = invert_diag_blocks(self.D).transpose(1, 2).contiguous()
            self._ops = (dinvT, self.Lval.transpose(1, 2).contiguous())
        return self._ops

    def solve_ops(self) -> WinSolveOps:
        """The card's operands of the kernels besides dinvT (P, and for a
        grouped solve F), built once per form and dropped by `refresh`:
        planner work once per values, like the diagonal-block inversion."""
        if self._solve_ops is None:
            self._solve_ops = win_solve_operands(*self.operands(), self.nb, self.WL)
        return self._solve_ops

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        """Solve on a padded (m_pad,) or (m_pad, k) right-hand side in block
        order: the window-solve kernels on a CUDA tensor, their plain
        version on a CPU one (which builds no card operands). A single
        column takes the single-RHS solve and wider ones the multi-RHS
        solve, as the JAX package splits them (planner/triangular.py:145-208)."""
        dinvT, lwT = self.operands()
        r = r.to(dinvT.dtype)
        ops = self.solve_ops() if r.device.type == "cuda" else None
        if r.dim() == 1:
            return trsv_win(dinvT, lwT, r.contiguous(), self.nb, self.WL, ops)
        if r.shape[1] == 1:
            return trsv_win(dinvT, lwT, r[:, 0].contiguous(), self.nb, self.WL, ops)[:, None]
        return trsm_win(dinvT, lwT, r.contiguous(), self.nb, self.WL, ops)


def _reverse_structure(eff: EffectiveCSR) -> EffectiveCSR:
    """Apply the reversal permutation to rows and cols (host side): the
    upper triangle becomes lower. Effective-CSR rows are column-sorted, so
    new row m-1-r is old row r's entries in reverse order; src maps each
    new entry to its position in eff's values."""
    m = eff.m
    ptr = eff.ptr.astype(np.int64)
    lens = np.diff(ptr)
    rlens = lens[::-1]
    nptr = np.concatenate([[0], np.cumsum(rlens)])
    nnz = int(ptr[-1])
    rows_new = np.repeat(np.arange(m, dtype=np.int64), rlens) if nnz else np.zeros(0, np.int64)
    off = np.arange(nnz, dtype=np.int64) - np.repeat(nptr[:-1], rlens)
    old_row = (m - 1) - rows_new
    order = ptr[old_row + 1] - 1 - off
    new_cols = (m - 1) - eff.ind.astype(np.int64)[order]
    return EffectiveCSR(
        nptr.astype(np.int32), new_cols.astype(np.int32), order.astype(np.int64),
        False, eff.const_val, (m, m),
    )


def build_trsv_form(
    descr: MatrixDescriptor,
    op: Operation,
    eff: EffectiveCSR,
    nb: int = DEFAULT_BLOCK,
    val_override=None,
) -> TrsvForm:
    """The numpy builder (planner/triangular.py:263-433, ``win`` branch).
    val_override: host values over eff's structure to fill the form with
    instead of eff.val (ILU0 passes its host-factored values)."""
    m = eff.m
    dt = DiagType(descr.diag_type)
    lower = FillMode(descr.fill_mode) == FillMode.lower
    eff_lower = lower if Operation(op) == Operation.none else not lower
    if not eff_lower:
        rev = _reverse_structure(eff)
        ptr, ind, src = rev.ptr, rev.ind, rev.src
        reversed_ = True
    else:
        ptr, ind, src = eff.ptr, eff.ind, np.arange(eff.nnz, dtype=np.int64)
        reversed_ = False

    nb = int(min(nb, max(8, m)))
    nblk = -(-m // nb) if m else 1
    m_pad = nblk * nb
    ptr64 = ptr.astype(np.int64)
    lens = np.diff(ptr64)
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    cols = ind.astype(np.int64)

    # the reference requires a full diagonal for non-unit solves
    # (trsv.cpp:130-134 -> invalid_value)
    if dt == DiagType.zero:
        raise AoclSparseError(Status.invalid_value, "cannot solve with zero diagonal")
    if dt == DiagType.non_unit:
        ndiag = np.bincount(rows[cols == rows], minlength=m) if rows.size else np.zeros(m)
        missing = np.nonzero(ndiag == 0)[0]
        if missing.size:
            raise AoclSparseError(
                Status.invalid_value, f"missing diagonal entry in row {int(missing[0])}"
            )

    blk_of_row = rows // nb
    blk0 = blk_of_row * nb
    lmask = cols < blk0  # left-of-block entries: a prefix of each sorted row
    r_in_blk = rows % nb
    WL_need = int((blk0 - cols)[lmask].max()) if lmask.any() else 0
    WL = max(8, -(-WL_need // 8) * 8)
    if not ((nblk * nb * WL) <= max(8 * cols.size, 64 * nb * nb) and WL <= MAX_WL):
        raise AoclSparseError(
            Status.not_implemented,
            f"left window WL={WL} too wide for the dense window form; the gather and "
            f"dwin forms are not ported yet ({_ITEM12})",
        )
    t_l = (cols - blk0 + WL)[lmask]
    L_dest = ((blk_of_row[lmask] * nb + r_in_blk[lmask]) * WL + t_l).astype(np.int64)
    L_srcpos = src[lmask].astype(np.int64)
    dmask = (cols >= blk0) & (cols < blk0 + nb)
    D_dest = ((blk_of_row[dmask] * nb + r_in_blk[dmask]) * nb + (cols - blk0)[dmask]).astype(
        np.int64
    )
    D_srcpos = src[dmask].astype(np.int64)
    # identity-pad rows beyond m (+ missing unit diagonals)
    pad_rows = np.arange(m, m_pad, dtype=np.int64)
    if dt == DiagType.unit:
        have = np.zeros(m, dtype=bool)
        have[rows[dmask & (cols == rows)]] = True
        pad_rows = np.concatenate([pad_rows, np.nonzero(~have)[0].astype(np.int64)])
    D_paddest = ((pad_rows // nb) * nb + pad_rows % nb) * nb + pad_rows % nb

    values = eff.val if val_override is None else val_override
    form = TrsvForm(
        nb=nb,
        nblk=nblk,
        m=m,
        reversed_=reversed_,
        unit_diag=(dt == DiagType.unit),
        D=None,
        Lval=None,
        _D_dest=D_dest,
        _D_srcpos=D_srcpos,
        _D_paddest=D_paddest,
        _L_dest=L_dest,
        _L_srcpos=L_srcpos,
        _L_shape=(nblk, nb, WL),
        device=eff.val.device,
        WL=WL,
    )
    form.refresh(values)
    return form


def build_trsv_form_native(
    clean: CleanCSR,
    descr: MatrixDescriptor,
    op: Operation,
    nb: int,
    values: np.ndarray,
    device: torch.device,
) -> Optional[TrsvForm]:
    """The host C++ builder (planner/triangular.py:436-568, host upload
    only): the triangle is cut straight off the clean structure's split
    pointers, D and Lw are filled in one O(nnz) sweep, and both are
    uploaded. `values` are host values over clean positions, and so are the
    refresh maps. Returns None when the builder does not apply (op !=
    none, dtype, window cap, library missing); callers then build in numpy."""
    from .. import native

    if Operation(op) != Operation.none:
        return None
    dt = DiagType(descr.diag_type)
    if dt == DiagType.zero:
        raise AoclSparseError(Status.invalid_value, "cannot solve with zero diagonal")
    m = clean.m
    if m == 0 or clean.shape[0] != clean.shape[1]:
        return None
    values = np.asarray(values)
    if values.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    ptr64 = clean.ptr.astype(np.int64)
    if FillMode(descr.fill_mode) == FillMode.lower:
        lo = ptr64[:-1]
        hi = (clean.iurow if dt == DiagType.non_unit else clean.idiag).astype(np.int64)
        reversed_ = False
    else:
        lo = (clean.idiag if dt == DiagType.non_unit else clean.iurow).astype(np.int64)
        hi = ptr64[1:]
        reversed_ = True
    if dt == DiagType.non_unit and not clean.fulldiag:
        missing = np.nonzero(~clean.has_diag)[0]
        if missing.size:
            raise AoclSparseError(
                Status.invalid_value, f"missing diagonal entry in row {int(missing[0])}"
            )
    nb = int(min(nb, max(8, m)))
    got = native.trsv_win_build(m, lo, hi, clean.ind, values, nb, reversed_)
    if got is None:
        return None
    nblk, WL = got["nblk"], got["WL"]
    pad_rows = np.arange(m, nblk * nb, dtype=np.int64)
    if dt == DiagType.unit:
        # strict slices never store the diagonal: every row takes the
        # implicit 1.0 (the numpy builder's miss detection gives the same)
        pad_rows = np.concatenate([pad_rows, np.arange(m, dtype=np.int64)])
    D_paddest = ((pad_rows // nb) * nb + pad_rows % nb) * nb + pad_rows % nb
    D = got["D"]
    D[D_paddest] = 1.0
    form = TrsvForm(
        nb=nb,
        nblk=nblk,
        m=m,
        reversed_=reversed_,
        unit_diag=(dt == DiagType.unit),
        D=torch.from_numpy(D.reshape(nblk, nb, nb)).to(device),
        Lval=torch.from_numpy(got["Lw"].reshape(nblk, nb, WL)).to(device),
        _D_dest=got["D_dest"],
        _D_srcpos=got["D_srcpos"],
        _D_paddest=D_paddest,
        _L_dest=got["L_dest"],
        _L_srcpos=got["L_srcpos"],
        _L_shape=(nblk, nb, WL),
        device=torch.device(device),
        WL=WL,
        _src_space="clean",
    )
    return form


def _tri_descr(descr: MatrixDescriptor) -> MatrixDescriptor:
    """The descriptor coerced to triangular semantics: the reference treats
    symmetric descriptors as triangular in trsv (aoclsparse_trsv.cpp:141-151)."""
    return MatrixDescriptor(
        type=MatrixType.triangular,
        fill_mode=descr.fill_mode,
        diag_type=descr.diag_type,
        base=descr.base,
    )


def trsv_form_for(
    plan: Plan, descr: MatrixDescriptor, op: Operation, nb: Optional[int] = None
) -> TrsvForm:
    """Cached TrsvForm lookup on the matrix plan (planner/triangular.py:571).
    The native builder serves op=none; the numpy builder the rest."""
    check_solve_dtype(plan.clean.val.dtype)
    if nb is None:
        nb = adaptive_nb(plan.clean.m, dtype=plan.clean.val.dtype)
    tri = _tri_descr(descr)
    op = Operation(op)
    if plan.levels is None:
        plan.levels = {}
    key = ("trsv", tri.fill_mode, tri.diag_type, op, nb)
    form = plan.levels.get(key)
    if form is not None:
        return form
    if op == Operation.none:
        form = build_trsv_form_native(
            plan.clean, tri, Operation.none, nb, plan.clean.host_val(), plan.clean.val.device
        )
    if form is None:
        form = _build_trsv_form_for(plan, tri, op, nb)
    plan.levels[key] = form
    return form


def _build_trsv_form_for(plan: Plan, tri_descr: MatrixDescriptor, op: Operation, nb: int):
    """The numpy route: the effective triangle built without op; a
    transposed solve transposes the structure on the host and flips the
    triangle's orientation (planner/triangular.py:620-645). Real dtypes
    only, so conjugate-transpose is transpose."""
    eff = build_effective_csr(plan.clean, tri_descr, Operation.none)
    if Operation(op) != Operation.none:
        return build_trsv_form(tri_descr, Operation.transpose, _transpose_eff(eff), nb)
    return build_trsv_form(tri_descr, Operation.none, eff, nb)


def _transpose_eff(eff: EffectiveCSR) -> EffectiveCSR:
    """Host transpose of an effective CSR; its values are eff's, permuted
    (planner/triangular.py:648-671)."""
    m, n = eff.shape
    ptr = eff.ptr.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    ind = eff.ind.astype(np.int64)
    order = np.lexsort((rows, ind))
    tptr = np.zeros(n + 1, dtype=np.int64)
    if ind.size:
        np.add.at(tptr, ind + 1, 1)
    tptr = np.cumsum(tptr)
    out = EffectiveCSR(
        tptr.astype(np.int32),
        rows[order].astype(np.int32),
        np.arange(eff.nnz, dtype=np.int64)[order],
        False,
        eff.const_val,
        (n, m),
    )
    out.val = eff.val[_dev_index(order, eff.val.device)]
    return out
