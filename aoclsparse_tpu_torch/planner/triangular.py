"""Blocked triangular-solve planning.

PyTorch counterpart of ``aoclsparse_tpu/planner/triangular.py``. The
reference's TRSV is a sequential per-row sweep
(level2/aoclsparse_trsv_kt.cpp:65); the planner re-architects it as a chain
of row blocks of nb rows,

    x_k = D_k^{-1} (b_k - s_k),

with D_k the dense (nb, nb) diagonal block and s_k the block's
left-of-diagonal entries times the solved x, in one of three layouts:

- ``win``: a dense (nb, WL) window ending at each block's first row, where
  nblk*nb*WL stays near the nonzeros (banded triangles). A solve is one
  call of the window-solve kernels (kernels/trsv_win.py, csrc/trsv_win.cu),
  which also read the window products the form builds once per values on
  the card (`win_solve_operands`).
- ``dwin``: the left part as a few element diagonals (nblk, ndg, nb), for
  wide windows with at most AOCLSPARSE_TPU_TRSV_DWIN_MAX distinct left
  offsets (stencil and FEM triangles: HPCG's 27-point stencil has 13).
- ``gather``: a padded ELL (nblk, nb, W) of column indices and values, for
  the rest, refused with ``memory_error`` past AOCLSPARSE_TPU_TRSV_WIN_CAP
  bytes (a hub row makes W huge).

The last two run on one launch of the blocked-solve chain kernel
(kernels/trsv_blocked.py, csrc/trsv_blocked.cu). Each form inverts its
diagonal blocks once per values on the device. Upper triangles solve on
reversed indices (reversing rows and columns turns U into L), applied to
the structure on the host.

Structure work is host numpy (or the host C++ builder, native/, for
``win``), once per (triangle, operation, nb); every value-dependent array
keeps scatter maps into its value source, so `TrsvForm.refresh` rebuilds
the operands on the device from new values without re-planning.

Besides the blocked forms: `TrsvHostForm` (sv KID 2, the host sequential
substitution of native/) and the level-scheduled form of
kernels/trsv_level.py (sv KID 1), with their builders.

`sv_engine_for` is the default solve's choice between a blocked form and the
level kernel (csrc/trsv_level.cu), the port's counterpart of the JAX
package's `_trsv_engine` pin (ops/level2/trsv.py:105-109 there, which
`autotune_trsv` sets): on the card a ``dwin`` or ``gather`` form, whose
chain kernel takes one dependent step a block, gives way to the level
kernel where `nlev` levels cost less than `nblk` chain steps
(`level_wins`); a ``win`` form's grouped chain takes few steps and stays.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Tuple

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
from ..kernels.trsv_blocked import DTYPES as CHAIN_DTYPES
from ..kernels.trsv_blocked import trsv_dwin, trsv_dwin_plain, trsv_gather, trsv_gather_plain
from ..kernels.trsv_level import DTYPES as LEVEL_DTYPES
from ..kernels.trsv_win import DTYPES as WIN_DTYPES
from ..kernels.trsv_win import WinSolveOps, trsm_win, trsm_win_plain, trsv_win, trsv_win_plain, win_solve_operands
from .plan import CleanCSR, EffectiveCSR, Plan, _dev_index, build_effective_csr, host_values

__all__ = [
    "TrsvForm",
    "TrsvHostForm",
    "adaptive_nb",
    "build_trsv_form",
    "build_trsv_form_native",
    "check_solve_dtype",
    "has_solve_kernel",
    "invert_diag_blocks",
    "level_wins",
    "pick_sv_engine",
    "sv_engine_for",
    "trsv_form_for",
    "trsv_host_form_for",
    "trsv_level_form_for",
    "trsv_level_stats_for",
]

DEFAULT_BLOCK = 64
#: the widest left window a ``win`` form may carry (the JAX package's cap)
MAX_WL = 8192
#: the farthest left offset a ``dwin`` form may carry (the JAX package's)
MAX_DWIN_OFFSET = 65536
#: the widest block of a ``dwin`` or ``gather`` form (`adaptive_nb`)
CHAIN_NB = 64
#: the forms whose solve is the chain kernel (csrc/trsv_blocked.cu)
CHAIN_KINDS = ("dwin", "gather")
#: the level engine's reach in levels, as the default's choice and as the
#: fallback of a refused blocked form (ops/level2/trsv.py:152 there)
LEVEL_MAX_NLEV = 4096
#: the devices on which the default solve may take the level kernel; the
#: CPU's default stays the blocked form (a test adds "cpu" to drive the
#: routing through the plain versions)
SV_LEVEL_DEVICES = ("cuda",)
#: the gate's constants in microseconds, measured by chip_smoke.py phase 6
#: on an NVIDIA H100 80GB HBM3 at 700 W: the level kernel's time a level
#: (a solve of the 104^3 stencil's lower triangle over its 722 levels) and
#: the chain kernel's time a step (its dwin solve over 17,576 blocks of 64)
T_LEVEL_US = 2.43
T_STEP_US = 2.48

#: the dtypes of a triangular solve: those of the JAX package's handles
SOLVE_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.complex64, torch.complex128)
#: the blocked forms' solve kernels by kind, and the dtypes they have
#: instances for; a complex form runs its kernel's plain version, chosen by
#: dtype in `solve`, as the JAX package runs every complex solve on its XLA
#: scans (planner/triangular.py:133-221 there gates its Pallas routes off);
#: a bf16 ``dwin``/``gather`` form does so on the CPU and raises on the card
KERNEL_DTYPES = {"win": WIN_DTYPES, "dwin": CHAIN_DTYPES, "gather": CHAIN_DTYPES}


def check_solve_dtype(dtype) -> None:
    """The handle dtypes a triangular solve takes: f32, f64, bf16, complex64
    and complex128, as in the JAX package."""
    if to_torch_dtype(dtype) not in SOLVE_DTYPES:
        raise AoclSparseError(Status.not_implemented, f"no triangular solve for {dtype}")


def has_solve_kernel(kind: str, dtype) -> bool:
    """Whether a form of `kind` and `dtype` has a solve kernel instance on
    the card; else its solve is the plain route (`TrsvForm.solve`)."""
    return to_torch_dtype(dtype) in KERNEL_DTYPES[kind]


def adaptive_nb(m: int, dtype=None) -> int:
    """Block size. The JAX package aims at about 512 scan steps, then, where
    its Pallas solve can run, takes min(256, max(128, base)) for m >= 1024
    (planner/triangular.py:52-68). The port has its window-solve kernel for
    f32, f64 and bf16, so it takes that branch for them: a step streams
    nb*nb + WL*nb values, and smaller blocks cut the dense diagonal-block
    traffic. Complex takes the base branch, as in the JAX package: its
    solves run the plain block loops, where halving nb doubles the steps.

    A ``dwin`` or ``gather`` form takes at most CHAIN_NB = 64 rows a block
    (`build_trsv_form` builds it again at that width): its chain kernel
    (csrc/trsv_blocked.cu) runs on one SM, and past 64 rows its step time
    grows faster than the step count falls. A solve of the 104^3 stencil's
    lower triangle (f32, one right-hand side; chip_smoke.py phase 6 on an
    NVIDIA H100 80GB HBM3 at 700 W) took 64.75 ms at nb = 32, 43.85 at 64,
    47.10 at 128 and 70.62 at 256 (1.84, 2.50, 5.36 and 16.07 us a step)."""
    base = int(min(512, max(DEFAULT_BLOCK, 1 << int(np.ceil(np.log2(max(m / 512, 1)))))))
    if m >= 8 * 128 and (dtype is None or to_torch_dtype(dtype) in WIN_DTYPES):
        return int(min(256, max(128, base)))
    return base


def invert_diag_blocks(D: torch.Tensor) -> torch.Tensor:
    """Invert the (nblk, nb, nb) lower-triangular diagonal blocks in one
    batched triangular solve against the identity, on D's device
    (kernels/xla/trsv.py:55 `invert_diag_blocks`). Planner work, once per
    form. bf16 blocks invert in f32 and round once to bf16 (the batched
    solve has no bf16 kernel)."""
    nb = D.shape[1]
    work = torch.float32 if D.dtype == torch.bfloat16 else D.dtype
    eye = torch.eye(nb, dtype=work, device=D.device).expand(D.shape[0], nb, nb)
    return torch.linalg.solve_triangular(D.to(work), eye, upper=False).to(D.dtype)


@dataclasses.dataclass
class TrsvForm:
    """Blocked lower-triangular operand (after the reversal permutation when
    the triangle was upper): D (nblk, nb, nb) dense diagonal blocks and the
    left part Lval, tensors on the matrix's device. By kind, Lval is
    (nblk, nb, WL) dense windows ending at each block's first row (``win``),
    (nblk, ndg, nb) element diagonals at the offsets dwin_offs (``dwin``;
    WL the largest offset rounded up to 8), or (nblk, nb, W) padded-ELL
    values with column indices Lind (``gather``)."""

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
    #: gather: (nblk, nb, W) int32 column indices into the padded x
    Lind: Optional[torch.Tensor] = None
    #: dwin: the ascending left offsets of Lval's diagonals
    dwin_offs: Optional[Tuple[int, ...]] = None
    #: "eff": maps index an effective CSR's values; "clean": the clean
    #: structure's positions (native builds, e.g. ILU0's factored values)
    _src_space: str = "eff"
    #: lazy kernel operands (dinvT, left): the inverted diagonal blocks
    #: transposed, and the windows transposed (win) or Lval as it is
    _ops: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    #: lazy card operands of the window-solve kernels (`win_solve_operands`)
    _solve_ops: Optional[WinSolveOps] = None
    #: lazy dwin offsets as an int32 tensor on the device
    _offs_t: Optional[torch.Tensor] = None
    #: the operand dtype (the handle's); values of another dtype are cast to
    #: it on refresh (bf16 handles' host values come as float32)
    dtype: Optional[torch.dtype] = None

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
        v = v.to(dev, self.dtype or v.dtype)
        D = torch.zeros(self.nblk * self.nb * self.nb, dtype=v.dtype, device=dev)
        D[_dev_index(self._D_dest, dev)] = v[_dev_index(self._D_srcpos, dev)]
        D[_dev_index(self._D_paddest, dev)] = 1.0
        self.D = D.reshape(self.nblk, self.nb, self.nb)
        L = torch.zeros(int(np.prod(self._L_shape)), dtype=v.dtype, device=dev)
        L[_dev_index(self._L_dest, dev)] = v[_dev_index(self._L_srcpos, dev)]
        self.Lval = L.reshape(self._L_shape)

    def operands(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dinvT, left operand) of the form's kernel, built once per form:
        lwT, the windows transposed, for ``win``; Lval itself otherwise."""
        if self._ops is None:
            dinvT = invert_diag_blocks(self.D).transpose(1, 2).contiguous()
            left = self.Lval.transpose(1, 2).contiguous() if self.kind == "win" else self.Lval
            self._ops = (dinvT, left)
        return self._ops

    def solve_ops(self) -> WinSolveOps:
        """The card's operands of the window-solve kernels besides dinvT (P,
        and for a grouped solve F), built once per form and dropped by
        `refresh`: planner work once per values, like the diagonal-block
        inversion. ``win`` forms only."""
        if self._solve_ops is None:
            self._solve_ops = win_solve_operands(*self.operands(), self.nb, self.WL)
        return self._solve_ops

    def offsets(self) -> torch.Tensor:
        """The dwin offsets as an int32 tensor on the form's device."""
        if self._offs_t is None:
            self._offs_t = torch.tensor(self.dwin_offs, dtype=torch.int32, device=self.device)
        return self._offs_t

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        """Solve on a padded (m_pad,) or (m_pad, k) right-hand side in block
        order, by kind (planner/triangular.py:115-226 there): the window-solve
        kernels for ``win`` (a single column takes the single-RHS solve and
        wider ones the multi-RHS solve, as the JAX package splits them), the
        blocked-solve chain kernel for ``dwin`` and ``gather``; their plain
        versions on a CPU tensor (which build no card operands). Complex
        (no window or chain instance, `has_solve_kernel`) takes the plain
        route on any device; a bf16 ``dwin`` or ``gather`` form (no chain
        instance) takes it on the CPU and raises `not_implemented` on the
        card (ROADMAP item 29)."""
        dinvT, left = self.operands()
        r = r.to(dinvT.dtype).contiguous()
        if not has_solve_kernel(self.kind, dinvT.dtype):
            if r.device.type != "cpu" and not dinvT.dtype.is_complex:
                raise AoclSparseError(
                    Status.not_implemented,
                    f"no {dinvT.dtype} instance of the chain kernel for a {self.kind} form on "
                    f"{r.device} (ROADMAP item 29)")
            return self._solve_plain(dinvT, left, r)
        if self.kind == "dwin":
            return trsv_dwin(dinvT, left, self.offsets(), r, self.nb, self.WL)
        if self.kind == "gather":
            return trsv_gather(dinvT, self.Lind, left, r, self.nb)
        ops = self.solve_ops() if r.device.type == "cuda" else None
        if r.dim() == 1:
            return trsv_win(dinvT, left, r, self.nb, self.WL, ops)
        if r.shape[1] == 1:
            return trsv_win(dinvT, left, r[:, 0].contiguous(), self.nb, self.WL, ops)[:, None]
        return trsm_win(dinvT, left, r, self.nb, self.WL, ops)

    def _solve_plain(self, dinvT: torch.Tensor, left: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """The plain route: the kind's kernel contract as a Python loop over
        blocks (kernels/trsv_win.py, kernels/trsv_blocked.py)."""
        if self.kind == "dwin":
            return trsv_dwin_plain(dinvT.transpose(1, 2), left, r, self.nb, self.WL, self.dwin_offs)
        if self.kind == "gather":
            return trsv_gather_plain(dinvT.transpose(1, 2), self.Lind, left, r, self.nb)
        if r.dim() == 1:
            return trsv_win_plain(dinvT, left, r, self.nb, self.WL)
        return trsm_win_plain(dinvT, left, r, self.nb, self.WL)


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
    """The numpy builder (planner/triangular.py:263-433): ``win`` where the
    dense window stays near the nonzeros, else ``dwin``, else ``gather``
    (``memory_error`` past the cap). val_override: host values over eff's
    structure to fill the form with instead of eff.val (ILU0 passes its
    host-factored values)."""
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
    itemsize = eff.val.element_size()
    cap = float(os.environ.get("AOCLSPARSE_TPU_TRSV_WIN_CAP", "1.2e9"))
    L_ind = None
    dwin_offs = None
    if (nblk * nb * WL) <= max(8 * cols.size, 64 * nb * nb) and WL <= MAX_WL:
        kind = "win"
        t_l = (cols - blk0 + WL)[lmask]
        L_dest = ((blk_of_row[lmask] * nb + r_in_blk[lmask]) * WL + t_l).astype(np.int64)
        L_shape = (nblk, nb, WL)
    elif nb > CHAIN_NB:
        # the chain kernel's forms take narrower blocks (adaptive_nb)
        return build_trsv_form(descr, op, eff, CHAIN_NB, val_override)
    else:
        # the diagonal window first: wide windows whose left part carries
        # few distinct element diagonals (stencils, FEM), O(ndg * m_pad)
        # storage where the dense window would be GBs (:343-367 there)
        offs_left = (rows - cols)[lmask]
        uoff = np.unique(offs_left) if offs_left.size else np.zeros(0, np.int64)
        dwin_max = int(os.environ.get("AOCLSPARSE_TPU_TRSV_DWIN_MAX", "192"))
        if (
            offs_left.size > 0
            and uoff.size <= dwin_max
            and int(uoff[-1]) <= MAX_DWIN_OFFSET
            and float(uoff.size * nblk * nb) * itemsize <= cap
        ):
            kind = "dwin"
            ndg = int(uoff.size)
            d_idx = np.searchsorted(uoff, offs_left)
            L_dest = ((blk_of_row[lmask] * ndg + d_idx) * nb + r_in_blk[lmask]).astype(np.int64)
            L_shape = (nblk, ndg, nb)
            WL = max(8, -(-int(uoff[-1]) // 8) * 8)
            dwin_offs = tuple(int(v) for v in uoff)
        else:
            # the padded-ELL left part, W = the widest row's left count; a
            # hub row blows it up, so its true size is guarded (:369-395)
            csum_left = np.concatenate([[0], np.cumsum(lmask.astype(np.int64))])
            left_counts = csum_left[ptr64[1:]] - csum_left[ptr64[:-1]]
            W = max(int(left_counts.max()) if m else 0, 1)
            nbytes = float(nblk * nb * W) * (4 + itemsize)
            if nbytes > cap:
                raise AoclSparseError(
                    Status.memory_error,
                    f"padded-ELL left window would need ~{nbytes / 1e9:.1f} GB"
                    f" ((nblk,nb,W)=({nblk},{nb},{W})); use the level engine"
                    " (kid=1) or the host engine (kid=2), or raise"
                    " AOCLSPARSE_TPU_TRSV_WIN_CAP",
                )
            kind = "gather"
            pos_in_row = np.arange(cols.size, dtype=np.int64) - np.repeat(ptr64[:-1], lens)
            t_l = pos_in_row[lmask]
            ind_np = np.zeros((nblk, nb, W), dtype=np.int32)
            ind_np[blk_of_row[lmask], r_in_blk[lmask], t_l] = cols[lmask].astype(np.int32)
            L_ind = torch.from_numpy(ind_np).to(eff.val.device)
            L_dest = ((blk_of_row[lmask] * nb + r_in_blk[lmask]) * W + t_l).astype(np.int64)
            L_shape = (nblk, nb, W)
            WL = 0
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
        _L_shape=L_shape,
        device=eff.val.device,
        kind=kind,
        WL=WL,
        Lind=L_ind,
        dwin_offs=dwin_offs,
        dtype=eff.val.dtype,
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
    dtype: Optional[torch.dtype] = None,
) -> Optional[TrsvForm]:
    """The host C++ builder (planner/triangular.py:436-568, host upload
    only): the triangle is cut straight off the clean structure's split
    pointers, D and Lw are filled in one O(nnz) sweep, and both are
    uploaded. `values` are host values over clean positions (f32 or f64;
    a bf16 handle's come widened to f32, and `dtype` rounds the uploads
    back), and so are the refresh maps. Returns None when the builder does
    not apply (op != none, dtype, window cap, library missing); callers
    then build in numpy."""
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
        D=torch.from_numpy(D.reshape(nblk, nb, nb)).to(device, dtype),
        Lval=torch.from_numpy(got["Lw"].reshape(nblk, nb, WL)).to(device, dtype),
        _D_dest=got["D_dest"],
        _D_srcpos=got["D_srcpos"],
        _D_paddest=D_paddest,
        _L_dest=got["L_dest"],
        _L_srcpos=got["L_srcpos"],
        _L_shape=(nblk, nb, WL),
        device=torch.device(device),
        WL=WL,
        _src_space="clean",
        dtype=dtype,
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
            plan.clean, tri, Operation.none, nb, plan.clean.host_val(), plan.clean.val.device,
            plan.clean.val.dtype,
        )
    if form is None:
        form = _build_trsv_form_for(plan, tri, op, nb)
    plan.levels[key] = form
    return form


def _build_trsv_form_for(plan: Plan, tri_descr: MatrixDescriptor, op: Operation, nb: int):
    """The numpy route: the effective triangle built without op; a
    transposed solve transposes the structure on the host and flips the
    triangle's orientation, and a conjugate transpose conjugates the
    values first (planner/triangular.py:620-645)."""
    eff = _conj_for(build_effective_csr(plan.clean, tri_descr, Operation.none), op)
    if Operation(op) != Operation.none:
        return build_trsv_form(tri_descr, Operation.transpose, _transpose_eff(eff), nb)
    return build_trsv_form(tri_descr, Operation.none, eff, nb)


def _conj_for(eff: EffectiveCSR, op: Operation) -> EffectiveCSR:
    """The effective triangle with conjugated values for a conjugate
    transpose of a complex triangle (the JAX package's conj=True
    materialization), else as it is."""
    if Operation(op) == Operation.conjugate_transpose and eff.val.is_complex():
        return dataclasses.replace(eff, val=torch.conj_physical(eff.val))
    return eff


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


@dataclasses.dataclass
class TrsvHostForm:
    """Host-resident triangle for the sequential host substitution, sv KID
    2 (native/ trsv_seq and trsm_seq; planner/triangular.py:674-700 there).
    Everything stays numpy; a solve takes a tensor and returns a CPU tensor,
    as the host mv engine (KID 11) does. The reference's role: the scalar
    substitution of level2/aoclsparse_trsv_kr.hpp. Cached under
    plan.levels, which drops on update_values."""

    m: int
    ptr: np.ndarray  # (m+1,) int64
    ind: np.ndarray  # (nnz,) int64
    val: np.ndarray  # (nnz,) host values, diagonal materialized
    lower: bool

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x of an (m,) or (m, k) right-hand side, k columns threaded in C++
        like the reference's OpenMP split (level3/aoclsparse_trsm.hpp:149),
        in b's dtype."""
        from .. import native

        bh = host_values(b)
        if bh.ndim == 1:
            x = native.trsv_seq(self.m, self.ptr, self.ind, self.val, bh, self.lower)
        else:
            x = native.trsm_seq(self.m, self.ptr, self.ind, self.val, bh, self.lower)
        return torch.from_numpy(x).to(b.dtype)


def _host_eff_vals(eff: EffectiveCSR, clean: CleanCSR) -> np.ndarray:
    """An effective triangle's values on the host: the clean values at src,
    const_val where src is -1 (planner/triangular.py:703-715 there; the
    triangles of a solve carry no conjugation of their own)."""
    cv = clean.host_val()
    src = np.asarray(eff.src, dtype=np.int64)
    return np.where(src >= 0, cv[np.maximum(src, 0)], np.asarray(eff.const_val, dtype=cv.dtype))


def _sv_key_descr(plan: Plan, descr: MatrixDescriptor) -> MatrixDescriptor:
    check_solve_dtype(plan.clean.val.dtype)
    tri = _tri_descr(descr)
    if DiagType(tri.diag_type) == DiagType.zero:
        raise AoclSparseError(Status.invalid_value, "cannot solve with zero diagonal")
    if plan.levels is None:
        plan.levels = {}
    return tri


def trsv_host_form_for(plan: Plan, descr: MatrixDescriptor, op: Operation) -> TrsvHostForm:
    """Cached host-engine form, sv KID 2 (planner/triangular.py:718-759
    there): a transposed solve takes the host-transposed structure, a
    conjugate transpose the conjugated values; no reversal, the sequential
    sweep runs either direction."""
    tri = _sv_key_descr(plan, descr)
    op = Operation(op)
    key = ("trsv_host", tri.fill_mode, tri.diag_type, op)
    form = plan.levels.get(key)
    if form is not None:
        return form
    eff = build_effective_csr(plan.clean, tri, Operation.none)
    hval = _host_eff_vals(eff, plan.clean)
    if op == Operation.conjugate_transpose and np.iscomplexobj(hval):
        hval = np.conj(hval)
    ptr, ind = eff.ptr.astype(np.int64), eff.ind.astype(np.int64)
    lower = FillMode(tri.fill_mode) == FillMode.lower
    if op != Operation.none:
        rows = np.repeat(np.arange(eff.m, dtype=np.int64), np.diff(ptr))
        order = np.lexsort((rows, ind))
        tptr = np.zeros(eff.m + 1, dtype=np.int64)
        np.add.at(tptr, ind + 1, 1)
        ptr, ind, hval = np.cumsum(tptr), rows[order], hval[order]
        lower = not lower
    form = TrsvHostForm(
        m=eff.m,
        ptr=np.ascontiguousarray(ptr),
        ind=np.ascontiguousarray(ind),
        val=np.ascontiguousarray(hval),
        lower=lower,
    )
    plan.levels[key] = form
    return form


def _oriented_triangle(plan: Plan, tri: MatrixDescriptor, op: Operation):
    """(eff, ptr, ind, src, reversed_): the effective triangle (transposed
    for op != none, conjugated for a conjugate transpose) and its structure
    oriented lower, as the blocked form orients it (planner/triangular.py:
    792-842 there)."""
    eff = _conj_for(build_effective_csr(plan.clean, tri, Operation.none), op)
    if op != Operation.none:
        eff = _transpose_eff(eff)
    lower = FillMode(tri.fill_mode) == FillMode.lower
    if lower if op == Operation.none else not lower:
        return eff, eff.ptr, eff.ind, np.arange(eff.nnz, dtype=np.int64), False
    rev = _reverse_structure(eff)
    return eff, rev.ptr, rev.ind, rev.src, True


def trsv_level_stats_for(plan: Plan, descr: MatrixDescriptor, op: Operation):
    """(nlev, padded run entries) of the level-scheduled form without
    building it: the routing check of the default trsv's fallback."""
    from ..kernels.trsv_level import level_form_stats

    tri = _sv_key_descr(plan, descr)
    eff, ptr, ind, _src, _rev = _oriented_triangle(plan, tri, Operation(op))
    return level_form_stats(ptr, ind, eff.m)


def trsv_level_form_for(plan: Plan, descr: MatrixDescriptor, op: Operation):
    """Cached level-scheduled (wavefront) form, sv KID 1
    (kernels/trsv_level.py; planner/triangular.py:762-789 there), with the
    blocked form's orientation rules. Rebuilt after update_values."""
    from ..kernels.trsv_level import build_level_form

    tri = _sv_key_descr(plan, descr)
    op = Operation(op)
    key = ("trsv_level", tri.fill_mode, tri.diag_type, op)
    form = plan.levels.get(key)
    if form is None:
        eff, ptr, ind, src, rev = _oriented_triangle(plan, tri, op)
        form = build_level_form(ptr, ind, src, eff.m, rev, DiagType(tri.diag_type) == DiagType.unit, eff.val)
        plan.levels[key] = form
    return form


def level_wins(kind: str, nblk: int, nlev: int) -> bool:
    """The gate: a chain-kernel form (``dwin``, ``gather``) of nblk blocks
    gives way to the level kernel when its nlev levels, at most
    LEVEL_MAX_NLEV, cost less than its chain steps on the card."""
    return kind in CHAIN_KINDS and nlev <= LEVEL_MAX_NLEV and nlev * T_LEVEL_US < nblk * T_STEP_US


def pick_sv_engine(form: Optional[TrsvForm], nlev_of: Callable[[], int], device) -> str:
    """"level" or "blocked" for a solve on `device` whose blocked form is
    `form`; nlev_of() gives the triangle's level count (read from the
    structure, cached by the caller) and runs only where the count decides,
    on a device of SV_LEVEL_DEVICES. By dtype: a dtype with no level-kernel
    instance (bf16) stays blocked (a bf16 ``dwin``/``gather`` form then
    raises in `TrsvForm.solve` on the card); a dtype whose blocked form has
    no kernel instance (complex: no window or chain instance) takes the
    level kernel wherever its levels are at most LEVEL_MAX_NLEV, whatever
    the form's kind, and the plain block loops past that; the rest follow
    `level_wins`."""
    if form is None or torch.device(device).type not in SV_LEVEL_DEVICES or form.D.dtype not in LEVEL_DTYPES:
        return "blocked"
    if not has_solve_kernel(form.kind, form.D.dtype):
        return "level" if nlev_of() <= LEVEL_MAX_NLEV else "blocked"
    if form.kind not in CHAIN_KINDS:
        return "blocked"
    return "level" if level_wins(form.kind, form.nblk, nlev_of()) else "blocked"


def sv_engine_for(plan: Plan, descr: MatrixDescriptor, op: Operation, device,
                  form: Optional[TrsvForm] = None) -> str:
    """The default solve's engine for a triangle of a matrix plan ("level"
    or "blocked"), with its blocked form (`trsv_form_for`, or `form` where
    the caller has it) and the level count cached in plan.trsv_level_stats
    (`trsv_level_stats_for`)."""
    key = (descr.fill_mode, descr.diag_type, Operation(op))

    def nlev() -> int:
        if key not in plan.trsv_level_stats:
            plan.trsv_level_stats[key] = trsv_level_stats_for(plan, descr, op)
        return plan.trsv_level_stats[key][0]

    return pick_sv_engine(form if form is not None else trsv_form_for(plan, descr, op), nlev, device)
