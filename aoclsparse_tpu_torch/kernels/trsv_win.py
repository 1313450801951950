"""Blocked window triangular solve: the hand-written Hopper kernels of the
``win`` TrsvForm, their plain PyTorch versions and their launch counts.

Contract (``csrc/trsv_win.cu``, built by ``kernels/build.py``):

    x_k = (b_k - w @ lwT[k]) @ dinvT[k],   w <- [w, x_k][-WL:],   w starts at 0

over blocks k of nb rows: dinvT (nblk, nb, nb) = the inverted diagonal
blocks transposed, lwT (nblk, WL, nb) = the left windows transposed, b and
x of nblk*nb values, all f32, all f64 or all bf16. f32 and f64 accumulate
in their dtype; bf16 computes what the Pallas kernels compute on bf16
operands: each product sums in f32 and rounds to bf16, so s = w @ lwT[k],
b_k - s and x_k each round to bf16, and so does the window.

It replaces the JAX package's ``pallas_trsv_win_inv8``
(kernels/pallas/trsv.py:74) and ``pallas_trsv_win_inv`` (:114), one
contract at 8 blocks and at 1 block per grid step, and is the Hopper route
of ``trsv_blocked_win_inv`` (kernels/xla/trsv.py:72).

`trsm_win` is the same solve with K right-hand sides, row-major B and X of
(nblk*nb, K):

    X_k = dinvT[k]^T @ (B_k - lwT[k]^T @ W),   W <- [W; X_k][-WL:]

It replaces ``pallas_trsm_win_inv`` (kernels/pallas/trsv.py:160), which
takes B transposed per block.

On the card a solve is a few launches (the source's header has the
design): pass A computes ``C_k = B_k^T dinvT[k]`` for every block in
parallel over dinvT's upper triangle; a chain walks the blocks and carries
only the window through the tails of ``P = lwT @ dinvT``; pass C finishes
the other rows of every block in parallel. Where the window is the last
block's chain rows (WL <= nb) and there are enough blocks (`chain_group`),
the chain runs grouped: each group's own chain, a chain over the groups
through the products F of their tails, and a parallel fix-up.
`solve_launches` counts them. ``P`` and ``F`` depend on the values only:
`win_solve_operands` builds them once into a `WinSolveOps` (the form does,
planner/triangular.py, for a form on the card), which the caller passes as
``ops=``. The kernels read dinvT's upper triangle only, so dinvT[k] must be
upper triangular, as inverted lower-triangular blocks transposed are.

The bf16 instance reads bf16 dinvT and b and f32 ``P`` and ``F`` (the
source's header says why), sums in f32 into an f32 work copy of x, which
the chain rounds to bf16 as rows enter the window, and rounds the copy to
the bf16 x in one more launch.

`trsv_win` and `trsm_win` have one rule: a CPU tensor takes the plain
version (``ops`` is not read), a CUDA tensor launches the kernels or
raises. `trsv_win.launches` and `trsm_win.launches` count the kernel
launches the C entry reports, per instance.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from ..core.types import AoclSparseError, Status
from .build import MAX_SMEM, load_library

__all__ = [
    "DTYPES",
    "MAX_NB",
    "MAX_SMEM",
    "TRSM_MAX_NB",
    "ChainPlan",
    "WinSolveOps",
    "chain_group",
    "chain_plan",
    "solve_launches",
    "trsm_chunk",
    "trsm_win",
    "trsm_win_plain",
    "trsv_win",
    "trsv_win_plain",
    "win_solve_operands",
]

#: dtype -> (instance name, C entry point)
_INSTANCES = {
    torch.float32: ("f32", "win_solve_f32"),
    torch.float64: ("f64", "win_solve_f64"),
    torch.bfloat16: ("bf16", "win_solve_bf16"),
}
#: operand dtype -> the dtype of its sums, of P and F and of the work copy
#: of x (and so of the chain's shared-memory plan)
WORK_DTYPE = {torch.float32: torch.float32, torch.float64: torch.float64, torch.bfloat16: torch.float32}
#: column chunk sizes the kernels are built for
_CHUNKS = (16, 8, 4, 2, 1)
#: the multi-RHS passes run one thread a row of a block, at most this many
TRSM_MAX_NB = 512
#: operand dtypes the kernels have instances for
DTYPES = tuple(_INSTANCES)

#: widest block: pass A runs one CTA of round_up(nb, 32) threads, one row each
MAX_NB = 1024
#: threads the chain aims at: its slices split a step's window rows
CHAIN_THREADS = 256
#: threads a CTA may have for several columns (csrc/trsv_win.cu kChunkThreads)
CHUNK_THREADS = 512
#: columns a chain CTA takes at most (csrc/trsv_win.cu chain_cols): the
#: chunks' chains run side by side, one SM each
CHAIN_COLS = 2
#: deepest ring of the chain's stages (csrc/trsv_win.cu kMaxStages caps it)
MAX_STAGES = 8

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 9 + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _row_stride(kc: int, itemsize: int) -> int:
    """Values per shared-memory row of kc columns (csrc/trsv_win.cu
    row_stride): kc plus one 16-byte vector, or kc + 1 below one vector."""
    v = 16 // itemsize
    return kc + v if kc >= v else (kc + 1 if kc > 1 else 1)


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """The chain's launch shape (csrc/trsv_win.cu win_chain_kernel): R chain
    rows a block (the last min(WL, nb)), kb columns a CTA, tg slices of a
    tile's window rows, tiles of tt window rows (tt = WL: one tile a step), a
    ring of `stages` shared-memory stages, and the CTA's threads and dynamic
    shared memory."""

    R: int
    kb: int
    tg: int
    tt: int
    stages: int
    threads: int
    smem: int


def chain_plan(nb: int, WL: int, kc: int, itemsize: int) -> Optional[ChainPlan]:
    """The chain's shape for a column chunk of kc (its CTAs take kb =
    min(kc, CHAIN_COLS) columns each), or None when its window, the slices'
    sums and two stages of one window row do not fit one block's shared
    memory, or when several columns' R rows need more than 512 threads. The
    sizes are csrc/trsv_win.cu's chain_head_values and stage_values. A whole tail a stage (tt = WL) when at least two fit,
    with up to MAX_STAGES of them; else tiles of as many window rows as four
    (or three, or two) stages hold."""
    V = 16 // itemsize
    R = min(WL, nb)
    rp = _up(R, 32)
    if kc > 1 and rp > CHUNK_THREADS:
        return None
    kb = min(kc, CHAIN_COLS)
    tg = max(1, min(CHAIN_THREADS // rp, WL))
    cs = 1 if kb == 1 else kb + 1
    rs = _up(R, V)
    head = _up(WL * _row_stride(kb, itemsize), V) + (_up(tg * R * cs, V) if tg > 1 else 0)
    budget = MAX_SMEM // itemsize - head

    def stage(tt):
        return _up(tt * rs + R * cs, V)

    if budget >= 2 * stage(WL):
        tt, stages = WL, min(MAX_STAGES, budget // stage(WL))
    else:
        for stages in (4, 3, 2):
            tt = min(WL, (budget // stages - R * cs - V) // rs)
            if tt >= 1:
                break
        else:
            return None
    return ChainPlan(R, kb, tg, tt, stages, rp * tg, (head + stages * stage(tt)) * itemsize)


def chain_group(nblk: int, nb: int, WL: int) -> int:
    """Blocks a group of a grouped solve, or 0 for the plain chain. Where
    the window is the last block's chain rows (WL <= nb) the chain of nblk
    dependent steps splits into groups of s blocks: every group's own chain
    from a zero window (s steps, all groups at once), a chain over the
    groups' last blocks through their products F (nblk / s steps), and a
    parallel fix-up; s is the power of two nearest sqrt(nblk), at least 4,
    and the solve stays plain where that leaves one group."""
    if WL > nb or nblk < 1:
        return 0
    s = 1 << max(2, round(math.log2(math.sqrt(nblk))))
    return s if nblk > s else 0


def solve_launches(nblk: int, nb: int, WL: int, dtype=torch.float32) -> int:
    """Kernel launches of one solve on the card: pass A and the chain; for
    a grouped solve (`chain_group`) the chain over the groups where two or
    more are full, and the fix-up of the groups after the first; pass C
    where a block has rows outside the chain's (WL < nb) and a block
    follows the first; the bf16 instance's rounding of x."""
    if nblk == 0:
        return 0
    s = chain_group(nblk, nb, WL)
    n = 2 + (WL < nb and nblk > 1) + (dtype == torch.bfloat16)
    if s:
        n += 1 + (nblk // s >= 2)
    return n


@dataclasses.dataclass(frozen=True)
class WinSolveOps:
    """What the card's passes read besides dinvT, built once per values by
    `win_solve_operands`: P = lwT @ dinvT (nblk, WL, nb); for a grouped
    solve (`chain_group` > 0, its `group`) F (nblk, WL, WL), with T_k =
    P[k][:, nb - WL:], F_j = (-1)^(j-a) T_a T_(a+1) ... T_j for block j of
    the group that starts at block a, so that a block's chain rows are
    x_j = u_j - v F_j, u_j the group's own chain from a zero window and v
    the chain rows of block a - 1; else F is None."""

    P: torch.Tensor
    F: Optional[torch.Tensor]
    group: int


def win_solve_operands(dinvT: torch.Tensor, lwT: torch.Tensor, nb: int, WL: int) -> WinSolveOps:
    """The card's solve operands of (dinvT, lwT): set-up work, once per
    values, on the operands' device. Both products run in float64 and round
    once to the operand dtype's work dtype (`WORK_DTYPE`: f32 for bf16), so
    they do not depend on the TF32 setting of float32 matrix products; F
    takes s - 1 batched products over the groups."""
    work = WORK_DTYPE.get(dinvT.dtype, dinvT.dtype)
    P = torch.matmul(lwT.to(torch.float64), dinvT.to(torch.float64))
    nblk = P.shape[0]
    s = chain_group(nblk, nb, WL)
    F = None
    if s:
        ng = -(-nblk // s)
        Tg = torch.zeros(ng * s, WL, WL, dtype=torch.float64, device=P.device)
        Tg[:nblk] = P[:, :, nb - WL :]
        Tg = Tg.reshape(ng, s, WL, WL)
        Fg = torch.empty_like(Tg)
        Fg[:, 0] = Tg[:, 0]
        for i in range(1, s):
            Fg[:, i] = -torch.matmul(Fg[:, i - 1], Tg[:, i])
        F = Fg.reshape(ng * s, WL, WL)[:nblk].to(work).contiguous()
    return WinSolveOps(P.to(work).contiguous(), F, s)


def _check(dinvT, lwT, b, nb: int, WL: int, ops: Optional[WinSolveOps], rhs_dims=1):
    """Validate the operands (b of rhs_dims dimensions, ops None or those of
    this shape); return the instance (name, symbol)."""
    inst = _INSTANCES.get(dinvT.dtype)
    extra = () if ops is None else tuple(t for t in (ops.P, ops.F) if t is not None)
    if (
        inst is None
        or any(t.dtype != dinvT.dtype for t in (lwT, b))
        or any(t.dtype != WORK_DTYPE[dinvT.dtype] for t in extra)
    ):
        raise AoclSparseError(
            Status.wrong_type,
            f"window solve has no instance for {dinvT.dtype}/{lwT.dtype}/{b.dtype}"
            + ("" if ops is None else f" with P/F of {ops.P.dtype}"),
        )
    nblk = dinvT.shape[0] if dinvT.dim() == 3 else -1
    if not (
        dinvT.dim() == 3
        and tuple(dinvT.shape[1:]) == (nb, nb)
        and tuple(lwT.shape) == (nblk, WL, nb)
        and b.dim() == rhs_dims
        and b.shape[0] == nblk * nb
    ):
        raise AoclSparseError(
            Status.invalid_size,
            f"want dinvT (nblk, {nb}, {nb}), lwT (nblk, {WL}, {nb}), a {rhs_dims}-D b of "
            f"nblk*{nb} rows; got {tuple(dinvT.shape)}, {tuple(lwT.shape)}, {tuple(b.shape)}",
        )
    if ops is not None:
        s = chain_group(nblk, nb, WL)
        if not (
            tuple(ops.P.shape) == (nblk, WL, nb)
            and ops.group == s
            and (ops.F is None if s == 0 else ops.F is not None and tuple(ops.F.shape) == (nblk, WL, WL))
        ):
            raise AoclSparseError(
                Status.invalid_size,
                f"ops are not win_solve_operands of {nblk} blocks of {nb} rows and a window of {WL}",
            )
    if not (1 <= nb <= MAX_NB and WL >= 1):
        raise AoclSparseError(Status.invalid_size, f"nb={nb} (1..{MAX_NB}) WL={WL} (>= 1)")
    if chain_plan(nb, WL, 1, _work_size(dinvT.dtype)) is None:
        raise AoclSparseError(
            Status.invalid_size, f"window WL={WL} + nb={nb} exceeds one block's shared memory"
        )
    tensors = (dinvT, lwT, b) + extra
    if any(t.device != b.device for t in tensors):
        raise AoclSparseError(Status.invalid_value, "operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise AoclSparseError(Status.invalid_value, "operands must be contiguous")
    return inst


def _work_size(dtype) -> int:
    """Bytes of one value of the sums (`WORK_DTYPE`): the chain's
    shared-memory plan counts in them."""
    return torch.empty(0, dtype=WORK_DTYPE.get(dtype, dtype)).element_size()


def _launch(symbol, name, dinvT, ops, B, nb, WL, K, kc):
    """The passes of csrc/trsv_win.cu on B's device, current stream, not
    synchronised; returns X and the number of kernels the entry launched
    (the bf16 instance sums into an f32 work copy of X, made here)."""
    nblk = dinvT.shape[0]
    if ops is None:
        raise AoclSparseError(
            Status.invalid_value,
            "the card's window solve needs ops = win_solve_operands(dinvT, lwT, nb, WL)",
        )
    X = torch.empty_like(B)
    if nblk == 0 or K == 0:
        return X, 0
    plan = chain_plan(nb, WL, kc, _work_size(B.dtype))
    work = torch.empty(B.shape, dtype=torch.float32, device=B.device) if B.dtype == torch.bfloat16 else None
    n = ctypes.c_int64(0)
    with torch.cuda.device(B.device):
        rc = _entry(symbol)(
            dinvT.data_ptr(),
            ops.P.data_ptr(),
            ops.F.data_ptr() if ops.group else None,
            B.data_ptr(),
            X.data_ptr(),
            None if work is None else work.data_ptr(),
            nblk,
            nb,
            WL,
            K,
            kc,
            ops.group,
            plan.tg,
            plan.tt,
            plan.stages,
            torch.cuda.current_stream().cuda_stream,
            ctypes.addressof(n),
        )
    if rc != 0:
        raise RuntimeError(f"window solve ({name}) launch failed: CUDA error {rc}")
    return X, n.value


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b; in bf16 summed in f32 and rounded once to bf16, as a Pallas
    ``jnp.dot(..., preferred_element_type=bf16)`` computes it."""
    if a.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(torch.bfloat16)
    return a @ b


def trsv_win_plain(dinvT: torch.Tensor, lwT: torch.Tensor, b: torch.Tensor, nb: int, WL: int):
    """The kernel's contract in plain PyTorch: a Python loop over blocks
    (any dtype; bf16 rounds where the Pallas kernels round)."""
    nblk = dinvT.shape[0]
    w = torch.zeros(WL, dtype=b.dtype, device=b.device)
    bk = b.reshape(nblk, nb)
    out = []
    for k in range(nblk):
        xk = _dot(bk[k] - _dot(w, lwT[k]), dinvT[k])
        out.append(xk)
        w = torch.cat([w, xk])[-WL:]
    return torch.cat(out) if out else b.new_empty(0)


def trsv_win(dinvT: torch.Tensor, lwT: torch.Tensor, b: torch.Tensor, nb: int, WL: int,
             ops: Optional[WinSolveOps] = None):
    """Solve by the contract above: the plain version on a CPU tensor, the
    CUDA kernels on a CUDA tensor (`solve_launches` launches on the current
    stream, not synchronised), which read dinvT and ops =
    `win_solve_operands` (P, and for a grouped solve F), not lwT."""
    name, symbol = _check(dinvT, lwT, b, nb, WL, ops)
    if b.device.type == "cpu":
        return trsv_win_plain(dinvT, lwT, b, nb, WL)
    if b.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no window-solve kernel for {b.device}")
    x, n = _launch(symbol, name, dinvT, ops, b, nb, WL, 1, 1)
    trsv_win.launches[name] += n
    return x


trsv_win.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def trsm_chunk(K: int, nb: int, WL: int, itemsize: int) -> int:
    """Columns per CTA of the multi-RHS passes: the largest of 16, 8, 4, 2,
    1 that K asks for and whose chain fits one block's shared memory
    (`chain_plan`; pass A's nb staged rows and pass C's window fit
    whenever it does, nb being at most TRSM_MAX_NB); 0 when none fits."""
    for kc in _CHUNKS:
        if kc > 1 and kc >= 2 * K:
            continue
        if chain_plan(nb, WL, kc, itemsize) is not None and nb * _row_stride(kc, itemsize) * itemsize <= MAX_SMEM:
            return kc
    return 0


def trsm_win_plain(dinvT: torch.Tensor, lwT: torch.Tensor, B: torch.Tensor, nb: int, WL: int):
    """The multi-RHS contract in plain PyTorch: a Python loop over blocks,
    two matrix products and a window shift each (any dtype; bf16 rounds
    where the Pallas kernel rounds)."""
    nblk = dinvT.shape[0]
    K = B.shape[1]
    w = torch.zeros(WL, K, dtype=B.dtype, device=B.device)
    bk = B.reshape(nblk, nb, K)
    out = []
    for k in range(nblk):
        xk = _dot(dinvT[k].T, bk[k] - _dot(lwT[k].T, w))
        out.append(xk)
        w = torch.cat([w, xk])[-WL:]
    return torch.cat(out) if out else B.new_empty(0, K)


def trsm_win(dinvT: torch.Tensor, lwT: torch.Tensor, B: torch.Tensor, nb: int, WL: int,
             ops: Optional[WinSolveOps] = None):
    """Solve by the multi-RHS contract: the plain version on a CPU tensor,
    the three passes on a CUDA tensor in chunks of `trsm_chunk` columns, one
    CTA a chunk in the chain (current stream, not synchronised)."""
    name, symbol = _check(dinvT, lwT, B, nb, WL, ops, rhs_dims=2)
    if nb > TRSM_MAX_NB:
        raise AoclSparseError(Status.invalid_size, f"nb={nb} > {TRSM_MAX_NB} for the multi-RHS solve")
    K = B.shape[1]
    kc = trsm_chunk(max(K, 1), nb, WL, _work_size(B.dtype))
    if kc == 0:
        raise AoclSparseError(
            Status.invalid_size, f"window WL={WL} + nb={nb} exceeds one block's shared memory"
        )
    if B.device.type == "cpu":
        return trsm_win_plain(dinvT, lwT, B, nb, WL)
    if B.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no window-solve kernel for {B.device}")
    X, n = _launch(symbol, name, dinvT, ops, B, nb, WL, K, kc)
    trsm_win.launches[name] += n
    return X


trsm_win.launches = {name: 0 for name, _sym in _INSTANCES.values()}
