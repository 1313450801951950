"""Blocked window triangular solve: the hand-written Hopper kernel of the
``win`` TrsvForm, its plain PyTorch version and its launch counts.

Contract (``csrc/trsv_win.cu``, built by ``kernels/build.py``):

    x_k = (b_k - w @ lwT[k]) @ dinvT[k],   w <- [w, x_k][-WL:],   w starts at 0

over blocks k of nb rows: dinvT (nblk, nb, nb) = the inverted diagonal
blocks transposed, lwT (nblk, WL, nb) = the left windows transposed, b and
x of nblk*nb values, all f32 or all f64, accumulated in that dtype.

It replaces the JAX package's ``pallas_trsv_win_inv8``
(kernels/pallas/trsv.py:74) and ``pallas_trsv_win_inv`` (:114), one
contract at 8 blocks and at 1 block per grid step, and is the Hopper route
of ``trsv_blocked_win_inv`` (kernels/xla/trsv.py:72).

`trsm_win` is the same solve with K right-hand sides, row-major B and X of
(nblk*nb, K):

    X_k = dinvT[k]^T @ (B_k - lwT[k]^T @ W),   W <- [W; X_k][-WL:]

It replaces ``pallas_trsm_win_inv`` (kernels/pallas/trsv.py:160), which
takes B transposed per block; one launch covers every column, in chunks of
`trsm_chunk` columns, one CTA each.

`trsv_win` and `trsm_win` have one rule: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. `trsv_win.launches`
and `trsm_win.launches` count kernel launches per instance.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import MAX_SMEM, load_library

__all__ = [
    "DTYPES",
    "MAX_NB",
    "MAX_SMEM",
    "TRSM_MAX_NB",
    "trsm_chunk",
    "trsm_win",
    "trsm_win_plain",
    "trsv_win",
    "trsv_win_plain",
]

#: dtype -> (instance name, C entry point)
_INSTANCES = {
    torch.float32: ("f32", "trsv_win_f32"),
    torch.float64: ("f64", "trsv_win_f64"),
}
_TRSM = {torch.float32: "trsm_win_f32", torch.float64: "trsm_win_f64"}
#: column chunk sizes the multi-RHS kernel is built for
_CHUNKS = (16, 8, 4, 2, 1)
#: the multi-RHS kernel runs one thread a row of a block, at most this many
TRSM_MAX_NB = 512
#: operand dtypes the kernel has instances for
DTYPES = tuple(_INSTANCES)

#: widest block: one CTA of round_up(nb, 32) threads, one row each
MAX_NB = 1024

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        nint = 5 if symbol.startswith("trsm") else 3
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * nint + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(dinvT: torch.Tensor, lwT: torch.Tensor, b: torch.Tensor, nb: int, WL: int, rhs_dims=1):
    """Validate the operands (b of rhs_dims dimensions); return the
    instance (name, symbol)."""
    inst = _INSTANCES.get(dinvT.dtype)
    if inst is None or lwT.dtype != dinvT.dtype or b.dtype != dinvT.dtype:
        raise AoclSparseError(
            Status.wrong_type,
            f"window solve has no instance for {dinvT.dtype}/{lwT.dtype}/{b.dtype}",
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
    if not (1 <= nb <= MAX_NB and WL >= 1):
        raise AoclSparseError(Status.invalid_size, f"nb={nb} (1..{MAX_NB}) WL={WL} (>= 1)")
    if (WL + nb) * dinvT.element_size() > MAX_SMEM:
        raise AoclSparseError(
            Status.invalid_size, f"window WL={WL} + nb={nb} exceeds one block's shared memory"
        )
    if not (dinvT.device == lwT.device == b.device):
        raise AoclSparseError(Status.invalid_value, "operands on different devices")
    if not (dinvT.is_contiguous() and lwT.is_contiguous() and b.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "operands must be contiguous")
    return inst


def trsv_win_plain(dinvT: torch.Tensor, lwT: torch.Tensor, b: torch.Tensor, nb: int, WL: int):
    """The kernel's contract in plain PyTorch: a Python loop over blocks."""
    nblk = dinvT.shape[0]
    w = torch.zeros(WL, dtype=b.dtype, device=b.device)
    bk = b.reshape(nblk, nb)
    out = []
    for k in range(nblk):
        xk = (bk[k] - w @ lwT[k]) @ dinvT[k]
        out.append(xk)
        w = torch.cat([w, xk])[-WL:]
    return torch.cat(out) if out else b.new_empty(0)


def trsv_win(dinvT: torch.Tensor, lwT: torch.Tensor, b: torch.Tensor, nb: int, WL: int):
    """Solve by the contract above: the plain version on a CPU tensor, the
    CUDA kernel on a CUDA tensor (one launch on the current stream, not
    synchronised)."""
    name, symbol = _check(dinvT, lwT, b, nb, WL)
    if b.device.type == "cpu":
        return trsv_win_plain(dinvT, lwT, b, nb, WL)
    if b.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no window-solve kernel for {b.device}")
    x = torch.empty_like(b)
    nblk = dinvT.shape[0]
    if nblk == 0:
        return x
    with torch.cuda.device(b.device):
        rc = _entry(symbol)(
            dinvT.data_ptr(),
            lwT.data_ptr(),
            b.data_ptr(),
            x.data_ptr(),
            nblk,
            nb,
            WL,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"trsv_win_{name} launch failed: CUDA error {rc}")
    trsv_win.launches[name] += 1
    return x


trsv_win.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def _row_stride(kc: int, itemsize: int) -> int:
    """Values per shared-memory row of the multi-RHS kernel (csrc/trsv_win.cu
    row_stride): kc plus one 16-byte vector, or kc + 1 below one vector."""
    v = 16 // itemsize
    return kc + v if kc >= v else (kc + 1 if kc > 1 else 1)


def trsm_chunk(K: int, nb: int, WL: int, itemsize: int) -> int:
    """Columns per CTA of the multi-RHS kernel: the largest of 16, 8, 4, 2,
    1 that K asks for and whose window and staged rows ((WL + nb) rows of
    `_row_stride` values) fit one block's shared memory; 0 when none fits."""
    for kc in _CHUNKS:
        if kc > 1 and kc >= 2 * K:
            continue
        if (WL + nb) * _row_stride(kc, itemsize) * itemsize <= MAX_SMEM:
            return kc
    return 0


def trsm_win_plain(dinvT: torch.Tensor, lwT: torch.Tensor, B: torch.Tensor, nb: int, WL: int):
    """The multi-RHS contract in plain PyTorch: a Python loop over blocks,
    two matrix products and a window shift each."""
    nblk = dinvT.shape[0]
    K = B.shape[1]
    w = torch.zeros(WL, K, dtype=B.dtype, device=B.device)
    bk = B.reshape(nblk, nb, K)
    out = []
    for k in range(nblk):
        xk = dinvT[k].T @ (bk[k] - lwT[k].T @ w)
        out.append(xk)
        w = torch.cat([w, xk])[-WL:]
    return torch.cat(out) if out else B.new_empty(0, K)


def trsm_win(dinvT: torch.Tensor, lwT: torch.Tensor, B: torch.Tensor, nb: int, WL: int):
    """Solve by the multi-RHS contract: the plain version on a CPU tensor,
    one launch of ceil(K / trsm_chunk) CTAs on a CUDA tensor (current
    stream, not synchronised)."""
    name, _symbol = _check(dinvT, lwT, B, nb, WL, rhs_dims=2)
    if nb > TRSM_MAX_NB:
        raise AoclSparseError(Status.invalid_size, f"nb={nb} > {TRSM_MAX_NB} for the multi-RHS solve")
    K = B.shape[1]
    kc = trsm_chunk(max(K, 1), nb, WL, B.element_size())
    if kc == 0:
        raise AoclSparseError(
            Status.invalid_size, f"window WL={WL} + nb={nb} exceeds one block's shared memory"
        )
    if B.device.type == "cpu":
        return trsm_win_plain(dinvT, lwT, B, nb, WL)
    if B.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no window-solve kernel for {B.device}")
    X = torch.empty_like(B)
    nblk = dinvT.shape[0]
    if nblk == 0 or K == 0:
        return X
    with torch.cuda.device(B.device):
        rc = _entry(_TRSM[B.dtype])(
            dinvT.data_ptr(),
            lwT.data_ptr(),
            B.data_ptr(),
            X.data_ptr(),
            nblk,
            nb,
            WL,
            K,
            kc,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"trsm_win_{name} launch failed: CUDA error {rc}")
    trsm_win.launches[name] += 1
    return X


trsm_win.launches = {name: 0 for name, _sym in _INSTANCES.values()}
