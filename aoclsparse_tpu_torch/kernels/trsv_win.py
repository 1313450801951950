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

`trsv_win` has one rule: a CPU tensor takes `trsv_win_plain`, a CUDA tensor
launches the kernel or raises. `trsv_win.launches` counts kernel launches
per instance.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library

__all__ = ["trsv_win", "trsv_win_plain", "DTYPES", "MAX_NB", "MAX_SMEM"]

#: dtype -> (instance name, C entry point)
_INSTANCES = {
    torch.float32: ("f32", "trsv_win_f32"),
    torch.float64: ("f64", "trsv_win_f64"),
}
#: operand dtypes the kernel has instances for
DTYPES = tuple(_INSTANCES)

#: widest block: one CTA of round_up(nb, 32) threads, one row each
MAX_NB = 1024
#: the window and b_k - s share one block's dynamic shared memory
#: ((WL + nb) values), at most the 227 KB an H100 block may use
MAX_SMEM = 232448

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(dinvT: torch.Tensor, lwT: torch.Tensor, b: torch.Tensor, nb: int, WL: int):
    """Validate the operands; return the instance (name, symbol)."""
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
        and tuple(b.shape) == (nblk * nb,)
    ):
        raise AoclSparseError(
            Status.invalid_size,
            f"want dinvT (nblk, {nb}, {nb}), lwT (nblk, {WL}, {nb}), b (nblk*{nb},); got "
            f"{tuple(dinvT.shape)}, {tuple(lwT.shape)}, {tuple(b.shape)}",
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
