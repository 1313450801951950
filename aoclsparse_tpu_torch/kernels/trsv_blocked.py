"""Blocked triangular solve chain: the hand-written Hopper kernel of the
``dwin`` (diagonal window) and ``gather`` (padded-ELL) TrsvForms, their
plain PyTorch versions and the kernel's launch counts.

Contracts, over blocks k of nb rows in order (blk0 = k * nb), b and x of
(m_pad,) or (m_pad, K), m_pad = nblk * nb:

    dwin:    s_k[r] = sum_d Dv[k, d, r] * w_pad[WL - offs[d] + r]
    gather:  s_k[r] = sum_w Lval[k, r, w] * x[Lind[k, r, w]]
    then     x_k = Dm_k @ (b_k - s_k)                 (inv=True, Dm = Dinv)
          or x_k = solve(Dm_k, b_k - s_k)             (inv=False, Dm = D)

with w_pad the solved rows [blk0 - WL, blk0) (zeros before row 0) and nb
zeros after them, and x zero where unsolved. They are the JAX package's
XLA scans ``trsv_blocked_dwin`` (kernels/xla/trsv.py:103) and
``trsv_blocked`` (:152, which always substitutes; ``inv`` adds the
inverted-block twin). The JAX package takes ``inv=True`` on its
accelerator and substitutes on the CPU.

`trsv_dwin_plain` and `trsv_gather_plain` are those contracts as a Python
loop over blocks: the CPU tensors' path and the tests' reference. The
kernel (``csrc/trsv_blocked.cu``, built by ``kernels/build.py``) runs the
``inv=True`` contract over dinvT = Dinv transposed, (nblk, nb, nb), whose
upper triangle it reads, in one launch a solve: one CTA a chunk of
`chunk_cols` columns walks the blocks (the source's header has the
design). `trsv_dwin` and `trsv_gather` have one rule: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.
`trsv_dwin.launches` and `trsv_gather.launches` count launches per
instance.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library

__all__ = [
    "DTYPES",
    "MAX_NB",
    "chunk_cols",
    "trsv_dwin",
    "trsv_dwin_plain",
    "trsv_gather",
    "trsv_gather_plain",
]

#: dtype -> (instance name, C entry point)
_INSTANCES = {
    torch.float32: ("f32", "trsv_blocked_f32"),
    torch.float64: ("f64", "trsv_blocked_f64"),
}
#: operand dtypes the kernel has instances for
DTYPES = tuple(_INSTANCES)
#: widest block: one thread a row (times the CTA's slices), 1024 at most
MAX_NB = 1024
_MODE = {"dwin": 0, "gather": 1}

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def chunk_cols(K: int) -> int:
    """Columns a CTA takes (csrc/trsv_blocked.cu KC): 4 from K = 4 on, so a
    loaded operand value serves four sums, else 2 or 1; the chunks' chains
    run side by side, one SM each."""
    return 4 if K >= 4 else (2 if K >= 2 else 1)


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _diag_apply(Dm: torch.Tensor, rhs: torch.Tensor, inv: bool) -> torch.Tensor:
    if inv:
        return Dm @ rhs
    return torch.linalg.solve_triangular(Dm, rhs, upper=False)


def trsv_dwin_plain(Dm: torch.Tensor, Dv: torch.Tensor, b: torch.Tensor, nb: int, WL: int,
                    offs: Union[Sequence[int], torch.Tensor], inv: bool = True) -> torch.Tensor:
    """The dwin contract in plain PyTorch: a Python loop over blocks, the
    diagonals' terms gathered from the padded window at once."""
    squeeze = b.dim() == 1
    b2 = b[:, None] if squeeze else b
    k = b2.shape[1]
    nblk = Dm.shape[0]
    dev = b2.device
    offs_t = torch.as_tensor(offs, dtype=torch.int64, device=dev)
    idx = WL - offs_t[:, None] + torch.arange(nb, device=dev)[None, :]  # (ndg, nb) rows of w_pad
    w = torch.zeros(WL, k, dtype=Dm.dtype, device=dev)
    zpad = torch.zeros(nb, k, dtype=Dm.dtype, device=dev)
    bs = b2.to(Dm.dtype).reshape(nblk, nb, k)
    out = []
    for blk in range(nblk):
        wp = torch.cat([w, zpad])
        s = (Dv[blk][:, :, None] * wp[idx]).sum(0)
        xk = _diag_apply(Dm[blk], bs[blk] - s, inv)
        out.append(xk)
        w = torch.cat([w, xk])[-WL:]
    x = torch.cat(out) if out else b2.new_empty(0, k)
    return x[:, 0] if squeeze else x


def trsv_gather_plain(Dm: torch.Tensor, Lind: torch.Tensor, Lval: torch.Tensor, b: torch.Tensor, nb: int,
                      inv: bool = True) -> torch.Tensor:
    """The gather contract in plain PyTorch: a Python loop over blocks,
    each a gather of solved x and a row-wise sum."""
    squeeze = b.dim() == 1
    b2 = b[:, None] if squeeze else b
    k = b2.shape[1]
    nblk = Dm.shape[0]
    x = torch.zeros(nblk * nb, k, dtype=Dm.dtype, device=b2.device)
    bs = b2.to(Dm.dtype).reshape(nblk, nb, k)
    ind = Lind.long()
    for blk in range(nblk):
        s = torch.einsum("rw,rwk->rk", Lval[blk], x[ind[blk]])
        x[blk * nb : (blk + 1) * nb] = _diag_apply(Dm[blk], bs[blk] - s, inv)
    return x[:, 0] if squeeze else x


def _check(dinvT, left, b, nb: int, aux, aux_shape, left_shape):
    """Validate the operands; return the instance (name, symbol)."""
    inst = _INSTANCES.get(dinvT.dtype)
    if inst is None or left.dtype != dinvT.dtype or b.dtype != dinvT.dtype:
        raise AoclSparseError(
            Status.wrong_type, f"blocked solve has no instance for {dinvT.dtype}/{left.dtype}/{b.dtype}"
        )
    if aux.dtype != torch.int32:
        raise AoclSparseError(Status.wrong_type, f"offsets / column indices must be int32, got {aux.dtype}")
    nblk = dinvT.shape[0] if dinvT.dim() == 3 else -1
    if not (
        dinvT.dim() == 3
        and tuple(dinvT.shape[1:]) == (nb, nb)
        and tuple(left.shape) == (nblk,) + left_shape
        and tuple(aux.shape) == aux_shape(nblk)
        and b.dim() in (1, 2)
        and b.shape[0] == nblk * nb
    ):
        raise AoclSparseError(
            Status.invalid_size,
            f"want dinvT (nblk, {nb}, {nb}), a left operand (nblk, {left_shape}), b of nblk*{nb} rows; "
            f"got {tuple(dinvT.shape)}, {tuple(left.shape)}, {tuple(aux.shape)}, {tuple(b.shape)}",
        )
    if not 1 <= nb <= MAX_NB or left.numel() == 0:
        raise AoclSparseError(Status.invalid_size, f"nb={nb} (1..{MAX_NB}), an empty left operand")

    tensors = (dinvT, left, aux, b)
    if any(t.device != b.device for t in tensors):
        raise AoclSparseError(Status.invalid_value, "operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise AoclSparseError(Status.invalid_value, "operands must be contiguous")
    return inst


def _launch(symbol: str, name: str, mode: str, dinvT, left, aux, b, nb: int) -> torch.Tensor:
    """One launch of csrc/trsv_blocked.cu on b's device, current stream,
    not synchronised."""
    if b.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no blocked-solve kernel for {b.device}")
    B = b if b.dim() == 2 else b[:, None]
    X = torch.empty_like(B)
    K = B.shape[1]
    if K == 0:
        return X if b.dim() == 2 else X[:, 0]
    nw = left.shape[1] if mode == "dwin" else left.shape[2]
    n = ctypes.c_int64(0)
    with torch.cuda.device(b.device):
        rc = _entry(symbol)(
            _MODE[mode],
            dinvT.data_ptr(),
            left.data_ptr(),
            aux.data_ptr(),
            B.data_ptr(),
            X.data_ptr(),
            dinvT.shape[0],
            nb,
            nw,
            K,
            chunk_cols(K),
            torch.cuda.current_stream().cuda_stream,
            ctypes.addressof(n),
        )
    if rc != 0:
        raise RuntimeError(f"blocked solve ({mode}, {name}) launch failed: CUDA error {rc}")
    return X if b.dim() == 2 else X[:, 0]


def trsv_dwin(dinvT: torch.Tensor, Dv: torch.Tensor, offs: torch.Tensor, b: torch.Tensor, nb: int, WL: int):
    """Solve by the dwin contract with inv=True: dinvT (nblk, nb, nb) the
    inverted diagonal blocks transposed, Dv (nblk, ndg, nb), offs the ndg
    ascending offsets as an int32 tensor, b (m_pad,) or (m_pad, K). The
    plain version on a CPU tensor, one kernel launch on a CUDA tensor."""
    ndg = offs.shape[0] if offs.dim() == 1 else -1
    name, symbol = _check(dinvT, Dv, b, nb, offs, lambda nblk: (ndg,), (ndg, nb))
    if b.device.type == "cpu":
        return trsv_dwin_plain(dinvT.transpose(1, 2), Dv, b, nb, WL, offs, inv=True)
    x = _launch(symbol, name, "dwin", dinvT, Dv, offs, b, nb)
    trsv_dwin.launches[name] += 1
    return x


trsv_dwin.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def trsv_gather(dinvT: torch.Tensor, Lind: torch.Tensor, Lval: torch.Tensor, b: torch.Tensor, nb: int):
    """Solve by the gather contract with inv=True: dinvT as for
    `trsv_dwin`, Lind (int32) and Lval (nblk, nb, W), b (m_pad,) or
    (m_pad, K). The plain version on a CPU tensor, one kernel launch on a
    CUDA tensor."""
    W = Lval.shape[2] if Lval.dim() == 3 else -1
    name, symbol = _check(dinvT, Lval, b, nb, Lind, lambda nblk: (nblk, nb, W), (nb, W))
    if b.device.type == "cpu":
        return trsv_gather_plain(dinvT.transpose(1, 2), Lind, Lval, b, nb, inv=True)
    x = _launch(symbol, name, "gather", dinvT, Lval, Lind, b, nb)
    trsv_gather.launches[name] += 1
    return x


trsv_gather.launches = {name: 0 for name, _sym in _INSTANCES.values()}
