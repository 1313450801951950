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
upper triangle it reads, in one launch a solve: a thread-block cluster a
chunk of `chunk_cols` columns, whose CTA 0 walks the blocks over shared
memory only while the other CTAs sum each block's far left terms ahead of
it (the source's header has the design). A gather row is read only over
its stored left slots (`TrsvForm.counts()`, int32 (nblk, nb)), so the
kernel differs from the plain version, which multiplies the padding, only
where solved x[0] is Inf or NaN. Instances: f32, f64, bf16 (f32 sums, x
rounded to bf16 as each block is solved), complex64 and complex128.
`trsv_dwin` and `trsv_gather` have one rule: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. `trsv_dwin.launches`
and `trsv_gather.launches` count launches per instance.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library

__all__ = [
    "DTYPES",
    "KERNEL_MAX_NB",
    "MAX_NB",
    "chain_slices",
    "chunk_cols",
    "gather_counts",
    "kernel_layout",
    "trsv_dwin",
    "trsv_dwin_plain",
    "trsv_gather",
    "trsv_gather_plain",
]

#: dtype -> (instance name, C entry point)
_INSTANCES = {
    torch.float32: ("f32", "trsv_blocked_f32"),
    torch.float64: ("f64", "trsv_blocked_f64"),
    torch.bfloat16: ("bf16", "trsv_blocked_bf16"),
    torch.complex64: ("c64", "trsv_blocked_c64"),
    torch.complex128: ("c128", "trsv_blocked_c128"),
}
#: operand dtypes the kernel has instances for
DTYPES = tuple(_INSTANCES)
#: widest block of the plain versions' contract
MAX_NB = 1024
#: widest block the kernel takes (one chain thread a row, 512 threads a CTA)
KERNEL_MAX_NB = 256
_MODE = {"dwin": 0, "gather": 1}

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def kernel_layout(nb: int, K: int, dtype) -> dict:
    """The launch an instance takes for nb rows and K columns: its ring
    depth D, helpers H, slices S (of the chain's rows; helper groups a
    CTA), dinvT stages P, threads a CTA, bytes of shared memory its buffers
    take and near entries a row NR (from the library, so on a machine that
    can build it)."""
    te = torch.empty(0, dtype=dtype).element_size()
    ta = 4 if dtype == torch.bfloat16 else te
    fn = getattr(load_library(), "trsv_blocked_layout")
    fn.argtypes = [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 7)()
    rc = fn(int(nb), chunk_cols(K), te, ta, ctypes.addressof(out))
    return dict(zip(("D", "H", "S", "P", "threads", "smem", "NR"), list(out)), fits=rc == 0)


def gather_counts(Lind: torch.Tensor, Lval: torch.Tensor) -> torch.Tensor:
    """Each gather row's count of left slots the kernel reads, (nblk, nb)
    int32: one past its last slot whose index or value is nonzero. A form
    built here keeps its rows' exact left counts instead; these cover
    every stored entry but a trailing one of value 0 on column 0, which
    adds 0 * x[0] in the plain version."""
    nz = (Lind != 0) | (Lval != 0)
    w = torch.arange(1, Lind.shape[2] + 1, dtype=torch.int32, device=Lind.device)
    return (nz.to(torch.int32) * w).amax(dim=2).to(torch.int32) if Lind.shape[2] else \
        torch.zeros(Lind.shape[:2], dtype=torch.int32, device=Lind.device)


def chunk_cols(K: int) -> int:
    """Columns a cluster takes (csrc/trsv_blocked.cu KC): 4 from K = 4 on,
    so a loaded operand value serves four sums, else 2 or 1; the chunks'
    clusters run side by side."""
    return 4 if K >= 4 else (2 if K >= 2 else 1)


def chain_slices(nb: int) -> int:
    """Slices of a chain row's triangle product (csrc/trsv_blocked.cu
    plan_layout): as many 32-row-rounded copies of the block's rows as fit
    in 448 threads, at most 4; slice s takes the batches s, s + S, ... of
    8 / chunk_cols(K) rows of the triangle, and a row's partials meet in
    slice order."""
    rp = _up(nb, 32)
    return max(1, min(4, 448 // rp))


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


def _launch(symbol: str, name: str, mode: str, dinvT, left, aux, b, nb: int, counts=None) -> torch.Tensor:
    """One launch of csrc/trsv_blocked.cu on b's device, current stream,
    not synchronised."""
    if b.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no blocked-solve kernel for {b.device}")
    if nb > KERNEL_MAX_NB:
        raise AoclSparseError(Status.invalid_size, f"nb={nb}: the chain kernel takes blocks of 1..{KERNEL_MAX_NB}")
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
            counts.data_ptr() if counts is not None else None,
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


def trsv_gather(dinvT: torch.Tensor, Lind: torch.Tensor, Lval: torch.Tensor, b: torch.Tensor, nb: int,
                counts: Optional[torch.Tensor] = None):
    """Solve by the gather contract with inv=True: dinvT as for
    `trsv_dwin`, Lind (int32) and Lval (nblk, nb, W), b (m_pad,) or
    (m_pad, K); counts (nblk, nb) int32, each row's stored left slots
    (`TrsvForm.counts()`), required on a CUDA tensor. The plain version on
    a CPU tensor (which reads no counts), one kernel launch on a CUDA
    tensor."""
    W = Lval.shape[2] if Lval.dim() == 3 else -1
    name, symbol = _check(dinvT, Lval, b, nb, Lind, lambda nblk: (nblk, nb, W), (nb, W))
    if b.device.type == "cpu":
        return trsv_gather_plain(dinvT.transpose(1, 2), Lind, Lval, b, nb, inv=True)
    if counts is None or counts.dtype != torch.int32 or tuple(counts.shape) != tuple(Lind.shape[:2]) \
            or not counts.is_contiguous() or counts.device != b.device:
        got = None if counts is None else f"{counts.dtype} {tuple(counts.shape)} on {counts.device}"
        raise AoclSparseError(Status.invalid_value, f"counts must be contiguous int32 {tuple(Lind.shape[:2])} on "
                              f"{b.device}, got {got}")
    x = _launch(symbol, name, "gather", dinvT, Lval, Lind, b, nb, counts)
    trsv_gather.launches[name] += 1
    return x


trsv_gather.launches = {name: 0 for name, _sym in _INSTANCES.values()}
