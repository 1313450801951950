"""Group-window SpMV: the hand-written Hopper kernel of the ``bwd`` form
(mv KID 5), its plain PyTorch version, and the KID 5 dispatch.

Contract (``csrc/spmv_bwd.cu``, built by ``kernels/build.py``):

    y[8b + r] = sum_{t < W} win[b, r, t] * x[8 (b + base8) + t - padL]   (8b + r < m)

plus the peel spill: sp_val[e] * x[sp_ind[e]] added into row sp_rows[e].
``win`` is the (nblk, 8, W) row-major group-window band of the JAX
package's ``bwd`` form (its layout kept, so its form arrays feed the kernel
unchanged; both planners round W up to a multiple of 8, which the kernel's
16-byte loads need and the wrapper checks); x indices outside [0, n) contribute 0, which is the JAX
package's left-padded x (``padL``) without the copy. Instances: band f32 /
x f32, band bf16 / x f32 (mixed precision), band f64 / x f64; y is
float32, or float64 for f64.

It replaces the JAX package's ``pallas_spmv_bwd``
(kernels/pallas/spmv.py:1093) and the XLA row ``spmv_bwd``
(kernels/xla/spmv.py:129, mv KID 5) with the spill its caller adds
(ops/level2/mv.py:173-197). The kernel adds the spill in the same launch,
so an mv call on the form is one launch; the group pointer of the spill
(``spill_group_ptr``) is built once with the form.

`spmv_bwd` has one rule: a CPU tensor takes `spmv_bwd_plain`, a CUDA
tensor launches the kernel or raises. `spmv_bwd.launches` counts kernel
launches per instance. `spmv_bwd_any`, the registry's KID 5 function, adds
the dtype rule: dtypes the kernel has no instance for (complex64,
complex128, float16) take the plain formulation, on any device, as the JAX
package runs them on its XLA row; that rule reads the dtype and nothing
else, never the outcome of a build or a launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..core.types import AoclSparseError, Status
from .build import load_library

__all__ = ["G", "spill_group_ptr", "spmv_bwd", "spmv_bwd_any", "spmv_bwd_plain"]

#: rows per group of the bwd form (the JAX package's G = 8)
G = 8

#: (band dtype, x dtype) -> (instance name, C entry point)
_INSTANCES = {
    (torch.float32, torch.float32): ("f32", "spmv_bwd_f32"),
    (torch.bfloat16, torch.float32): ("bf16", "spmv_bwd_bf16"),
    (torch.float64, torch.float64): ("f64", "spmv_bwd_f64"),
}

#: dtypes with no kernel instance: the plain formulation serves them
PLAIN_DTYPES = (torch.complex64, torch.complex128, torch.float16)

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def spill_group_ptr(sp_rows: np.ndarray, nblk: int) -> np.ndarray:
    """(nblk + 1,) int64: the first spill entry of each 8-row group, over
    row-sorted spill rows."""
    rows = np.asarray(sp_rows, dtype=np.int64)
    if rows.size > 1 and np.any(rows[1:] < rows[:-1]):
        raise AoclSparseError(Status.invalid_value, "the spill rows must be sorted")
    return np.searchsorted(rows, np.arange(nblk + 1, dtype=np.int64) * G).astype(np.int64)


def _check(win: torch.Tensor, x: torch.Tensor, base8: int, padL: int, m: int):
    """Validate the operands; return the instance (name, symbol)."""
    inst = _INSTANCES.get((win.dtype, x.dtype))
    if inst is None:
        raise AoclSparseError(
            Status.wrong_type, f"bwd kernel has no instance for band {win.dtype} with x {x.dtype}"
        )
    if win.dim() != 3 or win.shape[1] != G or x.dim() != 1:
        raise AoclSparseError(Status.invalid_size, f"band must be (nblk, {G}, W) and x (n,)")
    if win.shape[2] % 8:
        raise AoclSparseError(Status.invalid_size, f"W={win.shape[2]} is not a multiple of 8, as the planner makes it")
    if m > win.shape[0] * G or m < 0:
        raise AoclSparseError(Status.invalid_size, f"m={m} outside the band's {win.shape[0] * G} rows")
    if padL < 0 or 8 * base8 < 0:
        raise AoclSparseError(Status.invalid_value, f"base8={base8} padL={padL} must be >= 0")
    if win.device != x.device:
        raise AoclSparseError(Status.invalid_value, f"band on {win.device}, x on {x.device}")
    if not (win.is_contiguous() and x.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "band and x must be contiguous")
    return inst


def spmv_bwd_plain(win, x, base8: int, padL: int, m: int, sp_val=None, sp_ind=None, sp_rows=None):
    """The kernel's contract in plain PyTorch: x zero-padded by padL, seen
    through a strided (nblk, W) window view, one batched matvec with the
    band, then the spill's index_add_. Accumulates in float32 for a bf16
    band, else in the promoted dtype of band and x."""
    nblk, g, W = win.shape
    acc = torch.promote_types(torch.float32 if win.dtype == torch.bfloat16 else win.dtype, x.dtype)
    y = torch.zeros(m, dtype=acc, device=x.device)
    if nblk and W and m:
        need = G * (nblk - 1 + base8) + W  # end of the last window in padded x
        xp = torch.zeros(max(need, 0), dtype=acc, device=x.device)
        hi = min(padL + x.shape[0], need)
        if hi > padL:
            xp[padL:hi] = x[: hi - padL]
        view = xp.as_strided((nblk, W), (G, 1), G * base8)  # view[b, t] = xp[8 (b + base8) + t]
        y = torch.matmul(win.to(acc), view[:, :, None]).reshape(-1)[:m]
    if sp_ind is not None and sp_ind.shape[0]:
        y.index_add_(0, sp_rows, (sp_val * x[sp_ind]).to(acc))
    return y


def spmv_bwd(win, x, base8: int, padL: int, m: int, sp_val=None, sp_ind=None, sp_rows=None,
             sp_gptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = bwd(win) @ x plus the spill, by the contract above: the plain
    version on a CPU tensor, the CUDA kernel on a CUDA tensor (one launch,
    the spill included, on the current stream, not synchronised). On the
    card a spill needs its group pointer `sp_gptr` (spill_group_ptr)."""
    name, symbol = _check(win, x, base8, padL, m)
    spilled = sp_ind is not None and sp_ind.shape[0] > 0
    if win.device.type == "cpu":
        return spmv_bwd_plain(win, x, base8, padL, m, sp_val, sp_ind, sp_rows)
    if win.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no bwd kernel for {win.device}")
    if win.data_ptr() % 16:
        raise AoclSparseError(Status.invalid_value, "the kernel reads the band in 16-byte loads: align its start")
    if spilled:
        if sp_gptr is None or sp_gptr.shape[0] != win.shape[0] + 1:
            raise AoclSparseError(Status.invalid_value, "a spill on the card needs its (nblk + 1,) group pointer")
        if sp_val.dtype != x.dtype:
            raise AoclSparseError(Status.wrong_type, f"spill values {sp_val.dtype} with x {x.dtype}")
        for t in (sp_ind, sp_rows, sp_gptr):
            if t.dtype != torch.int64 or t.device != x.device or not t.is_contiguous():
                raise AoclSparseError(Status.invalid_value, "spill indices must be contiguous int64 on x's device")
        if sp_val.device != x.device or not sp_val.is_contiguous():
            raise AoclSparseError(Status.invalid_value, "spill values must be contiguous on x's device")
    y = torch.empty(m, dtype=x.dtype, device=win.device)
    if m == 0:
        return y
    with torch.cuda.device(win.device):
        rc = _entry(symbol)(
            win.data_ptr(),
            x.data_ptr(),
            y.data_ptr(),
            sp_val.data_ptr() if spilled else None,
            sp_ind.data_ptr() if spilled else None,
            sp_rows.data_ptr() if spilled else None,
            sp_gptr.data_ptr() if spilled else None,
            win.shape[0],
            m,
            x.shape[0],
            win.shape[2],
            base8,
            padL,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"spmv_bwd_{name} launch failed: CUDA error {rc}")
    spmv_bwd.launches[name] += 1
    return y


spmv_bwd.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def spmv_bwd_any(win, x, base8: int, padL: int, m: int, sp_val=None, sp_ind=None, sp_rows=None,
                 sp_gptr=None) -> torch.Tensor:
    """mv KID 5 over a bwd form: the kernel for the dtypes it has instances
    for (a bf16 matrix's x widened to the bf16 instance's float32), the
    plain formulation for complex and float16 (PLAIN_DTYPES), by dtype."""
    if win.dtype in PLAIN_DTYPES or x.dtype in PLAIN_DTYPES:
        return spmv_bwd_plain(win, x, base8, padL, m, sp_val, sp_ind, sp_rows)
    xk = x.float() if win.dtype == torch.bfloat16 and x.dtype == torch.bfloat16 else x
    if sp_val is not None and sp_val.dtype != xk.dtype:
        sp_val = sp_val.to(xk.dtype)
    return spmv_bwd(win, xk.contiguous(), base8, padL, m, sp_val, sp_ind, sp_rows, sp_gptr)
