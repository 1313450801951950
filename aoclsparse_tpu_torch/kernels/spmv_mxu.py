"""Block-window band SpMV: the hand-written Hopper kernel over a band's
(nblk, 256, 128) block windows (``csrc/spmv_mxu.cu``, built by
``kernels/build.py``), its plain PyTorch version, and the form dispatch with
the peel spill.

Contract, over ``dt`` = `ExecForm.band_mxu_dt` (kernels/spmm_band.py
`band_mxu_blocks`; zero outside 0 <= c - s < W, W <= 129):

    y[128k + s] = sum_{0 <= c - s < W, c < 256} dt[k, c, s] * x[start + 128k + c - padL],   128k + s < m

which is the sum over all 256 window rows, since the windows hold zeros
outside the parallelogram; the kernel reads only the window rows that meet
a row's band. A caller with no band width at hand passes W = 256. x
indices outside [0, n) contribute 0. Instances: dt f32 with x f32, and dt
bf16 with x rounded to bf16 before the product (as the JAX kernel's
``xq.astype(dt.dtype)``); y and the sums are float32.

It replaces the JAX package's ``pallas_spmv_band_mxu``
(kernels/pallas/spmv.py:1019); the windows ``dt`` are the same array in
both packages. It is its own kernel, not the block-window SpMM
(`spmm_band_mxu`) at one column.

`spmv_band_mxu` has one rule: a CPU tensor takes `spmv_band_mxu_plain`, a
CUDA tensor launches the kernel or raises. ``spmv_band_mxu.launches``
counts kernel launches per instance.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library
from .spmm_plain import add_spill

__all__ = ["spmv_band_mxu", "spmv_band_mxu_plain", "spmv_bandmxu"]

#: dt dtype -> (instance name, C entry point); x and y are float32
_INSTANCES = {
    torch.float32: ("f32", "spmv_band_mxu_f32"),
    torch.bfloat16: ("bf16", "spmv_band_mxu_bf16"),
}

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(dt: torch.Tensor, x: torch.Tensor, start: int, padL: int, m: int, W: int):
    inst = _INSTANCES.get(dt.dtype)
    if inst is None or x.dtype != torch.float32:
        raise AoclSparseError(
            Status.wrong_type, f"block-window SpMV has no instance for windows {dt.dtype} with x {x.dtype}"
        )
    if dt.dim() != 3 or tuple(dt.shape[1:]) != (256, 128) or x.dim() != 1 or not 0 <= m <= 128 * dt.shape[0]:
        raise AoclSparseError(
            Status.invalid_size, f"want dt (nblk, 256, 128) covering m={m} and x (n,), got {tuple(dt.shape)}"
        )
    if not 1 <= W <= 256:
        raise AoclSparseError(Status.invalid_size, f"band width W={W} outside [1, 256]")
    if start < 0 or padL < 0:
        raise AoclSparseError(Status.invalid_value, f"start={start} padL={padL} must be >= 0")
    if dt.device != x.device:
        raise AoclSparseError(Status.invalid_value, f"windows on {dt.device}, x on {x.device}")
    if not (dt.is_contiguous() and x.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "windows and x must be contiguous")
    return inst


def spmv_band_mxu_plain(dt: torch.Tensor, x: torch.Tensor, start: int, padL: int, m: int) -> torch.Tensor:
    """The contract in plain PyTorch: one (256, 128)^T x (256,) product a
    block over overlapping windows of the zero-padded x (rounded to bf16
    for a bf16 dt), summed in float32."""
    nblk = dt.shape[0]
    need = start + 128 * nblk + 128
    xe = torch.zeros(need, dtype=torch.float32, device=x.device)
    hi = min(padL + x.shape[0], need)
    if hi > padL:
        xe[padL:hi] = x[: hi - padL]
    if dt.dtype == torch.bfloat16:
        xe = xe.to(torch.bfloat16).float()
    wins = xe.as_strided((nblk, 256), (128, 1), start)  # wins[k, c] = xe[start + 128k + c]
    return (dt.float() * wins[:, :, None]).sum(1).reshape(-1)[:m]


def spmv_band_mxu(dt: torch.Tensor, x: torch.Tensor, start: int, padL: int, m: int, W: int) -> torch.Tensor:
    """y = (block windows dt) @ x by the contract above, rows [0, m), over
    windows of band width W: the plain version on a CPU tensor, one kernel
    launch on a CUDA tensor (current stream, not synchronised)."""
    name, symbol = _check(dt, x, start, padL, m, W)
    if dt.device.type == "cpu":
        return spmv_band_mxu_plain(dt, x, start, padL, m)
    if dt.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no block-window SpMV kernel for {dt.device}")
    if dt.data_ptr() % 16:
        raise AoclSparseError(Status.invalid_value, "the kernel reads the windows in 16-byte loads: align their start")
    y = torch.empty(m, dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _entry(symbol)(
            dt.data_ptr(), x.data_ptr(), y.data_ptr(), dt.shape[0], m, x.shape[0], start, padL, W,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    spmv_band_mxu.launches[name] += 1
    return y


spmv_band_mxu.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def spmv_bandmxu(dt, x, sp_val, sp_ind, sp_rows, start: int, padL: int, m: int, W: int) -> torch.Tensor:
    """A band form's product through its block windows (W: the form's
    bwd_W): one kernel launch, then the planner's peel spill as a
    scatter-add of sp_val * x[sp_ind] into sp_rows, on the same stream."""
    return add_spill(spmv_band_mxu(dt, x, start, padL, m, W), x, sp_val, sp_ind, sp_rows)
