"""Band SpMV: the hand-written Hopper kernel of the ``bandt`` form, its plain
PyTorch version, and the full form dispatch with the peel spill.

Contract (``csrc/band_spmv.cu``, built by ``kernels/build.py``):

    y[i] = sum_{j < W} vt[j, i] * x[start + i + j - padL],   0 <= i < m

over the transposed (W, m) band ``vt``; x indices outside [0, n) contribute
0. Instances: band f32 / x f32, band bf16 / x f32 (mixed precision), band
f64 / x f64; y is float32, or float64 for f64.

It replaces the JAX package's ``pallas_spmv_band_t``
(kernels/pallas/spmv.py:531, mv KID 8), ``pallas_spmv_band_v`` (:626, KID 12)
and ``pallas_spmv_band_v_df`` (:899, KID 13). `spmv_bandt` is the
counterpart of their wrappers ``spmv_bandt`` (:89) and ``spmv_bandv``
(:119): the band product plus the planner's peel spill.

`band_spmv` has one rule: a CPU tensor takes `band_spmv_plain`, a CUDA
tensor launches the kernel or raises. `band_spmv.launches` counts kernel
launches per instance.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library
from .spmm_plain import add_spill

__all__ = ["band_spmv", "band_spmv_plain", "spmv_bandt", "MAX_W"]

#: (band dtype, x dtype) -> (instance name, C entry point)
_INSTANCES = {
    (torch.float32, torch.float32): ("f32", "band_spmv_f32"),
    (torch.bfloat16, torch.float32): ("bf16", "band_spmv_bf16"),
    (torch.float64, torch.float64): ("f64", "band_spmv_f64"),
}

#: widest band the kernel takes: its (256 + W - 1)-value x window must fit
#: the 48 KB of static shared memory in f64
MAX_W = 4096

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(vt: torch.Tensor, x: torch.Tensor, start: int, padL: int):
    """Validate the operands; return the instance (name, symbol)."""
    inst = _INSTANCES.get((vt.dtype, x.dtype))
    if inst is None:
        raise AoclSparseError(
            Status.wrong_type,
            f"band kernel has no instance for band {vt.dtype} with x {x.dtype}",
        )
    if vt.dim() != 2 or x.dim() != 1:
        raise AoclSparseError(Status.invalid_size, "band must be (W, m) and x (n,)")
    if vt.shape[0] > MAX_W:
        raise AoclSparseError(Status.invalid_size, f"band width {vt.shape[0]} > {MAX_W}")
    if start < 0 or padL < 0:
        raise AoclSparseError(Status.invalid_value, f"start={start} padL={padL} must be >= 0")
    if vt.device != x.device:
        raise AoclSparseError(Status.invalid_value, f"band on {vt.device}, x on {x.device}")
    if not (vt.is_contiguous() and x.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "band and x must be contiguous")
    return inst


def band_spmv_plain(vt: torch.Tensor, x: torch.Tensor, start: int, padL: int) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: a zero-padded copy of x seen
    through an overlapping (W, m) window view, times the band, summed over j."""
    W, m = vt.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    need = start + m + W - 1  # xe[k] for k = start + i + j
    xe = torch.zeros(max(need, 0), dtype=acc, device=x.device)
    hi = min(padL + x.shape[0], need)
    if hi > padL:
        xe[padL:hi] = x[: hi - padL]
    if W == 0 or m == 0:
        return torch.zeros(m, dtype=acc, device=x.device)
    win = xe.as_strided((W, m), (1, 1), start)  # win[j, i] = xe[start + i + j]
    return (vt.to(acc) * win).sum(0)


def band_spmv(vt: torch.Tensor, x: torch.Tensor, start: int, padL: int) -> torch.Tensor:
    """y = band(vt) @ x by the contract above: the plain version on a CPU
    tensor, the CUDA kernel on a CUDA tensor (launched on the current
    stream, not synchronised)."""
    name, symbol = _check(vt, x, start, padL)
    if vt.device.type == "cpu":
        return band_spmv_plain(vt, x, start, padL)
    if vt.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no band kernel for {vt.device}")
    W, m = vt.shape
    y = torch.empty(m, dtype=x.dtype, device=vt.device)
    if m == 0:
        return y
    with torch.cuda.device(vt.device):
        rc = _entry(symbol)(
            vt.data_ptr(),
            x.data_ptr(),
            y.data_ptr(),
            m,
            x.shape[0],
            W,
            start,
            padL,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"band_spmv_{name} launch failed: CUDA error {rc}")
    band_spmv.launches[name] += 1
    return y


band_spmv.launches = {name: 0 for name, _sym in _INSTANCES.values()}


def spmv_bandt(vt, x, sp_val, sp_ind, sp_rows, start: int, padL: int) -> torch.Tensor:
    """Full bandt dispatch (mv KIDs 8, 12, 13): the band kernel, then the
    planner's peel spill as a scatter-add of sp_val * x[sp_ind] into
    sp_rows, on the same stream. A bf16 matrix's x is widened to the bf16
    instance's float32."""
    xk = x.float() if vt.dtype == torch.bfloat16 else x
    return add_spill(band_spmv(vt, xk.contiguous(), start, padL), x, sp_val, sp_ind, sp_rows)
