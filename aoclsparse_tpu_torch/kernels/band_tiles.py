"""Tile-major band SpMV: the two hand-written Hopper kernels of one contract
(``csrc/band_spmv_tiles.cu``, built by ``kernels/build.py``), their plain
PyTorch version, the tile-major layout and the form dispatch with the peel
spill.

Contract, over the (ntile, W, TM) tile-major band ``vt3`` (`band_tiles` of
a bandt form's (W, m) band):

    y[i] = sum_{j < W} vt3[i // TM, j, i % TM] * x[start + i + j - padL],   0 <= i < m

x indices outside [0, n) contribute 0. Instances: band f32 or bf16, x and
y float32 (a bf16 band is widened per value, the sums are float32).

- `band_spmv_tiles`: one CTA a tile, whose slab is contiguous. It replaces
  the JAX package's ``pallas_spmv_band_vc`` (kernels/pallas/spmv.py:708).
- `band_spmv_tiles_dbuf`: a persistent CTA an SM, the band staged by
  ``cp.async`` into a two-deep shared-memory ring. It replaces
  ``pallas_spmv_band_vd`` (:791), whose band is double-buffered by manual
  DMA.

The JAX kernels take the sublane-interleaved (ntile, W*8, TM/8) layout of
``band_vert_layout_tiles`` (:666); `interop.band_from_jax_tiles` carries
that layout back to the (W, m) band. The JAX kernels return ntile * TM
values; these return m.

Each wrapper has one rule: a CPU tensor takes `band_spmv_tiles_plain`, a
CUDA tensor launches the kernel or raises. ``band_spmv_tiles.launches`` and
``band_spmv_tiles_dbuf.launches`` count kernel launches per instance.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import MAX_SMEM, load_library
from .spmm_plain import add_spill

__all__ = ["band_spmv_tiles", "band_spmv_tiles_dbuf", "band_spmv_tiles_plain", "band_tiles", "spmv_bandt_tiles"]

#: band dtype -> instance name (x and y are float32)
_INSTANCES = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: the double-buffered kernel: at most 8 rows a thread of its 256
DBUF_MAX_TM = 2048

_fns = {}


def _entry(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def band_tiles(vt: torch.Tensor, TM: int) -> torch.Tensor:
    """(ntile, W, TM) tile-major copy of a (W, m) band, zero past row m:
    tile t's W x TM slab, vt[:, t*TM : (t+1)*TM], is contiguous."""
    W, m = vt.shape
    if TM < 1:
        raise AoclSparseError(Status.invalid_size, f"tile TM={TM} must be >= 1")
    ntile = -(-m // TM)
    out = torch.zeros(W, ntile * TM, dtype=vt.dtype, device=vt.device)
    out[:, :m] = vt
    return out.reshape(W, ntile, TM).transpose(0, 1).contiguous()


def _check(vt3: torch.Tensor, x: torch.Tensor, start: int, padL: int, m: int) -> str:
    """Validate the operands; return the instance name."""
    inst = _INSTANCES.get(vt3.dtype)
    if inst is None or x.dtype != torch.float32:
        raise AoclSparseError(
            Status.wrong_type, f"tile-major band kernel has no instance for band {vt3.dtype} with x {x.dtype}"
        )
    if vt3.dim() != 3 or x.dim() != 1:
        raise AoclSparseError(Status.invalid_size, "band must be (ntile, W, TM) and x (n,)")
    ntile, W, TM = vt3.shape
    if W > TM or not 0 <= m <= ntile * TM:
        raise AoclSparseError(
            Status.invalid_size, f"want W <= TM and m <= ntile * TM, got W={W} TM={TM} ntile={ntile} m={m}"
        )
    if (TM + W - 1) * 4 > MAX_SMEM:
        raise AoclSparseError(Status.invalid_size, f"x window of TM={TM}, W={W} exceeds shared memory")
    if start < 0 or padL < 0:
        raise AoclSparseError(Status.invalid_value, f"start={start} padL={padL} must be >= 0")
    if vt3.device != x.device:
        raise AoclSparseError(Status.invalid_value, f"band on {vt3.device}, x on {x.device}")
    if not (vt3.is_contiguous() and x.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, "band and x must be contiguous")
    return inst


def band_spmv_tiles_plain(vt3: torch.Tensor, x: torch.Tensor, start: int, padL: int, m: int) -> torch.Tensor:
    """The contract in plain PyTorch: a zero-padded copy of x seen through an
    overlapping (ntile, W, TM) window view, times the band, summed over j."""
    ntile, W, TM = vt3.shape
    rows = ntile * TM
    need = start + rows + W - 1  # xe[k] for k = start + t*TM + c + j
    xe = torch.zeros(need, dtype=torch.float32, device=x.device)
    hi = min(padL + x.shape[0], need)
    if hi > padL:
        xe[padL:hi] = x[: hi - padL]
    win = xe.as_strided((ntile, W, TM), (TM, 1, 1), start)  # win[t, j, c] = xe[start + t*TM + c + j]
    return (vt3.float() * win).sum(1).reshape(-1)[:m]


def _launch(symbol, name, counts, vt3, x, start, padL, m):
    if vt3.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no tile-major band kernel for {vt3.device}")
    ntile, W, TM = vt3.shape
    y = torch.empty(m, dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _entry(symbol)(
            vt3.data_ptr(), x.data_ptr(), y.data_ptr(), m, x.shape[0], W, TM, start, padL,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    counts[name] += 1
    return y


def band_spmv_tiles(vt3: torch.Tensor, x: torch.Tensor, start: int, padL: int, m: int) -> torch.Tensor:
    """y = band(vt3) @ x by the contract above: the plain version on a CPU
    tensor, one CTA a tile on a CUDA tensor (current stream, not
    synchronised)."""
    name = _check(vt3, x, start, padL, m)
    if vt3.device.type == "cpu":
        return band_spmv_tiles_plain(vt3, x, start, padL, m)
    return _launch(f"band_spmv_tiles_{name}", name, band_spmv_tiles.launches, vt3, x, start, padL, m)


band_spmv_tiles.launches = {name: 0 for name in _INSTANCES.values()}


def band_spmv_tiles_dbuf(vt3: torch.Tensor, x: torch.Tensor, start: int, padL: int, m: int) -> torch.Tensor:
    """The same product by the persistent double-buffered kernel: the plain
    version on a CPU tensor, one launch on a CUDA tensor. Its cp.async
    stages need 16-byte band rows (TM a multiple of 8) on a 16-byte aligned
    band, TM <= DBUF_MAX_TM, and room for two band rows and two x windows
    in shared memory."""
    name = _check(vt3, x, start, padL, m)
    ntile, W, TM = vt3.shape
    row = TM * vt3.element_size()
    if TM % 8 or TM > DBUF_MAX_TM or 2 * row + 2 * (TM + W + 2) * 4 > MAX_SMEM:
        raise AoclSparseError(
            Status.invalid_size, f"the double-buffered kernel needs TM a multiple of 8 up to {DBUF_MAX_TM}, got {TM}"
        )
    if vt3.device.type == "cpu":
        return band_spmv_tiles_plain(vt3, x, start, padL, m)
    if vt3.data_ptr() % 16:
        raise AoclSparseError(Status.invalid_value, "the double-buffered kernel needs a 16-byte aligned band")
    return _launch(f"band_spmv_tiles_dbuf_{name}", name, band_spmv_tiles_dbuf.launches, vt3, x, start, padL, m)


band_spmv_tiles_dbuf.launches = {name: 0 for name in _INSTANCES.values()}


def spmv_bandt_tiles(vt3, x, sp_val, sp_ind, sp_rows, start: int, padL: int, m: int, dbuf: bool = False):
    """A bandt form's product through the tile-major band: one kernel
    launch, then the planner's peel spill as a scatter-add of
    sp_val * x[sp_ind] into sp_rows, on the same stream."""
    y = (band_spmv_tiles_dbuf if dbuf else band_spmv_tiles)(vt3, x, start, padL, m)
    return add_spill(y, x, sp_val, sp_ind, sp_rows)
