"""Band SpMM: the hand-written Hopper kernels of the ``bandtm`` form, their
plain PyTorch versions, and the form dispatches with the peel spill.

Contracts (``csrc/spmm_band.cu``, built by ``kernels/build.py``), with B
rows outside [0, n) contributing 0 (the band instances: f32 and f64 with B
and C in the operand dtype; a bf16 band with B and C f32, f32 sums, as the
JAX kernel casts a bf16 band and B to its f32 output):

    spmm_band:      C[i, :] = sum_{j < W} v[i, j] * B[start + i + j - padL, :]
    spmm_band_mxu:  C[128k + s, :] = sum_{c < 256} dt[k, c, s] * B[start + 128k + c - padL, :]

over the row-aligned (m, W) band ``v`` of the bandtm form, and over its
(nblk, 256, 128) block windows ``dt`` (`band_mxu_blocks`, zero outside
0 <= c - s < W). The block-window kernel takes the band width W in
[1, 256] and reads and multiplies only the window rows that meet a warp's
rows' bands (`mxu_walk`); a caller with no band width passes 256. Instances:
spmm_band f32 and f64 (C in the operand dtype) and bf16 band with f32 B and
C (an even W: the band moves in column pairs); spmm_band_mxu with dt f32
(exact f32 FMA on the CUDA cores) or bf16 (tensor cores), B and C f32 (the
bf16 instance rounds B to bf16 before the product and accumulates in f32,
as the JAX package's mixed mode does).

They replace the JAX package's ``pallas_spmm_band_t``
(kernels/pallas/spmv.py:173, mm KID 4) and ``pallas_spmm_band_mxu``
(:306, mm KID 5). `spmm_bandtm` and `spmm_bandmxu` are the counterparts of
their wrappers ``spmm_bandtm`` (:220) and ``spmm_bandmxu`` (:253): the band
product plus the planner's peel spill. No padded copy of B is made: the
kernels mask B's edges themselves.

Each wrapper has one rule: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. ``spmm_band.launches`` and
``spmm_band_mxu.launches`` count kernel launches per instance.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import AoclSparseError, Status
from .build import load_library
from .spmm_plain import add_spill

__all__ = [
    "BAND_JC",
    "BAND_RING",
    "BAND_STAGES",
    "BAND_TM",
    "MXU_MAX_W",
    "band_max_w",
    "band_mxu_blocks",
    "spmm_band",
    "spmm_band_mxu",
    "spmm_band_mxu_plain",
    "spmm_band_plain",
    "spmm_bandmxu",
    "spmm_bandtm",
    "mxu_walk",
]

#: (band dtype, B dtype) -> (instance name, C entry point)
_BAND = {
    (torch.float32, torch.float32): ("f32", "spmm_band_f32"),
    (torch.float64, torch.float64): ("f64", "spmm_band_f64"),
    (torch.bfloat16, torch.float32): ("bf16", "spmm_band_bf16"),
}
_MXU = {
    (torch.float32, torch.float32): ("f32", "spmm_band_mxu_f32"),
    (torch.bfloat16, torch.float32): ("bf16", "spmm_band_mxu_bf16"),
}

#: the band kernel's schedule (csrc/spmm_band.cu): rows of a CTA tile, B
#: rows of its ring, band columns j of a chunk by the band's element size
#: (64 bytes a row: 32 bf16, 16 f32, 8 f64), and the stages of its band ring
#: (copies run BAND_STAGES - 1 chunks ahead)
BAND_TM, BAND_RING, BAND_STAGES = 128, 256, 3
BAND_JC = {2: 32, 4: 16, 8: 8}
#: the widest band the planner gives the band kernel (its bandtm gate), by
#: element size (2, 4, 8, 16 bytes). The kernel streams the band and B
#: through rings whose size does not depend on W, so these are the widths
#: an earlier design's shared-memory tile held, kept so that the planner
#: picks the same forms. That tile held the band and the B window; a bf16
#: band's B window is f32, as the f32 instance's, and its chunk takes the f32
#: chunk's bytes (twice the columns), so the bf16 gate is the f32 one.
_BAND_MAX_W = {2: 400, 4: 400, 8: 184, 16: 72}
#: one 256-row window covers a 128-row block plus a band of W <= 129
MXU_MAX_W = 129

_fns = {}


def band_max_w(dtype) -> int:
    """Widest band the band kernel is given in `dtype`: 400 in bf16 and
    f32, 184 in f64 (the planner's bandtm gate)."""
    return _BAND_MAX_W[max(torch.empty(0, dtype=dtype).element_size(), 2)]


def _entry(symbol: str, nint: int):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * nint + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(table, what, a: torch.Tensor, B: torch.Tensor, adim: int, start: int, padL: int):
    inst = table.get((a.dtype, B.dtype))
    if inst is None:
        raise AoclSparseError(
            Status.wrong_type, f"{what} kernel has no instance for {a.dtype} with B {B.dtype}"
        )
    if a.dim() != adim or B.dim() != 2:
        raise AoclSparseError(Status.invalid_size, f"{what}: operand must be {adim}-D and B 2-D")
    if start < 0 or padL < 0:
        raise AoclSparseError(Status.invalid_value, f"start={start} padL={padL} must be >= 0")
    if a.device != B.device:
        raise AoclSparseError(Status.invalid_value, f"operand on {a.device}, B on {B.device}")
    if not (a.is_contiguous() and B.is_contiguous()):
        raise AoclSparseError(Status.invalid_value, f"{what}: operands must be contiguous")
    return inst


def _window(B: torch.Tensor, rows: int, padL: int, acc) -> torch.Tensor:
    """Be[t] = B[t - padL] for 0 <= t < rows, zero outside B: the padded B
    the plain versions slide over."""
    n, K = B.shape
    Be = torch.zeros(max(rows, 0), K, dtype=acc, device=B.device)
    hi = min(padL + n, rows)
    if hi > padL:
        Be[padL:hi] = B[: hi - padL]
    return Be


def _launch(symbol, name, counts, out, a, B, dims, start, padL, tail=()):
    with torch.cuda.device(B.device):
        rc = _entry(symbol, len(dims) + 2 + len(tail))(
            a.data_ptr(), B.data_ptr(), out.data_ptr(), *dims, start, padL, *tail,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    counts[name] += 1


def spmm_band_plain(v: torch.Tensor, B: torch.Tensor, start: int, padL: int) -> torch.Tensor:
    """The band kernel's contract in plain PyTorch: W shifted row windows of
    the padded B, each scaled by a band column, summed in order of j."""
    m, W = v.shape
    acc = torch.float64 if B.dtype == torch.float64 else torch.float32
    C = torch.zeros(m, B.shape[1], dtype=acc, device=B.device)
    if m == 0 or W == 0:
        return C
    Be = _window(B, start + m + W - 1, padL, acc)
    for j in range(W):
        C += v[:, j, None].to(acc) * Be[start + j : start + j + m]
    return C


def spmm_band(v: torch.Tensor, B: torch.Tensor, start: int, padL: int) -> torch.Tensor:
    """C = band(v) @ B by the contract above: the plain version on a CPU
    tensor, one kernel launch on a CUDA tensor (current stream, not
    synchronised)."""
    name, symbol = _check(_BAND, "band SpMM", v, B, 2, start, padL)
    m, W = v.shape
    if W > band_max_w(v.dtype):
        raise AoclSparseError(
            Status.invalid_size, f"band width {W} > {band_max_w(v.dtype)} for {v.dtype}"
        )
    if v.dtype == torch.bfloat16 and (W % 2 or v.data_ptr() % 4):
        raise AoclSparseError(Status.invalid_size, f"a bf16 band moves in column pairs: W={W} must be even, v 4-byte aligned")
    if v.device.type == "cpu":
        return spmm_band_plain(v, B, start, padL)
    if v.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no band SpMM kernel for {v.device}")
    n, K = B.shape
    C = torch.empty(m, K, dtype=B.dtype, device=B.device)
    if m == 0 or K == 0:
        return C
    _launch(symbol, name, spmm_band.launches, C, v, B, (m, n, K, W), start, padL)
    return C


spmm_band.launches = {name: 0 for name, _sym in _BAND.values()}


def band_mxu_blocks(v: torch.Tensor, W: int) -> torch.Tensor:
    """(nblk, 256, 128) block windows of a row-aligned (m, W) band, on its
    device: dt[k, c, s] = v[128k + s, c - s] for 0 <= c - s < W, else 0
    (kernels/pallas/spmv.py:1059 `band_mxu_blocks` of the JAX package, which
    builds the same array from the transposed band on the host)."""
    m = v.shape[0]
    if W > MXU_MAX_W or v.shape[1] != W:
        raise AoclSparseError(Status.invalid_size, f"block windows need W <= {MXU_MAX_W}, got {W}")
    nblk = -(-m // 128)
    D = torch.zeros(nblk * 128, 256, dtype=v.dtype, device=v.device)
    s = torch.arange(m, device=v.device) % 128
    D[:m].scatter_(1, s[:, None] + torch.arange(W, device=v.device)[None, :], v)
    return D.reshape(nblk, 128, 256).transpose(1, 2).contiguous()


def spmm_band_mxu_plain(dt: torch.Tensor, B: torch.Tensor, start: int, padL: int, m: int) -> torch.Tensor:
    """The block-window kernel's contract in plain PyTorch: one (256, 128)^T
    x (256, K) product per block over overlapping windows of the padded B
    (a bf16 dt takes B rounded to bf16; products accumulate in f32)."""
    nblk = dt.shape[0]
    K = B.shape[1]
    Be = _window(B, start + 128 * nblk + 128, padL, torch.float32)
    wins = Be.as_strided((nblk, 256, K), (128 * K, K, 1), start * K)
    d = dt.float()
    if dt.dtype == torch.bfloat16:
        wins = wins.to(torch.bfloat16).float()
    return torch.matmul(d.transpose(1, 2), wins).reshape(nblk * 128, K)[:m]


def mxu_walk(W: int, bf16: bool):
    """The block-window kernel's walk over one 128-row block, as
    [(rows lo, rows hi, window rows lo, window rows hi)]: the f32 instance
    takes 32-row warps over c in [s0, min(256, s0 + 31 + W)) one window row
    at a time; the bf16 instance 16-row halves over the 16-deep steps that
    meet [s, min(256, s + 15 + W)), so its window rows are whole steps."""
    if not bf16:
        return [(s0, s0 + 32, s0, min(256, s0 + 31 + W)) for s0 in range(0, 128, 32)]
    out = []
    for r in range(0, 128, 16):
        steps = [c for c in range(0, 256, 16) if c + 15 >= r and c < min(256, r + 15 + W)]
        out.append((r, r + 16, steps[0], steps[-1] + 16))
    return out


def spmm_band_mxu(dt: torch.Tensor, B: torch.Tensor, start: int, padL: int, m: int, W: int = 256) -> torch.Tensor:
    """C = (block windows dt) @ B by the contract above, rows [0, m), for
    windows of band width W (in [1, 256]; 256 for a caller with none): the
    plain version on a CPU tensor, one kernel launch on a CUDA tensor."""
    name, symbol = _check(_MXU, "block-window SpMM", dt, B, 3, start, padL)
    nblk = dt.shape[0]
    if tuple(dt.shape[1:]) != (256, 128) or not 0 <= m <= 128 * nblk:
        raise AoclSparseError(
            Status.invalid_size, f"want dt (nblk, 256, 128) covering m={m}, got {tuple(dt.shape)}"
        )
    if not 1 <= W <= 256:
        raise AoclSparseError(Status.invalid_size, f"band width W={W} outside [1, 256]")
    if dt.device.type == "cpu":
        return spmm_band_mxu_plain(dt, B, start, padL, m)
    if dt.device.type != "cuda":
        raise AoclSparseError(Status.not_implemented, f"no block-window SpMM kernel for {dt.device}")
    n, K = B.shape
    C = torch.empty(m, K, dtype=torch.float32, device=B.device)
    if m == 0 or K == 0:
        return C
    if dt.data_ptr() % 16:
        raise AoclSparseError(Status.invalid_value, "the kernel reads the windows 16 bytes at a time: align dt")
    _launch(symbol, name, spmm_band_mxu.launches, C, dt, B, (nblk, m, n, K), start, padL, (W,))
    return C


spmm_band_mxu.launches = {name: 0 for name, _sym in _MXU.values()}


def spmm_bandtm(v, B, sp_val, sp_ind, sp_rows, start: int, padL: int) -> torch.Tensor:
    """Full bandtm dispatch (mm KID 4): the band kernel, then the peel spill
    as a scatter-add of sp_val * B[sp_ind] rows into sp_rows."""
    return add_spill(spmm_band(v, B, start, padL), B, sp_val, sp_ind, sp_rows)


def spmm_bandmxu(dt, B, sp_val, sp_ind, sp_rows, m: int, start: int, padL: int, W: int = 256) -> torch.Tensor:
    """Full block-window dispatch (mm KID 5): the block-window kernel at
    band width W, then the peel spill."""
    return add_spill(spmm_band_mxu(dt, B, start, padL, m, W), B, sp_val, sp_ind, sp_rows)
