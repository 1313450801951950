"""Band x band SpGEMM numeric stage: plan, band refresh and C extraction.

PyTorch counterpart of ``aoclsparse_tpu/kernels/xla/spgemm_band.py``. When
both operands band-compress, C = A @ B needs no per-product indexing: in the
G-row-group layout (the ``bwdg`` form) the B-row slab that group g of A
multiplies splits into at most six consecutive B blocks whose offsets are
the same for every group, so the numeric stage is

    for each group g, stream s:  C_g[:, G*s : G*s+WB] += A_g[:, rows_s] @ B_{g+d0+s}[rows_s', :]

dense products only, one launch of the band GEMM kernel
(kernels/band_gemm.py, ``csrc/band_gemm.cu``) over every group, emitting C
as a (nblk, G, WC) band. CSR values are one gather through a plan-time
extraction map. Reference counterpart: the numeric stage of the Gustavson
engine (level3/aoclsparse_csr2m.cpp:405), the same products in dense tiles.

The plan geometry, the cost gate (the JAX package's measured TPU rates,
kept so both packages build the same plans; re-deriving it for Hopper is
ROADMAP.md work), the stream ranges and the extraction map are the JAX
package's (:75-180). Its rolled B streams (`_ensure_streams`) have no
counterpart: the kernel reads block g+d0+s in place and skips blocks out of
range. Its silent fall back to the scan engine when Mosaic refuses the
kernel is not carried over: a build or launch failure raises. The band
engine takes real operands (f32, f64); complex products take the expansion
or host engine (ops/level3/spgemm.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .band_gemm import MAX_STREAMS, band_gemm

__all__ = [
    "BandGemmPlan",
    "BandGeometry",
    "band_geometry",
    "build_band_gemm_plan",
    "band_gemm_cband",
    "band_gemm_values",
    "cband_exec_form",
]


def _window8(eff, G: int):
    """(W, rel_lo, rows, rel) of the G-group relative window, 8-aligned (the
    slab takes any sub-G offset through sl0, so G alignment, which would
    widen W by up to G - 8, is not needed)."""
    if eff.nnz == 0 or eff.m == 0:
        return None
    rows = np.repeat(np.arange(eff.m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
    rel = eff.ind.astype(np.int64) - G * (rows // G)
    rel_lo = (int(rel.min()) // 8) * 8
    W = -(-(int(rel.max()) - rel_lo + 1) // 8) * 8
    return W, rel_lo, rows, rel


@dataclasses.dataclass
class BandGemmPlan:
    """Geometry and extraction map of the band x band numeric stage."""

    G: int
    WA: int
    WB: int
    WC: int
    d0: int  # first B-block offset (g + d0)
    sl0: int  # slab-row offset of the first stream inside its block
    nstream: int
    relC: int  # C's group-relative window start
    nblk: int
    stream_ranges: Tuple  # ((rho_lo, rho_hi, br_lo), ...) per stream
    extract_idx: np.ndarray  # (nnzC,) flat positions into the C band
    formA: object  # bwdg ExecForm of A (8-aligned window)
    formB: object


@dataclasses.dataclass
class BandGeometry:
    """The band engine's geometry for C = A @ B and its cost estimate."""

    WA: int
    relA: int
    rowsA: Optional[np.ndarray]  # A's entry rows (None: a seeded operand band)
    WB: int
    relB: int
    rowsB: Optional[np.ndarray]
    d0: int
    sl0: int
    nstream: int
    WC: int
    nblk: int
    est_band: float  # seconds, the JAX package's TPU rate model
    est_exp: float  # seconds of the product-expansion engine, same model


def band_geometry(effA, effB, G: int, formA_pre=None, formB_pre=None, nnzC: int = 0) -> Optional[BandGeometry]:
    """The band geometry of effA @ effB and the engine gate's estimates, or
    None when the operands do not band-compress (window, stream count, group
    count, C band memory). One policy for the symbolic stage, which asks
    before C's pattern exists (nnzC = 0: no extraction term), and for
    `build_band_gemm_plan`. formA_pre/formB_pre: seeded operand bands, whose
    (possibly wider) windows are taken as they are."""
    from ..planner.plan import BWD_MAX_W

    mA, _nA = effA.shape
    mB, _nB = effB.shape
    if mA == 0 or effA.nnz == 0 or effB.nnz == 0:
        return None
    if formA_pre is not None:
        WA, relA, rowsA = formA_pre.bwd_W, formA_pre.bwd_rel, None
    else:
        wA = _window8(effA, G)
        if wA is None:
            return None
        WA, relA, rowsA, _ = wA
    if formB_pre is not None:
        WB, relB, rowsB = formB_pre.bwd_W, formB_pre.bwd_rel, None
    else:
        wB = _window8(effB, G)
        if wB is None:
            return None
        WB, relB, rowsB, _ = wB
    if WA > 2 * BWD_MAX_W or WB > 2 * BWD_MAX_W:
        return None
    d0 = relA // G
    sl0 = relA - G * d0  # in [0, G)
    nstream = -(-(sl0 + WA) // G)
    if nstream > MAX_STREAMS:
        return None
    WC = G * (nstream - 1) + WB
    nblk = -(-mA // G)
    if -(-mB // G) != nblk:
        return None  # stream alignment assumes equal group counts
    if nblk * G * WC * 4 > 8e9:  # C band memory guard
        return None
    # the JAX package's measured-rate cost model (a TPU's: per-product
    # index ops ~13 ns an element, dense streams ~250 GB/s, matmul ~20 TFLOP/s)
    P = float(np.diff(effB.ptr.astype(np.int64))[effA.ind.astype(np.int64)].sum())
    est_exp = 3.0 * P * 13e-9
    est_band = (
        (mA * WA + (1.0 + nstream) * mB * WB + 2.0 * nblk * G * WC) * 4 / 250e9
        + (nblk * G * WA * WB * 2.0) / 20e12
        + float(nnzC) * 13e-9  # extraction gather
    )
    return BandGeometry(WA, relA, rowsA, WB, relB, rowsB, int(d0), int(sl0), int(nstream), WC, nblk,
                        est_band, est_exp)


def build_band_gemm_plan(
    effA, effB, Cptr, Cind, G: int = 512, force: bool = False, formA_pre=None, formB_pre=None
) -> Optional[BandGemmPlan]:
    """The band path for C = effA @ effB given C's pattern from the symbolic
    stage; None when the operands do not band-compress or the cost model
    prefers product expansion (unless `force`).

    formA_pre/formB_pre: an operand that is itself a band-engine product
    carries a seeded ``bwdg`` form (`cband_exec_form`) whose band is the
    operand; a chained product takes it as it is, without the host relayout
    and the first refresh (its window may be wider than the tight one; the
    cost model prices that width)."""
    from ..planner.plan import _build_bwd_coo

    mA, nA = effA.shape
    mB, nB = effB.shape
    if formA_pre is not None and formA_pre.bwd_G != G:
        formA_pre = None
    if formB_pre is not None and formB_pre.bwd_G != G:
        formB_pre = None
    geo = band_geometry(effA, effB, G, formA_pre, formB_pre, nnzC=Cind.shape[0])
    if geo is None:
        return None
    if geo.est_band > 0.7 * geo.est_exp and not force:
        return None
    WA, relA, WB, relB = geo.WA, geo.relA, geo.WB, geo.relB
    d0, sl0, nstream, WC = geo.d0, geo.sl0, geo.nstream, geo.WC
    relC = relB + G * d0
    # per-stream static ranges: slab rows rho in [G*s - sl0, G*(s+1) - sl0)
    ranges = []
    for s in range(nstream):
        rho_lo = max(0, G * s - sl0)
        rho_hi = min(WA, G * (s + 1) - sl0)
        br_lo = rho_lo + sl0 - G * s  # row inside block g+d0+s
        ranges.append((int(rho_lo), int(rho_hi), int(br_lo)))
    # extraction map: CSR entry (i, j) -> band slot
    rowsC = np.repeat(np.arange(mA, dtype=np.int64), np.diff(np.asarray(Cptr).astype(np.int64)))
    colsC = np.asarray(Cind).astype(np.int64)
    g = rowsC // G
    c = colsC - G * g - relC
    if colsC.size and (c.min() < 0 or c.max() >= WC):
        return None  # coverage violated (safety)
    extract = (g * G + rowsC % G) * WC + c
    # band operands over the 8-aligned windows (src None: the identity map)
    dev = effA.val.device
    if formA_pre is not None:
        formA = formA_pre
    else:
        formA = _build_bwd_coo(geo.rowsA, effA.ind.astype(np.int64), None, mA, nA, (relA, WA), dev, G=G,
                               kind="bwdg")
    if formB_pre is not None:
        formB = formB_pre
    else:
        formB = _build_bwd_coo(geo.rowsB, effB.ind.astype(np.int64), None, mB, nB, (relB, WB), dev, G=G,
                               kind="bwdg")
    return BandGemmPlan(
        G=G,
        WA=WA,
        WB=WB,
        WC=WC,
        d0=d0,
        sl0=sl0,
        nstream=nstream,
        relC=int(relC),
        nblk=geo.nblk,
        stream_ranges=tuple(ranges),
        extract_idx=extract,
        formA=formA,
        formB=formB,
    )


def band_gemm_cband(plan: BandGemmPlan, valA_eff: torch.Tensor, valB_eff: torch.Tensor) -> torch.Tensor:
    """Run the numeric stage; returns C as the (nblk, G, WC) band. A band is
    rescattered only when its value tensor changed: the staleness key is a
    reference to the tensor (an `is` test), never a bare id(), whose address
    a freed tensor may hand on."""
    if getattr(plan, "_valA_src", None) is not valA_eff:
        plan.formA.refresh(valA_eff)
        plan._valA_src = valA_eff
    if getattr(plan, "_valB_src", None) is not valB_eff:
        plan.formB.refresh(valB_eff)
        plan._valB_src = valB_eff
    a, b = plan.formA.bwd_val, plan.formB.bwd_val
    dt = torch.promote_types(a.dtype, b.dtype)
    return band_gemm(a.to(dt), b.to(dt), plan.WC, plan.d0, plan.stream_ranges)


def extract_values(plan: BandGemmPlan, Cband: torch.Tensor) -> torch.Tensor:
    """CSR-ordered C values: one gather through the extraction map, whose
    device copy is kept on the plan."""
    idx = getattr(plan, "_extract_dev", None)
    if idx is None or idx.device != Cband.device:
        idx = plan._extract_dev = torch.from_numpy(plan.extract_idx).to(Cband.device)
    return Cband.reshape(-1)[idx]


def band_gemm_values(plan: BandGemmPlan, valA_eff: torch.Tensor, valB_eff: torch.Tensor) -> torch.Tensor:
    """The numeric stage returning CSR-ordered C values. The raw band stays
    on the plan, so the op layer can seed the result's mv form with it
    (`cband_exec_form`) without computing it again."""
    Cband = band_gemm_cband(plan, valA_eff, valB_eff)
    plan._last_cband = Cband
    return extract_values(plan, Cband)


def cband_exec_form(plan: BandGemmPlan, Cband: torch.Tensor, m: int, n: int, dtype=None):
    """An already computed C band as a ready ``bwdg`` mv form
    (kernels/plain_spmv.py `spmv_bwdg`, mv KID 9): band[g, r, c] =
    C[G*g + r, G*g + relC + c]. Seeded onto the product handle's plan
    (planner/plan.py `Plan.seed_bwdg`), so a chained `mv` runs on the band.
    ``bwd_dest`` is the extraction map (CSR slot -> band slot), which is
    also the scatter list a refresh after update_values needs."""
    from ..planner.plan import ExecForm

    if dtype is not None and Cband.dtype != dtype:
        Cband = Cband.to(dtype)
    return ExecForm(
        kind="bwdg",
        m=m,
        n=n,
        bwd_val=Cband,
        bwd_dest=plan.extract_idx,
        bwd_srcpos=None,
        bwd_W=plan.WC,
        bwd_G=plan.G,
        bwd_rel=plan.relC,
    )
