"""SpGEMM family: sp2m / csr2m / spmm / sp2md / spmmd / syrk / syrkd /
sypr / syprd and sparse add.

PyTorch counterpart of ``aoclsparse_tpu/ops/level3/spgemm.py``. Reference:
the two-stage Gustavson engine (level3/aoclsparse_csr2m.cpp:45-1125:
symbolic nnz count, then a numeric stage), spmm (aoclsparse_spmm.cpp:28),
dense-out sp2md/spmmd (aoclsparse_sp2md.{cpp,hpp}:130,223), syrk/syrkd,
sypr/syprd (aoclsparse_sypr.{cpp,hpp}) and add (aoclsparse_csradd.{cpp,hpp}).

- SYMBOLIC (host, once per structure): C's pattern, and, for the
  expansion engines, every scalar product A[i,k]*B[k,j] as an index triple
  (pa, pb, pc), pc the position of C[i,j] in C's pattern (native C++, numpy
  when the library is missing). This is the nnz_count stage.
- NUMERIC (repeatable, the finalize stage): when both operands
  band-compress, the band engine (kernels/spgemm_band.py, one launch of the
  hand-written band GEMM kernel on the card) computes C as a dense group
  band and extracts CSR values through a plan-time map; otherwise the
  device expansion engine, Cval = index_add_(pc, Aval[pa] * Bval[pb]), or,
  for large products whose operands lie on the CPU, the host engine
  (threaded C++ over the triples). Operands on the card take the host
  engine only when it is pinned (AOCLSPARSE_TPU_SPGEMM_HOST=1).

A band-engine product seeds its C band into the result handle as a
``bwdg`` mv form, and on the card (or with AOCLSPARSE_TPU_LAZY_SPGEMM=1)
leaves its CSR values pending: a chained `mv` then runs on the band and
never pays the extraction (core/matrix.py `set_lazy_values`).

The gates are the JAX package's, with the card in place of its TPU: the
band engine by default on the card (``get_context().platform == "cuda"``),
G = 128 there and 32 on the CPU (so CPU tests build the JAX package's own
plans), and the JAX package's switches AOCLSPARSE_TPU_FORCE_BANDGEMM,
_NO_BANDGEMM, _SPGEMM_HOST, _SPGEMM_DEVICE and _LAZY_SPGEMM. The band engine
takes f32 and f64; a complex product takes the expansion or host engine
(the same values by another engine). Descriptors and operations resolve
through the planner's effective CSR copies, so symmetric, hermitian and
triangular inputs and op(A) are handled uniformly.
"""

from __future__ import annotations

import dataclasses
import os
from numbers import Number
from typing import Optional, Tuple

import numpy as np
import torch

from ... import native
from ...core.context import get_context
from ...core.descr import GENERAL, MatrixDescriptor
from ...core.formats import CSR
from ...core.matrix import SparseMatrix, as_values
from ...core.types import (
    AoclSparseError,
    FormatType,
    MatrixType,
    Operation,
    Order,
    Request,
    Status,
)
from ...kernels.spgemm_band import (
    band_gemm_cband,
    band_geometry,
    build_band_gemm_plan,
    cband_exec_form,
    extract_values,
)
from ...planner.plan import EffectiveCSR, get_plan

__all__ = [
    "sp2m",
    "csr2m",
    "spmm",
    "sp2md",
    "spmmd",
    "syrk",
    "syrkd",
    "sypr",
    "syprd",
    "add",
]

#: products past which the host engine is the default for operands on the
#: CPU when no band plan attaches and the native library is present
#: (spgemm.py:447-455)
HOST_ENGINE_MIN_P = 1 << 17


def _env_on(name: str) -> bool:
    return os.environ.get(name, "0") in ("1", "true")


def _on_card() -> bool:
    return get_context().platform == "cuda"


def _group() -> int:
    """The band engine's row-group size: 128 on the card, 32 on the CPU
    (spgemm.py:231/307 of the JAX package, 128 on its TPU)."""
    return 128 if _on_card() else 32


# ---------------------------------------------------------------------------
# symbolic engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpgemmPlan:
    """Product-expansion plan (the cached symbolic stage)."""

    shape: Tuple[int, int]
    ptr: np.ndarray  # (m+1,) C row pointers
    ind: np.ndarray  # (nnzC,) C column indices
    pa: Optional[np.ndarray]  # (P,) into A values (None: pattern-only plan)
    pb: Optional[np.ndarray]  # (P,) into B values
    pc: Optional[np.ndarray]  # (P,) into C values (sorted)
    nnz: int
    conj_a: bool = False
    conj_b: bool = False
    band: object = None  # BandGemmPlan when both operands band-compress
    P: Optional[int] = None  # product count (set even without pa/pb/pc)
    #: the host numeric engine, pinned (autotune_spgemm in the JAX package;
    #: not ported yet, so it stays at its default)
    _host_engine: bool = False
    #: the lazy extraction's route, "gather" or "host" (likewise pinned by
    #: autotune_spgemm; the default here)
    _extract_route: str = "gather"


def _effective(h: SparseMatrix, descr: MatrixDescriptor, op: Operation):
    """Resolve (handle, descr, op) to an EffectiveCSR through the planner."""
    return get_plan(h).effective_for(descr, op, h.dtype)


def _expand(Aptr, Aind, Bptr, Bind, mA) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized product enumeration: (rows, pa, pb)."""
    Aptr = np.asarray(Aptr).astype(np.int64)
    Bptr = np.asarray(Bptr).astype(np.int64)
    a_rows = np.repeat(np.arange(mA, dtype=np.int64), np.diff(Aptr))
    b_counts = np.diff(Bptr)[np.asarray(Aind).astype(np.int64)]  # products per A entry
    P = int(b_counts.sum())
    if P == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    pa = np.repeat(np.arange(Aind.size, dtype=np.int64), b_counts)
    firsts = np.zeros(Aind.size + 1, dtype=np.int64)
    np.cumsum(b_counts, out=firsts[1:])
    within = np.arange(P, dtype=np.int64) - firsts[:-1][pa]
    pb = Bptr[np.asarray(Aind).astype(np.int64)][pa] + within
    return a_rows[pa], pa, pb


def _symbolic(effA, effB, upper_only: bool = False, conj_a=False, conj_b=False) -> SpgemmPlan:
    mA, nA = effA.shape
    mB, nB = effB.shape
    if nA != mB:
        raise AoclSparseError(Status.invalid_size, f"inner dims mismatch {nA} vs {mB}")
    nat = native.spgemm_expand(mA, effA.ptr, effA.ind, effB.ptr, effB.ind, upper_only)
    if nat is not None:
        pa, pb, pc, Cptr, Cind = nat
        # the triples stay on the host: the host engine reads them there, the
        # device expansion engine uploads them once (_dev_triples)
        return SpgemmPlan(
            shape=(mA, nB), ptr=Cptr.astype(np.int32), ind=Cind.astype(np.int32), pa=pa, pb=pb, pc=pc,
            nnz=int(Cind.size), conj_a=conj_a, conj_b=conj_b, P=int(pa.size),
        )
    rows, pa, pb = _expand(effA.ptr, effA.ind, effB.ptr, effB.ind, mA)
    cols = effB.ind.astype(np.int64)[pb] if pb.size else pb
    if upper_only:
        keep = cols >= rows
        rows, cols, pa, pb = rows[keep], cols[keep], pa[keep], pb[keep]
    keys = rows * nB + cols
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    uniq = np.ones(keys_s.size, dtype=bool)
    if keys_s.size:
        uniq[1:] = keys_s[1:] != keys_s[:-1]
    pc = np.cumsum(uniq) - 1 if keys_s.size else keys_s
    ukeys = keys_s[uniq] if keys_s.size else keys_s
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    if ukeys.size:
        np.add.at(Cptr, ukeys // nB + 1, 1)
    return SpgemmPlan(
        shape=(mA, nB), ptr=np.cumsum(Cptr).astype(np.int32), ind=(ukeys % nB).astype(np.int32),
        pa=pa[order], pb=pb[order], pc=pc, nnz=int(ukeys.size), conj_a=conj_a, conj_b=conj_b, P=int(pa.size),
    )


def _dev_triples(plan: SpgemmPlan, device: torch.device):
    """The product triples as int64 tensors on `device`, uploaded once a plan
    (plans serve every finalize)."""
    trip = getattr(plan, "_dev_trip", None)
    if trip is None or trip[0].device != device:
        trip = plan._dev_trip = tuple(torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
                                      for a in (plan.pa, plan.pb, plan.pc))
    return trip


def _numeric(Aval, Bval, pa, pb, pc, nnz: int, conj_a: bool, conj_b: bool) -> torch.Tensor:
    """The device expansion engine: Cval = index_add_(pc, Aval[pa] * Bval[pb])."""
    a = Aval[pa]
    b = Bval[pb]
    if conj_a and a.is_complex():
        a = torch.conj_physical(a)
    if conj_b and b.is_complex():
        b = torch.conj_physical(b)
    prod = a * b
    return torch.zeros(nnz, dtype=prod.dtype, device=prod.device).index_add_(0, pc, prod)


def _numeric_plan(plan: SpgemmPlan, Aval, Bval, conj_a: bool, conj_b: bool) -> torch.Tensor:
    return _numeric(Aval, Bval, *_dev_triples(plan, Aval.device), plan.nnz, conj_a, conj_b)


def _operand_seed(H: SparseMatrix, descr: MatrixDescriptor, op) -> Optional[object]:
    """A band-engine product's seeded bwdg form, reusable as a chained-GEMM
    operand band when the operand is taken as it is (general descriptor, op
    none: the band holds plain values) and its values have not been swapped
    since the seeding."""
    seed = getattr(H, "_seed_bwdg", None)
    if seed is None:
        return None
    # values_pending certifies freshness without materializing the lazy
    # extraction (seed and thunk came from the same numeric pass)
    if not H.values_pending and getattr(H, "_seed_bwdg_val", None) is not H.data.val:
        return None
    if Operation(op) != Operation.none or MatrixType(descr.type) != MatrixType.general:
        return None
    return seed


def _band_ok(effA, effB) -> bool:
    """The band kernel's instances: real f32/f64 operands."""
    return effA.val.dtype in (torch.float32, torch.float64) and effB.val.dtype in (torch.float32, torch.float64)


def _attach_band_plan(plan: SpgemmPlan, effA, effB, seedA=None, seedB=None) -> None:
    """Attach the band x band numeric plan when both operands compress (the
    card's default; AOCLSPARSE_TPU_FORCE_BANDGEMM=1 forces it on the CPU for
    tests, AOCLSPARSE_TPU_NO_BANDGEMM=1 turns it off). seedA/seedB: ready
    bands of operands that are themselves band-engine products (a chained
    GEMM: no host relayout, no first refresh)."""
    if _env_on("AOCLSPARSE_TPU_NO_BANDGEMM") or not _band_ok(effA, effB):
        return
    force = _env_on("AOCLSPARSE_TPU_FORCE_BANDGEMM")
    if not (_on_card() or force):
        return
    if plan.conj_a:
        seedA = None  # the band holds unconjugated values
    if plan.conj_b:
        seedB = None
    G = _group()
    band = build_band_gemm_plan(effA, effB, plan.ptr, plan.ind, G=G, force=force, formA_pre=seedA, formB_pre=seedB)
    if band is None and (seedA is not None or seedB is not None):
        # seeded windows can be wider than tight ones and pass the stream or
        # cost limits: try again with host-built tight operands
        seedA = seedB = None
        band = build_band_gemm_plan(effA, effB, plan.ptr, plan.ind, G=G, force=force)
    if band is not None:
        if band.formA is seedA:
            band._valA_src = effA.val  # the band already holds these values
        if band.formB is seedB:
            band._valB_src = effB.val
        plan.band = band


def _symbolic_auto(effA, effB, seedA=None, seedB=None) -> SpgemmPlan:
    """Band-first symbolic stage: when the cost model predicts the band
    engine, build only C's pattern (native spgemm_pattern) and skip the O(P)
    product triples, which the band engine never reads (at the cant
    stand-in's A.A, 285M products: gigabytes of host memory). Falls back to
    the full expansion when the band plan does not attach."""
    if effA.shape[1] != effB.shape[0]:
        # before the pattern kernel, which does not check (the JAX package
        # checks only in _symbolic, after it)
        raise AoclSparseError(Status.invalid_size, f"inner dims mismatch {effA.shape[1]} vs {effB.shape[0]}")
    force = _env_on("AOCLSPARSE_TPU_FORCE_BANDGEMM")
    if (_on_card() or force) and not _env_on("AOCLSPARSE_TPU_NO_BANDGEMM") and _band_ok(effA, effB):
        # the gate of build_band_gemm_plan, asked before C's pattern exists
        geo = band_geometry(effA, effB, _group())
        if geo is not None and (force or geo.est_band < 0.7 * geo.est_exp):
            pat = native.spgemm_pattern(effA.shape[0], effA.ptr, effA.ind, effB.ptr, effB.ind)
            if pat is not None:
                Cptr, Cind, P = pat
                plan = SpgemmPlan(
                    shape=(effA.shape[0], effB.shape[1]), ptr=Cptr.astype(np.int32), ind=Cind,
                    pa=None, pb=None, pc=None, nnz=int(Cind.size), P=P,
                )
                _attach_band_plan(plan, effA, effB, seedA=seedA, seedB=seedB)
                if plan.band is not None:
                    return plan
    plan = _symbolic(effA, effB)
    _attach_band_plan(plan, effA, effB, seedA=seedA, seedB=seedB)
    return plan


def _ensure_expansion(plan: SpgemmPlan, effA, effB) -> None:
    """Fill in the product triples of a pattern-only plan (the band engine
    was dropped or an expansion engine asked for)."""
    if plan.pa is not None:
        return
    full = _symbolic(effA, effB, conj_a=plan.conj_a, conj_b=plan.conj_b)
    plan.pa, plan.pb, plan.pc = full.pa, full.pb, full.pc
    plan.P = full.P


def _seed_cband(out: SparseMatrix, plan: SpgemmPlan, dtype) -> None:
    """When the numeric stage ran on the band engine, hand its (nblk, G, WC)
    C band to the result handle as a pre-seeded ``bwdg`` form: a chained mv
    then runs on the band. Planted at the handle's first get_plan, or used
    directly by mv while the values are pending."""
    band = plan.band
    cb = getattr(band, "_last_cband", None) if band is not None else None
    if cb is None:
        return
    out._seed_bwdg = cband_exec_form(band, cb, plan.shape[0], plan.shape[1], dtype)
    # the seed belongs to the value tensor it extracts to: update_values
    # swaps data.val and makes it stale. Pending values have no tensor yet:
    # the data property seats the key when they materialize
    out._seed_bwdg_val = None if out.values_pending else out.data.val


def _lazy_values_enabled() -> bool:
    """Lazy band-product values (no CSR extraction gather until CSR values
    are read): on by default on the card, off on the CPU;
    AOCLSPARSE_TPU_LAZY_SPGEMM=0/1 overrides."""
    v = os.environ.get("AOCLSPARSE_TPU_LAZY_SPGEMM")
    if v is not None:
        return v in ("1", "true")
    return _on_card()


def _host_values(plan: SpgemmPlan, va: torch.Tensor, vb: torch.Tensor):
    """The native host numeric engine over the plan's triples, or None."""
    return native.spgemm_numeric_host(
        plan.pa, plan.pb, plan.pc, va.detach().cpu().numpy(), vb.detach().cpu().numpy(), plan.nnz
    )


def _host_default(plan: SpgemmPlan, device: torch.device) -> bool:
    """Whether a product without a band plan takes the host engine unpinned:
    past HOST_ENGINE_MIN_P products when its operands lie on the CPU and the
    native library is present. Operands on the card stay there, on the
    device expansion engine: the JAX package's gate priced a TPU's device
    gathers, and the card's are not yet measured against the host engine
    (ROADMAP.md); AOCLSPARSE_TPU_SPGEMM_HOST=1 pins the host engine."""
    return (
        device.type == "cpu"
        and bool(plan.P)
        and plan.P > HOST_ENGINE_MIN_P
        and not _env_on("AOCLSPARSE_TPU_SPGEMM_DEVICE")
        and native.available()
    )


def _numeric_auto(plan: SpgemmPlan, effA, effB, conj_a: bool, conj_b: bool, lazy: bool = False):
    """The numeric stage: the band engine when attached, else the host or
    the device expansion engine. With ``lazy=True`` (band engine only) the C
    band is computed and the CSR extraction deferred: returns ("lazy",
    thunk), the thunk yielding the CSR-ordered values."""
    use_host = plan._host_engine or _env_on("AOCLSPARSE_TPU_SPGEMM_HOST")
    if plan.band is not None and not use_host:
        # the band engine takes real operands: conj_a/conj_b change nothing
        band = plan.band
        cband = band_gemm_cband(band, effA.val, effB.val)
        band._last_cband = cband
        if not lazy:
            return extract_values(band, cband)
        # the host extraction runs only where a plan pins it (autotune in the
        # JAX package, not ported): the default is the device gather
        if plan._extract_route == "host":

            def _host_extract(va=effA.val, vb=effB.val):
                _ensure_expansion(plan, effA, effB)
                cv = _host_values(plan, va, vb)
                if cv is not None:
                    return torch.from_numpy(cv).to(cband.device)
                return extract_values(band, cband)

            return ("lazy", _host_extract)
        return ("lazy", lambda: extract_values(band, cband))
    if plan.band is not None:
        band = plan.band
        band._last_cband = None  # this pass leaves no band to seed
    _ensure_expansion(plan, effA, effB)  # pattern-only plan, band not taken
    # the host engine (the reference's threaded numeric Gustavson,
    # csr2m.cpp:405-545) on the triples: pinned, or the default for large
    # products on the CPU
    use_host = use_host or _host_default(plan, effA.val.device)
    if use_host and plan.nnz:
        va, vb = effA.val, effB.val
        if conj_a and va.is_complex():
            va = torch.conj_physical(va)
        if conj_b and vb.is_complex():
            vb = torch.conj_physical(vb)
        cv = _host_values(plan, va, vb)
        if cv is not None:
            return torch.from_numpy(cv).to(va.device)
    return _numeric_plan(plan, effA.val, effB.val, conj_a, conj_b)


# ---------------------------------------------------------------------------
# sp2m / csr2m / spmm (sparse out)
# ---------------------------------------------------------------------------


def _check_handles(*hs):
    for h in hs:
        if h is None:
            raise AoclSparseError(Status.invalid_pointer, "null matrix handle")


def _dev_struct(plan: SpgemmPlan, device: torch.device):
    """C's row pointer and column indices as tensors on `device`, once a plan."""
    st = getattr(plan, "_dev_st", None)
    if st is None or st[0].device != device:
        st = plan._dev_st = (torch.from_numpy(plan.ptr).to(device), torch.from_numpy(plan.ind).to(device))
    return st


def _install(C: SparseMatrix, plan: SpgemmPlan, val, dtype, device) -> None:
    """Put the numeric stage's values (a tensor, or ("lazy", thunk)) on C."""
    ptr, ind = _dev_struct(plan, device)
    if isinstance(val, tuple):
        thunk = val[1]
        C.set_lazy_values(ptr, ind, plan.shape, dtype, lambda: thunk().to(dtype))
    else:
        C.data = CSR(ptr, ind, val.to(dtype), shape=plan.shape)


def sp2m(
    opA: Operation,
    descrA: MatrixDescriptor,
    A: SparseMatrix,
    opB: Operation,
    descrB: MatrixDescriptor,
    B: SparseMatrix,
    request: Request = Request.full_computation,
    C: Optional[SparseMatrix] = None,
) -> SparseMatrix:
    """C = op(descrA(A)) @ op(descrB(B))  (aoclsparse_sp2m, csr2m.cpp:546).

    Two-stage protocol: request=nnz_count builds the structure (values
    zero), request=finalize recomputes the values on the cached plan (C from
    an earlier call), request=full_computation does both."""
    _check_handles(A, B)
    descrA.validate()
    descrB.validate()
    request = Request(request)
    if request == Request.finalize:
        if C is None or getattr(C, "_spgemm_plan", None) is None:
            raise AoclSparseError(Status.invalid_value, "finalize requires C from a prior nnz_count stage")
        plan: SpgemmPlan = C._spgemm_plan
        effA = _effective(A, descrA, opA)
        effB = _effective(B, descrB, opB)
        dtype = torch.promote_types(effA.val.dtype, effB.val.dtype)
        lazy = plan.band is not None and _lazy_values_enabled()
        val = _numeric_auto(plan, effA, effB, plan.conj_a, plan.conj_b, lazy=lazy)
        _install(C, plan, val, dtype, effA.val.device)
        C.invalidate()  # the handle's cached plan holds pre-finalize values
        _seed_cband(C, plan, dtype)
        return C
    effA = _effective(A, descrA, Operation(opA))
    effB = _effective(B, descrB, Operation(opB))
    plan = _symbolic_auto(effA, effB, seedA=_operand_seed(A, descrA, opA), seedB=_operand_seed(B, descrB, opB))
    dtype = torch.promote_types(A.dtype, B.dtype)
    dev = effA.val.device
    out = SparseMatrix(None, FormatType.csr)
    out._spgemm_plan = plan
    if request == Request.nnz_count:
        _install(out, plan, torch.zeros(plan.nnz, dtype=dtype, device=dev), dtype, dev)
        return out
    lazy = plan.band is not None and _lazy_values_enabled()
    _install(out, plan, _numeric_auto(plan, effA, effB, False, False, lazy=lazy), dtype, dev)
    _seed_cband(out, plan, dtype)
    return out


def csr2m(
    opA: Operation,
    descrA: MatrixDescriptor,
    A: SparseMatrix,
    opB: Operation,
    descrB: MatrixDescriptor,
    B: SparseMatrix,
    request: Request = Request.full_computation,
    C: Optional[SparseMatrix] = None,
) -> SparseMatrix:
    """The legacy two-matrix product on the same engine (aoclsparse_?csr2m,
    level3/aoclsparse_csr2m.cpp:45)."""
    return sp2m(opA, descrA, A, opB, descrB, B, request, C)


def spmm(A: SparseMatrix, B: SparseMatrix, op: Operation = Operation.none) -> SparseMatrix:
    """C = op(A) @ B (aoclsparse_spmm, level3/aoclsparse_spmm.cpp:28)."""
    return sp2m(op, GENERAL, A, Operation.none, GENERAL, B, Request.full_computation)


# ---------------------------------------------------------------------------
# dense out: sp2md / spmmd
# ---------------------------------------------------------------------------


def _scalar(v, dtype, device) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=device)


def _numeric_dense(Aval, Bval, pa, pb, rows, cols, alpha, beta, C0, conj_a: bool, conj_b: bool) -> torch.Tensor:
    """alpha * (sum of the products into a dense C) + beta * C0."""
    a = Aval[pa]
    b = Bval[pb]
    if conj_a and a.is_complex():
        a = torch.conj_physical(a)
    if conj_b and b.is_complex():
        b = torch.conj_physical(b)
    acc = torch.zeros(C0.shape, dtype=C0.dtype, device=C0.device)
    acc.index_put_((rows, cols), (a * b).to(C0.dtype), accumulate=True)
    return alpha * acc + beta * C0


def _dense_in(C, device, dtype, order: Order) -> torch.Tensor:
    """A dense operand as a tensor of `dtype` on `device`, row-major view
    (Order.column: the caller's array is the transpose)."""
    t = C.to(device) if isinstance(C, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(np.asarray(C))).to(device)
    if Order(order) == Order.column:
        t = t.T
    return t.to(dtype)


def _expansion_tensors(effA, effB, m: int, upper_only: bool = False):
    """The dense-out products: (pa, pb, rows, cols) as device tensors."""
    rows, pa, pb = _expand(effA.ptr, effA.ind, effB.ptr, effB.ind, m)
    cols = effB.ind.astype(np.int64)[pb] if pb.size else pb
    if upper_only:
        keep = cols >= rows
        rows, cols, pa, pb = rows[keep], cols[keep], pa[keep], pb[keep]
    dev = effA.val.device
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev) for a in (pa, pb, rows, cols))


def sp2md(
    opA: Operation,
    descrA: MatrixDescriptor,
    A: SparseMatrix,
    opB: Operation,
    descrB: MatrixDescriptor,
    B: SparseMatrix,
    alpha,
    beta=0.0,
    C=None,
    order: Order = Order.row,
):
    """Dense C = alpha*op(A)op(B) + beta*C (aoclsparse_?sp2md,
    level3/aoclsparse_sp2md.cpp:130)."""
    _check_handles(A, B)
    effA = _effective(A, descrA, Operation(opA))
    effB = _effective(B, descrB, Operation(opB))
    mA, nA = effA.shape
    mB, nB = effB.shape
    if nA != mB:
        raise AoclSparseError(Status.invalid_size, f"inner dims mismatch {nA} vs {mB}")
    dtype = torch.promote_types(A.dtype, B.dtype)
    dev = effA.val.device
    C0 = torch.zeros(mA, nB, dtype=dtype, device=dev)
    if C is not None:
        Cin = _dense_in(C, dev, dtype, order)
        if tuple(Cin.shape) != (mA, nB):
            raise AoclSparseError(Status.invalid_size, f"C must be ({mA},{nB}), got {tuple(Cin.shape)}")
        # beta == 0: C is not read (NaN/Inf in C are overwritten, the
        # csrmv_kr.hpp:54-56 convention shared across the reference)
        if not (isinstance(beta, Number) and beta == 0):
            C0 = Cin
    pa, pb, rows, cols = _expansion_tensors(effA, effB, mA)
    out = _numeric_dense(
        effA.val, effB.val, pa, pb, rows, cols, _scalar(alpha, dtype, dev), _scalar(beta, dtype, dev), C0,
        False, False,
    )
    return out.T if Order(order) == Order.column else out


def spmmd(A: SparseMatrix, B: SparseMatrix, op: Operation = Operation.none, order: Order = Order.row):
    """Dense C = op(A) @ B (aoclsparse_?spmmd)."""
    return sp2md(op, GENERAL, A, Operation.none, GENERAL, B, 1.0, 0.0, None, order)


# ---------------------------------------------------------------------------
# syrk / syrkd: C = A op(A) or op(A) A, upper-triangle result
# ---------------------------------------------------------------------------


def _syrk_plan(A: SparseMatrix, opA: Operation):
    opA = Operation(opA)
    cplx = A.dtype.is_complex
    if cplx and opA == Operation.transpose:
        raise AoclSparseError(Status.not_implemented, "syrk: transpose unsupported for complex (reference parity)")
    effA = _effective(A, GENERAL, Operation.none)
    effAt = _effective(A, GENERAL, Operation.transpose)
    if opA == Operation.none:
        # C = A op(A): op(A) = A^T (real) or A^H (complex) = conj on values
        return effA, effAt, False, cplx
    return effAt, effA, cplx, False  # C = op(A) A


def syrk(opA: Operation, A: SparseMatrix) -> SparseMatrix:
    """C = A op(A) (none) or op(A) A; upper-triangle sparse sym/herm result
    (aoclsparse_syrk, level3/aoclsparse_syrk.cpp)."""
    _check_handles(A)
    effL, effR, conj_a, conj_b = _syrk_plan(A, opA)
    plan = _symbolic(effL, effR, upper_only=True, conj_a=conj_a, conj_b=conj_b)
    _attach_band_plan(plan, effL, effR)
    val = _numeric_auto(plan, effL, effR, conj_a, conj_b)
    ptr, ind = _dev_struct(plan, effL.val.device)
    out = SparseMatrix(CSR(ptr, ind, val, shape=plan.shape), FormatType.csr)
    out._spgemm_plan = plan
    # no band seeding: the band holds the full product while the stored
    # pattern is the upper triangle, so an mv over the band would add the
    # lower one
    return out


def syrkd(opA: Operation, A: SparseMatrix, alpha, beta=0.0, C=None, order: Order = Order.row):
    """Dense C = alpha A op(A) + beta C, upper triangle (aoclsparse_?syrkd).
    For complex dtypes only the real parts of alpha and beta are used, to
    keep C hermitian (reference note)."""
    _check_handles(A)
    effL, effR, conj_a, conj_b = _syrk_plan(A, opA)
    m = effL.shape[0]
    dtype = A.dtype
    dev = effL.val.device
    if dtype.is_complex:
        alpha = complex(np.real(alpha))
        beta = complex(np.real(beta))
    if C is None:
        C0 = torch.zeros(m, m, dtype=dtype, device=dev)
    else:
        C0 = _dense_in(C, dev, dtype, order)
        if tuple(C0.shape) != (m, m):
            raise AoclSparseError(Status.invalid_size, f"C must be ({m},{m}), got {tuple(C0.shape)}")
    # beta == 0: the accumulation does not read C (NaN/Inf overwrite); the
    # strict lower triangle below still returns the caller's C as it is
    C0_acc = torch.zeros(m, m, dtype=dtype, device=dev) if (isinstance(beta, Number) and beta == 0) else C0
    pa, pb, rows, cols = _expansion_tensors(effL, effR, m, upper_only=True)
    out = _numeric_dense(
        effL.val, effR.val, pa, pb, rows, cols, _scalar(alpha, dtype, dev), _scalar(beta, dtype, dev), C0_acc,
        conj_a, conj_b,
    )
    # the reference's beta loops touch only j >= i (aoclsparse_syrkd.hpp):
    # the caller's strict lower triangle passes through unscaled
    triu = torch.ones(m, m, dtype=torch.bool, device=dev).triu()
    out = torch.where(triu, out, C0)
    return out.T if Order(order) == Order.column else out


# ---------------------------------------------------------------------------
# sypr / syprd: symmetric triple products
# ---------------------------------------------------------------------------


def sypr(
    opA: Operation,
    A: SparseMatrix,
    descrB: MatrixDescriptor,
    B: SparseMatrix,
    request: Request = Request.full_computation,
    C: Optional[SparseMatrix] = None,
) -> SparseMatrix:
    """C = A B A^{T/H} (op none) or op(A) B A, B sym/herm; upper-triangle
    sparse result (aoclsparse_sypr, functions.h:2150-2258)."""
    _check_handles(A, B)
    opA = Operation(opA)
    cplx = A.dtype.is_complex
    if cplx and opA == Operation.transpose:
        raise AoclSparseError(Status.not_implemented, "sypr: transpose only for real dtypes")
    if MatrixType(descrB.type) not in (MatrixType.symmetric, MatrixType.hermitian):
        raise AoclSparseError(Status.invalid_value, "sypr requires symmetric/hermitian B")
    effB = _effective(B, descrB, Operation.none)
    effA = _effective(A, GENERAL, Operation.none)
    effAt = _effective(A, GENERAL, Operation.transpose)
    if opA == Operation.none:
        L, M_, R, conj_l, conj_r = effA, effB, effAt, False, cplx  # A B A^{T or H}
    else:
        L, M_, R, conj_l, conj_r = effAt, effB, effA, cplx, False  # op(A) B A
    if request == Request.finalize and C is not None and getattr(C, "_sypr_plan", None):
        plan1, plan2 = C._sypr_plan
        t_val = _numeric_plan(plan1, L.val, M_.val, conj_l, False)
        val = _numeric_plan(plan2, t_val, R.val, False, conj_r)
        ptr, ind = _dev_struct(plan2, val.device)
        C.data = CSR(ptr, ind, val, shape=plan2.shape)
        C.invalidate()
        return C
    # stage 1: T = L @ M
    plan1 = _symbolic(L, M_)
    t_val = _numeric_plan(plan1, L.val, M_.val, conj_l, False)
    effT = EffectiveCSR(plan1.ptr, plan1.ind, np.arange(plan1.nnz), False, 0.0, plan1.shape)
    effT.val = t_val
    # stage 2: C = T @ R, upper triangle
    plan2 = _symbolic(effT, R, upper_only=True)
    if request == Request.nnz_count:
        val = torch.zeros(plan2.nnz, dtype=A.dtype, device=t_val.device)
    else:
        val = _numeric_plan(plan2, t_val, R.val, False, conj_r)
    ptr, ind = _dev_struct(plan2, val.device)
    out = SparseMatrix(CSR(ptr, ind, val, shape=plan2.shape), FormatType.csr)
    out._sypr_plan = (plan1, plan2)
    return out


def syprd(op: Operation, A: SparseMatrix, B, alpha, beta=0.0, C=None, order: Order = Order.row):
    """Dense C = alpha A B op(A) + beta C with a dense sym/herm B
    (aoclsparse_?syprd, functions.h:2766-2890). B is taken as stored (full);
    C comes back full, its upper triangle authoritative as in the
    reference."""
    from .csrmm import mm as _mm

    _check_handles(A)
    op = Operation(op)
    dev = A.device
    Bt = B.to(dev) if isinstance(B, torch.Tensor) else as_values(np.asarray(B), dev)
    if Order(order) == Order.column:
        Bt = Bt.T
    cplx = A.dtype.is_complex
    if cplx and op == Operation.transpose:
        raise AoclSparseError(Status.not_implemented, "syprd: transpose only for real dtypes")
    if (not cplx) and op == Operation.conjugate_transpose:
        op = Operation.transpose
    m, n = A.shape
    want = (n, n) if op == Operation.none else (m, m)
    if tuple(Bt.shape) != want:
        raise AoclSparseError(Status.invalid_size, f"B must be {want}")
    dtype = torch.promote_types(A.dtype, Bt.dtype)
    if cplx:
        alpha = complex(np.real(alpha))
        beta = complex(np.real(beta))
    # stage 1: T = op(A) @ B (mm keeps the sparse operand on the left)
    T = _mm(1.0, A, GENERAL, op, Bt.to(dtype).contiguous(), 0.0)
    # stage 2: the remaining A factor on the right, through mm on the
    # (conjugate) transpose of the result
    if op == Operation.none:
        # C = T A^{T or H}; C^H = A T^H (complex), C^T = A T^T (real)
        rhs = torch.conj_physical(T).T if cplx else T.T
        Ct = _mm(1.0, A, GENERAL, Operation.none, rhs.contiguous(), 0.0)
        Cnew = torch.conj_physical(Ct).T if cplx else Ct.T
    else:
        # C = T A; C^T = A^T T^T
        Ct = _mm(1.0, A, GENERAL, Operation.transpose, T.T.contiguous(), 0.0)
        Cnew = Ct.T
    mC = Cnew.shape[0]
    if C is None:
        C0 = torch.zeros(mC, mC, dtype=dtype, device=dev)
    else:
        C0 = _dense_in(C, dev, dtype, order)
        if tuple(C0.shape) != (mC, mC):
            raise AoclSparseError(Status.invalid_size, f"C must be ({mC},{mC}), got {tuple(C0.shape)}")
    a = _scalar(alpha, dtype, dev)
    if isinstance(beta, Number) and beta == 0:
        out = a * Cnew.to(dtype)  # beta == 0: C is not read
    else:
        out = a * Cnew.to(dtype) + _scalar(beta, dtype, dev) * C0
    return out.T if Order(order) == Order.column else out


# ---------------------------------------------------------------------------
# add: C = alpha*op(A) + B
# ---------------------------------------------------------------------------


def add(op: Operation, alpha, A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
    """C = alpha*op(A) + B (aoclsparse_?add, level3/aoclsparse_csradd.hpp:50,
    226, the two-pass merge)."""
    _check_handles(A, B)
    effA = _effective(A, GENERAL, Operation(op))
    effB = _effective(B, GENERAL, Operation.none)
    if effA.shape != effB.shape:
        raise AoclSparseError(Status.invalid_size, f"{effA.shape} + {effB.shape}")
    m, n = effA.shape
    rowsA = np.repeat(np.arange(m, dtype=np.int64), np.diff(effA.ptr.astype(np.int64)))
    rowsB = np.repeat(np.arange(m, dtype=np.int64), np.diff(effB.ptr.astype(np.int64)))
    keysA = rowsA * n + effA.ind.astype(np.int64)
    keysB = rowsB * n + effB.ind.astype(np.int64)
    ukeys = np.unique(np.concatenate([keysA, keysB]))
    nnzC = ukeys.size
    # -1: the operand has no entry there (reads the appended zero)
    srcA = np.full(nnzC, -1, dtype=np.int64)
    srcB = np.full(nnzC, -1, dtype=np.int64)
    srcA[np.searchsorted(ukeys, keysA)] = np.arange(keysA.size)
    srcB[np.searchsorted(ukeys, keysB)] = np.arange(keysB.size)
    Cptr = np.zeros(m + 1, dtype=np.int64)
    if nnzC:
        np.add.at(Cptr, ukeys // n + 1, 1)
    dtype = torch.promote_types(A.dtype, B.dtype)
    dev = effA.val.device
    zero = torch.zeros(1, dtype=dtype, device=dev)
    a = torch.cat([effA.val.to(dtype), zero])[torch.from_numpy(srcA).to(dev)]
    b = torch.cat([effB.val.to(dtype), zero])[torch.from_numpy(srcB).to(dev)]
    val = _scalar(alpha, dtype, dev) * a + b
    ptr = torch.from_numpy(np.cumsum(Cptr).astype(np.int32)).to(dev)
    ind = torch.from_numpy((ukeys % n).astype(np.int32)).to(dev)
    return SparseMatrix(CSR(ptr, ind, val, shape=(m, n)), FormatType.csr)
