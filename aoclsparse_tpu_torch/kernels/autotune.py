"""Empirical kernel tuning: time the candidate forms, pin the fastest.

PyTorch counterpart of ``aoclsparse_tpu/kernels/autotune.py``. The
planner picks a form by a cost model (planner/plan.py `choose_mv_format`,
`choose_mm_format`, planner/triangular.py `sv_engine_for`); these
functions measure every buildable candidate for a concrete matrix through
the live dispatch and pin the winner on the plan, with the JAX package's
signatures, return values and pins:

- `autotune_mv`: the form planted in the plan's kind=None slot, which
  ``mv``, ``mv_operator`` and the solvers run; a host-engine winner is
  pinned in ``plan._mv_engine`` instead, which only ``mv`` reads (the whole
  call on the host engine, a CPU tensor back), and the best device form
  takes the slot. On a card handle the host engine is a candidate only
  where ``kinds`` names it;
- `autotune_mm`: ``plan._mm_tuned[(type, fill, diag, op, K)]``, the form
  ``mm`` runs without a kid (``"bandmxu"`` labels KID 5, which shares the
  ``bandtm`` form with KID 4);
- `autotune_trsv`: ``plan._trsv_tuned`` (a block size, read by
  `trsv_form_for` and taking the blocked form past the gate) or
  ``plan._trsv_engine`` (``"level"``, or ``"host"`` for trsv's single
  right-hand side, timed on a CPU handle only), keyed by (fill, diag, op);
- `autotune_spgemm`: the staged product's ``_host_engine`` and
  ``_extract_route`` (the host numeric timed on CPU operands only), and
  its band plan dropped unless the band engine won.

So a card handle is never pinned to an engine that runs its work on the
host unless the caller asked for it (mv's ``kinds``; the explicit kids sv
KID 2 and mv KID 11 reach the host engines as before).

Candidates are the JAX package's lists plus the form the port's default
takes for the operand where the list lacks it (``diag`` for mm on HPCG's
stencil, ``route`` for mv on a scatter operand), so that a pin never
replaces the default with a form that was not timed against it (ROADMAP.md
queue 3). A candidate that cannot be built or run for this operand is
skipped, as in the JAX package: it raised `AoclSparseError` (a form past
its caps, a layout the host or the card cannot allocate, a kernel with no
instance for the dtype, a kid the form cannot serve) or the card ran out
of memory in the call (`_SKIPPED`). Anything else, a
kernel that fails to build or launch among it, propagates; and the calls
that then dispatch the pinned form raise what they raise.

Timing: the host clock around chained calls, with one
``torch.cuda.synchronize()`` a chunk, the best of the chunks (the JAX
package's one fetch a chunk, autotune.py:34-53 there): a candidate's host
work counts, as it does for the caller. On CPU tensors the same loop runs
without the synchronize. The first call of each candidate, which builds
its caches, is not timed.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.descr import MatrixDescriptor
from ..core.types import AoclSparseError, MatrixType, Operation, Status

__all__ = ["autotune_mv", "autotune_trsv", "autotune_mm", "autotune_spgemm"]

_MV_KINDS = ("bandt", "bwd", "diag", "gen", "ell", "ellhyb", "segsum", "host")
_MM_KINDS = ("gen", "bandtm", "bandmxu", "bwdg", "ell", "ellhyb", "segsum")
#: the host engines sit out above this many nonzeros unless asked for: they
#: target the dispatch-latency-bound regime (the JAX package's carve-out)
HOST_MAX_NNZ = 1 << 18
#: what a candidate may raise and be skipped for; a kernel that fails to
#: build or launch raises RuntimeError, which is not among them
_SKIPPED = (AoclSparseError, torch.OutOfMemoryError)


def _best_seconds(fn: Callable, device: torch.device, iters: int, chunks: int) -> float:
    """Seconds a call of fn: one untimed call, then the best of `chunks`
    runs of `iters` chained calls, each closed by one synchronize."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    best = float("inf")
    for _ in range(chunks):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _times_host(device: torch.device, nnz: int = 0) -> bool:
    """Whether a tuner times a host engine unasked: on a CPU handle, at
    most HOST_MAX_NNZ nonzeros. On a card a host pin would run the caller's
    work on the host, which it did not ask for."""
    return device.type == "cpu" and nnz <= HOST_MAX_NNZ


def _probe(shape, dtype, device) -> torch.Tensor:
    """A deterministic scale-1 probe operand, linspace(-1, 1) over its
    elements, as in the JAX package."""
    n = int(np.prod(shape))
    return torch.from_numpy(np.linspace(-1.0, 1.0, n).reshape(shape)).to(device=device, dtype=dtype)


def autotune_mv(
    A,
    descr: Optional[MatrixDescriptor] = None,
    op: Operation = Operation.none,
    iters: int = 20,
    chunks: int = 3,
    kinds: Optional[Tuple[str, ...]] = None,
    x=None,
) -> Dict[str, float]:
    """Measure every buildable SpMV execution form for `A` and pin the
    winner as the plan's auto form for (descr, op).

    Returns {form_kind: best_seconds_per_mv}, by the kind each candidate
    realizes (a ``bandt`` request whose window is too wide builds ``bwd``).
    Later ``mv`` calls without a kid dispatch the winner; an explicit kid
    still overrides, and ``update_values`` refreshes the planted form."""
    from ..ops.level2.mv import _as_operand, _run_exec_form
    from ..planner.plan import build_exec_form, get_plan

    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descr = MatrixDescriptor() if descr is None else descr
    op = Operation(op)
    plan = get_plan(A)
    eff = plan.effective_for(descr, op, A.dtype)
    dev = A.device
    # effective_for folds the op into the structure: the input dimension is
    # the effective column count
    xv = _probe((eff.shape[1],), A.dtype, dev) if x is None else _as_operand(x, A, "x").to(A.dtype)
    key4 = (descr.type, descr.fill_mode, descr.diag_type, op)
    if kinds is None:
        kinds = _MV_KINDS
        if not _times_host(dev, eff.nnz):
            kinds = tuple(k for k in kinds if k != "host")
    # the default's form (the cost model's, built if need be): timed too
    default = plan.exec_form_for(descr, op)
    on_plan = [f for k, f in plan.exec_forms.items() if k[:4] == key4]
    results: Dict[str, float] = {}
    forms = {}

    def candidate(kind: str):
        if kind == "gen":  # the composite itself, never its route fallback
            return plan.gen_form_for(descr, op)
        for f in on_plan:
            if f.kind == kind:
                return f
        return build_exec_form(eff, kind)

    for kind in tuple(kinds) + (None,):
        try:
            form = default if kind is None else candidate(kind)
        except _SKIPPED:  # not buildable for this structure (caps, memory)
            continue
        if form is None or form.kind in results:
            continue
        form.precision_mode = A.precision_mode
        try:
            results[form.kind] = _best_seconds(lambda: _run_exec_form(form, xv, None), dev, iters, chunks)
        except _SKIPPED:  # no kernel instance for the dtype, or out of memory
            continue
        forms[form.kind] = form
    if not results:
        raise AoclSparseError(Status.internal_error, "no execution form could be timed")
    winner = min(results, key=results.get)
    if winner == "host":
        # the host engine serves the eager mv entry only; the solvers and
        # mv_operator keep the best device form in the auto slot
        plan._mv_engine[key4] = "host"
        plan.exec_forms[key4 + ("host",)] = forms["host"]
        device = {k: v for k, v in results.items() if k != "host"}
        if device:
            plan.exec_forms[key4 + (None,)] = forms[min(device, key=device.get)]
    else:
        plan._mv_engine.pop(key4, None)
        plan.exec_forms[key4 + (None,)] = forms[winner]
    return results


def autotune_mm(
    A,
    k: int = 128,
    descr: Optional[MatrixDescriptor] = None,
    op: Operation = Operation.none,
    iters: int = 10,
    chunks: int = 3,
    kinds: Optional[Tuple[str, ...]] = None,
    B=None,
) -> Dict[str, float]:
    """Measure the SpMM execution forms for `A` at RHS width `k` through
    the live ``mm`` dispatch (an explicit kid each) and pin the winner for
    (descr, op, k) in ``plan._mm_tuned``, which ``mm`` reads when no kid is
    given. Returns {form_kind: best_seconds_per_mm}."""
    from ..ops.level2.mv import _as_operand
    from ..ops.level3.csrmm import MXU_KID, MXU_LABEL, mm
    from ..planner.plan import get_plan, mm_kind
    from .registry import registry

    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descr = MatrixDescriptor() if descr is None else descr
    op = Operation(op)
    plan = get_plan(A)
    eff = plan.effective_for(descr, op, A.dtype)
    dev = A.device
    if B is None:
        B = _probe((eff.shape[1], k), A.dtype, dev)
    else:
        B = _as_operand(B, A, "B").to(A.dtype)
        k = int(B.shape[1])
    # the first entry per fmt (KIDs 4 and 5 share "bandtm"); KID 5 by label
    kid_of: Dict[str, int] = {MXU_LABEL: MXU_KID}
    for e in registry.table("mm"):
        kid_of.setdefault(e.fmt, e.kid)
    cands = tuple(kinds or _MM_KINDS)
    default = mm_kind(A, plan, descr, op)
    if default not in cands:
        cands += (default,)
    results: Dict[str, float] = {}
    for kind in cands:
        kid = kid_of.get(kind)
        if kid is None:
            continue
        try:
            results[kind] = _best_seconds(lambda: mm(1.0, A, descr, op, B, 0.0, kid=kid), dev, iters, chunks)
        except _SKIPPED:  # not buildable for this structure or K, no instance, or out of memory
            continue
    if not results:
        raise AoclSparseError(Status.internal_error, "no mm form could be timed")
    plan._mm_tuned[(descr.type, descr.fill_mode, descr.diag_type, op, k)] = min(results, key=results.get)
    return results


def autotune_spgemm(
    A,
    B,
    opA: Operation = Operation.none,
    opB: Operation = Operation.none,
    descrA: Optional[MatrixDescriptor] = None,
    descrB: Optional[MatrixDescriptor] = None,
    iters: int = 5,
    chunks: int = 2,
):
    """Measure the SpGEMM numeric engines (the band engine, the device
    expansion engine, and on CPU operands the host engine) for
    op(A) @ op(B) and pin the winner on the staged product's plan.

    Returns ``(C, results)``: C is the nnz_count-staged product handle whose
    plan is pinned (drive ``sp2m(..., request=finalize, C=C)`` on it, the
    reference's staged protocol); `results` maps each engine, and
    ``extract_gather`` (the band engine's CSR extraction alone, timed to
    pin the lazy values' extraction route), to best seconds a pass."""
    from .. import native
    from ..core.types import Request
    from ..ops.level3.spgemm import _effective, _ensure_expansion, _host_values, _numeric_auto, _numeric_plan, sp2m
    from .spgemm_band import extract_values

    if A is None or B is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descrA = MatrixDescriptor() if descrA is None else descrA
    descrB = MatrixDescriptor() if descrB is None else descrB
    C = sp2m(opA, descrA, A, opB, descrB, B, request=Request.nnz_count)
    plan = C._spgemm_plan
    effA = _effective(A, descrA, Operation(opA))
    effB = _effective(B, descrB, Operation(opB))
    dev = effA.val.device

    def best(fn) -> float:
        return _best_seconds(fn, dev, iters, chunks)

    results: Dict[str, float] = {}
    if plan.nnz:
        _ensure_expansion(plan, effA, effB)  # a band-first plan has no triples yet
        results["expand"] = best(lambda: _numeric_plan(plan, effA.val, effB.val, False, False))
        if plan.band is not None:
            try:
                results["band"] = best(lambda: _numeric_auto(plan, effA, effB, False, False))
            except _SKIPPED:  # the band engine cannot run these operands
                plan.band = None
        # the threaded host numeric (reference csr2m.cpp:405-545), on CPU
        # operands only; a zero-length call probes the library and the dtype
        probe = None
        if _times_host(dev):
            try:
                probe = native.spgemm_numeric_host(
                    plan.pa[:0], plan.pb[:0], plan.pc[:0], effA.val[:0].numpy(), effB.val[:0].numpy(), 0
                )
            except TypeError:  # bf16: no numpy dtype, and no host instance
                pass
        if probe is not None:
            results["host"] = best(lambda: torch.from_numpy(_host_values(plan, effA.val, effB.val)).to(dev))
    if plan.nnz and plan.band is not None and "band" in results:
        # the lazy values' extraction: the device gather of the C band,
        # against a host numeric pass that writes CSR order directly
        cband = plan.band._last_cband
        results["extract_gather"] = best(lambda: extract_values(plan.band, cband))
        host_t = results.get("host")
        plan._extract_route = "host" if host_t is not None and host_t < results["extract_gather"] else "gather"
    if not results:
        results["expand"] = 0.0  # an empty product: every engine is a no-op
    engines = {k: v for k, v in results.items() if k in ("expand", "band", "host")}
    winner = min(engines, key=engines.get)
    plan._host_engine = winner == "host"
    if winner != "band":
        plan.band = None  # the finalize passes take the chosen engine
    return C, results


def autotune_trsv(
    A,
    descr: Optional[MatrixDescriptor] = None,
    op: Operation = Operation.none,
    nb_candidates: Tuple[int, ...] = (128, 256, 512),
    k: int = 1,
    iters: int = 10,
    chunks: int = 3,
) -> Dict[object, float]:
    """Measure the blocked triangular solve at several block sizes, the
    level engine (sv KID 1) and, on a CPU handle, for one right-hand side
    of a triangle of at most 2^18 nonzeros, the host engine (sv KID 2),
    and pin the winner
    for this plan's (fill, diag, op). `k` sizes the probe right-hand side
    (k > 1 tunes the trsm path). Returns {nb or engine: seconds}."""
    from ..ops.level2.trsv import pad_solve
    from ..planner.plan import get_plan
    from ..planner.triangular import trsv_form_for, trsv_host_form_for, trsv_level_form_for

    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descr = MatrixDescriptor(type=MatrixType.triangular) if descr is None else descr
    op = Operation(op)
    plan = get_plan(A)
    m = plan.clean.m
    dev = A.device
    col = np.linspace(1.0, 2.0, m)  # every column the same, as in the JAX package
    r = torch.from_numpy(col if k == 1 else np.tile(col[:, None], (1, k))).to(device=dev, dtype=A.dtype)
    results: Dict[object, float] = {}
    for nb in nb_candidates:
        try:
            form = trsv_form_for(plan, descr, op, nb=min(nb, max(8, m)))
        except _SKIPPED:  # refused at this block size (memory cap)
            continue
        if form.nb in results:
            continue  # clamped candidates can collapse to one block size
        try:
            results[form.nb] = _best_seconds(lambda: pad_solve(form, r), dev, iters, chunks)
        except _SKIPPED:  # no kernel instance for the dtype on this device
            continue
    # the level-scheduled wavefront: wins on shallow dependency DAGs
    try:
        lform = trsv_level_form_for(plan, descr, op)
        results["level"] = _best_seconds(lambda: lform.solve(r), dev, iters, chunks)
    except _SKIPPED:  # too deep or padded, or no instance for the dtype
        pass
    # the host sequential engine: latency-bound small triangles, one
    # right-hand side (its trsm twin is explicit-kid only), on a CPU handle
    if k == 1 and _times_host(dev, plan.clean.nnz):
        try:
            hform = trsv_host_form_for(plan, descr, op)
            results["host"] = _best_seconds(lambda: hform.solve(r), dev, iters, chunks)
        except _SKIPPED:  # the host library has no instance for the dtype
            pass
    if not results:
        raise AoclSparseError(Status.internal_error, "no block size could be timed")
    winner = min(results, key=results.get)
    key = (descr.fill_mode, descr.diag_type, op)
    if winner in ("level", "host"):
        plan._trsv_engine[key] = winner
    else:
        plan._trsv_engine.pop(key, None)
        plan._trsv_tuned[key] = winner
    return results
