"""Kernel registry + oracle dispatcher.

PyTorch counterpart of ``aoclsparse_tpu/kernels/registry.py`` (the analog
of the reference's Kernel-Attribute-Table + Oracle,
library/src/include/aoclsparse_cntx_dispatcher.hpp:46-78, 272-364). Rows
declare which backend ("cuda" / "cpu" / "any") and which execution format
they serve; the Oracle scores (backend exact match, format match, declared
priority), caches the winner per lookup key, honors explicit KID overrides
(``Status.invalid_kid`` for unsupported requests, like Dispatch::Oracle) and
the global ``AOCLSPARSE_TPU_FORCE_KID`` override. The backend of a call is
the device of its operand. ``debug_dispatcher`` reports which kernel would
run (aoclsparse_debug_dispatcher analog).

The mv table keeps the JAX package's KID numbers and priorities
(kernels/xla/__init__.py:13-54 there): 0 (segsum), the CSR row-gather
kernel (kernels/spmv_csr.py: float32, float64, complex64, complex128 and
bfloat16 on the card, other dtypes raise there; the plain gather on the
CPU), the hand kernel of the JAX package's XLA row; 6 (the planner's diag
form), the diagonal SpMV kernel (kernels/spmv_diag.py: float32, bfloat16
and float64 on the card; the plain shifted sum on the CPU), also the hand
kernel of an XLA row; 1 (ell), 2 (ellhyb), 3 (bsr, a BSR handle's
product), 4 (dia, a DIA handle's) and 10 (sell, sliced ELL, whose
flattened slices have no row pointers: the plain gather), the gather and
shifted forms in plain torch; 5, the ``bwd`` group windows, whose hand-written kernel
(kernels/spmv_bwd.py) serves float32, a bf16 band with float32 x (the mixed
mode) and float64, while complex and float16 operands take its plain
formulation by that dtype rule (the JAX package runs KID 5 as an XLA
formulation; the rule reads the dtype only, never a failed build or
launch); 9 (bwdg), the group-band SpMV in plain torch that a SpGEMM
product's seeded band runs on; 7, the general-structure composite
(kernels/spmv_gen.py), whose band runs the band kernel and whose spill the
spill-route kernels; 8, 12 and 13 for the ``bandt`` form, all three the one
band kernel (kernels/band_spmv.py), 12 the default, streaming a bf16 band
under the mixed precision policy, 13 the f64 instance (the JAX package's
double-float KID); 11, the host engine (kernels/host.py), priority -5, run
only by an explicit kid; and 14, the whole-matrix route
(planner/spill_route.py), which a KID cannot pin (mv raises invalid_kid for
it, as the JAX package does). KID 10 is sell only: the JAX package's opt-in
that also registers its bwd kernel as KID 10 is not copied.

The level-1 tables (axpyi, doti, dotci, dotui, gthr, gthrz, gthrs, roti,
sctr, sctrs) each keep the JAX package's one KID-0 row
(ops/level1.py:236-248 there), registered by ops/level1.py.

The sv table keeps the JAX package's three rows (ops/level2/trsv.py:32-38
there), which serve trsv and trsm alike (the JAX package has no separate sm
table): KID 0, the blocked solve (the window-solve kernels of a ``win``
form, kernels/trsv_win.py, or the chain kernel of a ``dwin`` or ``gather``
form, kernels/trsv_blocked.py); KID 1, the level-scheduled wavefront
(kernels/trsv_level.py, the kernel csrc/trsv_level.cu on the card;
priority -1: never the registry's pick, though on the card the default
solve takes it where planner/triangular.py `sv_engine_for` says the DAG is
shallow against the chain); KID 2, the host sequential
substitution (native/, priority -2: an explicit kid only).

The mm table keeps the JAX package's KIDs 0-7 (ops/level3/csrmm.py:38-57):
0, the segsum form's CSR SpMM kernel (kernels/spmm_csr.py: float32,
float64, complex64, complex128 and bf16 values with float32 B on the card,
other dtypes raise there; the plain gather on the CPU), the hand kernel of
the JAX package's XLA row, which the card's default takes for general
structure; the plain gather and group forms 1-3, the hand-written kernels
of the bandtm form (4, the default there; 5, the block-window twin), the
general-structure composite (6, kernels/spmm_gen.py, its band leg on the
band SpMM kernel) and the diag form (7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.context import get_context
from ..core.types import AoclSparseError, Status
from ..native import trsv_seq
from .band_spmv import spmv_bandt
from .host import HOST_MV_KID, spmv_host_csr
from .plain_spmv import spmv_bsr, spmv_bwdg, spmv_dia, spmv_ell, spmv_ellhyb, spmv_segsum
from .spmm_band import spmm_bandmxu, spmm_bandtm
from .spmm_diag import spmm_diag
from .spmm_gen import spmm_gen
from .spmv_bwd import spmv_bwd_any
from .spmv_csr import spmv_csr_any
from .spmv_diag import spmv_diag_any
from .spmm_csr import spmm_csr_any
from .spmm_plain import spmm_bwd, spmm_ell, spmm_ellhyb
from .spmv_gen import spmv_gen, spmv_route
from .trsv_level import trsv_level
from .trsv_win import trsv_win

__all__ = ["KernelEntry", "Registry", "registry", "debug_dispatcher"]


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One KAT row: Table<K>{kernel, min_cpu_flag, arch_bitmask} analog."""

    kid: int
    name: str
    fn: Callable
    fmt: str  # execution format it consumes: "segsum" | "bandt" | "bandtm" | "diag" | ...
    backend: str = "any"  # "cuda" | "cpu" | "any"
    priority: int = 0  # ties -> highest kid wins, like the reference


def _backend(device) -> str:
    return "cuda" if device is not None and torch.device(device).type == "cuda" else "cpu"


class Registry:
    def __init__(self):
        self._tables: Dict[str, List[KernelEntry]] = {}
        self._cache: Dict[Tuple, KernelEntry] = {}

    def register(self, op: str, entry: KernelEntry) -> None:
        tbl = self._tables.setdefault(op, [])
        if any(e.kid == entry.kid for e in tbl):
            raise ValueError(f"duplicate kid {entry.kid} for op {op}")
        tbl.append(entry)
        self._cache = {k: v for k, v in self._cache.items() if k[0] != op}

    def table(self, op: str) -> List[KernelEntry]:
        return list(self._tables.get(op, []))

    def _score(self, e: KernelEntry, fmt: Optional[str], backend: str) -> int:
        """Oracle scoring (cntx_dispatcher.hpp:272-364): exact backend match
        scores highest; "any" rows are penalized; format mismatch disqualifies."""
        if fmt is not None and e.fmt != fmt:
            return -1
        if e.backend not in ("any", backend):
            return -1
        score = 32 if e.backend == backend else 16
        return score + e.priority

    def select(
        self, op: str, fmt: Optional[str] = None, kid: Optional[int] = None, device=None
    ) -> KernelEntry:
        """Pick the kernel for (op, execution format) on `device`, honoring
        the KID override."""
        backend = _backend(device)
        force_kid = get_context().force_kid
        if kid is None and force_kid is not None:
            kid = force_kid
        tbl = self._tables.get(op)
        if not tbl:
            raise AoclSparseError(Status.not_implemented, f"no kernels for op '{op}'")
        if kid is not None:
            for e in tbl:
                if e.kid == kid:
                    if self._score(e, fmt, backend) < 0:
                        raise AoclSparseError(
                            Status.invalid_kid,
                            f"kid {kid} unsupported for op '{op}' fmt={fmt} backend={backend}",
                        )
                    return e
            raise AoclSparseError(Status.invalid_kid, f"kid {kid} not in table for '{op}'")
        key = (op, fmt, backend)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        best, best_score = None, -1
        for e in tbl:
            s = self._score(e, fmt, backend)
            # ties resolved toward highest kid, like the reference Oracle
            if s > best_score or (s == best_score and best is not None and e.kid > best.kid):
                best, best_score = e, s
        if best is None or best_score < 0:
            raise AoclSparseError(
                Status.not_implemented, f"no kernel for op '{op}' fmt={fmt} backend={backend}"
            )
        self._cache[key] = best
        return best


#: Global registry with the static mv, sv and mm KAT tables.
registry = Registry()
# the segsum form's CSR: the row-gather kernel (kernels/spmv_csr.py) on the
# card, its plain spmv_segsum on the CPU
registry.register("mv", KernelEntry(0, "cuda_csr", spmv_csr_any, "segsum", "any", 0))
registry.register("mv", KernelEntry(1, "torch_ell", spmv_ell, "ell", "any", 0))
registry.register("mv", KernelEntry(2, "torch_ellhyb", spmv_ellhyb, "ellhyb", "any", 0))
registry.register("mv", KernelEntry(3, "torch_bsr", spmv_bsr, "bsr", "any", 0))
registry.register("mv", KernelEntry(4, "torch_dia", spmv_dia, "dia", "any", 0))
registry.register("mv", KernelEntry(5, "cuda_bwd", spmv_bwd_any, "bwd", "any", 1))
# the diag form: the diagonal SpMV kernel (kernels/spmv_diag.py) for the
# dtypes it has, the plain spmv_diag for the rest, on every backend
registry.register("mv", KernelEntry(6, "cuda_diag", spmv_diag_any, "diag", "any", 1))
registry.register("mv", KernelEntry(7, "gen_composite", spmv_gen, "gen", "any", 1))
registry.register("mv", KernelEntry(9, "torch_bwdg", spmv_bwdg, "bwdg", "any", 1))
registry.register("mv", KernelEntry(8, "cuda_bandt", spmv_bandt, "bandt", "any", 2))
registry.register("mv", KernelEntry(12, "cuda_bandv", spmv_bandt, "bandt", "any", 3))
# f64 instance: explicit KID, or the bandt dispatch of a float64 operand
# (ops/level2/mv.py), as the JAX package routes its double-float kernel
registry.register("mv", KernelEntry(13, "cuda_band_f64", spmv_bandt, "bandt", "any", -1))
registry.register("mv", KernelEntry(14, "cuda_spill_route", spmv_route, "route", "any", 1))
registry.register("mv", KernelEntry(10, "torch_sell", spmv_segsum, "sell", "any", 0))
# the host engine: an explicit kid only, never the Oracle's pick
registry.register("mv", KernelEntry(HOST_MV_KID, "host_csr", spmv_host_csr, "host", "any", -5))
registry.register("sv", KernelEntry(0, "cuda_trsv_win", trsv_win, "blocked", "any", 0))
registry.register("sv", KernelEntry(1, "cuda_trsv_level", trsv_level, "level", "any", -1))
registry.register("sv", KernelEntry(2, "host_sequential", trsv_seq, "host", "any", -2))
# the segsum form's CSR: the CSR SpMM kernel (kernels/spmm_csr.py) on the
# card, its plain spmm_segsum on the CPU
registry.register("mm", KernelEntry(0, "cuda_segsum", spmm_csr_any, "segsum", "any", 0))
registry.register("mm", KernelEntry(1, "torch_ell", spmm_ell, "ell", "any", 0))
registry.register("mm", KernelEntry(2, "torch_ellhyb", spmm_ellhyb, "ellhyb", "any", 0))
registry.register("mm", KernelEntry(3, "torch_bwdg", spmm_bwd, "bwdg", "any", 1))
registry.register("mm", KernelEntry(4, "cuda_bandtm", spmm_bandtm, "bandtm", "any", 2))
registry.register("mm", KernelEntry(5, "cuda_bandmxu", spmm_bandmxu, "bandtm", "any", 1))
# the general-structure composite: its band leg on the band SpMM kernel
registry.register("mm", KernelEntry(6, "cuda_gen", spmm_gen, "gen", "any", 1))
registry.register("mm", KernelEntry(7, "cuda_diag", spmm_diag, "diag", "any", 1))


def debug_dispatcher(
    op: str, fmt: Optional[str] = None, kid: Optional[int] = None, device=None
) -> dict:
    """Which kernel would run? (aoclsparse_debug_dispatcher analog)."""
    e = registry.select(op, fmt=fmt, kid=kid, device=device)
    ctx = get_context()
    return {
        "op": op,
        "kid": e.kid,
        "name": e.name,
        "fmt": e.fmt,
        "backend": e.backend,
        "platform": _backend(device),
        "device_kind": ctx.device_kind,
    }
