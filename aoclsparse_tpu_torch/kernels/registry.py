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

The mv table keeps the JAX package's KID numbers for the forms ported so
far: 0 (segsum), 1 (ell) and 2 (ellhyb), the gather forms in plain torch;
7, the general-structure composite (kernels/spmv_gen.py), whose band runs
the band kernel and whose spill the spill-route kernels; 8, 12 and 13 for
the ``bandt`` form, all three the one band kernel (kernels/band_spmv.py),
12 the default, streaming a bf16 band under the mixed precision policy, 13
the f64 instance (the JAX package's double-float KID); and 14, the
whole-matrix route (planner/spill_route.py), which a KID cannot pin (mv
raises invalid_kid for it, as the JAX package does).

The sv table keeps KID 0, the blocked window solve (kernels/trsv_win.py),
which serves trsv and trsm alike (the JAX package has no separate sm
table). The JAX package's KIDs 1 (level wavefront) and 2 (host
substitution) are not ported yet; ops/level2/trsv.py answers them with
not_implemented.

The mm table keeps the JAX package's KIDs 0-5 and 7 (ops/level3/csrmm.py:
38-57): the plain gather and group forms 0-3, and the hand-written kernels
of the bandtm form (4, the default there; 5, the block-window twin) and of
the diag form (7). KID 6 (the general-sparsity composite) is not ported
yet; ops/level3/csrmm.py answers it with not_implemented.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.context import get_context
from ..core.types import AoclSparseError, Status
from .band_spmv import spmv_bandt
from .plain_spmv import spmv_ell, spmv_ellhyb, spmv_segsum
from .spmm_band import spmm_bandmxu, spmm_bandtm
from .spmm_diag import spmm_diag
from .spmm_plain import spmm_bwd, spmm_ell, spmm_ellhyb, spmm_segsum
from .spmv_gen import spmv_gen, spmv_route
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
registry.register("mv", KernelEntry(0, "torch_segsum", spmv_segsum, "segsum", "any", 0))
registry.register("mv", KernelEntry(1, "torch_ell", spmv_ell, "ell", "any", 0))
registry.register("mv", KernelEntry(2, "torch_ellhyb", spmv_ellhyb, "ellhyb", "any", 0))
registry.register("mv", KernelEntry(7, "gen_composite", spmv_gen, "gen", "any", 1))
registry.register("mv", KernelEntry(8, "cuda_bandt", spmv_bandt, "bandt", "any", 2))
registry.register("mv", KernelEntry(12, "cuda_bandv", spmv_bandt, "bandt", "any", 3))
# f64 instance: explicit KID, or the bandt dispatch of a float64 operand
# (ops/level2/mv.py), as the JAX package routes its double-float kernel
registry.register("mv", KernelEntry(13, "cuda_band_f64", spmv_bandt, "bandt", "any", -1))
registry.register("mv", KernelEntry(14, "cuda_spill_route", spmv_route, "route", "any", 1))
registry.register("sv", KernelEntry(0, "cuda_trsv_win", trsv_win, "blocked", "any", 0))
registry.register("mm", KernelEntry(0, "torch_segsum", spmm_segsum, "segsum", "any", 0))
registry.register("mm", KernelEntry(1, "torch_ell", spmm_ell, "ell", "any", 0))
registry.register("mm", KernelEntry(2, "torch_ellhyb", spmm_ellhyb, "ellhyb", "any", 0))
registry.register("mm", KernelEntry(3, "torch_bwdg", spmm_bwd, "bwdg", "any", 1))
registry.register("mm", KernelEntry(4, "cuda_bandtm", spmm_bandtm, "bandtm", "any", 2))
registry.register("mm", KernelEntry(5, "cuda_bandmxu", spmm_bandmxu, "bandtm", "any", 1))
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
