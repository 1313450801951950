"""Typed options registry for the iterative-solver layer.

PyTorch counterpart of ``aoclsparse_tpu/solvers/options.py``. Reference:
OptionRegistry (library/src/include/aoclsparse_itsol_options.hpp:100-800)
with Int/Real/Bool/String options carrying bounds and lock-on-use, and the
registered set (solvers/aoclsparse_itsol_list_options.hpp:94-240):

  "iterative method"          {CG, PCG, GMRES, "GM RES"}    default CG
  "cg iteration limit"        int >= 1                      default 500
  "cg rel tolerance"          real >= 0                     default eps^.5-scale(2)
  "cg abs tolerance"          real >= 0                     default eps^.5-scale(1)
  "cg preconditioner"         {None, User, GS, SymGS, SGS}  default None
  "gmres iteration limit"     int >= 1                      default 150
  "gmres rel tolerance"       real >= 0                     default eps^.5-scale(2)
  "gmres abs tolerance"       real >= 0                     default eps^.5-scale(1)
  "gmres preconditioner"      {None, User, ILU0}            default None
  "gmres restart iterations"  int >= 1                      default 20

The tolerances' defaults are utils/tolerances.py's `expected_precision` of
the handle's dtype (a torch or a numpy dtype), so the option table prints
the same text as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..core.types import AoclSparseError, Status, to_torch_dtype
from ..utils.tolerances import expected_precision

__all__ = ["Option", "OptionRegistry", "default_registry"]


@dataclasses.dataclass
class Option:
    name: str
    kind: str  # "int" | "real" | "bool" | "string"
    default: Any
    desc: str = ""
    lower: Optional[float] = None  # numeric bound (inclusive)
    choices: Optional[Dict[str, Any]] = None  # normalized-string -> id
    value: Any = None
    locked: bool = False

    def __post_init__(self):
        if self.value is None:
            self.value = self.default


def _norm(s: str) -> str:
    return " ".join(str(s).lower().split())


class OptionRegistry:
    """String-keyed option store with validation + lock-on-use semantics."""

    def __init__(self):
        self._opts: Dict[str, Option] = {}

    def register(self, opt: Option) -> None:
        key = _norm(opt.name)
        if key in self._opts:
            raise AoclSparseError(Status.invalid_value, f"duplicate option '{opt.name}'")
        self._opts[key] = opt

    def _find(self, name: str) -> Option:
        opt = self._opts.get(_norm(name))
        if opt is None:
            raise AoclSparseError(Status.invalid_value, f"unknown option '{name}'")
        return opt

    def set(self, name: str, value) -> None:
        opt = self._find(name)
        if opt.locked:
            raise AoclSparseError(Status.invalid_operation, f"option '{name}' is locked")
        if opt.kind in ("int", "real"):
            v = int(value) if opt.kind == "int" else float(value)
            if opt.lower is not None and v < opt.lower:
                raise AoclSparseError(Status.invalid_value, f"{name}: {v} < {opt.lower}")
            opt.value = v
        elif opt.kind == "bool":
            opt.value = bool(value)
        else:  # string
            v = _norm(value)
            if opt.choices is not None and v not in opt.choices:
                raise AoclSparseError(
                    Status.invalid_value,
                    f"{name}: '{value}' not in {sorted(opt.choices)}",
                )
            opt.value = v

    def get(self, name: str, lock: bool = False):
        opt = self._find(name)
        if lock:
            opt.locked = True
        if opt.kind == "string" and opt.choices is not None:
            return opt.choices[_norm(opt.value)]
        return opt.value

    def get_string(self, name: str) -> str:
        return str(self._find(name).value)

    def unlock_all(self) -> None:
        for o in self._opts.values():
            o.locked = False

    def print_options(self) -> str:
        """aoclsparse_itsol_handle_prn_options analog."""
        lines = []
        for key in sorted(self._opts):
            o = self._opts[key]
            lines.append(f"{o.name} = {o.value}  (default {o.default}) : {o.desc}")
        return "\n".join(lines)


SOLVER_CG = 1
SOLVER_GMRES = 2

PRECOND_NONE = 0
PRECOND_USER = 1
PRECOND_ILU0 = 2
PRECOND_SGS = 3


def default_registry(dtype) -> OptionRegistry:
    r = OptionRegistry()
    dt = to_torch_dtype(dtype)
    rel = expected_precision(dt, 2.0)
    ab = expected_precision(dt, 1.0)
    r.register(
        Option(
            "iterative method",
            "string",
            "cg",
            "Choose solver to use",
            choices={"cg": SOLVER_CG, "pcg": SOLVER_CG, "gmres": SOLVER_GMRES, "gm res": SOLVER_GMRES},
        )
    )
    r.register(Option("cg iteration limit", "int", 500, "Set CG iteration limit", lower=1))
    r.register(Option("cg rel tolerance", "real", rel, "Relative tolerance for cg", lower=0.0))
    r.register(Option("cg abs tolerance", "real", ab, "Absolute tolerance for cg", lower=0.0))
    r.register(
        Option(
            "cg preconditioner",
            "string",
            "none",
            "Choose preconditioner to use with cg method",
            choices={
                "none": PRECOND_NONE,
                "user": PRECOND_USER,
                "gs": PRECOND_SGS,
                "symgs": PRECOND_SGS,
                "sgs": PRECOND_SGS,
            },
        )
    )
    r.register(Option("gmres iteration limit", "int", 150, "Set GMRES iteration limit", lower=1))
    r.register(Option("gmres rel tolerance", "real", rel, "Relative tolerance", lower=0.0))
    r.register(Option("gmres abs tolerance", "real", ab, "Absolute tolerance", lower=0.0))
    r.register(
        Option(
            "gmres preconditioner",
            "string",
            "none",
            "Choose preconditioner to use with gmres method",
            choices={"none": PRECOND_NONE, "user": PRECOND_USER, "ilu0": PRECOND_ILU0},
        )
    )
    r.register(
        Option("gmres restart iterations", "int", 20, "Set GMRES restart iterations", lower=1)
    )
    return r
