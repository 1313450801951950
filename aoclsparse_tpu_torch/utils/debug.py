"""Numerical-debug modes: NaN/Inf trapping and deterministic reductions.

PyTorch counterpart of ``aoclsparse_tpu/utils/debug.py`` (the analog of
the reference's sanitizer builds, SURVEY.md §5.2). The JAX package turns on
``jax_debug_nans``, which re-runs a jitted program op by op and raises
``FloatingPointError`` at the producing primitive. torch has no such trap,
so here the entry points check their own output while the checks are on:
``mv``, ``mm``, ``trsv``, ``trsm``, the ``sp2m`` finalize, ``ilu_smoother``,
``symgs``, ``sorv`` and each iteration of the Krylov solvers
(``pcg_solve``, ``pgmres_solve``, ``itsol_solve``) raise
``FloatingPointError`` naming the op when their result holds a NaN or an
Inf. A check is one ``torch.isfinite(out).all()`` read (a device sync) a
call; with the checks off nothing extra runs.

The switch is process-wide, as ``jax_debug_nans`` is in the JAX package.

``deterministic_mode()`` sets ``torch.use_deterministic_algorithms(True)``
and ``CUBLAS_WORKSPACE_CONFIG`` for its body and restores both after. It
covers PyTorch's own operations (``index_add_``, ``scatter_add_`` and the
cuBLAS products take their deterministic paths, or raise where PyTorch has
none). It does not cover the port's hand kernels, and one of them sums in a
run-dependent order: the spill-route accumulate (``csrc/spill_route.cu``
`oh_accum`) adds each run of a row into its shared-memory tile with
``atomicAdd``, so a row that several runs of one chunk meet sums in the
order the warps arrive (on the planner's row-sorted chunks each row is one
run, and the result repeats bit for bit). The gen spill and the
whole-matrix ``route`` form ride it on the card. The other paths that
scatter-add (about 20 ``index_add_``/``scatter_add_`` call sites: the
spills of the band and gen forms, the gather forms' segment sums, the
SpGEMM expansion engine, the format-direct products, level 1) are torch
calls, which the mode makes deterministic.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["check_finite", "deterministic_mode", "enable_nan_checks", "nan_checks"]

#: the cuBLAS workspace setting that makes its reductions repeatable
#: (PyTorch's reproducibility notes)
CUBLAS_DETERMINISTIC = ":4096:8"


class _Switch:
    """The process-wide NaN/Inf trap flag."""

    on = False


_NAN = _Switch()


def enable_nan_checks(on: bool = True) -> None:
    """Global NaN/Inf trap: the entry points raise FloatingPointError when
    their output holds a NaN or an Inf."""
    _NAN.on = bool(on)


@contextlib.contextmanager
def nan_checks():
    """Scoped NaN/Inf trapping."""
    prev = _NAN.on
    _NAN.on = True
    try:
        yield
    finally:
        _NAN.on = prev


def check_finite(op: str, out):
    """`out` unchanged; with the checks on, FloatingPointError when a
    tensor in it (one, or a tuple's) holds a NaN or an Inf."""
    if _NAN.on:
        for t in out if isinstance(out, tuple) else (out,):
            if isinstance(t, torch.Tensor) and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"{op}: NaN or Inf in its result (nan_checks)")
    return out


@contextlib.contextmanager
def deterministic_mode():
    """Bitwise-reproducible PyTorch reductions for run-to-run comparisons
    (the hand kernels' exception is in the module docstring)."""
    prev_mode = torch.are_deterministic_algorithms_enabled()
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev_mode)
        if prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
