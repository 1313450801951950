"""Level-1 sparse-vector ops (reference: library/src/level1/*).

PyTorch counterpart of ``aoclsparse_tpu/ops/level1.py``: aoclsparse_?axpyi
(level1/aoclsparse_axpyi.cpp:44), ?doti / ?dotci / ?dotui
(aoclsparse_dot.cpp), ?gthr / ?gthrz / ?gthrs (aoclsparse_gthr.cpp), ?roti
(aoclsparse_roti.cpp), ?sctr / ?sctrs (aoclsparse_sctr.cpp).

A sparse vector is a (values, indices) pair against a dense partner, the
reference's compressed-index model. The reference updates the dense
operand in place; here, as in the JAX package, every op returns the updated
tensors and leaves its arguments alone. They are gathers and scatters in
plain torch (index_select, index_add_, index_copy_ semantics), the JAX
package's XLA formulations, each behind its table's KID-0 row. Tensors stay
on their device; array-likes go to `device` (default cuda:0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.context import resolve_device
from ..core.matrix import as_values
from ..core.types import AoclSparseError, Status
from ..core.validate import host_array
from ..kernels.registry import KernelEntry, registry

__all__ = [
    "axpyi",
    "doti",
    "dotci",
    "dotui",
    "gthr",
    "gthrz",
    "gthrs",
    "roti",
    "sctr",
    "sctrs",
]


def _device(args, device) -> torch.device:
    """The device of the first tensor argument, else `device`."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(device)


def _vec(v, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        if v.device != dev:
            raise AoclSparseError(Status.invalid_value, f"operands on {v.device} and {dev}")
        return v
    return as_values(v, dev)


def _index(indx, dev: torch.device) -> torch.Tensor:
    t = indx if isinstance(indx, torch.Tensor) else torch.as_tensor(host_array(indx))
    if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
        raise AoclSparseError(Status.wrong_type, f"index array has dtype {t.dtype}")
    return t.to(dev).long()


def _check_sparse_vec(x, indx, dev):
    if x is None or indx is None:
        raise AoclSparseError(Status.invalid_pointer, "null sparse vector argument")
    x, indx = _vec(x, dev), _index(indx, dev)
    if indx.dim() != 1 or x.dim() != 1 or x.shape[0] != indx.shape[0]:
        raise AoclSparseError(Status.invalid_size, "sparse vector val/ind mismatch")
    return x, indx


def _check_bounds(indx: torch.Tensor, n: int):
    """Indices must fall inside the dense operand: the tensors carry their
    length, so an out-of-range index is invalid_index_value here, where
    the reference's raw pointers cannot tell."""
    if indx.shape[0] and (int(indx.min()) < 0 or int(indx.max()) >= n):
        raise AoclSparseError(Status.invalid_index_value, "index out of range of dense operand")


def _check_kid(op: str, kid: Optional[int]):
    """`_kid` variant parity (aoclsparse_?axpyi_kid etc.): an explicit KID
    must name a row of the op's table, else invalid_kid
    (cntx_dispatcher.hpp:272-364). Each table has the one KID-0 row."""
    if kid is not None and not any(e.kid == kid for e in registry.table(op)):
        raise AoclSparseError(Status.invalid_kid, f"kid {kid} not in table for '{op}'")


def _scalar(a, dtype, dev) -> torch.Tensor:
    """A scalar (Python, numpy or tensor) as a 0-d tensor of `dtype`."""
    return torch.as_tensor(np.asarray(host_array(a))).to(device=dev, dtype=dtype)


def _axpyi(a, x, indx, y):
    return y.clone().index_add_(0, indx, (a * x).to(y.dtype))


def axpyi(a, x, indx, y, kid: Optional[int] = None, device=None) -> torch.Tensor:
    """y[indx[i]] += a * x[i] (aoclsparse_?axpyi/_kid): returns the new y."""
    _check_kid("axpyi", kid)
    dev = _device((x, y), device)
    x, indx = _check_sparse_vec(x, indx, dev)
    if y is None:
        raise AoclSparseError(Status.invalid_pointer, "null y")
    y = _vec(y, dev)
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return y.clone()
    return _axpyi(_scalar(a, torch.promote_types(y.dtype, x.dtype), dev), x, indx, y)


def _dot(x, indx, y):
    return torch.sum(x * y[indx])


def _dot_common(op: str, x, indx, y, kid, device, complex_only: bool, conj: bool):
    _check_kid(op, kid)
    dev = _device((x, y), device)
    x, indx = _check_sparse_vec(x, indx, dev)
    y = _vec(y, dev)
    if complex_only and not x.is_complex():
        raise AoclSparseError(Status.wrong_type, f"{op} requires complex dtype")
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return torch.zeros((), dtype=torch.promote_types(x.dtype, y.dtype), device=dev)
    return _dot(torch.conj_physical(x) if conj else x, indx, y)


def doti(x, indx, y, kid: Optional[int] = None, device=None) -> torch.Tensor:
    """sum x[i] * y[indx[i]] (aoclsparse_?doti/_kid), a 0-d tensor."""
    return _dot_common("doti", x, indx, y, kid, device, complex_only=False, conj=False)


def dotci(x, indx, y, kid: Optional[int] = None, device=None) -> torch.Tensor:
    """sum conj(x[i]) * y[indx[i]] (aoclsparse_?dotci/_kid), complex only."""
    return _dot_common("dotci", x, indx, y, kid, device, complex_only=True, conj=True)


def dotui(x, indx, y, kid: Optional[int] = None, device=None) -> torch.Tensor:
    """sum x[i] * y[indx[i]], unconjugated (aoclsparse_?dotui/_kid), complex
    only."""
    return _dot_common("dotui", x, indx, y, kid, device, complex_only=True, conj=False)


def _gthr(y, indx):
    return y.index_select(0, indx)


def _gather_args(op, y, indx, kid, device):
    _check_kid(op, kid)
    if y is None or indx is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    dev = _device((y, indx), device)
    y, indx = _vec(y, dev), _index(indx, dev)
    _check_bounds(indx, y.shape[0])
    return y, indx


def gthr(y, indx, kid: Optional[int] = None, device=None) -> torch.Tensor:
    """x[i] = y[indx[i]] (aoclsparse_?gthr/_kid)."""
    return _gthr(*_gather_args("gthr", y, indx, kid, device))


def _gthrz(y, indx):
    return y.index_select(0, indx), y.clone().index_fill_(0, indx, 0)


def gthrz(y, indx, kid: Optional[int] = None, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather, then zero the gathered entries: (x, y') (aoclsparse_?gthrz/_kid)."""
    return _gthrz(*_gather_args("gthrz", y, indx, kid, device))


def gthrs(y, stride: int, nnz: Optional[int] = None, kid: Optional[int] = None, device=None) -> torch.Tensor:
    """Strided gather x[i] = y[i * stride] (aoclsparse_?gthrs/_kid), nnz
    entries (default: as many as y holds)."""
    _check_kid("gthrs", kid)
    if y is None:
        raise AoclSparseError(Status.invalid_pointer, "null y")
    y = _vec(y, _device((y,), device))
    if stride <= 0:
        raise AoclSparseError(Status.invalid_size, "stride must be positive")
    n = nnz if nnz is not None else y.shape[0] // stride
    if n < 0 or n * stride > y.shape[0]:
        raise AoclSparseError(Status.invalid_size, "stride*nnz exceeds y size")
    return y[: n * stride : stride].clone()


def _roti(x, indx, y, c, s):
    yg = y[indx]
    y_new = y.clone()
    y_new[indx] = (c * yg - s * x).to(y.dtype)
    return (c * x + s * yg).to(x.dtype), y_new


def roti(x, indx, y, c, s, kid: Optional[int] = None, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Givens rotation of sparse x against dense y (aoclsparse_?roti), real
    only: x[i] <- c x[i] + s y[indx[i]], y[indx[i]] <- c y[indx[i]] - s x[i];
    returns (x', y')."""
    _check_kid("roti", kid)
    dev = _device((x, y), device)
    x, indx = _check_sparse_vec(x, indx, dev)
    y = _vec(y, dev)
    if x.is_complex():
        raise AoclSparseError(Status.wrong_type, "roti is real-only (s/d) like the reference")
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return x.clone(), y.clone()
    dt = torch.promote_types(x.dtype, y.dtype)
    return _roti(x, indx, y, _scalar(c, dt, dev), _scalar(s, dt, dev))


def _sctr(x, indx, y):
    out = y.clone()
    out[indx] = x.to(y.dtype)
    return out


def sctr(x, indx, y, kid: Optional[int] = None, device=None) -> torch.Tensor:
    """y[indx[i]] = x[i] (aoclsparse_?sctr/_kid): returns the new y."""
    _check_kid("sctr", kid)
    dev = _device((x, y), device)
    x, indx = _check_sparse_vec(x, indx, dev)
    if y is None:
        raise AoclSparseError(Status.invalid_pointer, "null y")
    y = _vec(y, dev)
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return y.clone()
    return _sctr(x, indx, y)


def sctrs(x, stride: int, y, kid: Optional[int] = None, device=None) -> torch.Tensor:
    """Strided scatter y[i * stride] = x[i] (aoclsparse_?sctrs/_kid)."""
    _check_kid("sctrs", kid)
    if x is None or y is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    dev = _device((x, y), device)
    x, y = _vec(x, dev), _vec(y, dev)
    if stride <= 0:
        raise AoclSparseError(Status.invalid_size, "stride must be positive")
    if x.shape[0] * stride > y.shape[0]:
        raise AoclSparseError(Status.invalid_size, "stride*nnz exceeds y size")
    out = y.clone()
    out[: x.shape[0] * stride : stride] = x.to(y.dtype)
    return out


# the one KID-0 row of each level-1 table (ops/level1.py:236-248 of the JAX package)
for _op, _fn in [
    ("axpyi", _axpyi),
    ("doti", _dot),
    ("dotci", _dot),
    ("dotui", _dot),
    ("gthr", _gthr),
    ("gthrz", _gthrz),
    ("gthrs", _gthr),
    ("roti", _roti),
    ("sctr", _sctr),
    ("sctrs", _sctr),
]:
    registry.register(_op, KernelEntry(0, f"torch_{_op}", _fn, "dense", "any", 0))
