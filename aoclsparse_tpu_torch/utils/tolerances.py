"""Tolerance model, the same as ``aoclsparse_tpu/utils/tolerances.py``.

Reference: expected_precision = scale * safeguard * sqrt(2*eps)
(library/src/extra/aoclsparse_utils.hpp:493-498; safeguard 1.0 for double,
2.0 for float, 4.0 for the 16-bit types), and the bench-side near_check
with scale 10 and up to 4x relaxation (tests/include/aoclsparse_check.hpp:
36-122). Arguments are numpy arrays or CPU tensors.
"""

from __future__ import annotations

import numpy as np

__all__ = ["expected_precision", "near_error"]

_EPS = {"float64": 2.0**-52, "float32": 2.0**-23, "bfloat16": 2.0**-7, "float16": 2.0**-10}
_SAFEGUARD = {"float64": 1.0, "float32": 2.0}


def _name(dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return {"complex128": "float64", "complex64": "float32"}.get(name, name)


def expected_precision(dtype, scale: float = 1.0) -> float:
    """scale * safeguard * sqrt(2 * eps) for the (real part of the) dtype."""
    name = _name(dtype)
    return scale * _SAFEGUARD.get(name, 4.0) * float(np.sqrt(2.0 * _EPS[name]))


def near_error(actual, expected) -> float:
    """max_i |actual_i - expected_i| / max(|expected_i|, 1): the error the
    reference's checks hold against a tolerance (absolute or relative per
    element)."""
    a = np.asarray(actual, dtype=np.complex128 if np.iscomplexobj(actual) else np.float64)
    e = np.asarray(expected, dtype=a.dtype)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - e) / np.maximum(np.abs(e), 1.0)))
