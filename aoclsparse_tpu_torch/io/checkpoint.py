"""Checkpoint and resume for matrix handles and their ILU0 factorization.

PyTorch counterpart of ``aoclsparse_tpu/io/checkpoint.py``. The reference
has no file checkpointing (SURVEY.md §5.4; its analogs are the staged
SpGEMM, the one-time ILU flag and the caller-owned RCI state). For long
solves the JAX package adds save and load of a handle's CSR data and its
ILU0 factor values to one .npz, so an interrupted solve resumes without
re-factorizing; the port keeps that file, key for key (``format_version``,
``m``, ``n``, ``ptr``, ``ind``, ``val``, ``base``, ``ilu_lu``; the clean,
sorted CSR, so the factor re-aligns on load), so a checkpoint written by
either package loads in the other. The port adds one key the JAX package
does not read, ``dtype`` (a bf16 handle's values travel widened to f32,
numpy having no bfloat16).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..core.matrix import SparseMatrix, create_csr
from ..core.types import AoclSparseError, IndexBase, Status

__all__ = ["save_matrix", "load_matrix"]

_FORMAT_VERSION = 1


def save_matrix(path, h: SparseMatrix) -> None:
    """Serialize a handle (its clean CSR and cached ILU0 values) to .npz."""
    from ..planner.plan import get_plan, host_values

    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix")
    clean = get_plan(h).clean
    payload = {
        "format_version": np.int64(_FORMAT_VERSION),
        "m": np.int64(clean.m),
        "n": np.int64(clean.n),
        "ptr": np.asarray(clean.ptr),
        "ind": np.asarray(clean.ind),
        "val": clean.host_val(),
        "base": np.int64(int(h.base)),
        "dtype": np.str_(str(h.dtype).replace("torch.", "")),
    }
    if h.ilu_state is not None:
        payload["ilu_lu"] = host_values(h.ilu_state.lu)
    np.savez_compressed(Path(path), **payload)


def load_matrix(path, device=None) -> SparseMatrix:
    """Restore a handle on `device` (cuda:0 unless named), and its ILU0
    factor when the file holds one, with the factor's solve forms built as
    `ilu0_factorize` builds them (planner/triangular.py
    `build_trsv_form_native`, else `build_trsv_form`)."""
    from ..planner.plan import get_plan
    from ..solvers.ilu import ilu_state_from

    with np.load(Path(path)) as z:
        if int(z["format_version"]) != _FORMAT_VERSION:
            raise AoclSparseError(
                Status.invalid_value, f"unknown checkpoint version {int(z['format_version'])}"
            )
        files = dict(z)
    m, n = int(files["m"]), int(files["n"])
    dtype = getattr(torch, str(files["dtype"])) if "dtype" in files else None
    val = torch.from_numpy(np.ascontiguousarray(files["val"]))
    # the stored CSR is the clean, zero-based one; the handle keeps its base
    h = create_csr(m, n, files["ptr"], files["ind"], val if dtype is None else val.to(dtype), device=device)
    h.base = IndexBase(int(files["base"]))
    if "ilu_lu" in files:
        h.ilu_state = ilu_state_from(get_plan(h).clean, np.asarray(files["ilu_lu"]), h.dtype)
    return h
