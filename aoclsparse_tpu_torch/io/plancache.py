"""Planner-state persistence: save and load a matrix's optimized plan.

PyTorch counterpart of ``aoclsparse_tpu/io/plancache.py``. A serving
restart should not re-plan: the planner's products (RCM permutations,
band and window layouts, hub slabs, scatter maps, tuned pins) are pure
functions of the matrix structure, and the gen analysis of a large
general matrix takes seconds. `save_plan` snapshots a handle's plan (its
execution forms and the `autotune_*` pins) into one .npz; `load_plan`
restores it onto a handle of the same structure.

What is stored: each execution form's fields, by kind: a tensor (restored
onto the handle's device, in its dtype; bf16 travels as its 16-bit
pattern), a numpy array, or a static (int, float, bool, str, int tuple).
What is not: the values-derived caches, which rebuild on first use (the
bf16 band copy, the `_derive` entries, among them mm KID 6's row-aligned
band `bandt_rows`, the gen form's spill route and permutation maps), and
the forms whose content cannot be stored as arrays: the whole-matrix
``route`` form (its Benes plan is an object) rebuilds at its first use
from the structure, as the triangular solve forms do, which the JAX
package does not store either (their values are op-folded orderings);
nothing raises for them.

A ``segsum`` form's row pointers and CSR-kernel plan are stored with it;
a snapshot written before the form carried them rebuilds them on load from
the structure.

Values are never taken from the snapshot: every restored form is refreshed
from the live handle's values through its scatter maps, so a handle whose
values changed since the save computes correctly. A form held in two
slots (the gen form the mv default and mm KID 6 share) is stored once and
restored as one.

Format: npz with arrays named "<slot>::<field>" plus a JSON manifest
(keys, statics, array kinds and dtypes, the pins, the structure signature)
under "__manifest__", version `_FORMAT_VERSION`, the layout of the JAX
package's. The two packages' form layouts differ (the port's forms hold
tensors and other fields), so a snapshot written by one package is not
read by the other: the manifest names its package, and `load_plan`
refuses another's with ``invalid_value``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import numpy as np
import torch

from ..core.descr import MatrixDescriptor
from ..core.types import AoclSparseError, DiagType, FillMode, MatrixType, Operation, Status

__all__ = ["save_plan", "load_plan"]

_FORMAT_VERSION = 1
_PACKAGE = "aoclsparse_tpu_torch"
#: ExecForm fields that are caches of values, rebuilt on first use
_DERIVED = ("host_val",)
#: forms whose content lives in an object that is not an array
_UNSTORED_KINDS = ("route",)


def _struct_sig(plan) -> Dict:
    c = plan.clean
    return {
        "m": int(c.m),
        "n": int(c.n),
        "nnz": int(c.ind.size),
        "ptr_sum": int(np.asarray(c.ptr).astype(np.int64).sum()),
        "ind_sum": int(np.asarray(c.ind).astype(np.int64).sum()),
    }


def _pack_form(form, slot: str, arrays: Dict, entry: Dict) -> None:
    """Split an ExecForm into arrays (npz) and JSON-able statics."""
    statics, kinds = {}, {}
    for f in dataclasses.fields(form):
        v = getattr(form, f.name)
        if v is None or f.name.startswith("_") or f.name in _DERIVED:
            continue
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            kinds[f.name] = ["torch", str(t.dtype).replace("torch.", "")]
            arrays[f"{slot}::{f.name}"] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        elif isinstance(v, np.ndarray):
            kinds[f.name] = ["np", None]
            arrays[f"{slot}::{f.name}"] = v
        elif isinstance(v, (bool, int, float, str)):
            statics[f.name] = v
        elif isinstance(v, tuple):
            statics[f.name] = {"__tuple__": [int(x) for x in v]}
        else:
            raise AoclSparseError(Status.internal_error, f"unserializable field {f.name}: {type(v)}")
    entry["statics"] = statics
    entry["kinds"] = kinds


#: fields that snapshots of earlier versions of the port hold and the form
#: no longer has: the CSR kernel's first schedule (its sub-warp width and
#: long-row list); load_plan rebuilds the block schedule from ptr
#: (attach_csr_plan)
_RETIRED = ("csr_lanes", "csr_long")


def _unpack_form(slot: str, npz, entry: Dict, device: torch.device):
    from ..planner.plan import ExecForm

    kw = {}
    for name, val in entry["statics"].items():
        if name not in _RETIRED:
            kw[name] = tuple(val["__tuple__"]) if isinstance(val, dict) else val
    for name, (kind, dtype) in entry["kinds"].items():
        if name in _RETIRED:
            continue
        arr = npz[f"{slot}::{name}"]
        if kind == "torch":
            t = torch.from_numpy(arr)
            kw[name] = (t.view(torch.bfloat16) if dtype == "bfloat16" else t).to(device)
        else:
            kw[name] = arr
    return ExecForm(**kw)


def _npz_path(path) -> str:
    # np.savez appends .npz: keep save and load symmetric
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _pins(d: Dict) -> list:
    return [[[int(k) for k in key], v if isinstance(v, str) else int(v)] for key, v in d.items()]


def save_plan(A, path) -> None:
    """Snapshot A's plan: execution forms and autotune pins. Effective CSRs,
    triangular forms and value caches rebuild and are not stored."""
    from ..planner.plan import get_plan

    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    plan = get_plan(A)
    arrays: Dict[str, np.ndarray] = {}
    manifest = {
        "version": _FORMAT_VERSION,
        "package": _PACKAGE,
        "sig": _struct_sig(plan),
        "exec_forms": [],
        "trsv_tuned": _pins(plan._trsv_tuned),
        "trsv_engine": _pins(plan._trsv_engine),
        "mv_engine": _pins(plan._mv_engine),
        "mm_tuned": _pins(plan._mm_tuned),
    }
    sp = getattr(A, "_spgemm_plan", None)
    if sp is not None:  # a staged product's autotune_spgemm pins
        manifest["spgemm"] = {"host_engine": bool(sp._host_engine), "extract_route": sp._extract_route}
    stored: Dict[int, int] = {}  # id(form) -> its entry: a form in two slots is stored once
    for i, (key, form) in enumerate(plan.exec_forms.items()):
        if form.kind in _UNSTORED_KINDS:
            continue
        entry = {"key": [int(k) for k in key[:4]] + [key[4]]}
        if id(form) in stored:
            entry["same_as"] = stored[id(form)]
        else:
            stored[id(form)] = len(manifest["exec_forms"])
            _pack_form(form, f"ef{i}", arrays, entry)
        manifest["exec_forms"].append(entry)
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez_compressed(_npz_path(path), **arrays)


def load_plan(A, path) -> int:
    """Rebuild A's plan from a snapshot of the SAME matrix structure
    (validated by a size and index signature; a mismatch, another version
    or another package's snapshot -> invalid_value). Every restored form is
    refreshed from A's live values, its tensors on A's device. Returns the
    number of forms restored."""
    from ..planner.plan import attach_csr_plan, get_plan

    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    with np.load(_npz_path(path), allow_pickle=False) as npz:
        manifest = json.loads(bytes(npz["__manifest__"]).decode())
        if manifest.get("version") != _FORMAT_VERSION or manifest.get("package") != _PACKAGE:
            raise AoclSparseError(
                Status.invalid_value,
                f"plan snapshot version {manifest.get('version')} of {manifest.get('package', 'aoclsparse_tpu')}, "
                f"want version {_FORMAT_VERSION} of {_PACKAGE}",
            )
        plan = get_plan(A)
        if _struct_sig(plan) != manifest["sig"]:
            raise AoclSparseError(Status.invalid_value, "plan snapshot belongs to a different matrix structure")
        forms = []
        for i, entry in enumerate(manifest["exec_forms"]):
            t, fill, diag, op, kind = entry["key"]
            key = (MatrixType(t), FillMode(fill), DiagType(diag), Operation(op), kind)
            if "same_as" in entry:
                form = forms[entry["same_as"]]
            else:
                form = _unpack_form(f"ef{i}", npz, entry, A.device)
                # values come from the LIVE handle, not the snapshot
                eff = plan.effective_for(MatrixDescriptor(type=key[0], fill_mode=key[1], diag_type=key[2]), key[3], A.dtype)
                form.refresh(eff.val)
                if form.kind == "segsum":
                    # row pointers and the CSR kernel's schedule rebuilt
                    # where a snapshot lacks them (written before segsum
                    # forms carried them, or with the earlier schedule);
                    # row ids kept only where the plain gather runs the
                    # form on this device
                    attach_csr_plan(form, eff.ptr)
            forms.append(form)
            plan.exec_forms[key] = form
    for name, enums in (("trsv_tuned", (FillMode, DiagType, Operation)),
                        ("trsv_engine", (FillMode, DiagType, Operation)),
                        ("mv_engine", (MatrixType, FillMode, DiagType, Operation)),
                        ("mm_tuned", (MatrixType, FillMode, DiagType, Operation, int))):
        getattr(plan, "_" + name).update(
            {tuple(e(k) for e, k in zip(enums, key)): v for key, v in manifest.get(name, [])}
        )
    sp = getattr(A, "_spgemm_plan", None)
    if sp is not None and "spgemm" in manifest:
        sp._host_engine = manifest["spgemm"]["host_engine"]
        sp._extract_route = manifest["spgemm"]["extract_route"]
    return len(manifest["exec_forms"])
