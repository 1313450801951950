"""Placement of arrays on a process-group mesh (the JAX package's
parallel/placement.py).

The JAX package is single-controller: one process maps a call over a `Mesh`
of devices, and `put` places one host array over it with a PartitionSpec.
The port is multi-controller: one process a rank, each running the same
call on its own block. A `Mesh` here names the process group, its axis, the
world size, this process's rank and the device its blocks live on.

- `put(arr, mesh, spec)`: every rank holds the same host array, as every
  JAX process does, and keeps its part on `mesh.device`: the row block
  (`P(axis)`), the column block (`P(None, axis)`) or the whole array
  (`P()`, returned as a plain tensor). A sharded part comes back as a
  `Shard`: the rank's block, its global offset and the global shape.
- `fetch(arr)`: the full value as numpy on every rank; a `Shard`'s blocks
  are all-gathered.

The sharded size must split evenly over the ranks, as a NamedSharding's
must (`invalid_size` otherwise). Nothing here moves a block anywhere but
`mesh.device`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import AoclSparseError, Status

__all__ = ["Mesh", "P", "Shard", "fetch", "local", "mesh_is_multiprocess", "put"]


class P(tuple):
    """A partition spec, as jax.sharding.PartitionSpec: P("x") splits dim 0
    over axis "x", P(None, "x") dim 1, P() replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D mesh over a process group: one rank a process, each with its
    blocks on `device`. `group` None is the default (world) group. `stats`
    sums the seconds the collectives took on this rank, and of them the
    host staging of gloo transfers; `trace`, when a list, gets every
    collective's (kind, start, end) (utils/collectives.py)."""

    axis: str
    size: int
    rank: int
    device: torch.device
    backend: str
    group: object = None
    stats: dict = dataclasses.field(default_factory=dict)
    trace: Optional[list] = None

    @property
    def shape(self):
        """{axis: size}, the JAX Mesh's `mesh.shape[axis]`."""
        return {self.axis: self.size}

    def reset_stats(self) -> None:
        self.stats.clear()


@dataclasses.dataclass
class Shard:
    """This rank's block of a sharded array: `local` on the mesh's device,
    `offset` its first global index along `dim`, `shape` the global shape."""

    local: torch.Tensor
    offset: int
    shape: Tuple[int, ...]
    dim: int

    @property
    def dtype(self):
        return self.local.dtype


def mesh_is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans more than this process (every rank is one)."""
    return mesh.size > 1


def _spec_dim(mesh: Mesh, spec) -> Optional[int]:
    spec = tuple(spec) if spec is not None else ()
    if mesh.axis in spec:
        return spec.index(mesh.axis)
    return None


def _block(arr, dim: int, lo: int, hi: int):
    idx = [slice(None)] * arr.ndim
    idx[dim] = slice(lo, hi)
    return arr[tuple(idx)]


def _tensor(arr, device: torch.device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.to(device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def put(arr, mesh: Mesh, spec):
    """Place `arr` (host numpy, a tensor, or a Shard) on `mesh` by `spec`.
    A sharded spec returns a Shard of this rank's block on mesh.device; P()
    a tensor on mesh.device. A Shard already laid out by `spec` comes back
    as it is."""
    dim = _spec_dim(mesh, spec)
    if isinstance(arr, Shard):
        if arr.dim == dim:
            return arr
        arr = fetch(arr, mesh)
    if dim is None:
        return _tensor(arr, mesh.device)
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    size = int(arr.shape[dim])
    if size % mesh.size:
        raise AoclSparseError(
            Status.invalid_size, f"dim {dim} of size {size} does not split over {mesh.size} ranks"
        )
    blk = size // mesh.size
    lo = mesh.rank * blk
    return Shard(_tensor(_block(arr, dim, lo, lo + blk), mesh.device), lo, tuple(arr.shape), dim)


def local(arr, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of `arr` by `spec`, as a tensor on mesh.device."""
    out = put(arr, mesh, spec)
    return out.local if isinstance(out, Shard) else out


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def fetch(arr, mesh: Optional[Mesh] = None) -> np.ndarray:
    """The full numpy value of `arr` on every rank: a Shard's blocks
    all-gathered over `mesh` (the world group when None), anything else
    as it is."""
    if not isinstance(arr, Shard):
        if isinstance(arr, torch.Tensor):
            return _host(arr)
        return np.asarray(arr)
    from ..utils import collectives
    from .multiproc import global_mesh

    loc = arr.local.movedim(arr.dim, 0).contiguous()
    full = collectives.all_gather(loc, mesh or global_mesh(), record=False)
    return _host(full[: arr.shape[arr.dim]].movedim(0, arr.dim))
