"""Multi-process (multi-controller) execution on torch.distributed (the JAX
package's parallel/multiproc.py).

Every process runs the same program on its own rank:

    from aoclsparse_tpu_torch.parallel import multiproc as mp
    mp.init_multiprocess("host0:29500", num_processes=4, process_id=rank, backend="nccl")
    mesh = mp.global_mesh()                        # the world, one card a rank
    y = dist_spmv_bwd_halo(mesh, form, mp.put(x, mesh, P("x")))
    y_host = mp.fetch(y, mesh)                     # numpy on every rank

The caller names the backend; nothing guesses it:

- ``"nccl"``: one card a rank. The rank's card is ``device`` when given,
  else ``cuda:<process_id mod the cards on the host>``, and becomes the
  current device (torch.cuda.set_device).
- ``"gloo"``: CPU shards (``device="cpu"``), or CUDA shards on a card the
  ranks may share; gloo moves host memory, so utils/collectives.py stages
  every CUDA transfer through a pinned host buffer. With no ``device`` the
  rank's blocks go to cuda:0, the port's default device.

``coordinator_address`` is ``"host:port"`` (a TCP rendezvous), a URL
(``"tcp://..."``, ``"file://..."``), or None for the ``env://``
rendezvous (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from ..core.context import resolve_device
from ..core.types import AoclSparseError, Status
from .placement import Mesh, fetch, mesh_is_multiprocess, put

__all__ = [
    "init_multiprocess",
    "global_mesh",
    "put",
    "fetch",
    "mesh_is_multiprocess",
    "process_count",
    "process_index",
    "shutdown",
]

BACKENDS = ("nccl", "gloo")

#: the backend and device init_multiprocess chose for this process
_world = {}


def init_multiprocess(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 600.0,
) -> None:
    """Join this process to the run as rank `process_id` of
    `num_processes`. `backend` is "nccl" or "gloo" (module docstring);
    collectives that wait longer than `timeout_s` raise."""
    if backend not in BACKENDS:
        raise AoclSparseError(Status.invalid_value, f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise AoclSparseError(Status.invalid_value, "the nccl backend needs a CUDA card a rank")
        dev = torch.device(device) if device is not None else torch.device(
            "cuda", (process_id or 0) % torch.cuda.device_count()
        )
        if dev.type != "cuda":
            raise AoclSparseError(Status.invalid_value, f"the nccl backend moves CUDA tensors, not {dev}")
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _world.update(backend=backend, device=dev)


def global_mesh(axis: str = "x", n_devices: Optional[int] = None) -> Mesh:
    """The 1-D mesh over every rank of the run, rank r holding shard r."""
    if not dist.is_initialized() or "backend" not in _world:
        raise AoclSparseError(Status.invalid_operation, "no distributed run: call init_multiprocess first")
    size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != size:
        raise AoclSparseError(
            Status.invalid_value, f"n_devices={n_devices}: the run has {size} ranks, one device each"
        )
    return Mesh(axis, size, dist.get_rank(), _world["device"], _world["backend"])


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the run: destroy the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _world.clear()
