"""The collectives of the distributed layer, and the collective ledger (the
JAX package's utils/collectives.py).

Every collective of the port passes through this module:

- `all_reduce` (JAX's psum): the sum over the ranks;
- `ppermute`: a ring shift, rank r sending to r + shift and receiving from
  r - shift (mod the size), by batch_isend_irecv; `async_op=True` returns a
  handle whose `wait()` gives the received tensor, so local work can run
  while the transfer is on the wire;
- `all_gather`: the ranks' blocks concatenated along dim 0;
- `all_to_all`: dim 0 split into one chunk a rank, chunk d sent to rank d.

The backend decides how a tensor travels, before any call: NCCL moves CUDA
tensors as they are; gloo moves host memory, so a CUDA tensor is staged
through a pinned host buffer and copied back (a CPU tensor goes as it is).
No call switches transport after a failure. A one-rank world still calls
the backend (a ppermute onto itself excepted). The mesh's `stats` sum each
kind's calls and seconds on this rank, and of them the staging copies.
Where `mesh.trace` is a list, every collective also appends (kind, start,
end) on time.monotonic, one clock for every process of a host, so the
ranks' traces line up call by call: how long the first rank to arrive
waited for the last, and how long the call took once all had arrived.
Off (None, the default) it costs one attribute test a call.

The ledger: the JAX package traces a solve into one program and walks its
jaxpr, where a loop body appears once. Here the loops are Python, and each
marks its iterations with `loop_body(k)`. `collective_ledger(fn, *args,
**kwargs)` runs fn and records the collectives of the first pass through
every loop body (k == 0 at every level, `in_loop` True) and those outside
loops: the list a trace gives, with the JAX schema (primitive, op,
per_shard_bytes, in_loop). `ledger_summary` aggregates it as there.

`predict_weak_scaling` prices a ledger on a link model whose bandwidth and
latency are parameters. The defaults are no measurement: the bandwidth is
the H100 SXM data sheet's NVLink rate, one way, and the latency an assumed
per-hop cost; pass measured ones where there are.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "all_gather",
    "all_reduce",
    "all_to_all",
    "collective_ledger",
    "ledger_summary",
    "loop_body",
    "ppermute",
    "predict_weak_scaling",
]

#: NVLink 4 of one H100 SXM: 900 GB/s both directions together (NVIDIA data
#: sheet), 450e9 B/s one way. Data sheet, not measured.
NVLINK_BW = 450e9
#: per-hop latency of a collective: an assumption, neither measured nor on
#: the data sheet; pass a measured one
NVLINK_LAT = 1.0e-5

_recorder: Optional[List[Dict[str, Any]]] = None
_loop_depth = 0
_later_pass = 0


@contextlib.contextmanager
def loop_body(k: int):
    """Mark one pass through a solver loop's body, iteration k (0-based)."""
    global _loop_depth, _later_pass
    later = int(k) > 0
    _loop_depth += 1
    _later_pass += later
    try:
        yield
    finally:
        _loop_depth -= 1
        _later_pass -= later


def _record(primitive: str, op: str, t: torch.Tensor) -> None:
    if _recorder is not None and not _later_pass:
        _recorder.append(
            {
                "primitive": primitive,
                "op": op,
                "per_shard_bytes": int(t.numel()) * t.element_size(),
                "in_loop": _loop_depth > 0,
            }
        )


def collective_ledger(fn, *args, **kwargs) -> List[Dict[str, Any]]:
    """Run fn(*args, **kwargs) on this rank and return the collectives it
    issued, as a trace lists them: [{primitive, op, per_shard_bytes,
    in_loop}]."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("collective_ledger does not nest")
    _recorder = []
    try:
        fn(*args, **kwargs)
        return _recorder
    finally:
        _recorder = None


def ledger_summary(ledger: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a ledger into {op: count} totals plus per-iteration rows."""
    summary: Dict[str, Any] = {
        "total_collectives": len(ledger),
        "per_iteration": {},
        "one_time": {},
        "per_iteration_bytes": 0,
    }
    for rec in ledger:
        bucket = "per_iteration" if rec["in_loop"] else "one_time"
        summary[bucket][rec["op"]] = summary[bucket].get(rec["op"], 0) + 1
        if rec["in_loop"]:
            summary["per_iteration_bytes"] += rec["per_shard_bytes"]
    return summary


def predict_weak_scaling(
    summary: Dict[str, Any],
    t_iter_s: float,
    per_iteration_bytes: int = None,
    n_devices=(2, 4, 8, 16, 64, 256),
    link_bw: float = NVLINK_BW,
    link_lat: float = NVLINK_LAT,
) -> Dict[str, Any]:
    """Predicted weak-scaling efficiency of a solver loop, t / (t + t_wire(N)),
    for a fixed per-rank iteration time t_iter_s and the ledger's
    per-iteration collectives: an all-reduce costs 2 log2(N) hops of
    link_lat, any other collective one hop, and the per-iteration bytes
    stream twice at link_bw."""
    bytes_iter = summary.get("per_iteration_bytes", 0) if per_iteration_bytes is None else per_iteration_bytes
    counts = summary.get("per_iteration", {})

    def latency(N):
        return sum(c * (2 * np.log2(N) if op == "all_reduce" else 1) * link_lat for op, c in counts.items())

    out = {}
    for N in n_devices:
        t_wire = latency(N) + 2.0 * bytes_iter / link_bw
        out[str(N)] = round(t_iter_s / (t_iter_s + t_wire), 4)
    dominant = "latency" if counts else "none"
    if bytes_iter / link_bw > latency(max(n_devices)):
        dominant = "bandwidth"
    return {
        "t_iter_compute_ms": round(t_iter_s * 1e3, 4),
        "per_iteration_bytes": int(bytes_iter),
        "efficiency": out,
        "binding_term": dominant,
        "model": f"link bw={link_bw:.1e} B/s, lat={link_lat:.0e} s/hop;"
        " all_reduce=2*log2(N) hops, permute=1 hop; weak scaling",
    }


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _add(mesh, key: str, t0: float) -> None:
    """Count a call of `key` that began at t0 (time.monotonic); a collective
    also goes to the mesh's trace where one is kept."""
    t1 = time.monotonic()
    mesh.stats[key] = mesh.stats.get(key, 0.0) + (t1 - t0)
    mesh.stats[key + "_n"] = mesh.stats.get(key + "_n", 0) + 1
    if mesh.trace is not None and key != "staging":
        mesh.trace.append((key, t0, t1))


def _staged(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _out(mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend moves: t itself, or its pinned host copy."""
    t = t.contiguous()
    if not _staged(mesh, t):
        return t
    t0 = time.monotonic()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    _add(mesh, "staging", t0)
    return h


def _back(mesh, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received host buffer back on `like`'s device."""
    if h.device == like.device:
        return h
    t0 = time.monotonic()
    out = h.to(like.device, non_blocking=True)
    _add(mesh, "staging", t0)
    return out


def _empty(mesh, shape, like: torch.Tensor) -> torch.Tensor:
    if _staged(mesh, like):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _peer(mesh, r: int) -> int:
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def all_reduce(t: torch.Tensor, mesh, async_op: bool = False):
    """The sum of t over the ranks (JAX psum), a new tensor on t's device.
    With async_op, a handle whose wait() returns it."""
    _record("psum", "all_reduce", t)
    t0 = time.monotonic()
    buf = _out(mesh, t) if _staged(mesh, t) else t.contiguous().clone()
    work = dist.all_reduce(buf, group=mesh.group, async_op=True)
    p = _Pending(mesh, [work], buf, t, t0, "all_reduce")
    return p if async_op else p.wait()


class _Pending:
    """A ppermute or all-reduce in flight: wait() returns its result."""

    def __init__(self, mesh, reqs, buf, like, t0, kind="ppermute"):
        self.mesh, self.reqs, self.buf, self.like, self.t0, self.kind = mesh, reqs, buf, like, t0, kind

    def wait(self) -> torch.Tensor:
        for r in self.reqs:
            r.wait()
        out = _back(self.mesh, self.buf, self.like)
        _add(self.mesh, self.kind, self.t0)
        return out


def ppermute(t: torch.Tensor, mesh, shift: int = 1, async_op: bool = False):
    """Rank r's t goes to rank r + shift; returns what rank r - shift sent
    (mod the size). With async_op, a handle whose wait() returns it."""
    _record("ppermute", "collective_permute", t)
    t0 = time.monotonic()
    if mesh.size == 1:  # the one rank's shift is itself: no transfer
        p = _Pending(mesh, [], t.clone(), t, t0)
    else:
        send = _out(mesh, t)
        recv = _empty(mesh, t.shape, t)
        dst = _peer(mesh, (mesh.rank + shift) % mesh.size)
        src = _peer(mesh, (mesh.rank - shift) % mesh.size)
        ops = [dist.P2POp(dist.isend, send, dst, mesh.group), dist.P2POp(dist.irecv, recv, src, mesh.group)]
        p = _Pending(mesh, dist.batch_isend_irecv(ops), recv, t, t0)
        p.send = send  # keep the send buffer alive until the wait
    return p if async_op else p.wait()


def _gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """The ranks' t into `out`: torch.distributed.all_gather_single where the
    installed torch has it (2.13 adds it and deprecates the other name),
    else all_gather_into_tensor, its name in earlier releases."""
    if hasattr(dist, "all_gather_single"):
        dist.all_gather_single(out, t, group=group)
    else:
        dist.all_gather_into_tensor(out, t, group=group)


def all_gather(t: torch.Tensor, mesh, record: bool = True) -> torch.Tensor:
    """The ranks' t (equal shapes) concatenated along dim 0, on t's device."""
    if record:
        _record("all_gather", "all_gather", t)
    t0 = time.monotonic()
    send = _out(mesh, t)
    full = _empty(mesh, (mesh.size * t.shape[0],) + tuple(t.shape[1:]), t)
    _gather_into(full, send, mesh.group)
    out = _back(mesh, full, t)
    _add(mesh, "all_gather", t0)
    return out


def all_to_all(t: torch.Tensor, mesh) -> torch.Tensor:
    """Dim 0 of t in `size` equal chunks, chunk d to rank d; returns the
    chunks received, in rank order, on t's device (JAX all_to_all, tiled)."""
    _record("all_to_all", "all_to_all", t)
    t0 = time.monotonic()
    send = _out(mesh, t)
    recv = _empty(mesh, t.shape, t)
    dist.all_to_all_single(recv, send, group=mesh.group)
    out = _back(mesh, recv, t)
    _add(mesh, "all_to_all", t0)
    return out
