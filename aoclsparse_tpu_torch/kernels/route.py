"""Gather-free application of a static permutation through a Benes network.

PyTorch counterpart of ``aoclsparse_tpu/kernels/xla/route.py`` (and of the
mask packing of ``kernels/pallas/route_fused.py:33-43``). A fixed
permutation of n = 2^k slots is a Benes network: 2k-1 stages of
"conditionally swap i with i^s" switches with strides 2^(k-1), ..., 2, 1,
2, ..., 2^(k-1). The switch settings (cross masks) come from the planner
once (``native.benes_plan``); applying them does no arithmetic, so every
version of the route returns bit-equal values.

- `apply_benes` is the stage loop in plain torch (two rolls and a select a
  stage), over unpacked (2k-1, n) masks: the plain version of the route.
- `plan_route_arrays` splits the masks into the arrays the route kernel
  takes, exactly as the JAX package splits them: for k <= `FUSED_MAX_K`
  one bit-packed network; above it the 2(k - 20) outer stages stay
  unpacked and the middle splits into 2^(k-20) independent packed
  subnetworks (strides <= 2^19 never cross the top address bits).
- `apply_route` runs such a plan through `kernels/benes.py` `benes_apply`,
  one entry for the whole plan (the hand-written kernel's three passes on
  a CUDA tensor, its plain version on a CPU one). `route_masks` turns a
  plan back into its (2k-1, n) masks, for the plain stage loop over the
  whole route.

``StaticRoute`` (the JAX package's partial-permutation wrapper) serves the
SpGEMM path, which is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "FUSED_MAX_K",
    "apply_benes",
    "apply_route",
    "benes_strides",
    "pack_masks",
    "plan_route_arrays",
    "route_masks",
    "unpack_masks",
]

#: largest network the packed route kernel takes in one piece (the JAX
#: package's fused VMEM cap, kept so both packages split alike)
FUSED_MAX_K = 20


def benes_strides(k: int):
    """Stage strides 2^(k-1), ..., 2, 1, 2, ..., 2^(k-1) (2k-1 stages)."""
    if k <= 0:
        return ()
    down = [1 << (k - 1 - t) for t in range(k)]
    return tuple(down + [1 << (t + 1) for t in range(k - 1)])


def pack_masks(masks: np.ndarray) -> np.ndarray:
    """(S, n) uint8 cross masks -> (ceil(S/8), n) uint8 with stage t at bit
    t % 8 of row t // 8."""
    S, n = masks.shape
    packed = np.zeros((-(-S // 8), n), dtype=np.uint8)
    for t in range(S):
        packed[t // 8] |= (masks[t] & 1) << (t % 8)
    return packed


def plan_route_arrays(k: int, masks_np: np.ndarray):
    """(outer, packed) for `apply_route`. k < 7: (masks, None), the plain
    stage loop only; 7 <= k <= FUSED_MAX_K: (None, (1, ceil((2k-1)/8), n));
    k > FUSED_MAX_K: outer = the first and last k - FUSED_MAX_K stages
    unpacked, packed = one packed subnetwork per 2^FUSED_MAX_K slots."""
    S = masks_np.shape[0]
    if k < 7:
        return masks_np, None
    kc = min(k, FUSED_MAX_K)
    d = k - kc
    nsub = 1 << kc
    if d == 0:
        return None, pack_masks(masks_np)[None]
    outer = np.concatenate([masks_np[:d], masks_np[S - d :]])
    mid = masks_np[d : S - d]
    packed = np.stack([pack_masks(mid[:, h * nsub : (h + 1) * nsub]) for h in range(1 << d)])
    return outer, packed


def unpack_masks(masks_packed: torch.Tensor, S: int) -> torch.Tensor:
    """(ceil(S/8), n) packed rows -> (S, n) 0/1 uint8 rows."""
    t = torch.arange(S, device=masks_packed.device)
    return (masks_packed[t // 8] >> (t % 8)[:, None].to(torch.uint8)) & 1


def route_masks(outer, packed, k: int) -> torch.Tensor:
    """The (2k-1, 2^k) cross masks of a (outer, packed) plan: the packed
    subnetworks' stages side by side between the outer ones."""
    if packed is None:
        return outer
    d = int(packed.shape[0]).bit_length() - 1
    mid = torch.cat([unpack_masks(p, 2 * (k - d) - 1) for p in packed], dim=1)
    return mid if d == 0 else torch.cat([outer[:d], mid, outer[d:]])


def stage(v: torch.Tensor, mask_row: torch.Tensor, s: int) -> torch.Tensor:
    """One Benes stage: v'[i] = v[i ^ s] where mask_row[i] is set. For i
    with bit s clear the partner i + s is roll(v, -s)[i], else i - s is
    roll(v, s)[i]; a roll never wraps across a switch."""
    bit = (torch.arange(v.shape[0], device=v.device) & s) != 0
    partner = torch.where(bit, torch.roll(v, s), torch.roll(v, -s))
    return torch.where(mask_row != 0, partner, v)


def apply_benes(v: torch.Tensor, masks: torch.Tensor, k: int) -> torch.Tensor:
    """Route v (2^k values) through the network with (2k-1, 2^k) cross
    masks: the stage loop in plain torch."""
    n = v.shape[0]
    if n != (1 << k):
        raise ValueError(f"apply_benes: v has {n} elements, expected 2^{k}")
    for t, s in enumerate(benes_strides(k)):
        v = stage(v, masks[t], s)
    return v


def apply_route(v: torch.Tensor, outer, packed, k: int) -> torch.Tensor:
    """Route v through a (outer, packed) plan from `plan_route_arrays`;
    returns a new tensor. k < 7 (no packed network): the plain stage loop;
    else the route kernel's one entry for the whole plan."""
    from .benes import benes_apply

    if packed is None:
        return apply_benes(v, outer, k)
    return benes_apply(v, outer, packed, k)
