"""DDA voxel traversal along rays.

Port of gtsam_points_tpu/utils/raycast.py (reference:
util/voxel_raycaster.hpp:20-60). Plain PyTorch on every device, as the
reference module is a `lax.scan`, not a kernel: every ray takes one voxel
a step for `max_steps` steps. The visited voxels go to one output
allocated before the first step (a sweep's rays fill hundreds of MB), laid
out step by step so that each step writes one contiguous block, and
returned as a view with the steps moved in front of the last axis, the
reference's shape.

It equals the reference bit for bit, invalid steps included. Everything is
float32, and every constant is a float32 value, as JAX rounds a Python
float. |d| is written as separate products and adds in the reference's
order: a reduction kernel may add in another order or contract a product
into an FMA, which moves the direction by an ulp and flips the axis choice
on a near tie. A tie goes to the first axis (`torch.argmin`'s rule, as
`jnp.argmin`'s). All `max_steps` steps run, with no early exit, so once its
inputs are on the device a call makes no synchronizing call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, float32_on, resolve_device
from gtsam_points_tpu_torch.ops.voxel_keys import fast_floor

_TINY = float(np.float32(1e-12))  # the reference's guard, as float32


def raycast_voxels(origins, targets, leaf: float, max_steps: int, device: DeviceLike = None):
    """-> (coords [..., max_steps, 3] int32, valid [..., max_steps] bool).

    Visits voxels from origin toward target (inclusive of the start voxel,
    exclusive of the target's voxel), standard Amanatides-Woo DDA; a ray
    whose start and target share a voxel visits none. At an invalid step
    `coords` repeats the ray's current voxel, as the reference's does.
    `origins` and `targets` are [..., 3] of one shape.
    """
    dev = resolve_device(device)
    origins, targets = float32_on(origins, dev), float32_on(targets, dev)
    if origins.shape != targets.shape or origins.shape[-1:] != (3,):
        raise ValueError(f"origins {tuple(origins.shape)} and targets {tuple(targets.shape)}: want one shape [..., 3]")
    inv_leaf = float(np.float32(1.0 / leaf))
    o = origins * inv_leaf
    t = targets * inv_leaf
    d = t - o
    sq = d[..., 0] * d[..., 0]
    sq = sq + d[..., 1] * d[..., 1]
    sq = sq + d[..., 2] * d[..., 2]
    dn = d / torch.clamp_min(torch.sqrt(sq), _TINY)[..., None]

    cur = fast_floor(o)
    end = fast_floor(t)
    step = torch.where(dn > 0, 1, -1).to(torch.int32)
    # parametric distance to the first boundary along each axis
    next_boundary = torch.where(dn > 0, cur + 1, cur).to(o.dtype)
    flat = torch.abs(dn) < _TINY
    safe_dn = torch.where(flat, _TINY, dn)
    t_max = torch.where(flat, math.inf, (next_boundary - o) / safe_dn)
    t_delta = torch.abs(1.0 / safe_dn)

    batch = o.shape[:-1]
    coords = torch.empty(max_steps, *batch, 3, dtype=torch.int32, device=dev)
    valid = torch.empty(max_steps, *batch, dtype=torch.bool, device=dev)
    axes = torch.arange(3, device=dev)
    alive = torch.ones(batch, dtype=torch.bool, device=dev)
    for s in range(max_steps):
        coords[s] = cur
        emit = alive & ~torch.all(cur == end, dim=-1)
        onehot = torch.argmin(t_max, dim=-1, keepdim=True) == axes
        cur = torch.where(emit[..., None], cur + step * onehot, cur)
        t_max = torch.where(emit[..., None], t_max + t_delta * onehot, t_max)
        valid[s] = emit
        alive = emit
    return coords.movedim(0, -2), valid.movedim(0, -1)
