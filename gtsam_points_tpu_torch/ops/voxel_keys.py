"""Packed int32 voxel keys.

Port of gtsam_points_tpu/ops/voxel_keys.py: each integer voxel coordinate is
offset by 2^(BITS-1) and packed into BITS bits of a non-negative int32, so
equal keys mean equal voxels (coordinates outside the range wrap).
"""

from __future__ import annotations

import torch

BITS = 10  # per axis -> 2^10 voxels per axis, 30-bit keys
RANGE = 1 << BITS
HALF = RANGE // 2
MASK = RANGE - 1

# Sentinel key larger than any packed key (packed keys < 2^30). Bitcast to
# f32 it is a NaN, so keys stored in float tables are compared as int32 views.
INVALID_KEY = 0x7FFFFFFF


def fast_floor(x: torch.Tensor) -> torch.Tensor:
    """Floor to int32 by truncation and correction (same as the reference)."""
    i = x.to(torch.int32)
    return i - (x < i.to(x.dtype)).to(torch.int32)


def voxel_coords(points: torch.Tensor, inv_leaf) -> torch.Tensor:
    """[..., 3] float points -> [..., 3] int32 voxel coords."""
    return fast_floor(points * inv_leaf)


def pack_coords(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] int32 coords -> [...] int32 key (wrapping into BITS bits/axis)."""
    c = (coords + HALF) & MASK
    return (c[..., 0] << (2 * BITS)) | (c[..., 1] << BITS) | c[..., 2]


def unpack_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_coords (valid keys only)."""
    x = ((key >> (2 * BITS)) & MASK) - HALF
    y = ((key >> BITS) & MASK) - HALF
    z = (key & MASK) - HALF
    return torch.stack([x, y, z], dim=-1)


def point_keys(points: torch.Tensor, mask: torch.Tensor, leaf) -> torch.Tensor:
    """Packed voxel keys, padding slots forced to INVALID_KEY. `leaf` is a
    python float or a 0-d f32 tensor (then 1/leaf is
    taken in f32, as the reference takes it)."""
    keys = pack_coords(voxel_coords(points, 1.0 / leaf))
    return torch.where(mask, keys, INVALID_KEY)


def point_keys_planar(points_p: torch.Tensor, mask: torch.Tensor, leaf) -> torch.Tensor:
    """Planar variant: points_p [3, N] -> keys [N]."""
    c = fast_floor(points_p * (1.0 / leaf))
    c = (c + HALF) & MASK
    keys = (c[0] << (2 * BITS)) | (c[1] << BITS) | c[2]
    return torch.where(mask, keys, INVALID_KEY)


def neighbor_offsets(num: int, device: torch.device) -> torch.Tensor:
    """1/7/19/27-cell neighbourhood offset patterns, [num, 3] int32."""
    if num == 1:
        offs = [(0, 0, 0)]
    elif num == 7:
        offs = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    elif num == 19:
        offs = [
            (x, y, z)
            for x in (-1, 0, 1)
            for y in (-1, 0, 1)
            for z in (-1, 0, 1)
            if abs(x) + abs(y) + abs(z) <= 2
        ]
    elif num == 27:
        offs = [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)]
    else:
        raise ValueError(f"unsupported neighborhood {num} (use 1/7/19/27)")
    return torch.tensor(offs, dtype=torch.int32, device=device)
