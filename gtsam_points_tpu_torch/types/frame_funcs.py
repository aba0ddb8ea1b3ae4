"""Point-cloud utility functions: sampling, sorting, ranges and overlap.

Port of gtsam_points_tpu/types/frame_funcs.py. Every function runs on the
device of its frame; the sorts are stable, as the reference's are.
"""

from __future__ import annotations

import torch

from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.types.frame import Frame, _map_attrs
from gtsam_points_tpu_torch.utils import se3


def sample(frame: Frame, indices: torch.Tensor) -> Frame:
    """The points (and every attribute) at `indices`, which must be valid."""
    return _map_attrs(frame, lambda arr: arr[indices])


def sort_by_time(frame: Frame) -> Frame:
    """Stable sort by per-point time; invalid slots last."""
    if frame.times is None:
        raise ValueError("sort_by_time requires times")
    key = torch.where(frame.mask, frame.times, float("inf"))
    return sample(frame, torch.argsort(key, stable=True))


def sort_by_voxel_key(frame: Frame, leaf) -> Frame:
    """Stable sort by packed voxel key at `leaf`; invalid slots last."""
    keys = vk.point_keys(frame.points, frame.mask, leaf)
    key = torch.where(frame.mask, keys, torch.iinfo(torch.int32).max)
    return sample(frame, torch.argsort(key, stable=True))


def point_distances(frame: Frame) -> torch.Tensor:
    """Range of each point from the origin (0 in invalid slots)."""
    return torch.where(frame.mask, torch.linalg.norm(frame.points, dim=-1), 0.0)


def minmax_distance(frame: Frame):
    """(smallest, largest) range of the valid points."""
    d = torch.linalg.norm(frame.points, dim=-1)
    return torch.amin(torch.where(frame.mask, d, float("inf"))), torch.amax(torch.where(frame.mask, d, float("-inf")))


def median_distance(frame: Frame, num_samples: int = 256) -> torch.Tensor:
    """Median range of every `capacity // num_samples`-th slot, invalid
    slots ignored. Of an even count it is the mean of the two middle values,
    as numpy's and the reference's nanmedian give it (`torch.nanmedian`
    returns the lower one)."""
    d = torch.linalg.norm(frame.points, dim=-1)
    stride = max(frame.capacity // num_samples, 1)
    d, ok = d[::stride], frame.mask[::stride]
    s = torch.sort(torch.where(ok, d, float("inf"))).values
    n = torch.sum(ok.to(torch.int64))
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = (s[lo] + s[hi]) / 2.0
    return torch.where(n > 0, med, float("nan"))


def overlap(target_voxelmap, source: Frame, T: torch.Tensor) -> torch.Tensor:
    """The share of source points, moved by T, that land in a voxel of the
    target map."""
    from gtsam_points_tpu_torch.ops.voxelmap import voxelmap_overlap

    return voxelmap_overlap(target_voxelmap, source, T)


def overlap_auto(target_voxelmaps, source: Frame, Ts) -> torch.Tensor:
    """The share of source points that land in a voxel of any of the maps,
    each map with its own pose."""
    from gtsam_points_tpu_torch.ops.voxelmap import lookup_voxels

    found_any = torch.zeros(source.capacity, dtype=torch.bool, device=source.device)
    for vm, T in zip(target_voxelmaps, Ts):
        _, found = lookup_voxels(vm, se3.transform_points(T, source.points), source.mask)
        found_any = found_any | found
    n = torch.clamp(source.num_valid(), min=1)
    return torch.sum(found_any.to(torch.float32)) / n
