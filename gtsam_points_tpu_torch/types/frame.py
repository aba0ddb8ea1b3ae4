"""Frame: fixed-capacity struct-of-arrays point cloud.

Port of gtsam_points_tpu/types/frame.py. Every attribute is an optional dense
tensor padded to a static capacity with a validity mask; padding slots hold
the first valid point and the mask is authoritative.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device
from gtsam_points_tpu_torch.utils import se3


@dataclasses.dataclass(frozen=True)
class Frame:
    """points [N,3] f32, mask [N] bool, and optional normals [N,3],
    covs [N,3,3], intensities [N], times [N] (all f32)."""

    points: torch.Tensor
    mask: torch.Tensor
    normals: Optional[torch.Tensor] = None
    covs: Optional[torch.Tensor] = None
    intensities: Optional[torch.Tensor] = None
    times: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def replace(self, **kwargs) -> "Frame":
        return dataclasses.replace(self, **kwargs)


def _round_capacity(n: int, multiple: int = 256) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def make_frame(
    points,
    normals=None,
    covs=None,
    intensities=None,
    times=None,
    capacity: Optional[int] = None,
    pad_multiple: int = 256,
    device: DeviceLike = None,
) -> Frame:
    """Build a Frame from host arrays on `device` (default `cuda`), padding to
    a multiple of `pad_multiple` unless `capacity` is given."""
    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    cap = capacity if capacity is not None else _round_capacity(n, pad_multiple)
    if cap < n:
        raise ValueError(f"capacity {cap} < num points {n}")

    def pad(arr, fill_from_first=False):
        if arr is None:
            return None
        arr = np.asarray(arr, dtype=np.float32)
        if arr.shape[0] != n:
            raise ValueError(f"attribute length {arr.shape[0]} != {n}")
        out = np.zeros((cap,) + arr.shape[1:], dtype=np.float32)
        out[:n] = arr
        if fill_from_first and n > 0:
            out[n:] = arr[0]
        return torch.from_numpy(out).to(dev)

    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    return Frame(
        points=pad(points, fill_from_first=True),
        mask=torch.from_numpy(mask).to(dev),
        normals=pad(normals),
        covs=pad(covs),
        intensities=pad(intensities),
        times=pad(times),
    )


def transform_frame(T: torch.Tensor, frame: Frame) -> Frame:
    """Rigidly transform a frame: points move, normals and covs rotate."""
    R = T[..., :3, :3]
    new_points = se3.transform_points(T, frame.points)
    new_normals = None if frame.normals is None else se3.rotate_points(T, frame.normals)
    new_covs = None
    if frame.covs is not None:
        new_covs = torch.einsum("...ij,...njk,...lk->...nil", R, frame.covs, R)
    return frame.replace(points=new_points, normals=new_normals, covs=new_covs)
