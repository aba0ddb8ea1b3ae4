"""Frame: fixed-capacity struct-of-arrays point cloud.

Port of gtsam_points_tpu/types/frame.py. Every attribute is an optional dense
tensor padded to a static capacity with a validity mask; padding slots hold
the first valid point and the mask is authoritative. `aux` carries any
further per-point attributes by name: gathered, concatenated and padded with
the points, left untouched by geometric operations.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.utils import se3


@dataclasses.dataclass(frozen=True)
class Frame:
    """points [N,3] f32, mask [N] bool, and optional normals [N,3],
    covs [N,3,3], intensities [N], times [N] (all f32) and aux, a dict of
    name -> [N, ...] f32."""

    points: torch.Tensor
    mask: torch.Tensor
    normals: Optional[torch.Tensor] = None
    covs: Optional[torch.Tensor] = None
    intensities: Optional[torch.Tensor] = None
    times: Optional[torch.Tensor] = None
    aux: Optional[Dict[str, torch.Tensor]] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.mask.to(torch.int32), dim=-1)

    def replace(self, **kwargs) -> "Frame":
        return dataclasses.replace(self, **kwargs)

    def has_normals(self) -> bool:
        return self.normals is not None

    def has_covs(self) -> bool:
        return self.covs is not None

    def has_intensities(self) -> bool:
        return self.intensities is not None

    def has_times(self) -> bool:
        return self.times is not None

    def aux_attribute(self, name: str) -> torch.Tensor:
        if self.aux is None or name not in self.aux:
            raise KeyError(f"no aux attribute {name!r}")
        return self.aux[name]


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
    aux: Optional[dict] = None,
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
        aux=None if aux is None else {k: pad(v) for k, v in aux.items()},
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


_ATTRS = ("points", "mask", "normals", "covs", "intensities", "times")


def _map_attrs(frame: Frame, fn) -> Frame:
    """A frame of fn(attribute) for every attribute present, aux included."""
    out = {k: None if getattr(frame, k) is None else fn(getattr(frame, k)) for k in _ATTRS}
    aux = None if frame.aux is None else {k: fn(v) for k, v in frame.aux.items()}
    return Frame(aux=aux, **out)


def merge_frames(frames, capacity: Optional[int] = None) -> Frame:
    """Concatenate frames (all on one device); an attribute is kept only if
    every frame has it, and an aux attribute only if every frame's aux has
    it (in sorted name order). `capacity` pads or truncates the result."""
    check_on(frames[0].device, *(f.points for f in frames))

    def cat(name):
        vals = [getattr(f, name) for f in frames]
        return None if any(v is None for v in vals) else torch.cat(vals, dim=0)

    aux = None
    if all(f.aux is not None for f in frames):
        common = set(frames[0].aux)
        for f in frames[1:]:
            common &= set(f.aux)
        aux = {k: torch.cat([f.aux[k] for f in frames], dim=0) for k in sorted(common)}
    out = Frame(aux=aux, **{k: cat(k) for k in _ATTRS})
    return out if capacity is None else pad_frame(out, capacity)


def pad_frame(frame: Frame, capacity: int) -> Frame:
    """Pad (with zeros, mask False) or truncate a frame to `capacity`."""
    n = frame.capacity
    if capacity == n:
        return frame

    def fix(arr):
        if capacity < n:
            return arr[:capacity]
        return torch.cat([arr, arr.new_zeros((capacity - n,) + arr.shape[1:])], dim=0)

    return _map_attrs(frame, fix)


def masked_points(frame: Frame, fill: float = float("inf")) -> torch.Tensor:
    """Points with the padding slots set to `fill` (for a nearest-neighbour
    search)."""
    return torch.where(frame.mask[:, None], frame.points, fill)
