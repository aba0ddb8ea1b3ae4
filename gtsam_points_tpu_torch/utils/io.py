"""Host-side IO for the binary point formats of the reference datasets.

Port of gtsam_points_tpu/utils/io.py. Formats (reference:
include/gtsam_points/util/read_points.hpp:13-63):
- `read_times`:  flat float32 array.
- `read_points`: packed float32 xyz triplets.
- `read_points4`: packed float32 xyzw quadruplets (KITTI .bin = xyz+intensity).
- `graph.txt`:  lines "v<id> x y z qx qy qz qw" (ground-truth poses).

The readers return numpy arrays on the host, as the JAX module's do.
`save_frame_npz` and `load_frame_npz` keep the JAX module's npz layout (keys
`points`, `mask`, `normals`, `covs`, `intensities`, `times` and
`aux__<name>`), so a frame that either package writes loads in the other bit
for bit (reference: PointCloud::save/save_compact,
include/gtsam_points/types/point_cloud.hpp:90-100).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device
from gtsam_points_tpu_torch.types.frame import Frame

_FRAME_FIELDS = ("points", "mask", "normals", "covs", "intensities", "times")
_AUX = "aux__"


def read_times(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32)


def read_points(path: str) -> np.ndarray:
    """Packed float32 xyz -> [N, 3]."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 3)


def read_points4(path: str) -> np.ndarray:
    """Packed float32 xyzw (KITTI: xyz + intensity) -> [N, 4]."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_kitti_bin(path: str):
    """KITTI velodyne .bin -> (points [N, 3], intensities [N])."""
    data = read_points4(path)
    return data[:, :3].copy(), data[:, 3].copy()


def load_graph(path: str) -> np.ndarray:
    """graph.txt -> [P, 7] float32 rows of (x, y, z, qx, qy, qz, qw), ordered by vertex id."""
    rows = {}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) != 8 or not tok[0].startswith("v"):
                continue
            rows[int(tok[0][1:])] = [float(x) for x in tok[1:]]
    return np.asarray([rows[i] for i in sorted(rows)], dtype=np.float32)


def save_frame_npz(path: str, frame: Frame) -> None:
    """The frame's fields (and each aux attribute as `aux__<name>`) as a compressed `.npz`."""
    arrays = {name: getattr(frame, name).cpu().numpy() for name in _FRAME_FIELDS
              if getattr(frame, name) is not None}
    for k, v in (frame.aux or {}).items():
        arrays[_AUX + k] = v.cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_frame_npz(path: str, device: DeviceLike = None) -> Frame:
    """A frame from the `.npz` that `save_frame_npz` (either package's)
    wrote, on `device` (default `cuda`), every array as stored."""
    dev = resolve_device(device)
    with np.load(path) as data:
        fields = {k: torch.from_numpy(data[k]).to(dev) for k in data.files}
    aux = {k[len(_AUX):]: v for k, v in fields.items() if k.startswith(_AUX)}
    return Frame(**{k: v for k, v in fields.items() if not k.startswith(_AUX)}, aux=aux or None)


def data_root() -> str:
    """Root of the reference datasets (read-only): `$GTSAM_POINTS_DATA`.
    Raises when the variable is unset: no directory outside the checkout is
    assumed."""
    root = os.environ.get("GTSAM_POINTS_DATA")
    if not root:
        raise RuntimeError("GTSAM_POINTS_DATA is not set: it names the root of the reference datasets")
    return root
