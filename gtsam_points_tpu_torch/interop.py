"""Carry state across from the JAX package as numpy arrays.

The system has no weights: its state is the voxel map, the frames and a
scan's source clusters. These functions take the numpy arrays of a JAX
`GaussianVoxelMap` (its seven fields), of a `Frame` and of a
`SourceClusters` (its four fields), and build the port's state from them
bit for bit, so both packages can start from the same map.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device
from gtsam_points_tpu_torch.ops.voxelmap import GaussianVoxelMap
from gtsam_points_tpu_torch.registration.cluster import SourceClusters
from gtsam_points_tpu_torch.types.frame import Frame

_VMAP_DTYPES = {
    "leaf": np.float32,
    "keys": np.int32,
    "moments": np.float32,
    "last_seen": np.int32,
    "epoch": np.int32,
    "num_voxels": np.int32,
    "table": np.float32,
}
_FRAME_FIELDS = ("points", "mask", "normals", "covs", "intensities", "times")
_CLUSTER_DTYPES = {"pts_p": np.float32, "covs6": np.float32, "weight": np.float32, "mask": bool}


def _tensor(a, dtype, dev: torch.device) -> torch.Tensor:
    # a byte copy (never shared with the caller's buffer, which may be a
    # read-only JAX array), so NaN-bitcast keys survive
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True, order="C")).to(dev)


def voxelmap_from_numpy(arrays: Mapping[str, np.ndarray], device: DeviceLike = None) -> GaussianVoxelMap:
    """`arrays`: leaf, keys, moments, last_seen, epoch, num_voxels, table."""
    dev = resolve_device(device)
    return GaussianVoxelMap(**{k: _tensor(arrays[k], dt, dev) for k, dt in _VMAP_DTYPES.items()})


def frame_from_numpy(arrays: Mapping[str, np.ndarray], device: DeviceLike = None) -> Frame:
    """`arrays`: points and mask, and any of normals, covs, intensities, times."""
    dev = resolve_device(device)
    fields = {}
    for k in _FRAME_FIELDS:
        a = arrays.get(k)
        if a is not None:
            fields[k] = _tensor(a, bool if k == "mask" else np.float32, dev)
    return Frame(**fields)


def voxelmap_to_numpy(vmap: GaussianVoxelMap) -> dict:
    """The map's fields as numpy arrays (for comparison with the JAX map)."""
    return {k: getattr(vmap, k).cpu().numpy() for k in _VMAP_DTYPES}


def clusters_from_numpy(arrays: Mapping[str, np.ndarray], device: DeviceLike = None) -> SourceClusters:
    """`arrays`: pts_p, covs6, weight, mask (a JAX `SourceClusters`' fields)."""
    dev = resolve_device(device)
    return SourceClusters(**{k: _tensor(arrays[k], dt, dev) for k, dt in _CLUSTER_DTYPES.items()})


def clusters_to_numpy(clusters: SourceClusters) -> dict:
    """The clusters' fields as numpy arrays (for comparison with the JAX ones)."""
    return {k: getattr(clusters, k).cpu().numpy() for k in _CLUSTER_DTYPES}
