"""Carry state across from the JAX package as numpy arrays.

The system has no weights: its state is the voxel map (whole, or sharded
with a leading [S] axis), the frames, a
scan's source clusters, a frame's hash grid, a pose graph's edges, a VGICP
factor set and an incremental optimizer's marginal priors, IMU samples, a Sim(3), an
occupancy grid and an incremental covariance map. These functions
take the numpy arrays of a JAX `GaussianVoxelMap` (its seven fields), of a
`Frame` (with its normals and covariances), of a `SourceClusters` (its four
fields), of a `HashGrid` (its nine arrays and its coarse level), of a
`PoseGraphEdges`, of a `VGICPFactorBatch` (its stacked maps and frames and
its keys), of a `MarginalPriorFactor` and of the bundle-adjustment factors
(an EVM factor's points and keys, an LSQ factor's moments), of
`ImuMeasurements`, `Sim3`, `OccupancyGrid` (its bit words as uint32) and
`IncrementalCovarianceMap` (with its `RunningStatistics`), and build the
port's state from them bit for bit, so both packages can start from the
same map, search the same grid or optimize the same graph. `isam2_to_numpy` snapshots either
package's `ISAM2Ext` so tests can hold the two against each other.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device
from gtsam_points_tpu_torch.factors.balm import EdgeEVMFactor, LsqBAFactor, PlaneEVMFactor
from gtsam_points_tpu_torch.factors.batch import VGICPFactorBatch
from gtsam_points_tpu_torch.factors.experimental import Sim3
from gtsam_points_tpu_torch.factors.imu import ImuMeasurements
from gtsam_points_tpu_torch.ops.incremental_covariance import IncrementalCovarianceMap
from gtsam_points_tpu_torch.ops.occupancy import OccupancyGrid
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid
from gtsam_points_tpu_torch.ops.voxelmap import FIELD_DTYPES, GaussianVoxelMap
from gtsam_points_tpu_torch.optim.incremental import MarginalPriorFactor
from gtsam_points_tpu_torch.optim.sparse import PoseGraphEdges
from gtsam_points_tpu_torch.registration.cluster import SourceClusters
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils.stats import RunningStatistics

_FRAME_FIELDS = ("points", "mask", "normals", "covs", "intensities", "times")
_GRID_DTYPES = {
    "leaf": np.float32,
    "cell_keys": np.int32,
    "cell_points": np.float32,
    "cell_pt_index": np.int32,
    "cell_count": np.int32,
    "cell_records": np.float32,
    "num_cells": np.int32,
    "hash_index": np.int32,
    "neighbor_rows": np.int32,
}
_POSE_GRAPH_DTYPES = {
    "measured": np.float32,
    "weights": np.float32,
    "t_idx": np.int32,
    "s_idx": np.int32,
    "prior_T": np.float32,
    "prior_w": np.float32,
    "prior_idx": np.int32,
    "info": np.float32,
    "prior_info": np.float32,
}
_MARGINAL_FIELDS = ("lin_poses", "sqrt_info_t", "delta_star")
_CLUSTER_DTYPES = {"pts_p": np.float32, "covs6": np.float32, "weight": np.float32, "mask": bool}
_EVM_DTYPES = {"points": np.float32, "point_keys": np.int64, "mask": bool}
_LSQ_DTYPES = {"counts": np.float32, "means": np.float32, "covs": np.float32}
_IMU_FIELDS = ("dts", "accs", "gyros")
_STATS_FIELDS = ("count", "total", "sq_total")
_ICM_DTYPES = {
    "points": np.float32,
    "mask": bool,
    "normals": np.float32,
    "covs": np.float32,
    "valid": bool,
    "birth": np.int32,
    "epoch": np.int32,
    "cursor": np.int32,
}


def _tensor(a, dtype, dev: torch.device) -> torch.Tensor:
    # a byte copy (never shared with the caller's buffer, which may be a
    # read-only JAX array), so NaN-bitcast keys survive
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True, order="C")).to(dev)


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def voxelmap_from_numpy(arrays: Mapping[str, np.ndarray], device: DeviceLike = None) -> GaussianVoxelMap:
    """`arrays`: leaf, keys, moments, last_seen, epoch, num_voxels, table."""
    dev = resolve_device(device)
    return GaussianVoxelMap(**{k: _tensor(arrays[k], dt, dev) for k, dt in FIELD_DTYPES.items()})


def frame_from_numpy(arrays: Mapping[str, np.ndarray], device: DeviceLike = None) -> Frame:
    """`arrays`: points and mask, and any of normals, covs, intensities,
    times, and aux (a mapping of name -> array)."""
    dev = resolve_device(device)
    fields = {}
    for k in _FRAME_FIELDS:
        a = arrays.get(k)
        if a is not None:
            fields[k] = _tensor(a, bool if k == "mask" else np.float32, dev)
    aux = arrays.get("aux")
    if aux is not None:
        fields["aux"] = {k: _tensor(v, np.float32, dev) for k, v in aux.items()}
    return Frame(**fields)


def frame_to_numpy(frame) -> dict:
    """The frame's arrays (those present) as numpy, `aux` as a dict. Takes
    the port's `Frame` or the JAX one."""
    out = {k: _numpy(getattr(frame, k)) for k in _FRAME_FIELDS if getattr(frame, k) is not None}
    if frame.aux is not None:
        out["aux"] = {k: _numpy(v) for k, v in frame.aux.items()}
    return out


def voxelmap_to_numpy(vmap: GaussianVoxelMap) -> dict:
    """The map's fields as numpy arrays. Takes the port's map or the JAX one."""
    return {k: _numpy(getattr(vmap, k)) for k in FIELD_DTYPES}


def sharded_voxelmap_from_numpy(arrays: Mapping[str, np.ndarray], device: DeviceLike = None) -> GaussianVoxelMap:
    """`arrays`: the seven fields of a sharded map (a JAX
    `build_sharded_voxelmap`'s), each with a leading [S] axis -> the port's
    stacked map. Raises unless every field has the same leading axis."""
    s = np.shape(arrays["leaf"])
    if len(s) != 1 or any(np.shape(arrays[k])[:1] != s for k in FIELD_DTYPES):
        raise ValueError("a sharded map has a leading [S] axis on every field")
    return voxelmap_from_numpy(arrays, device)


def sharded_voxelmap_to_numpy(svmap) -> dict:
    """A stacked sharded map's fields as numpy arrays, [S, ...] each. Takes
    the port's map or the JAX one."""
    out = voxelmap_to_numpy(svmap)
    if out["leaf"].ndim != 1:
        raise ValueError("not a sharded map: its leaf has no leading [S] axis")
    return out


def clusters_from_numpy(arrays: Mapping[str, np.ndarray], device: DeviceLike = None) -> SourceClusters:
    """`arrays`: pts_p, covs6, weight, mask (a JAX `SourceClusters`' fields)."""
    dev = resolve_device(device)
    return SourceClusters(**{k: _tensor(arrays[k], dt, dev) for k, dt in _CLUSTER_DTYPES.items()})


def clusters_to_numpy(clusters: SourceClusters) -> dict:
    """The clusters' fields as numpy arrays (for comparison with the JAX ones)."""
    return {k: getattr(clusters, k).cpu().numpy() for k in _CLUSTER_DTYPES}


def hash_grid_from_numpy(arrays: Mapping, device: DeviceLike = None) -> HashGrid:
    """`arrays`: the nine arrays of a JAX `HashGrid` (leaf, cell_keys,
    cell_points, cell_pt_index, cell_count, cell_records, num_cells,
    hash_index, neighbor_rows) and `coarse`, the same mapping for the coarse
    level or None (or absent)."""
    dev = resolve_device(device)
    coarse = arrays.get("coarse")
    return HashGrid(
        **{k: _tensor(arrays[k], dt, dev) for k, dt in _GRID_DTYPES.items()},
        coarse=None if coarse is None else hash_grid_from_numpy(coarse, dev),
    )


def hash_grid_to_numpy(grid) -> dict:
    """The grid's arrays as numpy arrays, with `coarse` the same dict for
    the coarse level or None. Takes the port's `HashGrid` or the JAX one."""
    out = {k: _numpy(getattr(grid, k)) for k in _GRID_DTYPES}
    out["coarse"] = None if grid.coarse is None else hash_grid_to_numpy(grid.coarse)
    return out


def pose_graph_from_numpy(arrays: Mapping, device: DeviceLike = None) -> PoseGraphEdges:
    """`arrays`: the fields of a JAX `PoseGraphEdges` (measured, weights,
    t_idx, s_idx, prior_T, prior_w, prior_idx, and info and prior_info,
    None or absent when the graph has none)."""
    dev = resolve_device(device)
    return PoseGraphEdges(**{k: None if arrays.get(k) is None else _tensor(arrays[k], dt, dev)
                             for k, dt in _POSE_GRAPH_DTYPES.items()})


def vgicp_batch_from_numpy(arrays: Mapping, device: DeviceLike = None) -> VGICPFactorBatch:
    """`arrays`: `voxelmaps` (the seven fields of a JAX `GaussianVoxelMap`,
    stacked [F, ...]), `sources` (a JAX `Frame`'s fields, stacked),
    `target_keys`, `source_keys` [F] and `min_voxel_points`."""
    dev = resolve_device(device)
    return VGICPFactorBatch(
        voxelmaps=voxelmap_from_numpy(arrays["voxelmaps"], dev),
        sources=frame_from_numpy(arrays["sources"], dev),
        target_keys=_tensor(arrays["target_keys"], np.int32, dev),
        source_keys=_tensor(arrays["source_keys"], np.int32, dev),
        min_voxel_points=float(arrays["min_voxel_points"]),
    )


def marginal_prior_from_numpy(arrays: Mapping, device: DeviceLike = None) -> MarginalPriorFactor:
    """`arrays`: lin_poses [K, 4, 4], sqrt_info_t [6K, 6K], delta_star [6K]
    and pose_keys (a JAX `MarginalPriorFactor`'s fields)."""
    dev = resolve_device(device)
    return MarginalPriorFactor(**{k: _tensor(arrays[k], np.float32, dev) for k in _MARGINAL_FIELDS},
                               pose_keys=tuple(int(k) for k in arrays["pose_keys"]))


def marginal_prior_to_numpy(f) -> dict:
    """A marginal prior's fields as numpy arrays and its keys as a tuple.
    Takes the port's `MarginalPriorFactor` or the JAX one."""
    return {**{k: _numpy(getattr(f, k)) for k in _MARGINAL_FIELDS}, "pose_keys": tuple(int(k) for k in f.pose_keys)}


def isam2_to_numpy(isam) -> dict:
    """The state of an `ISAM2Ext` (the port's or the JAX one) as numpy:
    estimates {key: 4x4}, window, frozen keys, history and loop edges (t, s,
    measured, info), history priors (key, T, w), num_values, num_compiles,
    and each active `MarginalPriorFactor`'s fields in the order of the
    factor list."""
    return {
        "estimates": {int(k): np.asarray(v, np.float32) for k, v in isam.estimates.items()},
        "window": [int(k) for k in isam.window],
        "frozen": sorted(int(k) for k in isam.frozen),
        "history_edges": [(int(t), int(s), np.asarray(m), np.asarray(i)) for t, s, m, i in isam.history_edges],
        "loop_edges": [(int(t), int(s), np.asarray(m), np.asarray(i)) for t, s, m, i in isam.loop_edges],
        "history_priors": [(int(k), np.asarray(T), np.asarray(w)) for k, T, w in isam.history_priors],
        "num_values": int(isam.num_values),
        "num_compiles": int(isam.num_compiles),
        "marginal_priors": [marginal_prior_to_numpy(f) for f in isam.factors if type(f).__name__ == "MarginalPriorFactor"],
    }


def evm_factor_from_numpy(arrays: Mapping, device: DeviceLike = None):
    """`arrays`: points [N, 3], point_keys [N], mask [N], pose_keys and
    num_eigvecs (a JAX `PlaneEVMFactor`'s or `EdgeEVMFactor`'s fields) -> the
    port's factor of the same kind (num_eigvecs 1: plane, 2: edge)."""
    dev = resolve_device(device)
    cls = PlaneEVMFactor if int(arrays["num_eigvecs"]) == 1 else EdgeEVMFactor
    return cls(**{k: _tensor(arrays[k], dt, dev) for k, dt in _EVM_DTYPES.items()},
               pose_keys=tuple(int(k) for k in arrays["pose_keys"]))


def evm_factor_to_numpy(f) -> dict:
    """An EVM factor's fields as numpy arrays (either package's)."""
    return {**{k: _numpy(getattr(f, k)) for k in _EVM_DTYPES}, "pose_keys": tuple(int(k) for k in f.pose_keys),
            "num_eigvecs": int(f.num_eigvecs)}


def lsq_ba_factor_from_numpy(arrays: Mapping, device: DeviceLike = None) -> LsqBAFactor:
    """`arrays`: counts [K], means [K, 3], covs [K, 3, 3] and pose_keys (a
    JAX `LsqBAFactor`'s fields)."""
    dev = resolve_device(device)
    return LsqBAFactor(**{k: _tensor(arrays[k], dt, dev) for k, dt in _LSQ_DTYPES.items()},
                       pose_keys=tuple(int(k) for k in arrays["pose_keys"]))


def lsq_ba_factor_to_numpy(f) -> dict:
    """An LSQ factor's moments as numpy arrays (either package's)."""
    return {**{k: _numpy(getattr(f, k)) for k in _LSQ_DTYPES}, "pose_keys": tuple(int(k) for k in f.pose_keys)}


def imu_measurements_from_numpy(arrays: Mapping, device: DeviceLike = None) -> ImuMeasurements:
    """`arrays`: dts [M], accs [M, 3], gyros [M, 3]."""
    dev = resolve_device(device)
    return ImuMeasurements(**{k: _tensor(arrays[k], np.float32, dev) for k in _IMU_FIELDS})


def imu_measurements_to_numpy(m) -> dict:
    """IMU samples as numpy arrays (either package's)."""
    return {k: _numpy(getattr(m, k)) for k in _IMU_FIELDS}


def sim3_from_numpy(arrays: Mapping, device: DeviceLike = None) -> Sim3:
    """`arrays`: pose [4, 4], scale ()."""
    dev = resolve_device(device)
    return Sim3(pose=_tensor(arrays["pose"], np.float32, dev), scale=_tensor(arrays["scale"], np.float32, dev))


def sim3_to_numpy(s) -> dict:
    """A Sim(3)'s pose and scale as numpy (either package's)."""
    return {"pose": _numpy(s.pose), "scale": _numpy(s.scale)}


def occupancy_grid_from_numpy(arrays: Mapping, device: DeviceLike = None) -> OccupancyGrid:
    """`arrays`: leaf, block_keys, bits [B, 2] (uint32 words, held as int64
    in the port), hash_index."""
    dev = resolve_device(device)
    return OccupancyGrid(
        leaf=_tensor(arrays["leaf"], np.float32, dev),
        block_keys=_tensor(arrays["block_keys"], np.int32, dev),
        bits=_tensor(np.asarray(arrays["bits"], np.uint32).astype(np.int64), np.int64, dev),
        hash_index=_tensor(arrays["hash_index"], np.int32, dev),
    )


def occupancy_grid_to_numpy(grid) -> dict:
    """An occupancy grid's arrays as numpy, its bit words as uint32 (either
    package's)."""
    out = {k: _numpy(getattr(grid, k)) for k in ("leaf", "block_keys", "hash_index")}
    out["bits"] = _numpy(grid.bits).astype(np.uint32)
    return out


def incremental_covariance_map_from_numpy(arrays: Mapping, device: DeviceLike = None) -> IncrementalCovarianceMap:
    """`arrays`: the map's fields (points, mask, normals, covs, valid, birth,
    epoch, cursor) and eig_stats, a mapping of count, total, sq_total."""
    dev = resolve_device(device)
    stats = RunningStatistics(**{k: _tensor(arrays["eig_stats"][k], np.float32, dev) for k in _STATS_FIELDS})
    return IncrementalCovarianceMap(**{k: _tensor(arrays[k], dt, dev) for k, dt in _ICM_DTYPES.items()},
                                    eig_stats=stats)


def incremental_covariance_map_to_numpy(cmap) -> dict:
    """The map's fields as numpy, eig_stats as a dict (either package's)."""
    out = {k: _numpy(getattr(cmap, k)) for k in _ICM_DTYPES}
    out["eig_stats"] = {k: _numpy(getattr(cmap.eig_stats, k)) for k in _STATS_FIELDS}
    return out
