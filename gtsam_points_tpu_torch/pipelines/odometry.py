"""Scan-to-map VGICP odometry, point path.

Port of gtsam_points_tpu/pipelines/odometry.py for `clusters=None`: predict
with constant velocity, register the scan against the voxel map with a
`VGICPFactor` in the LM, then insert the scan into the map when the keyframe
gate opens — incrementally, or with the structural `insert_frame` when the
incremental insert overflows. The reference's two `lax.cond`s (keyframe gate,
overflow fallback) are Python branches on values read from the device.

The cluster path (`clusters=...`) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.factors.vgicp import VGICPFactor
from gtsam_points_tpu_torch.ops.voxelmap import (
    GaussianVoxelMap,
    empty_voxelmap,
    insert_frame,
    insert_frame_incremental,
)
from gtsam_points_tpu_torch.optim.graph import FactorGraph
from gtsam_points_tpu_torch.optim.lm import LMParams, LMResult, optimize_lm
from gtsam_points_tpu_torch.types.frame import Frame, transform_frame
from gtsam_points_tpu_torch.utils import se3


class OdometryState(NamedTuple):
    vmap: GaussianVoxelMap
    T_world: torch.Tensor  # [4, 4] current sensor pose
    T_delta: torch.Tensor  # [4, 4] last inter-frame motion (constant-velocity model)
    num_frames: torch.Tensor  # () int32


@dataclasses.dataclass(frozen=True)
class OdometryParams:
    voxel_resolution: float = 1.0
    map_capacity: int = 262144
    min_voxel_points: float = 5.0
    max_iterations: int = 10
    keyframe_trans: float = 0.5  # insert into the map when moved this far...
    keyframe_rot: float = 0.2  # ...or rotated this much since the last frame
    scan_cells_capacity: int = 8192  # bound on distinct voxels of one scan
    lm: Optional[LMParams] = None


def _lm_params(params: OdometryParams) -> LMParams:
    return params.lm or LMParams(max_iterations=params.max_iterations, max_inner_iterations=5)


def init_odometry(first_frame: Frame, params: OdometryParams, device: DeviceLike = None) -> OdometryState:
    """Start odometry with a map built from `first_frame`, on `device`
    (default `cuda`; the frame must lie there)."""
    dev = resolve_device(device)
    check_on(dev, first_frame.points)
    vmap = insert_frame(empty_voxelmap(params.voxel_resolution, params.map_capacity, dev), first_frame)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return OdometryState(
        vmap=vmap, T_world=eye, T_delta=eye, num_frames=torch.ones((), dtype=torch.int32, device=dev)
    )


def _register(state: OdometryState, frame: Frame, params: OdometryParams, T_pred_delta):
    """-> (T_new, T_delta, LMResult): scan-to-map LM from the prediction."""
    delta_pred = state.T_delta if T_pred_delta is None else T_pred_delta
    T_pred = state.T_world @ delta_pred
    factor = VGICPFactor(
        voxelmap=state.vmap,
        source=frame,
        fixed_target_pose=torch.eye(4, dtype=torch.float32, device=T_pred.device),
        target_key=-1,
        source_key=0,
        min_voxel_points=params.min_voxel_points,
    )
    res: LMResult = optimize_lm(FactorGraph([factor], num_poses=1), T_pred[None], _lm_params(params))
    T_new = res.poses[0]
    T_new = torch.where(torch.all(torch.isfinite(T_new)), T_new, T_pred)
    T_delta = se3.se3_inverse(state.T_world) @ T_new
    return T_new, T_delta, res


def odometry_register(state: OdometryState, frame: Frame, params: OdometryParams, T_pred_delta=None):
    """Registration half of the odometry step -> (T_new, T_delta, diagnostics)."""
    T_new, T_delta, res = _register(state, frame, params, T_pred_delta)
    return T_new, T_delta, {"error": res.error, "iterations": res.status.num_iterations}


def odometry_step(
    state: OdometryState,
    frame: Frame,
    params: OdometryParams,
    T_pred_delta=None,
    clusters=None,
):
    """VGICP scan-to-map odometry step -> (new_state, T_world, diagnostics).
    `T_pred_delta` optionally overrides the constant-velocity prediction."""
    if clusters is not None:
        raise NotImplementedError("the cluster path of odometry_step is not ported yet")
    T_new, T_delta, res = _register(state, frame, params, T_pred_delta)

    xi = se3.se3_log(T_delta)
    moved = (
        (torch.linalg.norm(xi[3:]) > params.keyframe_trans)
        | (torch.linalg.norm(xi[:3]) > params.keyframe_rot)
        | (state.num_frames <= 1)
    )
    inserted = bool(moved.item())
    full_merge = False
    vmap_new = state.vmap
    if inserted:
        world_frame = transform_frame(T_new, frame)
        vmap_new, overflow = insert_frame_incremental(state.vmap, world_frame, params.scan_cells_capacity)
        full_merge = bool(overflow.item())
        if full_merge:
            vmap_new = insert_frame(state.vmap, world_frame)
    new_state = OdometryState(
        vmap=vmap_new, T_world=T_new, T_delta=T_delta, num_frames=state.num_frames + 1
    )
    diag = {
        "error": res.error,
        "iterations": res.status.num_iterations,
        "inserted": inserted,
        "full_merge": full_merge,
    }
    return new_state, T_new, diag


def make_odometry_stepper(params: OdometryParams, device: DeviceLike = None):
    """The streaming step fn(state, frame, T_pred_delta=None) -> (new_state,
    T_world, diag) on `device` (default `cuda`). The state passed in stays
    valid: each step returns new map tensors."""
    dev = resolve_device(device)

    def step(state: OdometryState, frame: Frame, T_pred_delta=None, clusters=None):
        check_on(dev, state.T_world, frame.points)
        return odometry_step(state, frame, params, T_pred_delta, clusters)

    return step
