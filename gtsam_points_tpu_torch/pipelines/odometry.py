"""Scan-to-map VGICP odometry.

Port of gtsam_points_tpu/pipelines/odometry.py: predict with constant
velocity, register the scan against the voxel map in the LM, then insert the
scan into the map when the keyframe gate opens — incrementally, or with the
structural `insert_frame` when the incremental insert overflows. The
reference's two `lax.cond`s (keyframe gate, overflow fallback) are Python
branches on values read from the device: they choose between inserts of
different shapes.

Two sources: the scan's points (`clusters=None`: a `VGICPFactor`, K3; the
incremental point insert), or its clusters (`clusters=` the scan's
`SourceClusters` in the sensor frame, from registration/cluster.py's
`cluster_source` at the map's leaf: a `VGICPClustersFactor`, K1 with
weights; `insert_clusters_incremental`).

`make_odometry_stepper` on a CUDA device is the counterpart of the
reference's `jax.jit(odometry_step)`: the registration (prediction, every LM
iteration, the finite guard) is one CUDA graph, captured at the first step
and replayed once a step with no host read; the gate and the insert stay
eager. `odometry_step` is the eager step, the counterpart of the un-jitted
reference function.

`frame_to_frame_step` is the GICP frame-to-frame step: the new frame
registered against the previous one through a unary `GICPFactor` (K3),
eagerly through `optimize_lm`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.factors.gicp import GICPFactor
from gtsam_points_tpu_torch.factors.vgicp import VGICPClustersFactor, VGICPFactor
from gtsam_points_tpu_torch.ops import fused_linearize
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid
from gtsam_points_tpu_torch.ops.voxelmap import (
    GaussianVoxelMap,
    empty_voxelmap,
    insert_frame,
    insert_frame_incremental,
)
from gtsam_points_tpu_torch.optim.graph import FactorGraph
from gtsam_points_tpu_torch.optim.lm import LMParams, LMResult, LMStatus, optimize_lm, optimize_lm_unrolled
from gtsam_points_tpu_torch.registration.cluster import SourceClusters, insert_clusters_incremental
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
    full_insert_miss_fraction: float = 0.05  # as in the reference; read by neither package
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


def _register(vmap: GaussianVoxelMap, T_world, delta_pred, source, params: OdometryParams, optimize=optimize_lm):
    """-> (T_new, T_delta, LMResult): scan-to-map LM from T_world @ delta_pred
    on `source`, a frame's points or its `SourceClusters`. It reads only
    `vmap.table` and `vmap.leaf` of the map."""
    T_pred = T_world @ delta_pred
    common = dict(
        voxelmap=vmap,
        fixed_target_pose=torch.eye(4, dtype=torch.float32, device=T_pred.device),
        target_key=-1,
        source_key=0,
        min_voxel_points=params.min_voxel_points,
    )
    if isinstance(source, SourceClusters):
        factor = VGICPClustersFactor(clusters=source, **common)
    else:
        factor = VGICPFactor(source=source, **common)
    res: LMResult = optimize(FactorGraph([factor], num_poses=1), T_pred[None], _lm_params(params))
    T_new = res.poses[0]
    T_new = torch.where(torch.all(torch.isfinite(T_new)), T_new, T_pred)
    T_delta = se3.se3_inverse(T_world) @ T_new
    return T_new, T_delta, res


def _delta_pred(state: OdometryState, T_pred_delta):
    return state.T_delta if T_pred_delta is None else T_pred_delta


def odometry_register(state: OdometryState, frame: Frame, params: OdometryParams, T_pred_delta=None):
    """Registration half of the odometry step -> (T_new, T_delta, diagnostics)."""
    T_new, T_delta, res = _register(state.vmap, state.T_world, _delta_pred(state, T_pred_delta), frame, params)
    return T_new, T_delta, {"error": res.error, "iterations": res.status.num_iterations}


def _insert(state: OdometryState, frame: Frame, params: OdometryParams, T_new, T_delta, res: LMResult,
            clusters: Optional[SourceClusters] = None):
    """The step's second half: the keyframe gate, then the insert (of the
    clusters when given) -> (new_state, T_world, diag). Two host reads: the
    gate and the overflow. On overflow the frame's points take the
    structural `insert_frame`, with or without clusters."""
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
        if clusters is None:
            world_frame = transform_frame(T_new, frame)
            vmap_new, overflow = insert_frame_incremental(state.vmap, world_frame, params.scan_cells_capacity)
        else:
            vmap_new, overflow = insert_clusters_incremental(state.vmap, clusters, T_new)
        full_merge = bool(overflow.item())
        if full_merge:
            vmap_new = insert_frame(state.vmap, transform_frame(T_new, frame))
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


def odometry_step(
    state: OdometryState,
    frame: Frame,
    params: OdometryParams,
    T_pred_delta=None,
    clusters=None,
):
    """VGICP scan-to-map odometry step -> (new_state, T_world, diagnostics).
    `T_pred_delta` optionally overrides the constant-velocity prediction.
    `clusters` (the frame's `SourceClusters`, sensor frame, at the map's
    leaf) switches registration and insert to the cluster path; they must
    lie on the state's device. Eager: the LM reads `done` from the device
    once an iteration."""
    if clusters is not None:
        check_on(state.T_world.device, *clusters)
    source = frame if clusters is None else clusters
    T_new, T_delta, res = _register(state.vmap, state.T_world, _delta_pred(state, T_pred_delta), source, params)
    return _insert(state, frame, params, T_new, T_delta, res, clusters)


class _GraphedRegister:
    """`_register` with all LM iterations (`optimize_lm_unrolled`) as one CUDA
    graph. Its inputs are static buffers that each call fills on the current
    stream: the map's probe table and leaf, T_world, the predicted motion,
    and the source's tensors (`tensors_of`). The graph holds the factor's
    planar views (or regularized cluster covariances) too, so they are
    formed from each call's source.

    The wrappers count their launches on the host, so a replay does not
    reach them: `fused_linearize` takes back what the capture counted of K3
    and K1, and each call counts those launches again as replayed."""

    def __init__(self, params: OdometryParams, state: OdometryState, source, delta_pred):
        self.params = params
        self.key = self.key_of(state, source)
        vmap = state.vmap
        self.table = vmap.table.clone()
        self.leaf = vmap.leaf.clone()
        self.buffers = [t.clone() for t in self.tensors_of(source)]
        if isinstance(source, SourceClusters):
            self.source = SourceClusters(*self.buffers)
        else:
            self.source = Frame(*self.buffers[:2], covs=self.buffers[2] if len(self.buffers) > 2 else None)
        self.T_world = state.T_world.clone()
        self.delta_pred = delta_pred.clone()
        dev = self.table.device
        # the map's other fields are not read by the LM: empty, so a read fails
        unread = torch.empty((0,), dtype=torch.int32, device=dev)
        self.vmap = GaussianVoxelMap(
            leaf=self.leaf, keys=unread, moments=unread.float(), last_seen=unread, epoch=unread,
            num_voxels=unread, table=self.table,
        )

        # warm-up on a side stream, as torch.cuda.graph asks: it also makes
        # the index tensors the wrappers build at first use, host-to-device
        # copies that a capturing stream refuses
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(dev).wait_stream(side)

        self.graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(self.graph):
                self.out = self._body()

        self.recorded = fused_linearize.captured_launches(capture)

    @staticmethod
    def tensors_of(source) -> tuple:
        """The source's tensors that the LM reads: the four cluster fields,
        or the frame's points, mask and covariances (when it has them)."""
        if isinstance(source, SourceClusters):
            return tuple(source)
        return (source.points, source.mask) + (() if source.covs is None else (source.covs,))

    @staticmethod
    def key_of(state: OdometryState, source):
        return (type(source), source.capacity, len(_GraphedRegister.tensors_of(source)),
                tuple(state.vmap.table.shape), state.T_world.device)

    def _body(self):
        return _register(self.vmap, self.T_world, self.delta_pred, self.source, self.params, optimize_lm_unrolled)

    def __call__(self, state: OdometryState, source, delta_pred):
        """-> (T_new, T_delta, LMResult), cloned out of the graph's memory,
        which the next replay overwrites."""
        self.table.copy_(state.vmap.table)
        self.leaf.copy_(state.vmap.leaf)
        for buf, t in zip(self.buffers, self.tensors_of(source)):
            buf.copy_(t)
        self.T_world.copy_(state.T_world)
        self.delta_pred.copy_(delta_pred)
        self.graph.replay()
        fused_linearize.replayed(self.recorded)
        T_new, T_delta, res = self.out
        status = LMStatus(*(t.clone() for t in res.status))
        return T_new.clone(), T_delta.clone(), LMResult(res.poses.clone(), res.error.clone(), status)


def make_odometry_stepper(params: OdometryParams, donate: bool = True, *, device: DeviceLike = None):
    """The streaming step fn(state, frame, T_pred_delta=None, clusters=None)
    -> (new_state, T_world, diag) on `device` (default `cuda`).

    On a CUDA device the registration is one CUDA graph, captured at the
    first step (again when the map's table shape or the device changes, when
    clusters come or go, or when the frame's capacity and covariances or the
    clusters' capacity change) and replayed once a step: it runs all LM
    iterations, so its poses equal `odometry_step`'s, and reads nothing from
    the device. A failed capture or replay raises. On the CPU the step is
    `odometry_step`.

    `donate` is the reference's signature; it does nothing here. The
    reference donates the state's buffers to XLA; this stepper never
    aliases the caller's state (the graph fills buffers of its own, and the
    insert returns new map tensors), so the state passed in stays valid."""
    del donate
    dev = resolve_device(device)
    graphed: Optional[_GraphedRegister] = None

    def step(state: OdometryState, frame: Frame, T_pred_delta=None, clusters: Optional[SourceClusters] = None):
        nonlocal graphed
        check_on(dev, state.T_world, frame.points, *(clusters or ()))
        if dev.type != "cuda":
            return odometry_step(state, frame, params, T_pred_delta, clusters)
        delta_pred = _delta_pred(state, T_pred_delta)
        source = frame if clusters is None else clusters
        if graphed is None or graphed.key != _GraphedRegister.key_of(state, source):
            graphed = None  # free the old graph's memory before capturing anew
            graphed = _GraphedRegister(params, state, source, delta_pred)
        T_new, T_delta, res = graphed(state, source, delta_pred)
        return _insert(state, frame, params, T_new, T_delta, res, clusters)

    return step


class FrameToFrameState(NamedTuple):
    prev: Frame
    prev_grid_points: torch.Tensor  # as the reference keeps it; the grid rides with the factor
    T_world: torch.Tensor
    T_delta: torch.Tensor


def frame_to_frame_step(prev_frame: Frame, prev_grid: HashGrid, T_world: torch.Tensor, T_delta: torch.Tensor,
                        max_iterations: int, frame: Frame):
    """GICP frame-to-frame odometry step: registers `frame` against
    `prev_frame` (with its prebuilt grid) from the constant-velocity
    prediction `T_delta` -> (T_world_new, T_delta_new, error). Both frames
    need covariances and lie on one device, which the step runs on; the LM
    reads `done` from the device once an iteration."""
    check_on(frame.device, prev_frame.points, prev_grid.cell_records, T_world, T_delta)
    factor = GICPFactor(
        target=prev_frame,
        source=frame,
        grid=prev_grid,
        fixed_target_pose=torch.eye(4, dtype=torch.float32, device=frame.device),
        target_key=-1,
        source_key=0,
        max_corr_dist=2.0,
        num_neighbor_cells=27,
        max_points_per_cell=prev_grid.points_per_cell,
    )
    graph = FactorGraph([factor], num_poses=1)
    res = optimize_lm(graph, T_delta[None], LMParams(max_iterations=max_iterations, max_inner_iterations=5))
    delta = torch.where(torch.all(torch.isfinite(res.poses[0])), res.poses[0], T_delta)
    return T_world @ delta, delta, res.error
