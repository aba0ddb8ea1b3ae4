"""Coarse-to-fine VGICP pyramid registration.

Port of gtsam_points_tpu/registration/pyramid.py. A fixed-iteration
Gauss-Newton schedule runs over a pyramid of Gaussian voxel maps: coarse
leaves widen the basin, the fine leaf sharpens the optimum. Early stages
register a fixed-stride subset of the source and only the last one the whole
cloud. Each stage probes the map afresh (`refresh` rounds, every iteration by
default) and runs the unary linearize K1 (ops/fused_linearize.py) on every
Gauss-Newton iteration.

Two parts of the reference's signature change:

- There is no `use_pallas`. The one route is `linearize_vgicp_unary`: K1's
  Hopper kernel on CUDA tensors, its plain PyTorch version on CPU tensors.
  The reference's `use_pallas=False` route is its XLA twin; here that twin is
  the plain version, which never runs on the card's path.
- There is no `jax.vmap` counterpart. Multi-hypothesis registration is a
  Python loop over the initial poses in the caller.

The pose stays on the device through the whole schedule: no value is read to
the host between iterations. Each stage's strided planes are made contiguous
once, before its iterations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.ops import fused_linearize
from gtsam_points_tpu_torch.ops.voxelmap import GaussianVoxelMap, build_voxelmap
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3
from gtsam_points_tpu_torch.utils.solve6 import solve6


class PyramidStage(NamedTuple):
    """One coarse-to-fine stage: voxel `leaf` size, `iters` Gauss-Newton
    iterations, source subsampling `stride` (1 = all points), and `refresh` =
    number of correspondence probes in the stage (iters split between them;
    0, the default, probes before every iteration)."""

    leaf: float
    iters: int
    stride: int = 1
    refresh: int = 0


# The reference's schedules: basin capture on a stride-8 subset at leaf 4,
# then refinement at stride 4 -> 2 -> 1; QUALITY_STAGES trades time for a
# tighter worst case.
DEFAULT_STAGES: Tuple[PyramidStage, ...] = (
    PyramidStage(4.0, 2, stride=8),
    PyramidStage(1.0, 2, stride=4),
    PyramidStage(1.0, 1, stride=2),
    PyramidStage(1.0, 1, stride=1),
)

QUALITY_STAGES: Tuple[PyramidStage, ...] = (
    PyramidStage(4.0, 2, stride=4),
    PyramidStage(2.0, 1, stride=2),
    PyramidStage(1.0, 2, stride=2),
    PyramidStage(1.0, 2, stride=1),
)

StageSpec = Union[PyramidStage, Tuple[float, int]]


def _norm_stages(stages: Sequence[StageSpec]) -> Tuple[PyramidStage, ...]:
    """Accept legacy (leaf, iters) pairs alongside PyramidStage."""
    return tuple(s if isinstance(s, PyramidStage) else PyramidStage(*s) for s in stages)


def build_pyramid(
    target: Frame, stages: Sequence[StageSpec] = DEFAULT_STAGES, device: DeviceLike = None
) -> Tuple[GaussianVoxelMap, ...]:
    """One voxel map per stage, coarse to fine, on `device` (default `cuda`;
    the frame must lie there)."""
    check_on(resolve_device(device), target.points)
    return tuple(build_voxelmap(target, s.leaf) for s in _norm_stages(stages))


def _source_planar(source: Frame):
    """(points [3, N], covs6 [6, N] or None) as planar views."""
    pts_p = source.points.T
    covs6 = None
    if source.covs is not None:
        c = source.covs
        covs6 = torch.stack([c[:, 0, 0], c[:, 0, 1], c[:, 0, 2], c[:, 1, 1], c[:, 1, 2], c[:, 2, 2]])
    return pts_p, covs6


def register_scan_pyramid(
    maps: Sequence[GaussianVoxelMap],
    source: Frame,
    T0: torch.Tensor,
    stages: Sequence[StageSpec] = DEFAULT_STAGES,
    min_voxel_points: float = 1.0,
    damping: float = 1e-6,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Register `source` against the pyramid from the initial pose T0 [4, 4].

    `maps` from build_pyramid (aligned with `stages`). Uses GICP fused
    covariances when `source.covs` is present, eps-regularized
    point-to-distribution otherwise. Every Gauss-Newton iteration runs
    `linearize_vgicp_unary`: K1 on CUDA tensors, its plain version only on CPU
    tensors (there is no `use_pallas` switch). For several initial poses, call
    once per pose. Runs on `device` (default `cuda`), where the maps, the
    source and T0 must lie. -> refined T [4, 4]."""
    dev = resolve_device(device)
    check_on(dev, source.points, T0, *(vm.table for vm in maps))
    stages = _norm_stages(stages)
    pts_all, covs_all = _source_planar(source)
    damp = damping * torch.eye(6, dtype=torch.float32, device=pts_all.device)
    T = T0.to(torch.float32).contiguous()
    for vm, st in zip(maps, stages):
        pts = pts_all[:, :: st.stride].contiguous()
        covs6 = None if covs_all is None else covs_all[:, :: st.stride].contiguous()
        mask = source.mask[:: st.stride]
        refresh = st.refresh if st.refresh > 0 else st.iters
        # spread iters over the probe rounds without exceeding the schedule:
        # the first (iters % refresh) rounds run one extra iteration
        base_iters, extra_rounds = divmod(st.iters, refresh)
        for r in range(refresh):
            momT, found = fused_linearize.probe_moments(vm, pts, mask, T)
            for _ in range(base_iters + (1 if r < extra_rounds else 0)):
                lin = fused_linearize.linearize_vgicp_unary(
                    pts, momT, found, T, min_voxel_points, src_covs6=covs6
                )
                xi = solve6(lin.H_ss + damp, lin.b_s)
                T = T @ se3.se3_exp(xi)
    return T


def register_pair_pyramid(
    target: Frame,
    source: Frame,
    T0: Optional[torch.Tensor] = None,
    stages: Sequence[StageSpec] = DEFAULT_STAGES,
    min_voxel_points: float = 1.0,
    device: DeviceLike = None,
) -> torch.Tensor:
    """One-call pair registration: builds the pyramid, then registers from T0
    (identity when None). For repeated sources against one target, call
    build_pyramid once and register_scan_pyramid per source."""
    stages = _norm_stages(stages)
    maps = build_pyramid(target, stages, device)
    if T0 is None:
        T0 = torch.eye(4, dtype=torch.float32, device=target.device)
    return register_scan_pyramid(maps, source, T0, stages, min_voxel_points, device=device)
