"""VGICP: voxelized GICP of a source frame against a Gaussian voxel map.

Port of `VGICPFactor` and `make_vgicp_factor` in
gtsam_points_tpu/factors/vgicp.py. Correspondence is one voxel probe per
source point; the cost is the GICP distribution-to-distribution distance
against the voxel's mean and covariance. The linearization on a frozen
correspondence set runs the fused K3 kernel (ops/fused_linearize.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from gtsam_points_tpu_torch.factors.base import MatchingFactorMixin, factor_poses
from gtsam_points_tpu_torch.ops import fused_linearize, planar
from gtsam_points_tpu_torch.ops.voxelmap import GaussianVoxelMap, build_voxelmap, lookup_fetch_planar
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3


@dataclasses.dataclass(frozen=True)
class VGICPFactor(MatchingFactorMixin):
    voxelmap: GaussianVoxelMap
    source: Frame
    fixed_target_pose: torch.Tensor
    target_key: int
    source_key: int
    min_voxel_points: float

    @functools.cached_property
    def _source_planar(self):
        """(points [3, N], covs6 [6, N] or None), contiguous planar views."""
        pts_p = self.source.points.T.contiguous()
        c = self.source.covs
        if c is None:
            return pts_p, None
        covs6 = torch.stack([c[:, 0, 0], c[:, 0, 1], c[:, 0, 2], c[:, 1, 1], c[:, 1, 2], c[:, 2, 2]])
        return pts_p, covs6

    def _delta(self, poses: torch.Tensor) -> torch.Tensor:
        T_t, T_s = factor_poses(self, poses)
        return se3.se3_inverse(T_t) @ T_s

    def correspondences(self, poses: torch.Tensor):
        """Voxel probe + fused Mahalanobis weights at `poses`.
        -> (found [N], mu [3, N], W6 [6, N])."""
        pts_p, covs6 = self._source_planar
        delta = self._delta(poses)
        pm = planar.transform(delta, pts_p)
        found, count, mu, C6 = lookup_fetch_planar(self.voxelmap, pm, self.source.mask)
        found = found & (count >= self.min_voxel_points)
        if covs6 is not None:
            fused = C6 + planar.sym_rotate(delta[:3, :3], covs6)
        else:
            e = torch.full_like(C6[0, :1], 1e-3)  # 1e-3 I in planar form
            z = torch.zeros_like(e)
            fused = C6 + torch.stack([e, z, z, e, z, e])
        return found, mu, planar.sym_inv(fused)

    def linearize_corr(self, poses: torch.Tensor, corr):
        """Linearization on a frozen correspondence set (K3), and the error
        function that scores candidate poses on the same set."""
        found, mu, W6 = corr
        pts_p, _ = self._source_planar
        lin = fused_linearize.linearize_fused(pts_p, mu, W6, found, self._delta(poses))

        def err_fn(new_poses):
            return fused_linearize.error_fused(pts_p, mu, W6, found, self._delta(new_poses))

        return lin, err_fn

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        found, mu, W6 = self.correspondences(poses)
        pts_p, _ = self._source_planar
        pm = planar.transform(self._delta(poses), pts_p)
        return planar.weighted_error(pm - mu, W6, found)


def make_vgicp_factor(
    target_key: int,
    source_key: int,
    target,
    source: Frame,
    voxel_resolution: float = 1.0,
    min_voxel_points: float = 5.0,
    fixed_target_pose: Optional[torch.Tensor] = None,
) -> VGICPFactor:
    """`target` may be a Frame (its voxel map is built here) or a GaussianVoxelMap."""
    vmap = target if isinstance(target, GaussianVoxelMap) else build_voxelmap(target, voxel_resolution)
    if fixed_target_pose is None:
        fixed_target_pose = torch.eye(4, dtype=torch.float32, device=source.device)
    return VGICPFactor(
        voxelmap=vmap,
        source=source,
        fixed_target_pose=fixed_target_pose,
        target_key=target_key,
        source_key=source_key,
        min_voxel_points=min_voxel_points,
    )
