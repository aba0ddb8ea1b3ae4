"""VGICP: voxelized GICP of a source frame against a Gaussian voxel map.

Port of `VGICPFactor`, `make_vgicp_factor`, `VGICPClustersFactor` and
`make_vgicp_clusters_factor` in gtsam_points_tpu/factors/vgicp.py.
Correspondence is one voxel probe per source point (or cluster); the cost
is the GICP distribution-to-distribution distance against the voxel's mean
and covariance. The point factor's linearization on a frozen correspondence
set runs the fused K3 kernel, the cluster factor's runs K1 with weights
(ops/fused_linearize.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Optional

import torch

from gtsam_points_tpu_torch.factors.base import MatchingFactorMixin, relative_pose
from gtsam_points_tpu_torch.factors.gicp import linearize_k3
from gtsam_points_tpu_torch.factors.linearized import inv3x3
from gtsam_points_tpu_torch.ops import fused_linearize, planar
from gtsam_points_tpu_torch.ops.voxelmap import GaussianVoxelMap, build_voxelmap, lookup_fetch, lookup_fetch_planar
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3

if TYPE_CHECKING:  # registration/cluster.py imports ops that import this package
    from gtsam_points_tpu_torch.registration.cluster import SourceClusters


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

    def correspondences(self, poses: torch.Tensor):
        """Voxel probe + fused Mahalanobis weights at `poses`.
        -> (found [N], mu [3, N], W6 [6, N])."""
        pts_p, covs6 = self._source_planar
        delta = relative_pose(self, poses)
        pm = planar.transform(delta, pts_p)
        found, count, mu, C6 = lookup_fetch_planar(self.voxelmap, pm, self.source.mask)
        found = found & (count >= self.min_voxel_points)
        if covs6 is not None:
            fused = C6 + planar.sym_rotate(delta[:3, :3], covs6)
        else:
            fused = planar.sym_add_eye(C6, 1e-3)
        return found, mu, planar.sym_inv(fused)

    def k3_inputs(self, poses: torch.Tensor, corr):
        """K3's inputs on `corr` at `poses` -> (p [3, N], mu [3, N], W6 [6, N],
        mask [N], delta [4, 4])."""
        found, mu, W6 = corr
        return self._source_planar[0], mu, W6, found, relative_pose(self, poses)

    def linearize_corr(self, poses: torch.Tensor, corr):
        """Linearization on a frozen correspondence set (K3), and the error
        function that scores candidate poses on the same set."""
        return linearize_k3(self, poses, corr)

    def linearize(self, poses: torch.Tensor):
        """K3 on fresh correspondences at `poses`."""
        return self.linearize_corr(poses, self.correspondences(poses))[0]

    def linearize_with_error_fn(self, poses: torch.Tensor):
        return self.linearize_corr(poses, self.correspondences(poses))

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        found, mu, W6 = self.correspondences(poses)
        pts_p, _ = self._source_planar
        pm = planar.transform(relative_pose(self, poses), pts_p)
        return planar.weighted_error(pm - mu, W6, found)

    def residual_closure(self, T_t: torch.Tensor, T_s: torch.Tensor):
        """The AD path (`linearize_residuals` of the mixin's form): the
        reference the K3 path is held to in the tests."""
        delta = se3.se3_inverse(T_t) @ T_s
        moved = se3.transform_points(delta, self.source.points)
        found, count, mu, C_t = lookup_fetch(self.voxelmap, moved, self.source.mask)
        found = found & (count >= self.min_voxel_points)
        R = delta[:3, :3]
        if self.source.covs is not None:
            fused = C_t + torch.einsum("ij,njk,lk->nil", R, self.source.covs, R)
        else:
            fused = C_t + 1e-3 * torch.eye(3, dtype=C_t.dtype, device=C_t.device)
        W = inv3x3(fused)

        def residual_fn(T_t_p, T_s_p):
            d = se3.se3_inverse(T_t_p) @ T_s_p
            return se3.transform_points(d, self.source.points) - mu, W, found

        return residual_fn


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


@dataclasses.dataclass(frozen=True)
class VGICPClustersFactor(MatchingFactorMixin):
    """VGICP whose source is a clustered scan (registration/cluster.py
    `SourceClusters`): correspondence is one probe of the weighted cluster
    records instead of the scan's points, and the linearize and the error
    are the weighted unary path. Only the source block is formed: the target
    pose is meant to be fixed (target_key = -1 with fixed_target_pose, the
    scan-to-map odometry shape). With target_key >= 0 the target blocks are
    zero, as in the reference. `eps` regularizes the cluster covariances as
    `register_clusters_pyramid` does."""

    voxelmap: GaussianVoxelMap
    clusters: SourceClusters
    fixed_target_pose: torch.Tensor
    target_key: int
    source_key: int
    min_voxel_points: float
    eps: float = 1e-3

    @functools.cached_property
    def _cl_covs6(self) -> torch.Tensor:
        return planar.sym_add_eye(self.clusters.covs6, self.eps)

    def correspondences(self, poses: torch.Tensor):
        """Probe at `poses` -> (momT [10, C], found [C])."""
        cl = self.clusters
        return fused_linearize.probe_moments(self.voxelmap, cl.pts_p, cl.mask, relative_pose(self, poses))

    def _error(self, corr, delta: torch.Tensor) -> torch.Tensor:
        momT, found = corr
        cl = self.clusters
        return fused_linearize.vgicp_unary_error(
            cl.pts_p, momT, found, delta, self.min_voxel_points, src_covs6=self._cl_covs6, weights=cl.weight
        )[0]

    def linearize_corr(self, poses: torch.Tensor, corr):
        """Linearization on a frozen correspondence set (K1 with weights),
        and the error function that scores candidate poses on the same set."""
        momT, found = corr
        cl = self.clusters
        lin = fused_linearize.linearize_vgicp_unary(
            cl.pts_p, momT, found, relative_pose(self, poses), self.min_voxel_points,
            src_covs6=self._cl_covs6, weights=cl.weight,
        )

        def err_fn(new_poses):
            return self._error(corr, relative_pose(self, new_poses))

        return lin, err_fn

    def linearize(self, poses: torch.Tensor):
        return self.linearize_corr(poses, self.correspondences(poses))[0]

    def linearize_with_error_fn(self, poses: torch.Tensor):
        return self.linearize_corr(poses, self.correspondences(poses))

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        return self._error(self.correspondences(poses), relative_pose(self, poses))


def make_vgicp_clusters_factor(
    target_key: int,
    source_key: int,
    target,
    clusters: SourceClusters,
    voxel_resolution: float = 1.0,
    min_voxel_points: float = 5.0,
    fixed_target_pose: Optional[torch.Tensor] = None,
) -> VGICPClustersFactor:
    """`target` may be a Frame (its voxel map is built here) or a
    GaussianVoxelMap; `clusters` from registration.cluster.cluster_source
    (sensor frame)."""
    vmap = target if isinstance(target, GaussianVoxelMap) else build_voxelmap(target, voxel_resolution)
    if fixed_target_pose is None:
        fixed_target_pose = torch.eye(4, dtype=torch.float32, device=clusters.pts_p.device)
    return VGICPClustersFactor(
        voxelmap=vmap,
        clusters=clusters,
        fixed_target_pose=fixed_target_pose,
        target_key=target_key,
        source_key=source_key,
        min_voxel_points=min_voxel_points,
    )
