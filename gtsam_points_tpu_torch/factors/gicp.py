"""GICP: distribution-to-distribution matching-cost factor.

Port of `GICPFactor` and `make_gicp_factor` in
gtsam_points_tpu/factors/gicp.py. Correspondence is the 1-NN of each moved
source point in the target's hash grid (ops/hash_grid.py); the per-point
Mahalanobis weight W_i = (C_target_i + R C_source_i Rᵀ)⁻¹ is formed at the
linearization point and frozen. The residual r = delta·p - q is affine in
the moved point, so the linearization on a frozen correspondence set is K3
(`fused_linearize.linearize_fused`: the kernel on CUDA tensors, its plain
version on CPU tensors), binary or unary.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from gtsam_points_tpu_torch._device import check_on
from gtsam_points_tpu_torch.factors.base import MatchingFactorMixin, relative_pose
from gtsam_points_tpu_torch.factors.linearized import inv3x3
from gtsam_points_tpu_torch.ops import fused_linearize
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid, build_hash_grid, knn_search
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3


def nearest_in_grid(factor, delta: torch.Tensor):
    """1-NN of the source points moved by `delta` in the factor's target
    grid, within max_corr_dist -> (index [N] clamped to 0, valid [N])."""
    moved = se3.transform_points(delta, factor.source.points)
    idx, _, valid = knn_search(
        factor.grid,
        moved,
        factor.source.mask,
        k=1,
        num_neighbor_cells=factor.num_neighbor_cells,
        max_points_per_cell=factor.max_points_per_cell,
        max_sq_dist=factor.max_corr_dist**2,
    )
    return torch.clamp(idx[:, 0], min=0).long(), valid[:, 0]


def linearize_k3(factor, poses: torch.Tensor, corr):
    """K3 on the factor's inputs for a frozen correspondence set at `poses`
    (`factor.k3_inputs`), and the error function that scores candidate
    poses on the same set."""
    pts_p, q_p, W6, valid, delta = factor.k3_inputs(poses, corr)
    lin = fused_linearize.linearize_fused(pts_p, q_p, W6, valid, delta)

    def err_fn(new_poses):
        return fused_linearize.error_fused(pts_p, q_p, W6, valid, relative_pose(factor, new_poses))

    return lin, err_fn


@dataclasses.dataclass(frozen=True)
class GICPFactor(MatchingFactorMixin):
    target: Frame
    source: Frame
    grid: HashGrid
    fixed_target_pose: torch.Tensor
    target_key: int
    source_key: int
    max_corr_dist: float
    num_neighbor_cells: int
    max_points_per_cell: int

    @functools.cached_property
    def _source_planar(self) -> torch.Tensor:
        return self.source.points.T.contiguous()

    def _weights(self, corr: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """W = (C_t + R C_s Rᵀ)⁻¹ per point [N, 3, 3]."""
        R = delta[:3, :3]
        fused = self.target.covs[corr] + torch.einsum("ij,njk,lk->nil", R, self.source.covs, R)
        return inv3x3(fused)

    def residual_closure(self, T_t: torch.Tensor, T_s: torch.Tensor):
        delta = se3.se3_inverse(T_t) @ T_s
        corr, valid = nearest_in_grid(self, delta)
        q = self.target.points[corr]
        W = self._weights(corr, delta)

        def residual_fn(T_t_p, T_s_p):
            d = se3.se3_inverse(T_t_p) @ T_s_p
            return se3.transform_points(d, self.source.points) - q, W, valid

        return residual_fn

    def correspondences(self, poses: torch.Tensor):
        """1-NN correspondences and frozen weights at `poses` -> (valid [N],
        q [3, N], W6 [6, N]) in planar layout, the payload K3 reads."""
        delta = relative_pose(self, poses)
        corr, valid = nearest_in_grid(self, delta)
        W = self._weights(corr, delta)
        W6 = torch.stack([W[:, 0, 0], W[:, 0, 1], W[:, 0, 2], W[:, 1, 1], W[:, 1, 2], W[:, 2, 2]])
        return valid.contiguous(), self.target.points[corr].T.contiguous(), W6

    def k3_inputs(self, poses: torch.Tensor, corr):
        """K3's inputs on `corr` at `poses` -> (p [3, N], q [3, N], W6 [6, N],
        mask [N], delta [4, 4])."""
        valid, q_p, W6 = corr
        return self._source_planar, q_p, W6, valid, relative_pose(self, poses)

    def linearize_corr(self, poses: torch.Tensor, corr):
        return linearize_k3(self, poses, corr)

    def linearize(self, poses: torch.Tensor):
        return self.linearize_corr(poses, self.correspondences(poses))[0]

    def linearize_with_error_fn(self, poses: torch.Tensor):
        return self.linearize_corr(poses, self.correspondences(poses))


def make_gicp_factor(
    target_key: int,
    source_key: int,
    target: Frame,
    source: Frame,
    max_corr_dist: float = 5.0,
    grid: Optional[HashGrid] = None,
    grid_leaf: float = 1.0,
    num_neighbor_cells: int = 27,
    max_points_per_cell: int = 16,
    fixed_target_pose: Optional[torch.Tensor] = None,
    coarse_factor: Optional[int] = None,
) -> GICPFactor:
    """Builds the target's grid, keeping `max_points_per_cell` points a
    cell, when not given. Both frames need covariances and lie on one
    device, the factor's."""
    if target.covs is None or source.covs is None:
        raise ValueError("GICP requires per-point covariances on both frames")
    check_on(source.device, target.points, target.covs, source.covs, fixed_target_pose)
    if grid is None:
        grid = build_hash_grid(target.points, target.mask, grid_leaf, max_points_per_cell=max_points_per_cell,
                               coarse_factor=coarse_factor)
    if fixed_target_pose is None:
        fixed_target_pose = torch.eye(4, dtype=torch.float32, device=source.device)
    return GICPFactor(
        target=target,
        source=source,
        grid=grid,
        fixed_target_pose=fixed_target_pose,
        target_key=target_key,
        source_key=source_key,
        max_corr_dist=max_corr_dist,
        num_neighbor_cells=num_neighbor_cells,
        max_points_per_cell=max_points_per_cell,
    )
