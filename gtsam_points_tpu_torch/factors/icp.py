"""Point-to-point and point-to-plane ICP factors.

Port of `ICPFactor` and `make_icp_factor` in gtsam_points_tpu/factors/icp.py.
Correspondence is the 1-NN of each moved source point in the target's hash
grid. On a frozen correspondence set both modes are the weighted form
rᵀWr, r = delta·p - q, that K3 linearizes: W = I point to point, the rank-1
W = nnᵀ of the target normal point to plane.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from gtsam_points_tpu_torch._device import check_on
from gtsam_points_tpu_torch.factors.base import MatchingFactorMixin, relative_pose
from gtsam_points_tpu_torch.factors.gicp import linearize_k3, nearest_in_grid
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid, build_hash_grid
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3


def icp_weights(n: Optional[torch.Tensor], num: int, like: torch.Tensor) -> torch.Tensor:
    """W6 [6, N] of ICP: nnᵀ for normals n [N, 3], the identity for None."""
    if n is not None:
        x, y, z = n.T
        return torch.stack([x * x, x * y, x * z, y * y, y * z, z * z])
    one = like.new_ones((num,))
    zero = like.new_zeros((num,))
    return torch.stack([one, zero, zero, one, zero, one])


@dataclasses.dataclass(frozen=True)
class ICPFactor(MatchingFactorMixin):
    target: Frame
    source: Frame
    grid: HashGrid
    fixed_target_pose: torch.Tensor
    target_key: int
    source_key: int
    point_to_plane: bool
    max_corr_dist: float
    num_neighbor_cells: int
    max_points_per_cell: int

    @functools.cached_property
    def _source_planar(self) -> torch.Tensor:
        return self.source.points.T.contiguous()

    def correspondences(self, poses: torch.Tensor):
        """1-NN at `poses` -> (q [N, 3], n [N, 3] or None, valid [N])."""
        corr, valid = nearest_in_grid(self, relative_pose(self, poses))
        q = self.target.points[corr]
        n = self.target.normals[corr] if self.point_to_plane else None
        return q, n, valid.contiguous()

    def k3_inputs(self, poses: torch.Tensor, corr):
        """K3's inputs on `corr` at `poses` -> (p [3, N], q [3, N], W6 [6, N],
        mask [N], delta [4, 4])."""
        q, n, valid = corr
        W6 = icp_weights(n, q.shape[0], q)
        return self._source_planar, q.T.contiguous(), W6, valid, relative_pose(self, poses)

    def linearize_corr(self, poses: torch.Tensor, corr):
        return linearize_k3(self, poses, corr)

    def residual_closure(self, T_t: torch.Tensor, T_s: torch.Tensor):
        corr, valid = nearest_in_grid(self, se3.se3_inverse(T_t) @ T_s)
        q = self.target.points[corr]
        n = self.target.normals[corr] if self.point_to_plane else None

        def residual_fn(T_t_p, T_s_p):
            d = se3.se3_inverse(T_t_p) @ T_s_p
            r = se3.transform_points(d, self.source.points) - q
            if n is not None:
                r = torch.sum(r * n, dim=-1, keepdim=True)  # [..., N, 1]
            return r, None, valid

        return residual_fn


def make_icp_factor(
    target_key: int,
    source_key: int,
    target: Frame,
    source: Frame,
    point_to_plane: bool = False,
    max_corr_dist: float = 5.0,
    grid: Optional[HashGrid] = None,
    grid_leaf: float = 1.0,
    num_neighbor_cells: int = 27,
    max_points_per_cell: int = 16,
    fixed_target_pose: Optional[torch.Tensor] = None,
    coarse_factor: Optional[int] = None,
) -> ICPFactor:
    """Builds the target's grid, keeping `max_points_per_cell` points a
    cell, when not given (coarse_factor, e.g. 4, for sparse maps where
    correspondences lie several leaves away)."""
    if point_to_plane and target.normals is None:
        raise ValueError("point-to-plane ICP requires target normals")
    check_on(source.device, target.points, target.normals, fixed_target_pose)
    if grid is None:
        grid = build_hash_grid(target.points, target.mask, grid_leaf, max_points_per_cell=max_points_per_cell,
                               coarse_factor=coarse_factor)
    if fixed_target_pose is None:
        fixed_target_pose = torch.eye(4, dtype=torch.float32, device=source.device)
    return ICPFactor(
        target=target,
        source=source,
        grid=grid,
        fixed_target_pose=fixed_target_pose,
        target_key=target_key,
        source_key=source_key,
        point_to_plane=point_to_plane,
        max_corr_dist=max_corr_dist,
        num_neighbor_cells=num_neighbor_cells,
        max_points_per_cell=max_points_per_cell,
    )
