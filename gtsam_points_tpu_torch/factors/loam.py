"""LOAM-style edge and plane matching-cost factors.

Port of gtsam_points_tpu/factors/loam.py. Edge points match their 2 nearest
target edge points (point-to-line distance); plane points match their 3
nearest target plane points (point-to-plane distance through the three).
Both search the port's hash grid (the neighbours in the reference's order,
ties by the lower index) and linearize through `linearize_residuals` by
forward-mode AD, as the reference does: no Pallas kernel is on this path.
`enable_correspondence_validation` rejects neighbours that lie on one LiDAR
scan line (their vertical angles within 0.1 degree).

`LOAMFactor` has `linearize` and `error` and no `linearize_with_error_fn`,
as in the reference, so the graph scores the LM's candidates with `error`,
which searches the correspondences again at each candidate. The reference's
`knn_search` ignores `max_points_per_cell` and its grids keep the default 16
points a cell; the port does the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from gtsam_points_tpu_torch._device import check_on
from gtsam_points_tpu_torch.factors.base import MatchingFactorMixin
from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid, build_hash_grid, knn_search
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3

_EPS = 1e-6
# the scan-line separation: 0.1 degree of vertical angle
_SAME_SCAN_LINE = 0.1 * math.pi / 180.0


def _vertical_angle(p: torch.Tensor) -> torch.Tensor:
    """Elevation atan2(z, |xy|) of each point, the proxy of its scan line."""
    return torch.atan2(p[..., 2], torch.linalg.norm(p[..., :2], dim=-1))


class _LOAMBase(MatchingFactorMixin):
    def _neighbors(self, T_t: torch.Tensor, T_s: torch.Tensor, k: int):
        """The k nearest target points of each moved source point -> ([N, 3]
        each, all k valid [N])."""
        moved = se3.transform_points(se3.se3_inverse(T_t) @ T_s, self.source.points)
        idx, _, valid = knn_search(self.grid, moved, self.source.mask, k=k,
                                   num_neighbor_cells=self.num_neighbor_cells, max_sq_dist=self.max_corr_dist**2)
        pts = [self.target.points[torch.clamp(idx[:, j], min=0).long()] for j in range(k)]
        return pts, torch.all(valid, dim=-1)

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """E at poses [..., P, 4, 4] -> [...], the correspondences searched
        at each set of poses."""
        if poses.dim() == 3:
            return MatchingFactorMixin.error(self, poses)
        flat = poses.reshape((-1,) + poses.shape[-3:])
        return torch.stack([MatchingFactorMixin.error(self, p) for p in flat]).reshape(poses.shape[:-3])


@dataclasses.dataclass(frozen=True)
class PointToEdgeFactor(_LOAMBase):
    """Point to line: r = (p - a) x d / |d|, (a, b) the 2 nearest target edge
    points, d = b - a. With validate_scan_lines, a pair on one scan line (a
    degenerate edge) is rejected."""

    target: Frame
    source: Frame
    grid: HashGrid
    fixed_target_pose: torch.Tensor
    target_key: int
    source_key: int
    max_corr_dist: float
    num_neighbor_cells: int
    max_points_per_cell: int
    validate_scan_lines: bool = False

    def residual_closure(self, T_t: torch.Tensor, T_s: torch.Tensor):
        (a, b), ok = self._neighbors(T_t, T_s, 2)
        if self.validate_scan_lines:
            ok = ok & (torch.abs(_vertical_angle(a) - _vertical_angle(b)) >= _SAME_SCAN_LINE)
        d = b - a
        dn = torch.linalg.norm(d, dim=-1, keepdim=True)
        ok = ok & (dn[:, 0] > _EPS)
        d_unit = d / torch.clamp(dn, min=_EPS)

        def residual_fn(T_t_p, T_s_p):
            p = se3.transform_points(se3.se3_inverse(T_t_p) @ T_s_p, self.source.points)
            return torch.linalg.cross(p - a, d_unit.expand(p.shape), dim=-1), None, ok

        return residual_fn


@dataclasses.dataclass(frozen=True)
class PointToPlaneLOAMFactor(_LOAMBase):
    """Point to plane: r = n·(p - a) / |n|, n = (b - a) x (c - a), (a, b, c)
    the 3 nearest target plane points. With validate_scan_lines, three
    points on one scan line are rejected."""

    target: Frame
    source: Frame
    grid: HashGrid
    fixed_target_pose: torch.Tensor
    target_key: int
    source_key: int
    max_corr_dist: float
    num_neighbor_cells: int
    max_points_per_cell: int
    validate_scan_lines: bool = False

    def residual_closure(self, T_t: torch.Tensor, T_s: torch.Tensor):
        (a, b, c), ok = self._neighbors(T_t, T_s, 3)
        if self.validate_scan_lines:
            va, vb, vc = _vertical_angle(a), _vertical_angle(b), _vertical_angle(c)
            ok = ok & ~((torch.abs(va - vb) < _SAME_SCAN_LINE) & (torch.abs(va - vc) < _SAME_SCAN_LINE))
        n = torch.linalg.cross(b - a, c - a, dim=-1)
        nn = torch.linalg.norm(n, dim=-1, keepdim=True)
        ok = ok & (nn[:, 0] > _EPS)
        n_unit = n / torch.clamp(nn, min=_EPS)

        def residual_fn(T_t_p, T_s_p):
            p = se3.transform_points(se3.se3_inverse(T_t_p) @ T_s_p, self.source.points)
            return torch.sum((p - a) * n_unit, dim=-1, keepdim=True), None, ok

        return residual_fn


@dataclasses.dataclass(frozen=True)
class LOAMFactor:
    """The edge and the plane factor of one scan pair, summed."""

    edge: PointToEdgeFactor
    plane: PointToPlaneLOAMFactor
    target_key: int
    source_key: int

    @property
    def keys(self):
        return (self.target_key, self.source_key)

    def linearize(self, poses: torch.Tensor) -> Linearized:
        le, lp = self.edge.linearize(poses), self.plane.linearize(poses)
        return Linearized(*[a + b for a, b in zip(le, lp)])

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        return self.edge.error(poses) + self.plane.error(poses)


def make_loam_factor(
    target_key: int,
    source_key: int,
    target_edges: Frame,
    target_planes: Frame,
    source_edges: Frame,
    source_planes: Frame,
    max_corr_dist: float = 2.0,
    grid_leaf: float = 1.0,
    num_neighbor_cells: int = 27,
    max_points_per_cell: int = 16,
    fixed_target_pose: Optional[torch.Tensor] = None,
    enable_correspondence_validation: bool = False,
) -> LOAMFactor:
    """Both target clouds' grids built at `grid_leaf`, on the frames'
    device."""
    dev = source_edges.device
    check_on(dev, target_edges.points, target_planes.points, source_planes.points, fixed_target_pose)
    if fixed_target_pose is None:
        fixed_target_pose = torch.eye(4, dtype=torch.float32, device=dev)
    common = dict(fixed_target_pose=fixed_target_pose, target_key=target_key, source_key=source_key,
                  max_corr_dist=max_corr_dist, num_neighbor_cells=num_neighbor_cells,
                  max_points_per_cell=max_points_per_cell, validate_scan_lines=enable_correspondence_validation)
    edge = PointToEdgeFactor(target=target_edges, source=source_edges,
                             grid=build_hash_grid(target_edges.points, target_edges.mask, grid_leaf), **common)
    plane = PointToPlaneLOAMFactor(target=target_planes, source=source_planes,
                                   grid=build_hash_grid(target_planes.points, target_planes.mask, grid_leaf), **common)
    return LOAMFactor(edge=edge, plane=plane, target_key=target_key, source_key=source_key)
