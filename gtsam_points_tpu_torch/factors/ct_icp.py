"""Continuous-time ICP / GICP factors (CT-ICP).

Port of gtsam_points_tpu/factors/ct_icp.py. Two pose keys, the scan's begin
and end; each source point is moved by the twist interpolation
T(t) = T0 · Exp(t · Log(T0⁻¹ T1)) at its normalized time before it is
matched in the target's hash grid. The whole interpolation chain is
differentiated by forward-mode AD through `linearize_residuals`, as the
reference does (its factor reaches no Pallas kernel, so the linearization is
plain PyTorch on every device). Three modes: point to point, point to plane
(target normals) and GICP (W = (C_t + R(t) C_s R(t)ᵀ)⁻¹ per point).

The reference's `knn_search` ignores `max_points_per_cell` and its
`make_ct_icp_factor` builds the grid with the default 16 points a cell, so
the port does the same: the field is kept and not read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gtsam_points_tpu_torch._device import check_on
from gtsam_points_tpu_torch.factors.base import MatchingFactorMixin
from gtsam_points_tpu_torch.factors.linearized import inv3x3
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid, build_hash_grid, knn_search
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3


def interpolate_poses(T0: torch.Tensor, T1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """T0 · Exp(t·Log(T0⁻¹T1)) for times t [N]: T0, T1 [..., 4, 4] ->
    [..., N, 4, 4]."""
    xi = se3.se3_log(se3.se3_inverse(T0) @ T1)
    return T0[..., None, :, :] @ se3.se3_exp(t[:, None] * xi[..., None, :])


def _move(Ts: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Each point [N, 3] by its own pose Ts [..., N, 4, 4]."""
    return torch.einsum("...nij,nj->...ni", Ts[..., :3, :3], points) + Ts[..., :3, 3]


def deskew(T0: torch.Tensor, T1: torch.Tensor, frame: Frame) -> Frame:
    """The frame's points motion-compensated into the scan-begin pose T0
    (its times normalized to [0, 1])."""
    Ts = interpolate_poses(T0, T1, frame.times)
    return frame.replace(points=_move(se3.se3_inverse(T0)[None] @ Ts, frame.points))


@dataclasses.dataclass(frozen=True)
class CTICPFactor(MatchingFactorMixin):
    """target_key: the scan-begin pose, source_key: the scan-end pose; both
    are always free (no unary mode)."""

    target: Frame
    source: Frame  # its times normalized to [0, 1]
    grid: HashGrid
    target_key: int
    source_key: int
    max_corr_dist: float
    num_neighbor_cells: int
    max_points_per_cell: int
    gicp: bool
    point_to_plane: bool

    def residual_closure(self, T0: torch.Tensor, T1: torch.Tensor):
        times = self.source.times
        Ts = interpolate_poses(T0, T1, times)
        idx, _, valid = knn_search(self.grid, _move(Ts, self.source.points), self.source.mask, k=1,
                                   num_neighbor_cells=self.num_neighbor_cells, max_sq_dist=self.max_corr_dist**2)
        corr = torch.clamp(idx[:, 0], min=0).long()
        ok = valid[:, 0]
        q = self.target.points[corr]
        W = n = None
        if self.gicp:
            R = Ts[:, :3, :3]
            W = inv3x3(self.target.covs[corr] + torch.einsum("nij,njk,nlk->nil", R, self.source.covs, R))
        elif self.point_to_plane:
            n = self.target.normals[corr]

        def residual_fn(T0p, T1p):
            r = _move(interpolate_poses(T0p, T1p, times), self.source.points) - q
            if n is not None:
                r = torch.sum(r * n, dim=-1, keepdim=True)
            return r, W, ok

        return residual_fn


def make_ct_icp_factor(
    begin_key: int,
    end_key: int,
    target: Frame,
    source: Frame,
    gicp: bool = False,
    point_to_plane: bool = False,
    max_corr_dist: float = 2.0,
    grid: Optional[HashGrid] = None,
    grid_leaf: float = 1.0,
    num_neighbor_cells: int = 27,
    max_points_per_cell: int = 16,
) -> CTICPFactor:
    """The source's times are normalized to [0, 1] over its valid points
    (0 in the padding); the target's grid is built unless given. On the
    frames' device."""
    if source.times is None:
        raise ValueError("CT-ICP requires per-point times on the source frame")
    if gicp and (target.covs is None or source.covs is None):
        raise ValueError("CT-GICP requires covariances on both frames")
    if point_to_plane and target.normals is None:
        raise ValueError("point-to-plane CT-ICP requires target normals")
    check_on(source.device, target.points, None if grid is None else grid.cell_points)
    tmin = torch.amin(torch.where(source.mask, source.times, float("inf")))
    tmax = torch.amax(torch.where(source.mask, source.times, float("-inf")))
    tnorm = (source.times - tmin) / torch.clamp(tmax - tmin, min=1e-9)
    source = source.replace(times=torch.where(source.mask, tnorm, 0.0))
    if grid is None:
        grid = build_hash_grid(target.points, target.mask, grid_leaf)
    return CTICPFactor(
        target=target,
        source=source,
        grid=grid,
        target_key=begin_key,
        source_key=end_key,
        max_corr_dist=max_corr_dist,
        num_neighbor_cells=num_neighbor_cells,
        max_points_per_cell=max_points_per_cell,
        gicp=gicp,
        point_to_plane=point_to_plane,
    )
