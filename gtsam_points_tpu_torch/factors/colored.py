"""Photometric (intensity) factors: color consistency and colored GICP.

Port of gtsam_points_tpu/factors/colored.py. Correspondences are the 1-NN
of each moved source point in XYZI space (the squared distance plus
`intensity_scale` times the squared intensity difference), searched in the
target's 3D hash grid; the photometric residual compares the source
intensity with the target's, extrapolated along its tangent-plane
intensity gradient. `ColoredGICPFactor` stacks the GICP residual on it,
a [N, 4] residual with a block-diagonal weight (the GICP 3x3, then
`photometric_weight`).

Both factors linearize through `linearize_residuals` (forward-mode AD): in
the reference none of this reaches a Pallas kernel. Correspondences and
weights are searched once a linearization, in `residual_closure`, and
frozen for the error function that scores the LM's candidates.

`estimate_intensity_gradients_ivox` keeps per-voxel gradients on a
Gaussian voxel map (neighbouring voxels' means and mean intensities in
place of a per-point kNN), to pair with `vmap.as_frame(with_normals=True)`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from gtsam_points_tpu_torch._device import check_on
from gtsam_points_tpu_torch.factors.base import MatchingFactorMixin
from gtsam_points_tpu_torch.factors.linearized import inv3x3
from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.eigh3 import eigh3
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid, _neighbor_offsets, build_hash_grid, knn_search, lookup_cells
from gtsam_points_tpu_torch.ops.voxelmap import (
    GaussianVoxelMap,
    finalize_intensity,
    finalize_mean,
    lookup_rows,
    lookup_voxels,
)
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3

_BIGF = float(2**30)


def _gradient_lsq(dx: torch.Tensor, dI: torch.Tensor, n: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tangent-plane LSQ of both gradient estimates: offsets dx [R, K, 3]
    projected onto the plane of n [R, 3], intensity differences dI [R, K],
    weights w [R, K]; the normal direction held at zero gradient -> [R, 3]."""
    dx_t = dx - torch.einsum("rkj,rj->rk", dx, n)[..., None] * n[:, None, :]
    wdx = dx_t * w[..., None]
    G = torch.einsum("rki,rkj->rij", wdx, dx_t) + torch.einsum("ri,rj->rij", n, n)
    G = G + 1e-6 * torch.eye(3, dtype=G.dtype, device=G.device)
    g = torch.einsum("rki,rk->ri", wdx, dI)
    return torch.einsum("rij,rj->ri", inv3x3(G), g)


def estimate_intensity_gradients(frame: Frame, k: int = 10, grid: Optional[HashGrid] = None,
                                 grid_leaf: float = 1.0) -> torch.Tensor:
    """Per-point intensity gradient [N, 3] on the tangent plane: the LSQ of
    the k nearest neighbours' intensity differences against their
    plane-projected offsets."""
    if frame.normals is None or frame.intensities is None:
        raise ValueError("intensity gradients need normals + intensities")
    if grid is None:
        grid = build_hash_grid(frame.points, frame.mask, grid_leaf)
    idx, _, valid = knn_search(grid, frame.points, frame.mask, k)
    nb = torch.clamp(idx, min=0).long()
    dx = frame.points[nb] - frame.points[:, None, :]
    dI = frame.intensities[nb] - frame.intensities[:, None]
    return _gradient_lsq(dx, dI, frame.normals, valid.to(torch.float32))


def _xyzi_knn(grid: HashGrid, target: Frame, moved: torch.Tensor, src_int: torch.Tensor, mask: torch.Tensor,
              intensity_scale: float, ncells: int, max_sq: float):
    """1-NN in XYZI space -> (index [N, 1], -1 where none; valid [N, 1]).

    Candidates are the tiles of the `ncells` neighbouring cells, laid out as
    [cell, slot]; a candidate counts within `max_sq` of geometric squared
    distance. Among the candidates at the least XYZI distance the lowest
    original index wins (the index travels as a float32, exact below 2^24
    points). A padded slot reads point 0's intensity; its index -1 drops it."""
    offsets = _neighbor_offsets(ncells, moved.device)
    coords = vk.voxel_coords(moved, 1.0 / grid.leaf)
    nb_keys = vk.pack_coords(coords[:, None, :] + offsets[None, :, :])
    nb_keys = torch.where(mask[:, None], nb_keys, vk.INVALID_KEY)
    cell_idx, found = lookup_cells(grid, nb_keys)
    rows = torch.where(found, cell_idx, grid.cell_capacity - 1).long()
    q, o = rows.shape
    jj = grid.points_per_cell
    int_cells = target.intensities[torch.clamp(grid.cell_pt_index, min=0).long()]  # [C, J]
    rec = grid.cell_records[rows].reshape(q, o, jj, 4)
    c_int = int_cells[rows].reshape(q, o * jj)
    dd = rec[..., :3] - moved[:, None, None, :]
    dd2 = dd * dd
    geo = ((dd2[..., 0] + dd2[..., 1]) + dd2[..., 2]).reshape(q, o * jj)
    cif = rec[..., 3].reshape(q, o * jj)
    dI = c_int - src_int[:, None]
    d = geo + intensity_scale * (dI * dI)
    # found per slot; an expand, since repeat_interleave reads its output size to the host
    ok = (cif >= 0) & (geo <= max_sq) & found[:, :, None].expand(q, o, jj).reshape(q, o * jj)
    d = torch.where(ok, d, float("inf"))
    best = torch.amin(d, dim=-1)
    idx = torch.amin(torch.where(d == best[:, None], cif, _BIGF), dim=-1)
    tvalid = torch.isfinite(best) & mask
    return torch.where(tvalid, idx.to(torch.int32), -1)[:, None], tvalid[:, None]


@dataclasses.dataclass(frozen=True)
class _ColoredBase(MatchingFactorMixin):
    target: Frame
    source: Frame
    target_gradients: torch.Tensor  # [N_t, 3]
    grid: HashGrid
    fixed_target_pose: torch.Tensor
    target_key: int
    source_key: int
    max_corr_dist: float
    intensity_scale: float
    photometric_weight: float
    num_neighbor_cells: int
    max_points_per_cell: int

    def _correspondences(self, delta: torch.Tensor):
        """XYZI 1-NN at delta -> (the target rows, clamped to 0; valid)."""
        moved = se3.transform_points(delta, self.source.points)
        idx, valid = _xyzi_knn(self.grid, self.target, moved, self.source.intensities, self.source.mask,
                               self.intensity_scale, self.num_neighbor_cells, self.max_corr_dist**2)
        return torch.clamp(idx[:, 0], min=0).long(), valid[:, 0]

    def _photometric(self, corr: torch.Tensor):
        """-> fn(moved points [..., N, 3]) -> (offset [..., N, 3], the
        photometric residual [..., N]) on the frozen correspondences."""
        q, n = self.target.points[corr], self.target.normals[corr]
        grad, I_t = self.target_gradients[corr], self.target.intensities[corr]
        I_s = self.source.intensities

        def fn(p):
            offset = p - q
            proj = offset - torch.sum(offset * n, dim=-1, keepdim=True) * n
            return offset, I_t + torch.sum(grad * proj, dim=-1) - I_s

        return fn


class ColorConsistencyFactor(_ColoredBase):
    """Photometric-only cost: r = sqrt(w) (I_t + ∇I_t · proj(p - q) - I_s)."""

    def residual_closure(self, T_t: torch.Tensor, T_s: torch.Tensor):
        corr, ok = self._correspondences(se3.se3_inverse(T_t) @ T_s)
        pho = self._photometric(corr)
        sw = math.sqrt(self.photometric_weight)

        def residual_fn(T_t_p, T_s_p):
            p = se3.transform_points(se3.se3_inverse(T_t_p) @ T_s_p, self.source.points)
            return pho(p)[1][..., None] * sw, None, ok

        return residual_fn


class ColoredGICPFactor(_ColoredBase):
    """GICP (r = p - q, W = (C_t + R C_s Rᵀ)⁻¹) and the photometric
    residual in one [N, 4] residual with a block-diagonal weight."""

    def residual_closure(self, T_t: torch.Tensor, T_s: torch.Tensor):
        delta = se3.se3_inverse(T_t) @ T_s
        corr, ok = self._correspondences(delta)
        pho = self._photometric(corr)
        R = delta[:3, :3]
        W3 = inv3x3(self.target.covs[corr] + torch.einsum("ij,njk,lk->nil", R, self.source.covs, R))
        W = W3.new_zeros(W3.shape[:-2] + (4, 4))
        W[..., :3, :3] = W3
        W[..., 3, 3] = self.photometric_weight

        def residual_fn(T_t_p, T_s_p):
            p = se3.transform_points(se3.se3_inverse(T_t_p) @ T_s_p, self.source.points)
            offset, r_pho = pho(p)
            return torch.cat([offset, r_pho[..., None]], dim=-1), W, ok

        return residual_fn


def _require_color(target: Frame, source: Frame) -> None:
    if target.intensities is None or source.intensities is None:
        raise ValueError("colored factors require intensities on both frames")


def _make(cls, target_key, source_key, target: Frame, source: Frame, target_gradients, max_corr_dist,
          intensity_scale, photometric_weight, grid_leaf, num_neighbor_cells, max_points_per_cell,
          fixed_target_pose):
    check_on(target.device, source.points, target_gradients, fixed_target_pose)
    if target_gradients is None:
        target_gradients = estimate_intensity_gradients(target, grid_leaf=grid_leaf)
    return cls(
        target=target, source=source, target_gradients=target_gradients,
        # the grid keeps 16 points a cell whatever max_points_per_cell says, as the reference's
        grid=build_hash_grid(target.points, target.mask, grid_leaf),
        fixed_target_pose=(torch.eye(4, dtype=torch.float32, device=target.device) if fixed_target_pose is None
                           else fixed_target_pose),
        target_key=target_key, source_key=source_key, max_corr_dist=max_corr_dist,
        intensity_scale=intensity_scale, photometric_weight=photometric_weight,
        num_neighbor_cells=num_neighbor_cells, max_points_per_cell=max_points_per_cell,
    )


def make_color_consistency_factor(
    target_key: int, source_key: int, target: Frame, source: Frame,
    target_gradients: Optional[torch.Tensor] = None,
    max_corr_dist: float = 2.0, intensity_scale: float = 1.0,
    photometric_weight: float = 1.0, grid_leaf: float = 1.0,
    num_neighbor_cells: int = 27, max_points_per_cell: int = 16,
    fixed_target_pose: Optional[torch.Tensor] = None,
) -> ColorConsistencyFactor:
    """The factor on the target's grid; the target's gradients are estimated
    (k = 10, at `grid_leaf`) unless given. Runs on the frames' device."""
    _require_color(target, source)
    if target.normals is None:
        raise ValueError("color consistency requires target normals")
    return _make(ColorConsistencyFactor, target_key, source_key, target, source, target_gradients, max_corr_dist,
                 intensity_scale, photometric_weight, grid_leaf, num_neighbor_cells, max_points_per_cell,
                 fixed_target_pose)


def make_colored_gicp_factor(
    target_key: int, source_key: int, target: Frame, source: Frame,
    target_gradients: Optional[torch.Tensor] = None,
    max_corr_dist: float = 2.0, intensity_scale: float = 1.0,
    photometric_weight: float = 1.0, grid_leaf: float = 1.0,
    num_neighbor_cells: int = 27, max_points_per_cell: int = 16,
    fixed_target_pose: Optional[torch.Tensor] = None,
) -> ColoredGICPFactor:
    """As make_color_consistency_factor; both frames also need covariances."""
    _require_color(target, source)
    if target.covs is None or source.covs is None or target.normals is None:
        raise ValueError("colored GICP requires covs on both frames + target normals")
    return _make(ColoredGICPFactor, target_key, source_key, target, source, target_gradients, max_corr_dist,
                 intensity_scale, photometric_weight, grid_leaf, num_neighbor_cells, max_points_per_cell,
                 fixed_target_pose)


def _cell_normals(moments: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Each voxel's normal: the smallest eigenvector of its covariance from
    the raw second moments [C, 6] (lanes 4:10) and the mean [C, 3]."""
    C6 = moments[:, 4:10] / torch.clamp(moments[:, 0], min=1.0)[:, None]
    mu2 = torch.stack([mu[:, 0] * mu[:, 0], mu[:, 0] * mu[:, 1], mu[:, 0] * mu[:, 2],
                       mu[:, 1] * mu[:, 1], mu[:, 1] * mu[:, 2], mu[:, 2] * mu[:, 2]], dim=-1)
    s = C6 - mu2
    cov = torch.stack([torch.stack([s[:, 0], s[:, 1], s[:, 2]], -1),
                       torch.stack([s[:, 1], s[:, 3], s[:, 4]], -1),
                       torch.stack([s[:, 2], s[:, 4], s[:, 5]], -1)], dim=-2)
    _, vecs = eigh3(cov + 1e-9 * torch.eye(3, dtype=cov.dtype, device=cov.device))
    return vecs[..., 0]


def estimate_intensity_gradients_ivox(vmap: GaussianVoxelMap, num_neighbor_cells: int = 27) -> torch.Tensor:
    """Per-voxel intensity gradients [C, 3], aligned with the map's rows and
    `vmap.as_frame()`: the LSQ of estimate_intensity_gradients with the
    `num_neighbor_cells` neighbouring voxels as neighbours (dx = neighbour
    mean - voxel mean, dI = the difference of their mean intensities) and
    the voxel's normal held at zero gradient; 0 on invalid rows. One probe
    fan-out, no per-point kNN."""
    valid = vmap.keys != vk.INVALID_KEY
    mu = finalize_mean(vmap.moments)
    inten = finalize_intensity(vmap.moments)
    offs = _neighbor_offsets(num_neighbor_cells, vmap.keys.device)
    nb_keys = vk.pack_coords(vk.unpack_key(vmap.keys)[:, None, :] + offs[None, :, :])
    nb_keys = torch.where(valid[:, None], nb_keys, vk.INVALID_KEY)
    nb_rows, nb_found = lookup_rows(vmap, nb_keys)
    rows = torch.where(nb_found, nb_rows, 0).long()
    n = _cell_normals(vmap.moments, mu)
    w = (nb_found & valid[:, None]).to(torch.float32)
    grads = _gradient_lsq(mu[rows] - mu[:, None, :], inten[rows] - inten[:, None], n, w)
    return torch.where(valid[:, None], grads, 0.0)


def lookup_intensity_gradients_ivox(vmap: GaussianVoxelMap, voxel_grads: torch.Tensor, points: torch.Tensor,
                                    mask: torch.Tensor):
    """Per-point gradient fetch from the map: one probe and one row gather
    -> ([N, 3] gradients, 0 where not found; found [N])."""
    row, found = lookup_voxels(vmap, points, mask)
    return torch.where(found[:, None], voxel_grads[row.long()], 0.0), found
