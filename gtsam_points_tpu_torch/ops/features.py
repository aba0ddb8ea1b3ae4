"""Per-point normals and covariances.

Port of gtsam_points_tpu/ops/features.py. Two routes:

- `estimate_normals_covs`, from each point's k nearest neighbours (one grid
  kNN pass, ops/hash_grid.py): the scatter matrix of the neighbours, its
  eigendecomposition, the smallest eigenvector as the normal and the
  eigenvalues regularised to [1e-3, 1, 1];
- `estimate_normals_covs_moments`, the documented preprocessing default:
  per-voxel moments blended with the neighbouring cells, one
  eigendecomposition per cell, and one probe per point to hand it its
  cell's normal and covariance.

Normals are oriented toward the view point (default: the sensor origin).
"""

from __future__ import annotations

from typing import Optional

import torch

from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.eigh3 import eigh3
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid, build_hash_grid, knn_search
from gtsam_points_tpu_torch.ops.voxelmap import _cov_from_sums, build_voxelmap, lookup_rows
from gtsam_points_tpu_torch.types.frame import Frame


def _eig_target(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([1e-3, 1.0, 1.0], dtype=like.dtype, device=like.device)


def _toward_view_point(normals: torch.Tensor, points: torch.Tensor, view_point) -> torch.Tensor:
    """Flip each normal whose dot product with (view point - point) is negative."""
    vp = points.new_zeros((3,)) if view_point is None else view_point
    to_vp = vp[None, :] - points
    sign = torch.where(torch.sum(normals * to_vp, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    return normals * sign


def neighbor_covariances(points: torch.Tensor, nn_idx: torch.Tensor, nn_valid: torch.Tensor):
    """[N, 3] points, [N, k] neighbour indices and validity -> ([N, 3, 3]
    scatter matrices, [N, 3] means) of the valid neighbours."""
    nbr = points[torch.clamp(nn_idx, min=0).long()]  # [N, k, 3]
    w = nn_valid.to(points.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    mean = torch.sum(nbr * w, dim=1) / cnt
    diff = (nbr - mean[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", diff, diff) / cnt[..., None]
    return cov, mean


def regularize_covariances(covs: torch.Tensor, mode: str = "eig") -> torch.Tensor:
    """Eigenvalues projected to [1e-3, 1, 1] (`mode="eig"`), or unchanged
    (`mode="none"`)."""
    if mode == "none":
        return covs
    _, eigvecs = eigh3(covs)
    return torch.einsum("nij,j,nkj->nik", eigvecs, _eig_target(covs), eigvecs)


def estimate_normals_covs(
    frame: Frame,
    k: int = 10,
    grid: Optional[HashGrid] = None,
    grid_leaf: float = 0.5,
    num_neighbor_cells: int = 27,
    max_points_per_cell: int = 16,
    regularization: str = "eig",
    view_point: Optional[torch.Tensor] = None,
) -> Frame:
    """Normals and covariances from each point's k nearest neighbours in
    one kNN pass over `grid` (built here at `grid_leaf`, keeping
    `max_points_per_cell` points a cell, when not given)."""
    if grid is None:
        grid = build_hash_grid(frame.points, frame.mask, grid_leaf, max_points_per_cell=max_points_per_cell)
    nn_idx, _, nn_valid = knn_search(
        grid, frame.points, frame.mask, k, num_neighbor_cells, max_points_per_cell
    )
    raw_cov, _ = neighbor_covariances(frame.points, nn_idx, nn_valid)
    _, eigvecs = eigh3(raw_cov)  # ascending
    normals = _toward_view_point(eigvecs[..., 0], frame.points, view_point)
    if regularization == "eig":
        covs = torch.einsum("nij,j,nkj->nik", eigvecs, _eig_target(raw_cov), eigvecs)
    else:
        covs = raw_cov
    return frame.replace(normals=normals, covs=covs)


def estimate_covariances(frame: Frame, k: int = 10, **kwargs) -> Frame:
    return frame.replace(covs=estimate_normals_covs(frame, k=k, **kwargs).covs)


def estimate_normals(frame: Frame, k: int = 10, **kwargs) -> Frame:
    return frame.replace(normals=estimate_normals_covs(frame, k=k, **kwargs).normals)


def estimate_normals_covs_moments(
    frame: Frame,
    leaf: float = 1.0,
    num_neighbor_cells: int = 7,
    regularization: str = "eig",
    view_point: Optional[torch.Tensor] = None,
) -> Frame:
    """Normals oriented toward `view_point` (default: the sensor origin) and
    covariances regularised to eigenvalues [1e-3, 1, 1] (`regularization="eig"`)."""
    vmap = build_voxelmap(frame, leaf)

    # blend each cell's moments with its neighbours' (moment sums are additive)
    offs = vk.neighbor_offsets(num_neighbor_cells, frame.device)
    cell_coords = vk.unpack_key(vmap.keys)
    nb_keys = vk.pack_coords(cell_coords[:, None, :] + offs[None, :, :])
    nb_keys = torch.where((vmap.keys != vk.INVALID_KEY)[:, None], nb_keys, vk.INVALID_KEY)
    nb_rows, nb_found = lookup_rows(vmap, nb_keys)  # [C, O]
    nb_mom = vmap.moments[torch.where(nb_found, nb_rows, 0)]  # [C, O, 16]
    blended = torch.sum(nb_mom * nb_found[..., None], dim=1)  # [C, 16]
    cell_cov = _cov_from_sums(blended[:, 0], blended[:, 1:4], blended[:, 4:10])

    _, eigvecs = eigh3(cell_cov)
    cell_normals = eigvecs[..., 0]
    if regularization == "eig":
        cell_cov = torch.einsum("nij,j,nkj->nik", eigvecs, _eig_target(cell_cov), eigvecs)

    keys = vk.point_keys(frame.points, frame.mask, leaf)
    row, found = lookup_rows(vmap, keys)
    normals = cell_normals[row]
    covs = cell_cov[row]

    normals = torch.where(found[:, None], _toward_view_point(normals, frame.points, view_point), 0.0)
    eye = torch.eye(3, dtype=covs.dtype, device=covs.device)
    covs = torch.where(found[:, None, None], covs, eye[None])
    return frame.replace(normals=normals, covs=covs)
