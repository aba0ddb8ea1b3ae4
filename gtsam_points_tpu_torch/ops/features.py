"""Per-point normals and covariances from voxel moments.

Port of `estimate_normals_covs_moments` in gtsam_points_tpu/ops/features.py,
the documented preprocessing default: per-voxel moments blended with the
neighbouring cells, one eigendecomposition per cell, and one probe per point
to hand it its cell's normal and covariance.
"""

from __future__ import annotations

from typing import Optional

import torch

from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.eigh3 import eigh3
from gtsam_points_tpu_torch.ops.voxelmap import _cov_from_sums, build_voxelmap, lookup_rows
from gtsam_points_tpu_torch.types.frame import Frame


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
        target = torch.tensor([1e-3, 1.0, 1.0], dtype=cell_cov.dtype, device=cell_cov.device)
        cell_cov = torch.einsum("nij,j,nkj->nik", eigvecs, target, eigvecs)

    keys = vk.point_keys(frame.points, frame.mask, leaf)
    row, found = lookup_rows(vmap, keys)
    normals = cell_normals[row]
    covs = cell_cov[row]

    vp = frame.points.new_zeros((3,)) if view_point is None else view_point
    to_vp = vp[None, :] - frame.points
    sign = torch.where(torch.sum(normals * to_vp, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    normals = torch.where(found[:, None], normals * sign, 0.0)
    eye = torch.eye(3, dtype=covs.dtype, device=covs.device)
    covs = torch.where(found[:, None, None], covs, eye[None])
    return frame.replace(normals=normals, covs=covs)
