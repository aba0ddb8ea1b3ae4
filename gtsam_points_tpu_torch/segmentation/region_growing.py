"""Region-growing segmentation.

Port of gtsam_points_tpu/segmentation/region_growing.py. A seed point grows
over the kNN graph through neighbours within a distance threshold whose
normals agree within an angle threshold, as synchronous label propagation
over the [N, k] neighbour table, then a distance-only dilation.

The reference propagates in a `lax.while_loop` until the label count stops
growing (at most 1 + max_steps propagations). Reading that condition after
every propagation would synchronize once a step, so here the propagations
run in blocks of PROPAGATION_BLOCK between host reads. Propagation is
monotone and changes nothing once the labels stop changing, and the total
never exceeds the reference's 1 + max_steps, so the labels are the same bit
for bit.

`region_growing` searches the kNN table and calls `_region_growing_from_knn`,
which takes the table, so that two devices can be held to each other on one
table (kNN ties may fall differently on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gtsam_points_tpu_torch._device import check_on
from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid, knn_search
from gtsam_points_tpu_torch.types.frame import Frame

PROPAGATION_BLOCK = 16  # propagations between two host reads


@dataclasses.dataclass(frozen=True)
class RegionGrowingParams:
    k: int = 10
    distance_thresh: float = 0.5
    angle_thresh: float = 0.3  # radians between normals
    max_steps: int = 256
    dilation_steps: int = 1  # final distance-only dilation passes
    grid_leaf: float = 0.5


def _seed_tensor(frame: Frame, seed_point) -> torch.Tensor:
    if isinstance(seed_point, torch.Tensor):
        check_on(frame.device, seed_point)
        return seed_point.to(torch.float32)
    return torch.as_tensor(seed_point, dtype=torch.float32).to(frame.device)


def _region_growing_from_knn(frame: Frame, seed_point, params: RegionGrowingParams, nn_idx: torch.Tensor,
                            nn_valid: torch.Tensor) -> torch.Tensor:
    """Region growing on a given kNN table (nn_idx [N, k], nn_valid [N, k],
    searched within distance_thresh) -> [N] bool cluster mask. The seed is
    the masked point nearest `seed_point`, the first on a tie."""
    p = params
    check_on(frame.device, nn_idx, nn_valid)
    seed_point = _seed_tensor(frame, seed_point)
    idx = torch.clamp(nn_idx, min=0).long()
    cos_thresh = torch.cos(torch.tensor(p.angle_thresh, dtype=torch.float32)).item()
    dots = torch.sum(frame.normals[:, None, :] * frame.normals[idx], dim=-1)
    edge_ok = nn_valid & (torch.abs(dots) >= cos_thresh)

    diff = frame.points - seed_point
    d_seed = torch.where(frame.mask, torch.sum(diff * diff, dim=-1), float("inf"))
    seed = torch.argmin(d_seed)
    labels = torch.arange(frame.capacity, device=frame.device) == seed

    def propagate(labels, adjacency):
        return labels | (torch.any(labels[idx] & adjacency, dim=-1) & frame.mask)

    labels = propagate(labels, edge_ok)
    done, limit = 1, 1 + p.max_steps
    while done < limit:
        for _ in range(min(PROPAGATION_BLOCK, limit - done)):
            prev, labels = labels, propagate(labels, edge_ok)
            done += 1
        if not bool(torch.any(labels != prev)):  # the host read: a propagation that changed nothing
            break
    for _ in range(p.dilation_steps):
        labels = propagate(labels, nn_valid)
    return labels


def region_growing(frame: Frame, seed_point, params: Optional[RegionGrowingParams] = None) -> torch.Tensor:
    """-> [N] bool cluster mask holding the seed point; on the frame's device."""
    p = params or RegionGrowingParams()
    if frame.normals is None:
        raise ValueError("region growing requires normals")
    grid = build_hash_grid(frame.points, frame.mask, p.grid_leaf)
    nn_idx, _, nn_valid = knn_search(grid, frame.points, frame.mask, p.k, max_sq_dist=p.distance_thresh**2)
    return _region_growing_from_knn(frame, seed_point, p, nn_idx, nn_valid)
