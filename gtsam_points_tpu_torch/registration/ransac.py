"""Feature-matched RANSAC global registration: its parameters, its result
and the overlap score it shares with GNC.

Port of `RANSACParams`, `RegistrationResult` and `overlap_score` in
gtsam_points_tpu/registration/ransac.py. `estimate_pose_ransac` is not
ported: its hypotheses are drawn with `jax.random` (threefry), which torch
does not reproduce bit for bit (ROADMAP.md, queue 5).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid, lookup_cells
from gtsam_points_tpu_torch.utils import se3


@dataclasses.dataclass(frozen=True)
class RANSACParams:
    max_iterations: int = 4096  # hypothesis count (all evaluated in parallel)
    poly_error_thresh: float = 0.3  # prerejection side-length similarity
    inlier_voxel_resolution: float = 1.0
    dof: int = 6  # 6 or 4 (gravity-aligned)
    seed: int = 0
    num_overlap_samples: int = 1024  # source points used for the final overlap score
    # every hypothesis scored on a coarse sample, the best `rescore_top`
    # rescored on the full sample
    coarse_overlap_samples: int = 128
    rescore_top: int = 128
    # a hypothesis within both thresholds of a known-bad (taboo) pose is rejected
    taboo_thresh_rot: float = 0.5 * 3.14159265 / 180.0
    taboo_thresh_trans: float = 0.25


class RegistrationResult(NamedTuple):
    T_target_source: torch.Tensor  # [4, 4]
    inlier_rate: torch.Tensor  # ()


def overlap_score(grid: HashGrid, T: torch.Tensor, pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The share of points, moved by T, that land in an occupied cell of
    `grid`; batched over the leading dimensions of T."""
    moved = se3.transform_points(T, pts)
    keys = vk.pack_coords(vk.voxel_coords(moved, 1.0 / grid.leaf))
    keys = torch.where(mask, keys, vk.INVALID_KEY)
    _, found = lookup_cells(grid, keys)
    return torch.sum(found.to(torch.int32), dim=-1) / torch.clamp(torch.sum(mask.to(torch.int32), dim=-1), min=1)
