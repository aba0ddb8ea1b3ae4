"""Graduated non-convexity global registration (fast global registration).

Port of gtsam_points_tpu/registration/gnc.py: reciprocal FPFH matching, then
Geman-McClure IRLS with μ starting at the square of the target's diameter
and divided by `div_factor` each iteration (floored at max_corr_dist²); each
iteration is a weighted closed-form alignment. The reference runs the IRLS
as a `fori_loop`; here it is a loop of device operations that reads no value
itself. On CUDA, though, `torch.linalg.svd` and `torch.linalg.det` each check
their solver's status with a synchronizing read, so a default call
synchronizes about twice an iteration (129 times on an H100, PERF.md). The
overlap score at the end rates the result. `reciprocal_matches` and
`gnc_irls` are the two halves of `estimate_pose_gnc`, apart so that the IRLS
can be held to another run's matches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid
from gtsam_points_tpu_torch.registration.alignment import align_points_4dof, align_points_se3
from gtsam_points_tpu_torch.registration.fpfh import feature_knn
from gtsam_points_tpu_torch.registration.ransac import RegistrationResult, overlap_score
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3


@dataclasses.dataclass(frozen=True)
class GNCParams:
    max_iterations: int = 64
    div_factor: float = 1.4
    max_corr_dist: float = 0.25  # the floor of μ is its square
    dof: int = 6
    reciprocal: bool = True
    inlier_voxel_resolution: float = 1.0


def estimate_pose_gnc(
    target: Frame,
    source: Frame,
    target_features: torch.Tensor,
    source_features: torch.Tensor,
    params: Optional[GNCParams] = None,
    *,
    device: DeviceLike = None,
) -> RegistrationResult:
    """T_target_source from FPFH matches alone (no initial guess), on
    `device` (default `cuda`), where the frames and features must lie."""
    check_on(resolve_device(device), source.points, target.points, target_features, source_features)
    params = params or GNCParams()
    match, valid = reciprocal_matches(target, source, target_features, source_features, params.reciprocal)
    T = gnc_irls(target, source, match, valid, params)
    occ = build_hash_grid(target.points, target.mask, params.inlier_voxel_resolution)
    return RegistrationResult(T_target_source=T, inlier_rate=overlap_score(occ, T, source.points, source.mask))


def reciprocal_matches(target: Frame, source: Frame, target_features: torch.Tensor, source_features: torch.Tensor,
                       reciprocal: bool = True):
    """Each source point's nearest target feature, kept where the target's
    nearest source feature points back (when reciprocal) -> (target index
    [N] int64, clamped at 0; valid [N] bool, the source mask included)."""
    st_idx, _, st_valid = feature_knn(target_features, target.mask, source_features, source.mask)
    st_idx, st_valid = st_idx[:, 0], st_valid[:, 0]
    match = torch.clamp(st_idx, min=0).long()
    if reciprocal:
        ts_idx = feature_knn(source_features, source.mask, target_features, target.mask)[0][:, 0]
        st_valid = st_valid & (ts_idx[match] == torch.arange(source.capacity, dtype=torch.int32, device=match.device))
    return match, st_valid & source.mask


def gnc_irls(target: Frame, source: Frame, match: torch.Tensor, valid: torch.Tensor,
             params: Optional[GNCParams] = None) -> torch.Tensor:
    """The Geman-McClure IRLS over the matches (source point i to target
    point match[i] where valid[i]) -> T_target_source [4, 4]."""
    params = params or GNCParams()
    src = source.points
    tgt = target.points[match]

    # μ from the target's diameter
    lo = torch.amin(torch.where(target.mask[:, None], target.points, float("inf")), dim=0)
    hi = torch.amax(torch.where(target.mask[:, None], target.points, float("-inf")), dim=0)
    diameter = torch.linalg.norm(hi - lo)
    mu = diameter * diameter

    align = align_points_se3 if params.dof == 6 else align_points_4dof
    T = torch.eye(4, dtype=torch.float32, device=src.device)
    for _ in range(params.max_iterations):
        sq = torch.sum((se3.transform_points(T, src) - tgt) ** 2, dim=-1)
        w = torch.where(valid, (mu / (mu + sq)) ** 2, 0.0)  # Geman-McClure IRLS weight
        T = align(src, tgt, w)
        mu = torch.clamp(mu / params.div_factor, min=params.max_corr_dist**2)
    return T
