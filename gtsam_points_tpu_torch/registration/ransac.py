"""Feature-matched RANSAC global registration.

Port of gtsam_points_tpu/registration/ransac.py. Every hypothesis is
evaluated in one batch: three source points and their FPFH matches, the
polygonal prerejection (side lengths alike), the closed-form alignment, the
taboo rejection, the overlap score on a coarse sample, and the best
`rescore_top` rescored on the full sample.

The reference draws its hypotheses with `jax.random` (threefry), which torch
does not reproduce, so the function is split in two:
`estimate_pose_ransac_from_draws` takes the draws (the hypotheses' source
indices [H, 3] and the overlap sample [S]) and is held to the reference on
the reference's own draws; `estimate_pose_ransac` draws them with a
`torch.Generator` on the CPU, seeded from `params.seed`, so one seed gives
the same hypotheses on every device. Ties go as in the reference: the
rescoring takes the best `rescore_top` with the lower index first among
equal scores (`lax.top_k`), and the pick is the first maximum (`argmax`).
On CUDA, `align_points_se3`'s `svd` and `det` each check their status with
a synchronizing read (PERF.md counts the reads of one call).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid, build_hash_grid, lookup_cells
from gtsam_points_tpu_torch.registration.alignment import align_points_4dof, align_points_se3
from gtsam_points_tpu_torch.registration.fpfh import feature_knn
from gtsam_points_tpu_torch.types.frame import Frame
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


def ransac_draws(params: RANSACParams, num_source: int, generator: Optional[torch.Generator] = None):
    """The hypotheses' source indices cand [H, 3] and the overlap sample
    score_idx [S] in [0, num_source), drawn on the CPU from `generator`
    (default: a new one seeded with params.seed)."""
    if generator is None:
        generator = torch.Generator().manual_seed(params.seed)
    score_idx = torch.randint(0, num_source, (params.num_overlap_samples,), generator=generator)
    cand = torch.randint(0, num_source, (params.max_iterations, 3), generator=generator)
    return cand, score_idx


def _side_lengths(p: torch.Tensor) -> torch.Tensor:
    """[H, 3, 3] triangles -> [H, 3] side lengths |p0 p1|, |p1 p2|, |p2 p0|."""
    return torch.linalg.norm(p - torch.roll(p, -1, dims=-2), dim=-1)


def _near_taboo(T: torch.Tensor, taboo: torch.Tensor, params: RANSACParams) -> torch.Tensor:
    """[H] True where T [H, 4, 4] lies within both thresholds of a taboo pose [M, 4, 4]."""
    rot_e, trans_e = se3.pose_error(T[:, None], taboo[None])
    return torch.any((rot_e < params.taboo_thresh_rot) & (trans_e < params.taboo_thresh_trans), dim=-1)


def estimate_pose_ransac_from_draws(
    target: Frame,
    source: Frame,
    target_features: torch.Tensor,
    source_features: torch.Tensor,
    params: Optional[RANSACParams],
    cand: torch.Tensor,
    score_idx: torch.Tensor,
    taboo: Optional[torch.Tensor] = None,
) -> RegistrationResult:
    """RANSAC on given draws: cand [H, 3] source indices of the hypotheses
    (H = params.max_iterations), score_idx [S] the overlap sample
    (S = params.num_overlap_samples), both on the frames' device. `taboo`
    [M, 4, 4]: known-bad poses; a hypothesis within params.taboo_thresh_rot
    and taboo_thresh_trans of one is rejected."""
    params = params or RANSACParams()
    check_on(source.device, target.points, target_features, source_features, cand, score_idx, taboo)
    cand, score_idx = cand.long(), score_idx.long()

    # the nearest target feature of every source feature, shared by all hypotheses
    match_idx, _, match_valid = feature_knn(target_features, target.mask, source_features, source.mask)
    match_idx, match_valid = match_idx[:, 0], match_valid[:, 0]
    occ = build_hash_grid(target.points, target.mask, params.inlier_voxel_resolution)

    score_pts, score_mask = source.points[score_idx], source.mask[score_idx]
    s_pts = source.points[cand]  # [H, 3, 3]
    t_pts = target.points[torch.clamp(match_idx[cand], min=0).long()]
    ls, lt = _side_lengths(s_pts), _side_lengths(t_pts)
    poly_ok = torch.all(torch.abs(ls - lt) / torch.clamp(torch.maximum(ls, lt), min=1e-6) < params.poly_error_thresh,
                        dim=-1)
    h_valid = torch.all(match_valid[cand], dim=-1) & poly_ok & (torch.amin(ls, dim=-1) > 1e-3)

    align = align_points_se3 if params.dof == 6 else align_points_4dof
    T_h = align(s_pts, t_pts)  # [H, 4, 4]
    if taboo is not None and taboo.shape[0] > 0:
        h_valid = h_valid & ~_near_taboo(T_h, taboo, params)

    # every hypothesis scored on a coarse sample
    nc = min(params.coarse_overlap_samples, params.num_overlap_samples)
    coarse = overlap_score(occ, T_h, score_pts[None, :nc], score_mask[None, :nc])
    coarse = torch.where(h_valid, coarse, -1.0)

    top = min(params.rescore_top, params.max_iterations)
    if top < params.max_iterations:
        # the best `top` rescored on the full sample, the lower index first among equal scores
        ti = torch.sort(coarse, descending=True, stable=True).indices[:top]
        T_t = T_h[ti]
        scores = overlap_score(occ, T_t, score_pts[None], score_mask[None])
        scores = torch.where(coarse[ti] > -1.0, scores, -1.0)
        return _pick(T_t, scores)
    return _pick(T_h, coarse)


def _pick(T: torch.Tensor, scores: torch.Tensor) -> RegistrationResult:
    """The pose of the first maximal score (`argmax`), gathered on the
    device: indexing with a 0-d CUDA tensor would read it to the host."""
    best = torch.argmax(scores).reshape(1)
    return RegistrationResult(T_target_source=T.index_select(0, best)[0], inlier_rate=scores.index_select(0, best)[0])


def estimate_pose_ransac(
    target: Frame,
    source: Frame,
    target_features: torch.Tensor,
    source_features: torch.Tensor,
    params: Optional[RANSACParams] = None,
    taboo: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> RegistrationResult:
    """T_target_source from FPFH matches alone (no initial guess), on
    `device` (default `cuda`), where the frames and features must lie. The
    draws come from `generator` (a CPU generator; default seeded with
    params.seed) and are copied to the device."""
    dev = resolve_device(device)
    check_on(dev, target.points, source.points, target_features, source_features, taboo)
    params = params or RANSACParams()
    cand, score_idx = ransac_draws(params, source.capacity, generator)
    return estimate_pose_ransac_from_draws(target, source, target_features, source_features, params,
                                           cand.to(dev), score_idx.to(dev), taboo)
