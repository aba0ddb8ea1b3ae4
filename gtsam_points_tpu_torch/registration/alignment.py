"""Closed-form point-set alignment.

Port of gtsam_points_tpu/registration/alignment.py: `align_points_se3`
(weighted SVD, Umeyama style, with the reflection fix) and
`align_points_4dof` (translation and yaw, for gravity-aligned clouds), both
batched over leading dimensions.
"""

from __future__ import annotations

from typing import Optional

import torch

from gtsam_points_tpu_torch.utils import se3


def _centered(source: torch.Tensor, target: torch.Tensor, weights: Optional[torch.Tensor]):
    """Normalized weights and both sets about their weighted centroids
    -> (w [..., N], mu_s, mu_t [..., 3], ds, dt [..., N, 3])."""
    if weights is None:
        weights = torch.ones(source.shape[:-1], dtype=source.dtype, device=source.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    mu_s = torch.sum(source * w[..., None], dim=-2)
    mu_t = torch.sum(target * w[..., None], dim=-2)
    return w, mu_s, mu_t, source - mu_s[..., None, :], target - mu_t[..., None, :]


def align_points_se3(source: torch.Tensor, target: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """Weighted least-squares T with T·source ≈ target.
    source, target [..., N, 3]; weights [..., N] or None -> [..., 4, 4]."""
    w, mu_s, mu_t, ds, dt = _centered(source, target, weights)
    H = torch.einsum("...n,...ni,...nj->...ij", w, dt, ds)  # Σ w dt dsᵀ
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    R = U @ torch.diag_embed(torch.stack([one, one, det], dim=-1)) @ Vt
    t = mu_t - torch.einsum("...ij,...j->...i", R, mu_s)
    return se3.make_transform(R, t)


def align_points_4dof(source: torch.Tensor, target: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """Yaw and translation alignment (rotation about z only) -> [..., 4, 4]."""
    w, mu_s, mu_t, ds, dt = _centered(source, target, weights)
    # the yaw maximizing Σ w dt_xy · R(yaw) ds_xy
    sxx = torch.sum(w * (ds[..., 0] * dt[..., 0] + ds[..., 1] * dt[..., 1]), dim=-1)
    sxy = torch.sum(w * (ds[..., 0] * dt[..., 1] - ds[..., 1] * dt[..., 0]), dim=-1)
    yaw = torch.atan2(sxy, sxx)
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([
        torch.stack([c, -s, zero], dim=-1),
        torch.stack([s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    t = mu_t - torch.einsum("...ij,...j->...i", R, mu_s)
    return se3.make_transform(R, t)
