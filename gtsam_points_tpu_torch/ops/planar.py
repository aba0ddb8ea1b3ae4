"""Planar (structure-of-planes) math for the point linearization path.

Port of gtsam_points_tpu/ops/planar.py. Points are [3, N], symmetric 3x3
matrices are six planes [6, N] (xx, xy, xz, yy, yz, zz). `transform`,
`sym_mul` and `weighted_error` also take a leading batch of poses, so the LM
can score all of its lambda candidates in one pass.

Jacobians are analytic, right perturbation, in the (omega, v) tangent order:
  J_t = [skew(pm) | -I],  J_s = [-R·skew(p) | R],  r = pm - mu,  pm = R p + t.
"""

from __future__ import annotations

from typing import Optional

import torch

from gtsam_points_tpu_torch.factors.linearized import Linearized


def sym_mul(W6: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Symmetric-3x3 times vector, planar: W6 [6, N], v [..., 3, N] -> [..., 3, N]."""
    xx, xy, xz, yy, yz, zz = W6.unbind(-2)
    v0, v1, v2 = v.unbind(-2)
    return torch.stack(
        [
            xx * v0 + xy * v1 + xz * v2,
            xy * v0 + yy * v1 + yz * v2,
            xz * v0 + yz * v1 + zz * v2,
        ],
        dim=-2,
    )


def sym_inv(C6: torch.Tensor) -> torch.Tensor:
    """Planar symmetric 3x3 inverse; near-singular input gives zero (a
    degenerate correspondence then contributes nothing)."""
    xx, xy, xz, yy, yz, zz = C6.unbind(0)
    co_xx = yy * zz - yz * yz
    co_xy = -(xy * zz - yz * xz)
    co_xz = xy * yz - yy * xz
    det = xx * co_xx + xy * co_xy + xz * co_xz
    scale = (torch.abs(xx) + torch.abs(yy) + torch.abs(zz)) / 3.0
    bad = torch.abs(det) <= 1e-9 * scale * scale * scale + 1e-30
    inv_det = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, det))
    co_yy = xx * zz - xz * xz
    co_yz = -(xx * yz - xy * xz)
    co_zz = xx * yy - xy * xy
    return torch.stack([co_xx, co_xy, co_xz, co_yy, co_yz, co_zz]) * inv_det


def sym_rotate(R: torch.Tensor, C6: torch.Tensor) -> torch.Tensor:
    """Planar congruence R C Rᵀ: R [3,3], C6 [6, N] -> [6, N]."""
    xx, xy, xz, yy, yz, zz = C6.unbind(0)
    C = ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))
    M = [[C[i][0] * R[j, 0] + C[i][1] * R[j, 1] + C[i][2] * R[j, 2] for j in range(3)] for i in range(3)]

    def entry(i, j):
        return R[i, 0] * M[0][j] + R[i, 1] * M[1][j] + R[i, 2] * M[2][j]

    return torch.stack([entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1), entry(1, 2), entry(2, 2)])


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply SE3 [..., 4, 4] to planar points [3, N] -> [..., 3, N]."""
    return T[..., :3, :3] @ p + T[..., :3, 3, None]


def _skew_cols(x: torch.Tensor):
    """Columns of skew(x) for planar x [3, N]: three [3, N] planes."""
    z = torch.zeros_like(x[0])
    c0 = torch.stack([z, x[2], -x[1]])
    c1 = torch.stack([-x[2], z, x[0]])
    c2 = torch.stack([x[1], -x[0], z])
    return c0, c1, c2


def linearize_point_system(
    p_src: torch.Tensor,
    pm: torch.Tensor,
    r: torch.Tensor,
    W6: Optional[torch.Tensor],
    mask: torch.Tensor,
    R_delta: torch.Tensor,
) -> Linearized:
    """Analytic Gauss-Newton system for residuals affine in the moved point.

    p_src, pm, r: [3, N] planar; W6: [6, N] symmetric weights or None;
    mask: [N] bool; R_delta: [3, 3].
    """
    n = r.shape[1]
    m = mask.to(r.dtype)

    s0, s1, s2 = _skew_cols(pm)
    minus_eye = -torch.eye(3, dtype=r.dtype, device=r.device)
    e0, e1, e2 = (minus_eye[:, i, None].expand(3, n) for i in range(3))
    k0, k1, k2 = _skew_cols(p_src)
    Rk0, Rk1, Rk2 = (-(R_delta @ k) for k in (k0, k1, k2))
    Rc = [R_delta[:, i, None].expand(3, n) for i in range(3)]

    # J [12, 3, N]: columns of the per-point 3x12 Jacobian as planar planes
    J = torch.stack([s0, s1, s2, e0, e1, e2, Rk0, Rk1, Rk2, Rc[0], Rc[1], Rc[2]])

    if W6 is None:
        zero = torch.zeros_like(m)
        Wm = torch.stack([m, zero, zero, m, zero, m])
    else:
        Wm = W6 * m
    Wr = sym_mul(Wm, r)
    WJ = sym_mul(Wm, J)  # [12, 3, N]

    Jf = J.reshape(12, 3 * n)
    WJf = WJ.reshape(12, 3 * n)
    H = Jf @ WJf.T
    b = -(Jf @ Wr.reshape(3 * n))
    err = torch.sum(Wr * r)
    return Linearized(
        H_tt=H[:6, :6],
        H_ss=H[6:, 6:],
        H_ts=H[:6, 6:],
        b_t=b[:6],
        b_s=b[6:],
        error=err,
        num_inliers=torch.sum(mask.to(torch.int32)),
    )


def weighted_error(r: torch.Tensor, W6: Optional[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """sum_n r_nᵀ W_n r_n over planar residuals r [..., 3, N] -> [...]."""
    m = mask.to(r.dtype)
    if W6 is None:
        return torch.sum(r * r * m, dim=(-2, -1))
    Wr = sym_mul(W6 * m, r)
    return torch.sum(Wr * r, dim=(-2, -1))
