"""Experimental factors: the Sim(3)-SE(3) coupling and trajectory alignment.

Port of gtsam_points_tpu/factors/experimental.py. A Sim(3) is held as an
(SE(3) matrix, scale) pair and retracted multiplicatively; the BetweenSim3SE3
error is Log(scaled_transform(S)⁻¹ T). `align_trajectories_sim3` is a
fixed-iteration Gauss-Newton over the 7 tangent directions, its Jacobian from
`torch.func.jacfwd` over all P poses at once, its 7x7 solve
`torch.linalg.solve_ex` (no status read on the host), so the loop makes no
synchronizing call. No function changes an operand in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.utils import se3


class Sim3(NamedTuple):
    """pose [4, 4] SE(3) (unit-scale rotation and translation) and scale ()
    f32; as a matrix [[s R, t], [0, 1]] (`sim3_matrix`)."""

    pose: torch.Tensor
    scale: torch.Tensor


def sim3_identity(*, device: DeviceLike = None) -> Sim3:
    dev = resolve_device(device)
    return Sim3(pose=torch.eye(4, dtype=torch.float32, device=dev),
                scale=torch.ones((), dtype=torch.float32, device=dev))


def _scale_block(M: torch.Tensor, rows: slice, cols: slice, s: torch.Tensor) -> torch.Tensor:
    """A copy of M [..., 4, 4] with M[..., rows, cols] multiplied by s."""
    out = M.clone()
    out[..., rows, cols] = M[..., rows, cols] * s[..., None, None]
    return out


def sim3_matrix(s: Sim3) -> torch.Tensor:
    """[[s R, t], [0, 1]]: acts on points as s R p + t."""
    return _scale_block(s.pose, slice(0, 3), slice(0, 3), s.scale)


def sim3_apply(s: Sim3, pts: torch.Tensor) -> torch.Tensor:
    return pts @ (s.scale * s.pose[:3, :3]).T + s.pose[:3, 3]


def sim3_retract(s: Sim3, xi7: torch.Tensor) -> Sim3:
    """pose <- pose Exp(xi[:6]); scale <- scale exp(xi[6])."""
    return Sim3(pose=s.pose @ se3.se3_exp(xi7[:6]), scale=s.scale * torch.exp(xi7[6]))


def scaled_transform(s: Sim3) -> torch.Tensor:
    """The SE(3) shadow of a Sim(3): (R, s t)."""
    return _scale_block(s.pose, slice(0, 3), slice(3, 4), s.scale)


def between_sim3_se3_error(s: Sim3, T: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """r = Log(scaled_transform(s)⁻¹ T) [..., 6], scaled by sqrt(weights)
    where given. A batch of poses in s.pose and T passes through."""
    r = se3.se3_log(se3.se3_inverse(scaled_transform(s)) @ T)
    if weights is not None:
        r = torch.sqrt(weights) * r
    return r


def align_trajectories_sim3(
    poses_a: torch.Tensor,
    poses_b: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    iterations: int = 20,
    damping: float = 1e-6,
) -> Sim3:
    """The Sim(3) S minimizing sum_i |Log(scaled(S A_i)⁻¹ B_i)|²: poses_a,
    poses_b [P, 4, 4] SE(3) -> S mapping frame a to frame b. `iterations`
    Gauss-Newton steps from the identity, on the poses' device; a
    weights tensor on another device is refused."""
    dev = poses_a.device
    check_on(dev, poses_b, weights)
    if weights is None:
        weights = torch.ones((6,), dtype=torch.float32, device=dev)

    def residuals(xi7, s):
        s2 = sim3_retract(s, xi7)
        pred = Sim3(pose=s2.pose @ poses_a, scale=s2.scale)
        return between_sim3_se3_error(pred, poses_b, weights).reshape(-1)

    eye7 = damping * torch.eye(7, dtype=torch.float32, device=dev)
    zero = torch.zeros((7,), dtype=torch.float32, device=dev)
    s = sim3_identity(device=dev)
    for _ in range(iterations):
        r0 = residuals(zero, s)
        J = torch.func.jacfwd(residuals)(zero, s)  # [6P, 7]
        A = J.T @ J + eye7
        b = -(J.T @ r0)
        xi = torch.linalg.solve_ex(A, b[:, None])[0][:, 0]
        s = sim3_retract(s, xi)
    return s
