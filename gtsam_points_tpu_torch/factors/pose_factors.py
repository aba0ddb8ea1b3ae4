"""Pose-space factors.

Port of `PriorFactor` in gtsam_points_tpu/factors/pose_factors.py (the
gauge prior of the two-scan registration): E = || Log(prior⁻¹ T) ||²_W with
W diagonal [6] in (omega, v) order, and its Jacobian by forward-mode AD at
zero tangent under the right retraction.
"""

from __future__ import annotations

import dataclasses

import torch

from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.utils import se3


@dataclasses.dataclass(frozen=True)
class PriorFactor:
    prior: torch.Tensor  # [4, 4]
    weights: torch.Tensor  # [6]
    key: int

    @property
    def keys(self):
        return (self.key,)

    def _residual(self, T: torch.Tensor) -> torch.Tensor:
        return se3.se3_log(se3.se3_inverse(self.prior) @ T)

    def linearize(self, poses: torch.Tensor) -> Linearized:
        T = poses[self.key]
        r0 = self._residual(T)
        zero = torch.zeros((6,), dtype=torch.float32, device=T.device)
        # a batch of one: forward-mode AD of a 0-d tensor times a python
        # float gives a float64 tangent in PyTorch
        J = torch.func.jacfwd(lambda xi: self._residual(T @ se3.se3_exp(xi[None]))[0])(zero)
        H = J.T @ (J * self.weights[:, None])
        b = -(J.T @ (self.weights * r0))
        z6 = torch.zeros((6, 6), dtype=torch.float32, device=T.device)
        return Linearized(
            H_tt=H,
            H_ss=z6,
            H_ts=z6,
            b_t=b,
            b_s=torch.zeros((6,), dtype=torch.float32, device=T.device),
            error=torch.sum(self.weights * r0 * r0),
            num_inliers=torch.ones((), dtype=torch.int32, device=T.device),
        )

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """E at poses [..., P, 4, 4] -> [...]."""
        r = self._residual(poses[..., self.key, :, :])
        return torch.sum(self.weights * r * r, dim=-1)
