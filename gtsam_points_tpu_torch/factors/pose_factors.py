"""Pose-space factors.

Port of gtsam_points_tpu/factors/pose_factors.py:

- `PriorFactor`: E = || Log(prior⁻¹ T) ||²_W;
- `BetweenFactor`: E = || Log(measured⁻¹ T_a⁻¹ T_b) ||²_W;
- `LinearDampingFactor`: a constant diagonal Hessian on one pose, error 0.

W is diagonal [6] in (omega, v) order. Jacobians come from forward-mode AD
at zero tangent under the right retraction, the tangents pushed through
`se3_exp` with a leading batch axis, the layout `error` takes: poses
[..., P, 4, 4] -> [...], so the LM scores its candidates in one call.
"""

from __future__ import annotations

import dataclasses

import torch

from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.utils import se3


def _unary(H: torch.Tensor, b: torch.Tensor, error: torch.Tensor) -> Linearized:
    """A one-key system: the target blocks given, the source blocks zero."""
    z6 = H.new_zeros((6, 6))
    return Linearized(H_tt=H, H_ss=z6, H_ts=z6, b_t=b, b_s=b.new_zeros((6,)), error=error,
                      num_inliers=torch.ones((), dtype=torch.int32, device=H.device))


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
        # a batch of one, the layout `error` takes
        J = torch.func.jacfwd(lambda xi: self._residual(T @ se3.se3_exp(xi[None]))[0])(zero)
        H = J.T @ (J * self.weights[:, None])
        b = -(J.T @ (self.weights * r0))
        return _unary(H, b, torch.sum(self.weights * r0 * r0))

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """E at poses [..., P, 4, 4] -> [...]."""
        r = self._residual(poses[..., self.key, :, :])
        return torch.sum(self.weights * r * r, dim=-1)


@dataclasses.dataclass(frozen=True)
class BetweenFactor:
    measured: torch.Tensor  # [4, 4]
    weights: torch.Tensor  # [6]
    target_key: int
    source_key: int

    @property
    def keys(self):
        return (self.target_key, self.source_key)

    def _residual(self, T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
        return se3.se3_log(se3.se3_inverse(self.measured) @ se3.se3_inverse(T_a) @ T_b)

    def linearize(self, poses: torch.Tensor) -> Linearized:
        T_a, T_b = poses[self.target_key], poses[self.source_key]
        r0 = self._residual(T_a, T_b)

        def at(xi):  # a batch of one, as PriorFactor's
            E = se3.se3_exp(xi.reshape(1, 2, 6))
            return self._residual(T_a @ E[:, 0], T_b @ E[:, 1])[0]

        J = torch.func.jacfwd(at)(torch.zeros((12,), dtype=torch.float32, device=T_a.device))
        H = J.T @ (J * self.weights[:, None])
        b = -(J.T @ (self.weights * r0))
        return Linearized(
            H_tt=H[:6, :6],
            H_ss=H[6:, 6:],
            H_ts=H[:6, 6:],
            b_t=b[:6],
            b_s=b[6:],
            error=torch.sum(self.weights * r0 * r0),
            num_inliers=torch.ones((), dtype=torch.int32, device=T_a.device),
        )

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """E at poses [..., P, 4, 4] -> [...]."""
        r = self._residual(poses[..., self.target_key, :, :], poses[..., self.source_key, :, :])
        return torch.sum(self.weights * r * r, dim=-1)


@dataclasses.dataclass(frozen=True)
class LinearDampingFactor:
    """A constant diagonal Hessian prior for gauge fixing."""

    weights: torch.Tensor  # [6]
    key: int

    @property
    def keys(self):
        return (self.key,)

    def linearize(self, poses: torch.Tensor) -> Linearized:
        return _unary(torch.diag(self.weights), self.weights.new_zeros((6,)), self.weights.new_zeros(()))

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """0 at poses [..., P, 4, 4] -> [...]."""
        return poses.new_zeros(poses.shape[:-3])
