"""Analytic pose factors over several keys.

Port of gtsam_points_tpu/factors/misc_factors.py: `Pose3CalibFactor`,
`Pose3InterpolationFactor` and `RotateVector3Factor`, on the same
`multi_linearize` protocol: each defines `_residual(T [..., K, 4, 4]) ->
[..., D]` over its `pose_keys`, and the (6K)x(6K) system comes from
forward-mode AD at zero tangent under the right retraction. The tangents go
through `se3_exp` as a batch of one, as PriorFactor's. `error` takes
poses [..., P, 4, 4] and returns [...], so the LM scores its candidates in
one call.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from gtsam_points_tpu_torch.utils import se3


class _MultiKeyAD:
    @property
    def keys(self) -> Tuple[int, ...]:
        return self.pose_keys

    def _sub(self, poses: torch.Tensor) -> torch.Tensor:
        """poses [..., P, 4, 4] -> the factor's poses [..., K, 4, 4]. One
        slice a key: indexing with a list would copy the list to the device
        and synchronize."""
        return torch.stack([poses[..., k, :, :] for k in self.pose_keys], dim=-3)

    def multi_linearize(self, poses: torch.Tensor):
        """-> (H [6K, 6K], b [6K], error ()) at poses [P, 4, 4]."""
        return self._linearize_with(poses, self._residual)

    def _linearize_with(self, poses: torch.Tensor, residual):
        """multi_linearize of `residual` (T [..., K, 4, 4] -> [..., D])."""
        K = len(self.pose_keys)
        sub = self._sub(poses)

        def at(xi):
            return residual(sub @ se3.se3_exp(xi.reshape(1, K, 6)))[0]

        zero = torch.zeros((K * 6,), dtype=torch.float32, device=poses.device)
        r0 = at(zero)
        J = torch.func.jacfwd(at)(zero)
        return J.T @ J, -(J.T @ r0), torch.sum(r0 * r0)

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """E at poses [..., P, 4, 4] -> [...]."""
        r = self._residual(self._sub(poses))
        return torch.sum(r * r, dim=-1)


@dataclasses.dataclass(frozen=True)
class Pose3CalibFactor(_MultiKeyAD):
    """Extrinsic calibration: world_T_sensor = world_T_base · base_T_sensor.
    Keys: (world_T_base, base_T_sensor, world_T_sensor)."""

    weights: torch.Tensor  # [6]
    pose_keys: Tuple[int, int, int]

    def _residual(self, T: torch.Tensor) -> torch.Tensor:
        pred = T[..., 0, :, :] @ T[..., 1, :, :]
        return torch.sqrt(self.weights) * se3.se3_log(se3.se3_inverse(pred) @ T[..., 2, :, :])


@dataclasses.dataclass(frozen=True)
class Pose3InterpolationFactor(_MultiKeyAD):
    """T_mid must equal the twist interpolation of (T_a, T_b) at ratio t.
    Keys: (T_a, T_b, T_mid)."""

    t: torch.Tensor  # () interpolation ratio in [0, 1]
    weights: torch.Tensor  # [6]
    pose_keys: Tuple[int, int, int]

    def _residual(self, T: torch.Tensor) -> torch.Tensor:
        T_a = T[..., 0, :, :]
        xi = se3.se3_log(se3.se3_inverse(T_a) @ T[..., 1, :, :])
        pred = T_a @ se3.se3_exp(self.t * xi)
        return torch.sqrt(self.weights) * se3.se3_log(se3.se3_inverse(pred) @ T[..., 2, :, :])


@dataclasses.dataclass(frozen=True)
class RotateVector3Factor(_MultiKeyAD):
    """R(T) · local must equal world (direction alignment, e.g. gravity).
    Key: (T,)."""

    local: torch.Tensor  # [3]
    world: torch.Tensor  # [3]
    weights: torch.Tensor  # [3]
    pose_keys: Tuple[int]

    def _residual(self, T: torch.Tensor) -> torch.Tensor:
        pred = T[..., 0, :3, :3] @ self.local
        return torch.sqrt(self.weights) * (pred - self.world)
