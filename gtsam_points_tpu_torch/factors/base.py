"""Shared machinery for binary/unary matching-cost factors.

Port of `remap_keys`, `factor_poses` and `MatchingFactorMixin` in
gtsam_points_tpu/factors/base.py (its `register_factor` registers a JAX
pytree and has no PyTorch counterpart): a factor relates a target and a source
pose, delta = T_t⁻¹·T_s; target_key == -1 is the unary mode with a fixed
target pose. A factor that defines `residual_closure(T_t, T_s)` (a residual
function with its correspondences and weights frozen at (T_t, T_s)) gets
`linearize`, `linearize_with_error_fn` and `error` from the mixin.
"""

from __future__ import annotations

import dataclasses

import torch

from gtsam_points_tpu_torch.factors.linearized import Linearized, evaluate_error, linearize_residuals
from gtsam_points_tpu_torch.utils import se3


def remap_keys(factor, mapping: dict):
    """Copy of `factor` with every pose key k >= 0 replaced by mapping[k]
    (keys absent from the mapping, and the unary -1, are unchanged): `key`,
    `target_key` / `source_key` and `pose_keys` tuples."""

    def m(k):
        return mapping.get(k, k) if k >= 0 else k

    kwargs = {name: m(getattr(factor, name)) for name in ("key", "target_key", "source_key") if hasattr(factor, name)}
    if hasattr(factor, "pose_keys"):
        kwargs["pose_keys"] = tuple(m(k) for k in factor.pose_keys)
    if not kwargs:
        raise TypeError(f"cannot remap keys of {type(factor).__name__}")
    return dataclasses.replace(factor, **kwargs)


def factor_poses(factor, poses: torch.Tensor):
    """(T_target, T_source) of a factor from poses [..., P, 4, 4]; a leading
    batch of pose sets (the LM's lambda candidates) passes through."""
    if factor.target_key < 0:
        T_t = factor.fixed_target_pose
    else:
        T_t = poses[..., factor.target_key, :, :]
    T_s = poses[..., factor.source_key, :, :]
    return T_t, T_s


def relative_pose(factor, poses: torch.Tensor) -> torch.Tensor:
    """delta = T_t⁻¹·T_s of the factor at poses [..., P, 4, 4]."""
    T_t, T_s = factor_poses(factor, poses)
    return se3.se3_inverse(T_t) @ T_s


class MatchingFactorMixin:
    def linearize(self, poses: torch.Tensor) -> Linearized:
        T_t, T_s = factor_poses(self, poses)
        return linearize_residuals(self.residual_closure(T_t, T_s), T_t, T_s)

    def linearize_with_error_fn(self, poses: torch.Tensor):
        """-> (Linearized, frozen_error_fn). The error function scores
        candidate poses on the correspondences and weights frozen at this
        linearization point, the surrogate the LM's accept gate uses."""
        T_t, T_s = factor_poses(self, poses)
        closure = self.residual_closure(T_t, T_s)
        lin = linearize_residuals(closure, T_t, T_s)

        def err_fn(new_poses):
            return evaluate_error(closure, *factor_poses(self, new_poses))

        return lin, err_fn

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        T_t, T_s = factor_poses(self, poses)
        return evaluate_error(self.residual_closure(T_t, T_s), T_t, T_s)

    @property
    def keys(self):
        return (self.target_key, self.source_key)
