"""Shared machinery for binary/unary matching-cost factors.

Port of `factor_poses` and the `keys` property of
gtsam_points_tpu/factors/base.py: a factor relates a target and a source
pose, delta = T_t⁻¹·T_s; target_key == -1 is the unary mode with a fixed
target pose.
"""

from __future__ import annotations

import torch


def factor_poses(factor, poses: torch.Tensor):
    """(T_target, T_source) of a factor from poses [..., P, 4, 4]; a leading
    batch of pose sets (the LM's lambda candidates) passes through."""
    if factor.target_key < 0:
        T_t = factor.fixed_target_pose
    else:
        T_t = poses[..., factor.target_key, :, :]
    T_s = poses[..., factor.source_key, :, :]
    return T_t, T_s


class MatchingFactorMixin:
    @property
    def keys(self):
        return (self.target_key, self.source_key)
