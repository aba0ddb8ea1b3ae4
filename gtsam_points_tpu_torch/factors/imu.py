"""IMU re-integration factor.

Port of gtsam_points_tpu/factors/imu.py. The raw IMU samples are
re-integrated at every linearization (not preintegrated around a fixed
bias): `reintegrate` is a plain differentiable function of the biases, so
`torch.func.jacfwd` gives its exact bias Jacobians. The factor couples two
pose keys; the velocity at the first key and the biases are stored
parameters, as in the reference package.

`reintegrate` forms every sample's bias-corrected acceleration and
rotation increment Exp(w dt) in one batch, then chains them in a Python
loop over the M samples (the reference scans them); a zero-`dt` padded
sample leaves the state unchanged. The factor re-integrates once a
linearization, outside the pose Jacobian (the deltas do not depend on the
poses), and once an error evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device
from gtsam_points_tpu_torch.factors.misc_factors import _MultiKeyAD
from gtsam_points_tpu_torch.utils import se3

GRAVITY = (0.0, 0.0, -9.80665)  # world frame, m/s²; a tensor of it is made on each operand's device
_GRAVITY: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}


def _gravity(like: torch.Tensor) -> torch.Tensor:
    """GRAVITY [3] on `like`'s device and dtype, made once: a module-level
    CPU tensor would raise beside a CUDA operand or be copied to the device
    on every call."""
    key = (like.device, like.dtype)
    if key not in _GRAVITY:
        _GRAVITY[key] = torch.tensor(GRAVITY, dtype=like.dtype, device=like.device)
    return _GRAVITY[key]


class ImuMeasurements(NamedTuple):
    """Raw IMU samples, zero-padded to a capacity M.

    dts [M] f32 integration intervals (s), accs [M, 3] f32 specific force
    and gyros [M, 3] f32 angular velocity, both in the body frame."""

    dts: torch.Tensor
    accs: torch.Tensor
    gyros: torch.Tensor


def make_imu_measurements(stamps, accs, gyros, capacity: Optional[int] = None, *,
                          device: DeviceLike = None) -> ImuMeasurements:
    """Samples at `stamps` -> ImuMeasurements with dt_i = stamp_i -
    stamp_{i-1} (0 for the first), zero-padded (or cut) to `capacity`."""
    dev = resolve_device(device)
    stamps = np.asarray(stamps, np.float32)
    dts = np.diff(stamps, prepend=stamps[0])
    m = len(dts)
    cap = capacity or m

    def pad(a, d):
        out = np.zeros((cap,) + d, np.float32)
        out[:m] = np.asarray(a, np.float32)[:cap]
        return torch.from_numpy(out).to(dev)

    return ImuMeasurements(dts=pad(dts, ()), accs=pad(accs, (3,)), gyros=pad(gyros, (3,)))


def reintegrate(meas: ImuMeasurements, bias_acc: torch.Tensor, bias_gyro: torch.Tensor, gravity=GRAVITY):
    """Integrate the samples -> (delta_R [3, 3], delta_p [3], delta_v [3],
    total dt): gravity-free body-frame deltas, recomputed from scratch
    (gravity enters at prediction). `gravity` is accepted and unused, as in
    the JAX package's signature."""
    dts = meas.dts
    accs = meas.accs - bias_acc
    steps = se3.so3_exp((meas.gyros - bias_gyro) * dts[:, None])  # [M, 3, 3]
    R = torch.eye(3, dtype=dts.dtype, device=dts.device)
    p = dts.new_zeros(3)
    v = dts.new_zeros(3)
    half = torch.tensor(0.5, dtype=dts.dtype)
    for dt, a, E in zip(dts.unbind(0), accs.unbind(0), steps.unbind(0)):
        Ra = R @ a
        p = p + v * dt + half * Ra * dt * dt
        v = v + Ra * dt
        R = R @ E
    return R, p, v, torch.sum(dts)


@dataclasses.dataclass(frozen=True)
class ReintegratedImuFactor(_MultiKeyAD):
    """Couples poses (i, j) through the re-integrated IMU delta; residual
    (6): sqrt(w) [Log(dR_imuᵀ R_iᵀ R_j); R_iᵀ(p_j - p_i - v_i dt - ½ g dt²)
    - dp_imu]."""

    measurements: ImuMeasurements
    v_i: torch.Tensor  # [3] world-frame velocity at i
    bias_acc: torch.Tensor  # [3]
    bias_gyro: torch.Tensor  # [3]
    weights: torch.Tensor  # [6]
    pose_keys: Tuple[int, int]

    def _deltas(self):
        return reintegrate(self.measurements, self.bias_acc, self.bias_gyro)

    def multi_linearize(self, poses: torch.Tensor):
        """-> (H [12, 12], b [12], error ()) at poses [P, 4, 4]; one
        re-integration, then the pose Jacobian of the residual on it."""
        deltas = self._deltas()
        return self._linearize_with(poses, lambda T: self._residual(T, deltas))

    def _residual(self, T: torch.Tensor, deltas=None) -> torch.Tensor:
        """T [..., 2, 4, 4] -> [..., 6], re-integrating unless given the deltas."""
        dR, dp, _, dt = self._deltas() if deltas is None else deltas
        g = _gravity(dp)
        R_i, p_i = T[..., 0, :3, :3], T[..., 0, :3, 3]
        R_j, p_j = T[..., 1, :3, :3], T[..., 1, :3, 3]
        R_it = R_i.transpose(-1, -2)
        r_rot = se3.so3_log(dR.T @ R_it @ R_j)
        d = p_j - p_i - self.v_i * dt - 0.5 * g * dt * dt
        r_pos = (R_it @ d[..., None])[..., 0] - dp
        return torch.sqrt(self.weights) * torch.cat([r_rot, r_pos], dim=-1)

    def predict(self, T_i: torch.Tensor):
        """Pose j [4, 4] and velocity v_j [3] predicted from pose i."""
        dR, dp, dv, dt = self._deltas()
        g = _gravity(dp)
        R_i, p_i = T_i[:3, :3], T_i[:3, 3]
        R_j = R_i @ dR
        p_j = p_i + self.v_i * dt + 0.5 * g * dt * dt + R_i @ dp
        v_j = self.v_i + g * dt + R_i @ dv
        return se3.make_transform(R_j, p_j), v_j
