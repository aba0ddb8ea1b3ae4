"""Bundle-adjustment factors: plane and edge eigenvalue minimization (BALM)
and the moment-based LSQ plane factor.

Port of gtsam_points_tpu/factors/balm.py. Points seen from several
keyframes form one feature. The EVM cost is the smallest eigenvalue (a
plane) or the two smallest (an edge) of the scatter of the feature's points
in the world frame. The linearization is the reference's Gauss-Newton
surrogate: the eigenvectors v are frozen at the linearization point (by
`ops.eigh3`), so lambda = Σ_i (vᵀ(p_i - mu))² / N is a sum of squares whose
(6K)x(6K) system over the K keys comes from forward-mode AD. The system
depends on neither an eigenvector's sign nor, for the edge, a rotation
within the kept pair; it does depend on the choice where the eigenvalue
next to the kept ones repeats. The LSQ factor computes the same cost from
per-keyframe Gaussian moments (count, mean, covariance). All three are
`multi_linearize` factors of the graph; `error` takes poses [..., P, 4, 4]
so the LM scores its candidates in one call.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device
from gtsam_points_tpu_torch.ops.eigh3 import eigh3
from gtsam_points_tpu_torch.utils import se3


def _keyed(poses: torch.Tensor, keys) -> torch.Tensor:
    """poses [..., P, 4, 4] -> [..., K, 4, 4] at `keys`. One slice a key:
    indexing with a list would copy the list to the device and synchronize."""
    return torch.stack([poses[..., k, :, :] for k in keys], dim=-3)


def _perturbed(poses: torch.Tensor, keys, xi: torch.Tensor) -> torch.Tensor:
    """poses [P, 4, 4] with poses[k] @ Exp(xi_k) at the K keys, xi [6K], the
    K tangents through one se3_exp call."""
    exps = se3.se3_exp(xi.reshape(1, len(keys), 6))[0]
    pos = {k: i for i, k in enumerate(keys)}
    return torch.stack([poses[k] @ exps[pos[k]] if k in pos else poses[k] for k in range(poses.shape[-3])])


def _system(at, num: int, device: torch.device):
    """H = JᵀJ, b = -Jᵀr, error rᵀr of the residual function `at` at zero
    tangent [6·num]."""
    zero = torch.zeros((6 * num,), dtype=torch.float32, device=device)
    r0 = at(zero)
    J = torch.func.jacfwd(at)(zero)
    return J.T @ J, -(J.T @ r0), torch.sum(r0 * r0)


class _EVMBase:
    """Multi-key EVM machinery; subclasses set num_eigvecs."""

    @property
    def keys(self) -> Tuple[int, ...]:
        return self.pose_keys

    def _world(self, poses: torch.Tensor) -> torch.Tensor:
        """Each point in the world by its keyframe's pose: [..., N, 3]."""
        T = poses[..., self.point_keys, :, :]
        return torch.einsum("...nij,nj->...ni", T[..., :3, :3], self.points) + T[..., :3, 3]

    def _moments(self, p: torch.Tensor):
        """(mask [N] f32, count (), mean [..., 3]) of world points p."""
        m = self.mask.to(torch.float32)
        cnt = torch.clamp(torch.sum(m), min=1.0)
        return m, cnt, torch.sum(p * m[:, None], dim=-2) / cnt

    def _scatter(self, poses: torch.Tensor) -> torch.Tensor:
        """The feature's scatter in the world [..., 3, 3]."""
        p = self._world(poses)
        m, cnt, mu = self._moments(p)
        d = (p - mu[..., None, :]) * m[:, None]
        return d.transpose(-1, -2) @ d / cnt

    def _residuals(self, poses: torch.Tensor, V: torch.Tensor, sqrt_cnt: torch.Tensor) -> torch.Tensor:
        p = self._world(poses)
        m, _, mu = self._moments(p)
        return ((p - mu) @ V) * (m[:, None] / sqrt_cnt)  # [N, E]

    def multi_linearize(self, poses: torch.Tensor):
        """-> (H [6K, 6K], b [6K], error ()) over self.pose_keys at poses [P, 4, 4]."""
        V = eigh3(self._scatter(poses))[1][:, : self.num_eigvecs]  # the smallest, frozen
        sqrt_cnt = torch.sqrt(torch.clamp(torch.sum(self.mask.to(torch.float32)), min=1.0))
        return _system(lambda xi: self._residuals(_perturbed(poses, self.pose_keys, xi), V, sqrt_cnt).reshape(-1),
                       len(self.pose_keys), poses.device)

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """The sum of the num_eigvecs smallest eigenvalues at poses [..., P, 4, 4] -> [...]."""
        w, _ = eigh3(self._scatter(poses))
        return torch.sum(w[..., : self.num_eigvecs], dim=-1)


@dataclasses.dataclass(frozen=True)
class PlaneEVMFactor(_EVMBase):
    """Minimizes lambda_0 of the feature's scatter (flatness)."""

    points: torch.Tensor  # [N, 3] in their keyframes' frames
    point_keys: torch.Tensor  # [N] int64 pose index of each point
    mask: torch.Tensor  # [N]
    pose_keys: Tuple[int, ...]
    num_eigvecs: int = 1


@dataclasses.dataclass(frozen=True)
class EdgeEVMFactor(_EVMBase):
    """Minimizes lambda_0 + lambda_1 (the scatter collapsed onto a line)."""

    points: torch.Tensor
    point_keys: torch.Tensor
    mask: torch.Tensor
    pose_keys: Tuple[int, ...]
    num_eigvecs: int = 2


def make_evm_factor(kind: str, points_per_key: dict, capacity_multiple: int = 64, *, device: DeviceLike = None):
    """points_per_key: {pose key: [Ni, 3] points in that keyframe}, host
    arrays, on `device` (default `cuda`); the points are padded to a
    multiple of `capacity_multiple`. kind "plane" or "edge"."""
    dev = resolve_device(device)
    keys = tuple(sorted(points_per_key))
    pts = np.concatenate([np.asarray(points_per_key[k], dtype=np.float32).reshape(-1, 3) for k in keys])
    pk = np.concatenate([np.full((len(points_per_key[k]),), k, dtype=np.int64) for k in keys])
    n = len(pts)
    cap = ((n + capacity_multiple - 1) // capacity_multiple) * capacity_multiple
    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    pts = np.concatenate([pts, np.zeros((cap - n, 3), np.float32)])
    pk = np.concatenate([pk, np.zeros((cap - n,), np.int64)])
    cls = PlaneEVMFactor if kind == "plane" else EdgeEVMFactor
    return cls(points=torch.from_numpy(pts).to(dev), point_keys=torch.from_numpy(pk).to(dev),
               mask=torch.from_numpy(mask).to(dev), pose_keys=keys)


@dataclasses.dataclass(frozen=True)
class LsqBAFactor:
    """Plane BA on per-keyframe Gaussian moments: the cost is lambda_0 of
    the fused world scatter of the (count, mean, covariance) summaries,
    independent of the number of points."""

    counts: torch.Tensor  # [K]
    means: torch.Tensor  # [K, 3] in the keyframes' frames
    covs: torch.Tensor  # [K, 3, 3] in the keyframes' frames
    pose_keys: Tuple[int, ...]

    @property
    def keys(self):
        return self.pose_keys

    @functools.cached_property
    def _weights(self) -> torch.Tensor:
        return self.counts / torch.clamp(torch.sum(self.counts), min=1.0)

    def _fused(self, T: torch.Tensor):
        """At the keys' poses T [..., K, 4, 4] -> (world means [..., K, 3],
        world covariances [..., K, 3, 3], fused mean [..., 3], fused
        scatter [..., 3, 3])."""
        R = T[..., :3, :3]
        mu_w = torch.einsum("...kij,kj->...ki", R, self.means) + T[..., :3, 3]
        cov_w = torch.einsum("...kij,kjl,...kml->...kim", R, self.covs, R)
        w = self._weights
        mu_g = torch.sum(mu_w * w[:, None], dim=-2)
        d = mu_w - mu_g[..., None, :]
        S = torch.sum(w[:, None, None] * (cov_w + torch.einsum("...ki,...kj->...kij", d, d)), dim=-3)
        return mu_w, cov_w, mu_g, S

    def multi_linearize(self, poses: torch.Tensor):
        """-> (H [6K, 6K], b [6K], error ()) at poses [P, 4, 4]."""
        T = _keyed(poses, self.pose_keys)
        v = eigh3(self._fused(T)[3])[1][:, 0]  # the plane normal, frozen
        w = self._weights
        K = len(self.pose_keys)

        def at(xi):
            mu_w, cov_w, mu_g, _ = self._fused(T @ se3.se3_exp(xi.reshape(1, K, 6))[0])
            # lambda_0 ≈ Σ_k w_k [(vᵀ(mu_k - mu_g))² + vᵀ C_k v]
            r_mean = torch.sqrt(w) * ((mu_w - mu_g) @ v)
            r_cov = torch.sqrt(torch.clamp(torch.einsum("i,kij,j->k", v, cov_w, v) * w, min=1e-12))
            return torch.cat([r_mean, r_cov])

        return _system(at, K, poses.device)

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """lambda_0 at poses [..., P, 4, 4] -> [...]."""
        return eigh3(self._fused(_keyed(poses, self.pose_keys))[3])[0][..., 0]


def make_lsq_ba_factor(moments_per_key: dict, *, device: DeviceLike = None) -> LsqBAFactor:
    """moments_per_key: {pose key: (count, mean [3], cov [3, 3])}, host
    values, on `device` (default `cuda`)."""
    dev = resolve_device(device)
    keys = tuple(sorted(moments_per_key))

    def stack(i, shape):
        return torch.from_numpy(np.stack([np.asarray(moments_per_key[k][i], dtype=np.float32).reshape(shape)
                                          for k in keys])).to(dev)

    return LsqBAFactor(counts=stack(0, ()), means=stack(1, (3,)), covs=stack(2, (3, 3)), pose_keys=keys)
