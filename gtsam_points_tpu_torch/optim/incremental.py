"""Marginal priors, Schur-complement marginalization and the fixed-lag smoother.

Port of gtsam_points_tpu/optim/incremental.py. The window of recent poses is
relinearized whole each update; poses that leave it are marginalized by
Schur complement into a dense `MarginalPriorFactor` over the poses they were
linked to, which keeps their information exactly at the linearization point.
`FixedLagSmoother` keys the window by timestamp and runs on `ISAM2Ext`
(optim/isam2.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike
from gtsam_points_tpu_torch.factors.misc_factors import _MultiKeyAD
from gtsam_points_tpu_torch.optim.lm import LMParams
from gtsam_points_tpu_torch.utils import se3


@dataclasses.dataclass(frozen=True)
class MarginalPriorFactor(_MultiKeyAD):
    """Dense Gaussian prior over K keys at a linearization point:
    E = || Lᵀ (delta - delta*) ||², delta_k = Log(T_lin_k⁻¹ T_k).

    Its (6K)x(6K) system comes from `torch.func.jacfwd` over the K-key
    tangent (`_MultiKeyAD.multi_linearize`), so the graph adds it through
    its `multi_linearize` branch; `error` takes poses [..., P, 4, 4]."""

    lin_poses: torch.Tensor  # [K, 4, 4]
    sqrt_info_t: torch.Tensor  # [6K, 6K] = Lᵀ with H = L Lᵀ
    delta_star: torch.Tensor  # [6K]
    pose_keys: Tuple[int, ...]

    def _residual(self, T: torch.Tensor) -> torch.Tensor:
        """T [..., K, 4, 4] -> Lᵀ (delta - delta*) [..., 6K]."""
        d = se3.se3_log(se3.se3_inverse(self.lin_poses) @ T)
        d = d.reshape(d.shape[:-2] + (-1,)) - self.delta_star
        return (self.sqrt_info_t @ d[..., None])[..., 0]


def _block_indices(blocks: Sequence[int], device: torch.device) -> torch.Tensor:
    return torch.tensor([6 * k + i for k in blocks for i in range(6)], dtype=torch.long, device=device)


def marginalize_system(A: torch.Tensor, b: torch.Tensor, marg: List[int], keep: List[int]):
    """Schur complement: eliminate the 6-blocks `marg` of A [6P, 6P], b [6P]
    -> (H_keep, b_keep). H_mm + 1e-6 I is solved by LU without an error
    check (`torch.linalg.solve_ex`), so nothing is read from the device."""
    mi, ki = _block_indices(marg, A.device), _block_indices(keep, A.device)
    H_mm = A[mi][:, mi] + 1e-6 * torch.eye(len(mi), dtype=A.dtype, device=A.device)
    H_km = A[ki][:, mi]
    H_kk = A[ki][:, ki]
    sol = torch.linalg.solve_ex(H_mm, torch.cat([H_km.T, b[mi][:, None]], dim=1))[0]
    X = sol[:, :-1]  # H_mm⁻¹ H_mk
    y = sol[:, -1]  # H_mm⁻¹ b_m
    return H_kk - H_km @ X, b[ki] - H_km @ y


def marginal_information(H: torch.Tensor, bk: torch.Tensor):
    """Symmetrize H, add 1e-6 I, factor H = L Lᵀ -> (Lᵀ, delta* = H⁻¹ bk).
    Where H is not positive definite, L's lower triangle and delta* are NaN,
    as the reference's Cholesky gives them; the window's LM then cannot move
    and the update keeps the previous estimates. The factorization's status
    is a device tensor (`cholesky_ex`), so nothing is read from the device."""
    H = 0.5 * (H + H.T) + 1e-6 * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(H)
    ok = info == 0
    L = torch.where(ok, L, torch.tril(torch.full_like(L, float("nan"))))
    return L.T, torch.cholesky_solve(bk[:, None], L)[:, 0]


def make_marginal_prior(A, b, poses, marg: List[int], keep: List[int]) -> MarginalPriorFactor:
    """The dense prior carrying the information of `marg` onto `keep`."""
    sqrt_info_t, delta_star = marginal_information(*marginalize_system(A, b, marg, keep))
    keep_idx = torch.tensor(keep, dtype=torch.long, device=poses.device)
    return MarginalPriorFactor(
        lin_poses=poses[keep_idx],
        sqrt_info_t=sqrt_info_t,
        delta_star=delta_star,
        pose_keys=tuple(keep),
    )


class FixedLagSmoother:
    """Timestamp-keyed sliding-window smoother on ISAM2Ext's machinery.

    update(key, stamp, initial_pose, factors) adds a pose and its factors,
    marginalizes the poses older than `lag` into a MarginalPriorFactor
    (their estimates frozen) and optimizes the remaining window with LM.
    A factor that reaches a frozen pose (`add_factors`) relaxes the frozen
    history as ISAM2Ext's late loop closures do."""

    def __init__(self, lag: float = 10.0, lm_params: Optional[LMParams] = None, max_poses: int = 1024, *,
                 device: DeviceLike = None):
        from gtsam_points_tpu_torch.optim.isam2 import ISAM2Ext  # isam2 imports this module

        del max_poses  # the reference's legacy capacity: the window is the capacity
        self.lag = lag
        self._isam = ISAM2Ext(window_size=1 << 30, lm_params=lm_params or LMParams(max_iterations=10), device=device)
        self.stamps: Dict[int, float] = {}

    @property
    def frozen(self) -> Dict[int, np.ndarray]:
        return self._isam.frozen

    @property
    def active(self) -> List[int]:
        return list(self._isam.window)

    @property
    def num_compiles(self) -> int:
        return self._isam.num_compiles

    def update(self, key: int, stamp: float, initial_pose, factors: List):
        self.stamps[key] = stamp
        horizon = stamp - self.lag
        to_marg = [k for k in self._isam.window if self.stamps.get(k, stamp) < horizon]
        if to_marg:
            self._isam._marginalize(to_marg)
        self._isam.update(factors, {key: initial_pose})
        return self._isam.calculate_estimate()

    def add_factors(self, factors: List):
        """Factors without a new pose, such as a late loop closure -> ISAM2ResultExt."""
        return self._isam.update(factors)

    def estimate(self, key: int) -> np.ndarray:
        return self._isam.calculate_estimate_pose(key)
