"""The per-factor Gauss-Newton block system.

Port of `Linearized` in gtsam_points_tpu/factors/linearized.py. Cost
convention: E = sum_i r_iᵀ W_i r_i, H = JᵀWJ, b = -JᵀWr, step = H⁻¹b.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Linearized(NamedTuple):
    """6-DoF Gauss-Newton block system of one binary factor (target, source)."""

    H_tt: torch.Tensor  # [6, 6]
    H_ss: torch.Tensor  # [6, 6]
    H_ts: torch.Tensor  # [6, 6]
    b_t: torch.Tensor  # [6]
    b_s: torch.Tensor  # [6]
    error: torch.Tensor  # ()
    num_inliers: torch.Tensor  # () int32
