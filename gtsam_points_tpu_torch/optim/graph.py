"""Factor graph container and its dense linearization.

Port of `FactorGraph` (correspondences, linearize_frozen, linearize_full) and
`retract` in gtsam_points_tpu/optim/graph.py, for the factors this port has:
matching factors that cache correspondences (`correspondences` +
`linearize_corr`). Other factor kinds raise until they are ported.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from gtsam_points_tpu_torch.utils import se3


def _is_matching(f) -> bool:
    return hasattr(f, "correspondences") and hasattr(f, "linearize_corr")


class FactorGraph:
    """An ordered list of factors over a pose array [P, 4, 4]."""

    def __init__(self, factors: Sequence = (), num_poses: int = 0):
        self.factors: List = list(factors)
        self.num_poses = num_poses

    def add(self, factor) -> "FactorGraph":
        self.factors.append(factor)
        for k in factor.keys:
            self.num_poses = max(self.num_poses, k + 1)
        return self

    def __len__(self):
        return len(self.factors)

    def correspondences(self, poses: torch.Tensor):
        """Per-factor correspondence caches at `poses`."""
        return tuple(f.correspondences(poses) if _is_matching(f) else None for f in self.factors)

    def linearize_frozen(self, poses: torch.Tensor, corr=None):
        """-> (A [6P, 6P], b [6P], error (), frozen_error_fn). frozen_error_fn
        scores candidate poses [..., P, 4, 4] with every factor's
        correspondences frozen at this linearization point. `corr` (from
        correspondences()) skips the per-factor search."""
        p = self.num_poses
        A = poses.new_zeros((p, p, 6, 6))
        b = poses.new_zeros((p, 6))
        err = poses.new_zeros(())
        err_fns = []
        for fi, f in enumerate(self.factors):
            if not _is_matching(f):
                raise NotImplementedError(f"{type(f).__name__} is not ported yet")
            fcorr = corr[fi] if corr is not None and corr[fi] is not None else f.correspondences(poses)
            lin, efn = f.linearize_corr(poses, fcorr)
            err_fns.append(efn)
            t, s = f.keys
            if t >= 0:
                A[t, t] += lin.H_tt
                A[t, s] += lin.H_ts
                A[s, t] += lin.H_ts.T
                b[t] += lin.b_t
            A[s, s] += lin.H_ss
            b[s] += lin.b_s
            err = err + lin.error
        A_full = A.permute(0, 2, 1, 3).reshape(6 * p, 6 * p)

        def frozen_error(new_poses):
            total = 0.0
            for efn in err_fns:
                total = total + efn(new_poses)
            return total

        return A_full, b.reshape(6 * p), err, frozen_error

    def linearize_full(self, poses: torch.Tensor):
        """-> (A [6P, 6P], b [6P], error ())."""
        A, b, err, _ = self.linearize_frozen(poses)
        return A, b, err

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        err = poses.new_zeros(())
        for f in self.factors:
            err = err + f.error(poses)
        return err


def retract(poses: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Right retraction T_i <- T_i · Exp(delta_i); delta [..., 6P] gives
    poses [..., P, 4, 4]."""
    p = poses.shape[-3]
    return poses @ se3.se3_exp(delta.reshape(delta.shape[:-1] + (p, 6)))
