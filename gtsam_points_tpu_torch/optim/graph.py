"""Factor graph container and its dense linearization.

Port of `FactorGraph` (correspondences, linearize_frozen, linearize_full) and
`retract` in gtsam_points_tpu/optim/graph.py, with the reference's order of
dispatch: matching factors that cache correspondences (`correspondences` +
`linearize_corr`), factor sets that add themselves to the system
(`add_to_system`, factors/batch.py), factors over any number of keys
(`multi_linearize`, factors/misc_factors.py), and factors of one key or two
(`linearize_with_error_fn`, or `linearize` + `error`).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from gtsam_points_tpu_torch.factors.linearized import add_blocks
from gtsam_points_tpu_torch.utils import se3


def _is_matching(f) -> bool:
    return hasattr(f, "correspondences") and hasattr(f, "linearize_corr")


def _add_multi(A: torch.Tensor, b: torch.Tensor, keys, Hm: torch.Tensor, bm: torch.Tensor) -> None:
    """Add a K-key system H [6K, 6K], b [6K] to A, b in place."""
    k = len(keys)
    Hm = Hm.reshape(k, 6, k, 6)
    bm = bm.reshape(k, 6)
    for i, ki in enumerate(keys):
        b[ki] += bm[i]
        for j, kj in enumerate(keys):
            A[ki, kj] += Hm[i, :, j, :]


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
            if _is_matching(f):
                fcorr = corr[fi] if corr is not None and corr[fi] is not None else f.correspondences(poses)
                lin, efn = f.linearize_corr(poses, fcorr)
                errf = add_blocks(A, b, f.keys, lin)
            elif hasattr(f, "add_to_system"):
                A, b, errf, efn = f.add_to_system(A, b, poses)
            elif hasattr(f, "multi_linearize"):
                Hm, bm, errf = f.multi_linearize(poses)
                _add_multi(A, b, f.keys, Hm, bm)
                efn = f.error
            else:
                if hasattr(f, "linearize_with_error_fn"):
                    lin, efn = f.linearize_with_error_fn(poses)
                else:
                    lin, efn = f.linearize(poses), f.error
                errf = add_blocks(A, b, f.keys, lin)
            err_fns.append(efn)
            err = err + errf
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
