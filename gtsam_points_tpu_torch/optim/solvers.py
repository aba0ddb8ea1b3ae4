"""Linear solvers beside the dense Cholesky of the LM.

Port of gtsam_points_tpu/optim/solvers.py:

- `cg_solve`: block-Jacobi (6x6) preconditioned conjugate gradients on a
  dense system, with the semantics of `jax.scipy.sparse.linalg.cg`: the
  stop test |r|² <= tol² |b|² (atol 0), at most 10 n iterations by default,
  the preconditioner applied to the residual. The iterations after the stop
  change nothing (masked updates), and the host reads the stop flag once
  every CG_CHECK iterations, as `optim/sparse.solve_cg_block` does;
- `schur_pose_landmark`: two-block Schur elimination (wraps
  optim/incremental.marginalize_system).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gtsam_points_tpu_torch.optim.incremental import marginalize_system
from gtsam_points_tpu_torch.optim.sparse import CG_CHECK


def block_jacobi_preconditioner(A: torch.Tensor, block: int = 6) -> Callable:
    """Invert the diagonal blocks of A once (+ 1e-8 I); apply as preconditioner."""
    n = A.shape[0] // block
    diag = torch.diagonal(A.reshape(n, block, n, block), dim1=0, dim2=2).permute(2, 0, 1)  # [n, b, b]
    inv = torch.linalg.inv_ex(diag + 1e-8 * torch.eye(block, dtype=A.dtype, device=A.device))[0]

    def apply(r):
        return (inv @ r.reshape(n, block, 1)).reshape(-1)

    return apply


def cg_solve(A: torch.Tensor, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tol: float = 1e-6,
             maxiter: Optional[int] = None, *, return_iterations: bool = False):
    """Block-Jacobi preconditioned CG on the dense system A x = b -> x, or
    (x, iterations run before the stop as a 0-d int32 tensor) when
    return_iterations."""
    M = block_jacobi_preconditioner(A)
    maxiter = 10 * b.shape[0] if maxiter is None else maxiter
    x = torch.zeros_like(b) if x0 is None else x0
    limit = tol * tol * torch.sum(b * b)
    r = b - A @ x
    z = M(r)
    p = z
    gamma = torch.sum(r * z)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    for it in range(maxiter):
        active = torch.sum(r * r) > limit
        if it % CG_CHECK == 0 and not bool(active):
            break
        Ap = A @ p
        alpha = gamma / torch.sum(p * Ap)
        r_n = r - alpha * Ap
        z_n = M(r_n)
        gamma_n = torch.sum(r_n * z_n)
        p_n = z_n + (gamma_n / gamma) * p
        x = torch.where(active, x + alpha * p, x)
        r, p, gamma = torch.where(active, r_n, r), torch.where(active, p_n, p), torch.where(active, gamma_n, gamma)
        k = k + active.to(torch.int32)
    return (x, k) if return_iterations else x


def schur_pose_landmark(A, b, pose_indices, landmark_indices):
    """Eliminate the landmark blocks onto the pose blocks (6-dof blocks on
    both sides) -> (H_poses, b_poses)."""
    return marginalize_system(A, b, list(landmark_indices), list(pose_indices))
