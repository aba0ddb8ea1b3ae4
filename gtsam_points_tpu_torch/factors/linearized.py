"""Gauss-Newton linearization core shared by the matching-cost factors.

Port of gtsam_points_tpu/factors/linearized.py. A factor is defined by its
residual alone: the per-point Jacobians come from forward-mode AD
(`torch.func.jacfwd`) of the residual at zero tangent under the right
retraction T·Exp(xi), and the masked reduction forms the binary block
system. Cost convention: E = sum_i r_iᵀ W_i r_i, H = JᵀWJ, b = -JᵀWr,
step = H⁻¹b.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gtsam_points_tpu_torch.utils import se3


class Linearized(NamedTuple):
    """6-DoF Gauss-Newton block system of one binary factor (target, source)."""

    H_tt: torch.Tensor  # [6, 6]
    H_ss: torch.Tensor  # [6, 6]
    H_ts: torch.Tensor  # [6, 6]
    b_t: torch.Tensor  # [6]
    b_s: torch.Tensor  # [6]
    error: torch.Tensor  # ()
    num_inliers: torch.Tensor  # () int32


def linearize_residuals(residual_fn: Callable, T_target: torch.Tensor, T_source: torch.Tensor) -> Linearized:
    """Linearize sum_i r_iᵀ W_i r_i around (T_target, T_source).

    residual_fn(T_t, T_s) -> (r [N, D], W, mask [N]), W [N, D, D], [N]
    (scalar weights) or None (identity). W and mask must not depend on the
    perturbation: they are frozen at the linearization point.
    """
    zero = torch.zeros((12,), dtype=torch.float32, device=T_source.device)

    def at(xi):
        # both tangents go through se3_exp as one [2, 6] batch, one call
        exps = se3.se3_exp(xi.reshape(2, 6))
        return residual_fn(T_target @ exps[0], T_source @ exps[1])[0]

    r0, W, mask = residual_fn(T_target, T_source)
    J = torch.func.jacfwd(at)(zero)  # [N, D, 12]
    return reduce_system(r0, J, W, mask)


def reduce_system(r: torch.Tensor, J: torch.Tensor, W, mask: torch.Tensor) -> Linearized:
    """Masked reduction of per-point r [N, D], J [N, D, 12] and W into a
    Linearized."""
    n, d = r.shape
    m = mask.to(r.dtype)
    if W is None:
        Wr = r * m[:, None]
        WJ = J * m[:, None, None]
    elif W.ndim == 1:
        Wr = r * (W * m)[:, None]
        WJ = J * (W * m)[:, None, None]
    else:
        Wm = W * m[:, None, None]
        Wr = torch.einsum("nij,nj->ni", Wm, r)
        WJ = torch.einsum("nij,njk->nik", Wm, J)

    Jf = J.reshape(n * d, 12)
    H = Jf.T @ WJ.reshape(n * d, 12)
    b = -(Jf.T @ Wr.reshape(n * d))
    err = torch.sum(Wr.reshape(n * d) * r.reshape(n * d))
    return Linearized(
        H_tt=H[:6, :6],
        H_ss=H[6:, 6:],
        H_ts=H[:6, 6:],
        b_t=b[:6],
        b_s=b[6:],
        error=err,
        num_inliers=torch.sum(mask.to(torch.int32)),
    )


def evaluate_error(residual_fn: Callable, T_target: torch.Tensor, T_source: torch.Tensor) -> torch.Tensor:
    """E at (T_target, T_source); a leading batch of poses gives a batch of
    errors, residuals [..., N, D]."""
    r, W, mask = residual_fn(T_target, T_source)
    m = mask.to(r.dtype)
    if W is None:
        return torch.sum(r * r * m[:, None], dim=(-2, -1))
    if W.ndim == 1:
        return torch.sum(torch.sum(r * r, dim=-1) * W * m, dim=-1)
    return torch.sum(torch.einsum("...ni,nij,...nj->...n", r, W, r) * m, dim=-1)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate over determinant).

    A near-singular input (|det| <= 1e-9 x its diagonal scale cubed, + 1e-30)
    returns zero, so a degenerate correspondence contributes nothing
    instead of dominating the cost, as in the reference."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    scale = (torch.abs(a) + torch.abs(e) + torch.abs(i)) / 3.0
    bad = torch.abs(det) <= 1e-9 * scale * scale * scale + 1e-30
    inv_det = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, det))
    adj = torch.stack(
        [
            torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def add_blocks(A: torch.Tensor, b: torch.Tensor, keys, lin) -> torch.Tensor:
    """Add a one- or two-key system to A [P, P, 6, 6], b [P, 6] in place (a
    target key < 0 is the fixed target: its blocks are dropped) -> its error."""
    if len(keys) == 1:
        (k,) = keys
        A[k, k] += lin.H_tt
        b[k] += lin.b_t
        return lin.error
    t, s = keys
    if t >= 0:
        A[t, t] += lin.H_tt
        A[t, s] += lin.H_ts
        A[s, t] += lin.H_ts.T
        b[t] += lin.b_t
    A[s, s] += lin.H_ss
    b[s] += lin.b_s
    return lin.error
