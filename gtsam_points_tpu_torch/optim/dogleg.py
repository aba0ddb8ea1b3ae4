"""Dogleg trust-region optimizer and gradient descent.

Port of gtsam_points_tpu/optim/dogleg.py. A Dogleg step blends the
Gauss-Newton step (a Cholesky solve of A + 1e-8 I, as the reference's
`cho_solve`; a failed factorisation gives the zero step) with the
steepest-descent (Cauchy) step inside a trust radius Delta, and adapts Delta
by the model's fidelity. Candidates are scored on the correspondences
frozen at the linearization point, as in `optimize_lm`. The reference's
`lax.while_loop` becomes a loop that reads its `done` flag once an
iteration, as `optimize_lm` does.

`gradient_descent` steps along the gradient of `graph.error` at zero
tangent, taken by `torch.autograd` (the reference's `jax.grad`; that one
returns NaN, because reverse-mode AD of sqrt at 0 in `se3_exp` gives NaN,
which the port's `se3._safe_sqrt` avoids).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gtsam_points_tpu_torch.optim.graph import FactorGraph, retract
from gtsam_points_tpu_torch.utils.solve6 import cho_solve


@dataclasses.dataclass(frozen=True)
class DoglegParams:
    max_iterations: int = 20
    initial_delta: float = 1.0
    min_delta: float = 1e-5
    max_delta: float = 1e3
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5


class DoglegResult(NamedTuple):
    poses: torch.Tensor
    error: torch.Tensor
    delta: torch.Tensor
    num_iterations: torch.Tensor


def _step(A: torch.Tensor, b: torch.Tensor, Delta: torch.Tensor) -> torch.Tensor:
    """The dogleg step of the model (A, b) inside the trust radius Delta."""
    dx_gn = cho_solve(A + 1e-8 * torch.eye(A.shape[0], dtype=A.dtype, device=A.device), b)
    dx_gn = torch.where(torch.all(torch.isfinite(dx_gn)), dx_gn, 0.0)
    # Cauchy step: alpha = gᵀg / gᵀAg with g = b
    gAg = b @ (A @ b)
    alpha = torch.where(gAg > 1e-12, (b @ b) / gAg, 0.0)
    dx_sd = alpha * b
    n_gn = torch.linalg.norm(dx_gn)
    n_sd = torch.linalg.norm(dx_sd)
    # on the segment dx_sd -> dx_gn, tau where the norm reaches Delta
    d = dx_gn - dx_sd
    a_ = d @ d
    b_ = 2.0 * (dx_sd @ d)
    c_ = n_sd * n_sd - Delta * Delta
    disc = torch.clamp(b_ * b_ - 4 * a_ * c_, min=0.0)
    tau = (-b_ + torch.sqrt(disc)) / torch.clamp(2 * a_, min=1e-12)
    blend = dx_sd + torch.clamp(tau, 0.0, 1.0) * d
    return torch.where(
        n_gn <= Delta,
        dx_gn,
        torch.where(n_sd >= Delta, dx_sd * (Delta / torch.clamp(n_sd, min=1e-12)), blend),
    )


def optimize_dogleg(graph: FactorGraph, poses: torch.Tensor, params: Optional[DoglegParams] = None) -> DoglegResult:
    """Run Dogleg from poses [P, 4, 4] to convergence, a stall (a rejected
    step at the smallest radius) or max_iterations."""
    p = params or DoglegParams()
    f32 = dict(dtype=torch.float32, device=poses.device)
    Delta = torch.full((), p.initial_delta, **f32)
    err0 = torch.full((), float("inf"), **f32)
    it = torch.zeros((), dtype=torch.int32, device=poses.device)
    for _ in range(p.max_iterations):
        A, b, err_lin, frozen_err = graph.linearize_frozen(poses)
        dx = _step(A, b, Delta)
        pred = 2.0 * (b @ dx) - dx @ (A @ dx)
        cand = retract(poses, dx)
        cand_err = frozen_err(cand)
        rho = (err_lin - cand_err) / torch.clamp(pred, min=1e-10)
        accept = (pred > 0) & (rho > 0.0) & torch.isfinite(cand_err)
        poses = torch.where(accept, cand, poses)
        Delta = torch.where(
            rho > 0.75,
            torch.clamp(Delta * 2.0, max=p.max_delta),
            torch.where(rho < 0.25, torch.clamp(Delta * 0.25, min=p.min_delta), Delta),
        )
        err_new = torch.where(accept, cand_err, err_lin)
        decrease = err0 - err_new
        converged = accept & (
            (torch.abs(decrease) < p.absolute_error_tol) | (torch.abs(decrease) < p.relative_error_tol * torch.abs(err0))
        )
        stalled = ~accept & (Delta <= p.min_delta)
        err0 = err_new
        it = it + 1
        if bool(converged | stalled):
            break
    return DoglegResult(poses=poses, error=err0, delta=Delta, num_iterations=it)


def gradient_descent(graph: FactorGraph, poses: torch.Tensor, iterations: int = 100, step: float = 1e-3):
    """`iterations` steps poses <- poses · Exp(-step · grad) of the graph
    error at zero tangent -> (poses, error)."""
    for _ in range(iterations):
        xi = torch.zeros((poses.shape[0] * 6,), dtype=torch.float32, device=poses.device, requires_grad=True)
        (g,) = torch.autograd.grad(graph.error(retract(poses, xi)), xi)
        poses = retract(poses, -step * g)
    with torch.no_grad():
        return poses, graph.error(poses)
