"""Levenberg-Marquardt optimizer.

Port of gtsam_points_tpu/optim/lm.py. The reference's `lax.while_loop` and
`lax.cond`s become a Python loop over device tensors that fills the same
status arrays. Kept as in the reference:

- the correspondence cache gate: with a nonzero update tolerance, matching
  factors re-probe only when a pose moved beyond it, and a fixed point on
  cached correspondences forces one more refreshed round;
- the batched lambda ladder: all K damped systems lam·f^k are solved and
  retracted at once; candidate 0 is scored first and the other K-1 only if
  it is rejected; the first acceptable candidate wins, so accept, lambda and
  tries are those of the sequential trial loop.

Cost model: E(δ) ≈ E0 - 2 bᵀδ + δᵀAδ, step δ = (A + λ·damp)⁻¹ b, predicted
decrease = 2bᵀδ - δᵀAδ. The host reads the device once per outer iteration
(twice when candidate 0 is rejected, three times with the cache gate on).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gtsam_points_tpu_torch.optim.graph import FactorGraph, retract
from gtsam_points_tpu_torch.utils import se3
from gtsam_points_tpu_torch.utils.solve6 import solve_small


@dataclasses.dataclass(frozen=True)
class LMParams:
    max_iterations: int = 20
    max_inner_iterations: int = 10
    lambda_initial: float = 1e-5
    lambda_factor: float = 10.0
    lambda_lower_bound: float = 1e-10
    lambda_upper_bound: float = 1e5
    min_fidelity: float = 1e-3
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5
    step_tol: float = 1e-4  # accepted-step norm below which LM has converged
    diagonal_damping: bool = True
    # 0.0 = search correspondences every iteration
    correspondence_update_tolerance_rot: float = 0.0
    correspondence_update_tolerance_trans: float = 0.0


class LMStatus(NamedTuple):
    """Per-iteration telemetry."""

    error: torch.Tensor  # [max_iter] error at each linearization point
    lambda_: torch.Tensor  # [max_iter] lambda after each iteration
    inner_iterations: torch.Tensor  # [max_iter] int32 lambda tries
    num_iterations: torch.Tensor  # () int32


class LMResult(NamedTuple):
    poses: torch.Tensor
    error: torch.Tensor
    status: LMStatus


def _solve_damped(A: torch.Tensor, b: torch.Tensor, lams: torch.Tensor, diagonal_damping: bool):
    """Damped solves for every lambda: A [n, n], b [n], lams [K] ->
    (delta [K, n], ok [K]); a non-finite solve gives a zero step."""
    if diagonal_damping:
        damp = torch.diag(torch.clamp(torch.diagonal(A), min=1e-10))
    else:
        damp = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    Ad = A + lams[:, None, None] * damp
    delta = solve_small(Ad, b.expand(lams.shape[0], -1))
    ok = torch.all(torch.isfinite(delta), dim=-1)
    return torch.where(ok[:, None], delta, 0.0), ok


def optimize_lm(graph: FactorGraph, poses: torch.Tensor, params: Optional[LMParams] = None) -> LMResult:
    """Run LM from poses [P, 4, 4] to convergence or max_iterations."""
    p = params or LMParams()
    dev = poses.device
    f32 = dict(dtype=torch.float32, device=dev)
    max_it = p.max_iterations
    K = p.max_inner_iterations
    use_corr_cache = (
        p.correspondence_update_tolerance_rot > 0.0 or p.correspondence_update_tolerance_trans > 0.0
    )

    st_error = torch.full((max_it,), float("inf"), **f32)
    st_lambda = torch.zeros((max_it,), **f32)
    st_inner = torch.zeros((max_it,), dtype=torch.int32, device=dev)
    ladder = p.lambda_factor ** torch.arange(K, **f32)
    lam = torch.full((), p.lambda_initial, **f32)
    err0 = torch.full((), float("inf"), **f32)
    # initial correspondences at the start point; iteration 0 reuses them
    corr = graph.correspondences(poses) if use_corr_cache else None
    probe_poses = poses
    force_refresh = False
    it = 0
    done = False
    while it < max_it and not done:
        if use_corr_cache:
            rot_d, trans_d = se3.pose_error(probe_poses, poses)
            refreshed = force_refresh or bool(
                (
                    (torch.max(rot_d) > p.correspondence_update_tolerance_rot)
                    | (torch.max(trans_d) > p.correspondence_update_tolerance_trans)
                ).item()
            )
            if refreshed:
                corr = graph.correspondences(poses)
                probe_poses = poses
        else:
            refreshed = True
            corr = graph.correspondences(poses)
        A, b, err_lin, frozen_error = graph.linearize_frozen(poses, corr)

        lams = lam * ladder
        in_bound = lams <= p.lambda_upper_bound
        deltas, oks = _solve_damped(A, b, lams, p.diagonal_damping)
        pred = 2.0 * (deltas @ b) - torch.einsum("ki,ij,kj->k", deltas, A, deltas)
        cands = retract(poses, deltas)  # [K, P, 4, 4]
        num_tried = torch.sum(in_bound.to(torch.int32))

        def finish(cand_errs):
            rho = (err_lin - cand_errs) / torch.clamp(pred, min=1e-10)
            accept_k = oks & in_bound & (pred > 0) & (rho > p.min_fidelity) & torch.isfinite(cand_errs)
            accepted = torch.any(accept_k)
            first = torch.argmax(accept_k.to(torch.uint8))  # first accepted (0 if none)
            # index_select, not x[first]: a 0-d index tensor is read to the host

            def pick(x):
                return torch.index_select(x, 0, first.reshape(1))[0]

            lam_n = torch.where(
                accepted,
                torch.clamp(pick(lams) / p.lambda_factor, min=p.lambda_lower_bound),
                lam * p.lambda_factor ** num_tried.to(torch.float32),
            )
            tries = torch.where(accepted, first.to(torch.int32) + 1, num_tried)
            step_norm = torch.where(accepted, torch.linalg.norm(pick(deltas)), 0.0)
            decrease = err0 - err_lin  # fresh errors across outer iterations
            small_change = (torch.abs(decrease) < p.absolute_error_tol) | (
                torch.abs(decrease) < p.relative_error_tol * torch.abs(err0)
            )
            converged = accepted & ((step_norm < p.step_tol) | (small_change & (it > 0)))
            at_rest = converged | ~accepted
            poses_n = torch.where(accepted, pick(cands), poses)
            return at_rest, accept_k[0], poses_n, lam_n, tries

        # two-stage scoring: candidate 0 alone, the rest only if it fails
        err0_c = frozen_error(cands[0])
        rest_inf = torch.full((K - 1,), float("inf"), **f32)
        out = finish(torch.cat([err0_c[None], rest_inf]))
        at_rest, accept0 = (bool(v) for v in torch.stack(out[:2]).tolist())
        if K > 1 and not accept0:
            out = finish(torch.cat([err0_c[None], frozen_error(cands[1:])]))
            at_rest = bool(out[0].item())
        _, _, poses_n, lam_n, tries = out

        # a fixed point on cached correspondences refreshes once more before
        # it may end the run (with the cache off, refreshed is always True)
        done = at_rest and refreshed
        force_refresh = at_rest and not refreshed
        st_error[it] = err_lin
        st_lambda[it] = lam_n
        st_inner[it] = tries
        poses, lam, err0 = poses_n, lam_n, err_lin
        it += 1

    status = LMStatus(
        error=st_error,
        lambda_=st_lambda,
        inner_iterations=st_inner,
        num_iterations=torch.full((), it, dtype=torch.int32, device=dev),
    )
    return LMResult(poses=poses, error=err0, status=status)
