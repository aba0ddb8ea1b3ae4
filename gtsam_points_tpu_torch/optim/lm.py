"""Levenberg-Marquardt optimizer.

Port of gtsam_points_tpu/optim/lm.py. The reference's `outer_body` becomes
`lm_iteration`, one function of device tensors that never reads the device
from the host, so it can be captured into a CUDA graph. Its `lax.cond`s
become selections: both branches are computed and `torch.where` keeps one.
Kept as in the reference:

- the correspondence cache gate: with a nonzero update tolerance, matching
  factors keep their cached correspondences while no pose moved beyond it,
  and a fixed point on cached correspondences forces one more refreshed
  round (fresh correspondences are computed every iteration and selected);
- the batched lambda ladder: all K damped systems lam·f^k are solved and
  retracted at once; candidate 0 is scored alone and candidates 1..K-1 in
  one batched pass, whose errors become inf where candidate 0 is accepted
  (the reference's `skip_rest`); the first acceptable candidate wins, so
  accept, lambda and tries are those of the sequential trial loop.

An iteration that starts with `done` set changes nothing: every field is
selected from the state it was given, and the status arrays and the
iteration count stay as they were. So `optimize_lm`, which reads `done` once
an iteration and stops, and `optimize_lm_unrolled`, which runs all
`max_iterations` and reads nothing, return the same result bit for bit.

Cost model: E(δ) ≈ E0 - 2 bᵀδ + δᵀAδ, step δ = (A + λ·damp)⁻¹ b, predicted
decrease = 2bᵀδ - δᵀAδ.
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


class LMState(NamedTuple):
    """The LM's loop state, all device tensors (`corr` and `probe_poses` are
    None unless the correspondence cache is on)."""

    poses: torch.Tensor  # [P, 4, 4]
    lam: torch.Tensor  # ()
    err0: torch.Tensor  # () error at the last linearization point
    done: torch.Tensor  # () bool
    force_refresh: torch.Tensor  # () bool
    status: LMStatus
    corr: Optional[tuple]
    probe_poses: Optional[torch.Tensor]
    ladder: torch.Tensor  # [K] lambda_factor ** k, a constant
    slots: torch.Tensor  # [max_iter] 0..max_iter-1, a constant


class Candidates(NamedTuple):
    """The K damped steps of one iteration and their retracted poses."""

    lams: torch.Tensor  # [K]
    in_bound: torch.Tensor  # [K] bool
    deltas: torch.Tensor  # [K, 6P]
    oks: torch.Tensor  # [K] bool
    pred: torch.Tensor  # [K] predicted decrease
    cands: torch.Tensor  # [K, P, 4, 4]


def _use_corr_cache(p: LMParams) -> bool:
    return p.correspondence_update_tolerance_rot > 0.0 or p.correspondence_update_tolerance_trans > 0.0


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


def candidates(A: torch.Tensor, b: torch.Tensor, lam: torch.Tensor, ladder: torch.Tensor, poses: torch.Tensor,
               p: LMParams) -> Candidates:
    """The lambda ladder lam·f^k: K damped solves, their predicted decreases
    and the K retracted pose sets."""
    lams = lam * ladder
    deltas, oks = _solve_damped(A, b, lams, p.diagonal_damping)
    pred = 2.0 * (deltas @ b) - torch.einsum("ki,ij,kj->k", deltas, A, deltas)
    return Candidates(lams, lams <= p.lambda_upper_bound, deltas, oks, pred, retract(poses, deltas))


def gate(c: Candidates, err_lin: torch.Tensor, errs: torch.Tensor, p: LMParams) -> torch.Tensor:
    """Accept flags of candidates 0..k-1 for their errors `errs` [k]."""
    k = errs.shape[0]
    rho = (err_lin - errs) / torch.clamp(c.pred[:k], min=1e-10)
    return c.oks[:k] & c.in_bound[:k] & (c.pred[:k] > 0) & (rho > p.min_fidelity) & torch.isfinite(errs)


def score(c: Candidates, err_lin: torch.Tensor, frozen_error, p: LMParams) -> torch.Tensor:
    """Candidate errors [K]: candidate 0 alone; candidates 1..K-1 in one
    batched pass, inf where candidate 0 is accepted (the reference evaluates
    them only when it is not, through `lax.cond`)."""
    err0_c = frozen_error(c.cands[0])[None]
    if c.cands.shape[0] == 1:
        return err0_c
    accept0 = gate(c, err_lin, err0_c, p)[0]
    rest = torch.where(accept0, float("inf"), frozen_error(c.cands[1:]))
    return torch.cat([err0_c, rest])


def lm_start(graph: FactorGraph, poses: torch.Tensor, params: Optional[LMParams] = None) -> LMState:
    """The LM's state before its first iteration, on the poses' device."""
    p = params or LMParams()
    f32 = dict(dtype=torch.float32, device=poses.device)
    false = torch.zeros((), dtype=torch.bool, device=poses.device)
    cache = _use_corr_cache(p)
    return LMState(
        poses=poses,
        lam=torch.full((), p.lambda_initial, **f32),
        err0=torch.full((), float("inf"), **f32),
        done=false,
        force_refresh=false,
        status=LMStatus(
            error=torch.full((p.max_iterations,), float("inf"), **f32),
            lambda_=torch.zeros((p.max_iterations,), **f32),
            inner_iterations=torch.zeros((p.max_iterations,), dtype=torch.int32, device=poses.device),
            num_iterations=torch.zeros((), dtype=torch.int32, device=poses.device),
        ),
        # initial correspondences at the start point; iteration 0 reuses them
        corr=graph.correspondences(poses) if cache else None,
        probe_poses=poses if cache else None,
        ladder=p.lambda_factor ** torch.arange(p.max_inner_iterations, **f32),
        slots=torch.arange(p.max_iterations, dtype=torch.int32, device=poses.device),
    )


def _select(keep: torch.Tensor, old, new):
    """`old` where `keep`, else `new`, over a tensor or a tuple tree of them
    (None, a factor without correspondences, stays None)."""
    if new is None:
        return None
    if isinstance(new, tuple):
        return tuple(_select(keep, a, b) for a, b in zip(old, new))
    return torch.where(keep, old, new)


def lm_iteration(graph: FactorGraph, st: LMState, params: Optional[LMParams] = None) -> LMState:
    """One outer iteration (the reference's `outer_body`), with no host read.
    A state with `done` set comes back unchanged."""
    p = params or LMParams()
    if _use_corr_cache(p):
        rot_d, trans_d = se3.pose_error(st.probe_poses, st.poses)
        refreshed = (
            st.force_refresh
            | (torch.max(rot_d) > p.correspondence_update_tolerance_rot)
            | (torch.max(trans_d) > p.correspondence_update_tolerance_trans)
        )
        corr = _select(refreshed, graph.correspondences(st.poses), st.corr)
        probe_poses = torch.where(refreshed, st.poses, st.probe_poses)
    else:
        refreshed = torch.ones_like(st.done)
        corr = graph.correspondences(st.poses)
        probe_poses = None
    A, b, err_lin, frozen_error = graph.linearize_frozen(st.poses, corr)

    c = candidates(A, b, st.lam, st.ladder, st.poses, p)
    accept_k = gate(c, err_lin, score(c, err_lin, frozen_error, p), p)
    accepted = torch.any(accept_k)
    first = torch.argmax(accept_k.to(torch.uint8))  # first accepted (0 if none)

    # index_select, not x[first]: a 0-d index tensor is read to the host
    def pick(x):
        return torch.index_select(x, 0, first.reshape(1))[0]

    num_tried = torch.sum(c.in_bound.to(torch.int32))
    lam_n = torch.where(
        accepted,
        torch.clamp(pick(c.lams) / p.lambda_factor, min=p.lambda_lower_bound),
        st.lam * p.lambda_factor ** num_tried.to(torch.float32),
    )
    tries = torch.where(accepted, first.to(torch.int32) + 1, num_tried)
    step_norm = torch.where(accepted, torch.linalg.norm(pick(c.deltas)), 0.0)
    decrease = st.err0 - err_lin  # fresh errors across outer iterations
    small_change = (torch.abs(decrease) < p.absolute_error_tol) | (
        torch.abs(decrease) < p.relative_error_tol * torch.abs(st.err0)
    )
    it = st.status.num_iterations
    converged = accepted & ((step_norm < p.step_tol) | (small_change & (it > 0)))
    at_rest = converged | ~accepted
    poses_n = torch.where(accepted, pick(c.cands), st.poses)

    # a fixed point on cached correspondences refreshes once more before it
    # may end the run (with the cache off, refreshed is always True)
    done = st.done
    row = (st.slots == it) & ~done
    status = LMStatus(
        error=torch.where(row, err_lin, st.status.error),
        lambda_=torch.where(row, lam_n, st.status.lambda_),
        inner_iterations=torch.where(row, tries, st.status.inner_iterations),
        num_iterations=it + (~done).to(torch.int32),
    )
    return st._replace(
        poses=torch.where(done, st.poses, poses_n),
        lam=torch.where(done, st.lam, lam_n),
        err0=torch.where(done, st.err0, err_lin),
        done=done | (at_rest & refreshed),
        force_refresh=torch.where(done, st.force_refresh, at_rest & ~refreshed),
        status=status,
        corr=None if st.corr is None else _select(done, st.corr, corr),
        probe_poses=None if st.probe_poses is None else torch.where(done, st.probe_poses, probe_poses),
    )


def lm_result(st: LMState) -> LMResult:
    return LMResult(poses=st.poses, error=st.err0, status=st.status)


def optimize_lm(graph: FactorGraph, poses: torch.Tensor, params: Optional[LMParams] = None) -> LMResult:
    """Run LM from poses [P, 4, 4] to convergence or max_iterations. The host
    reads `done` once an iteration and stops when it is set."""
    p = params or LMParams()
    st = lm_start(graph, poses, p)
    for _ in range(p.max_iterations):
        st = lm_iteration(graph, st, p)
        if bool(st.done):
            break
    return lm_result(st)


def optimize_lm_unrolled(graph: FactorGraph, poses: torch.Tensor, params: Optional[LMParams] = None) -> LMResult:
    """`optimize_lm` with all max_iterations run and nothing read from the
    device, so a CUDA graph can capture it; iterations after convergence
    change nothing, so the result is `optimize_lm`'s bit for bit."""
    p = params or LMParams()
    st = lm_start(graph, poses, p)
    for _ in range(p.max_iterations):
        st = lm_iteration(graph, st, p)
    return lm_result(st)


class GNResult(NamedTuple):
    poses: torch.Tensor
    error: torch.Tensor


def optimize_gn(graph: FactorGraph, poses: torch.Tensor, iterations: int = 10, damping: float = 1e-6) -> GNResult:
    """Gauss-Newton with a fixed iteration count: each step solves the
    system damped by `damping` x its diagonal, a non-finite step is 0. Reads
    nothing from the device."""
    lam = torch.full((1,), damping, dtype=torch.float32, device=poses.device)
    for _ in range(iterations):
        A, b, _ = graph.linearize_full(poses)
        delta, _ = _solve_damped(A, b, lam, True)
        poses = retract(poses, delta[0])
    return GNResult(poses=poses, error=graph.error(poses))
