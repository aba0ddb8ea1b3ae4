"""Block-sparse pose-graph optimization: memory linear in the edges.

Port of gtsam_points_tpu/optim/sparse.py, the large-P path beside the dense
[6P, 6P] system of optim/graph.py:

- `PoseGraphEdges`: all Between measurements as [E, ...] tensors, all priors
  as [Q, ...] tensors; one batched linearization for the whole graph;
- `SparseSystem`: block diagonal [P, 6, 6], one off-diagonal block [E, 6, 6]
  an edge, gradient [P, 6];
- `sparse_matvec` without materializing H; the damped solve by block-Jacobi
  preconditioned conjugate gradients; the LM outer loop.

The reference's scatter-adds become `voxelmap.scatter_sum`, which sums each
pose's blocks in a fixed order (the input's) on every device, so two card
runs agree bit for bit. The Jacobians come from `torch.func.jacfwd` with one
tangent shared by every edge: each edge's residual reads only its own two
poses, so the Jacobian of all E residuals against the shared tangent is
each edge's own Jacobian, in 12 forward passes over [E] batches.

The reference's two `lax.while_loop`s become loops with masked updates, as
`optimize_lm`'s: an iteration after convergence changes nothing, and the
host reads one flag every CG_CHECK conjugate-gradient iterations, one for
each lambda try and one for each LM iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gtsam_points_tpu_torch.ops.voxelmap import scatter_sum
from gtsam_points_tpu_torch.utils import se3

CG_CHECK = 10  # conjugate-gradient iterations between two reads of the convergence flag


class PoseGraphEdges(NamedTuple):
    """E between edges and Q priors over P poses.

    measured [E, 4, 4] relative measurements T_ts, weights [E, 6] diagonal
    information (omega, v order), t_idx, s_idx [E] int32 pose indices;
    prior_T [Q, 4, 4], prior_w [Q, 6], prior_idx [Q] int32; info [E, 6, 6]
    and prior_info [Q, 6, 6], optional full information matrices that
    replace diag(weights) and diag(prior_w).
    """

    measured: torch.Tensor
    weights: torch.Tensor
    t_idx: torch.Tensor
    s_idx: torch.Tensor
    prior_T: torch.Tensor
    prior_w: torch.Tensor
    prior_idx: torch.Tensor
    info: Optional[torch.Tensor] = None
    prior_info: Optional[torch.Tensor] = None

    @property
    def num_edges(self) -> int:
        return self.measured.shape[0]


def make_pose_graph(between: list, priors: list) -> PoseGraphEdges:
    """From lists of factors.BetweenFactor and factors.PriorFactor, on their
    device. An empty list becomes one entry of weight 0."""
    if not between and not priors:
        raise ValueError("a pose graph needs a BetweenFactor or a PriorFactor")
    dev = (between or priors)[0].weights.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)[None]
    zero_w = torch.zeros((1, 6), dtype=torch.float32, device=dev)

    def idx(keys):
        return torch.tensor(keys or [0], dtype=torch.int32, device=dev)

    return PoseGraphEdges(
        measured=torch.stack([f.measured for f in between]) if between else eye,
        weights=torch.stack([f.weights for f in between]) if between else zero_w,
        t_idx=idx([f.target_key for f in between]),
        s_idx=idx([f.source_key for f in between]),
        prior_T=torch.stack([f.prior for f in priors]) if priors else eye,
        prior_w=torch.stack([f.weights for f in priors]) if priors else zero_w,
        prior_idx=idx([f.key for f in priors]),
    )


class SparseSystem(NamedTuple):
    diag: torch.Tensor  # [P, 6, 6]
    edge: torch.Tensor  # [E, 6, 6] H_ts block of each edge
    t_idx: torch.Tensor  # [E]
    s_idx: torch.Tensor  # [E]
    b: torch.Tensor  # [P, 6]
    error: torch.Tensor  # ()


def _between_residual(measured: torch.Tensor, T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    return se3.se3_log(se3.se3_inverse(measured) @ se3.se3_inverse(T_a) @ T_b)


def _prior_residual(prior: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    return se3.se3_log(se3.se3_inverse(prior) @ T)


def _information(full: Optional[torch.Tensor], weights: torch.Tensor) -> torch.Tensor:
    return full if full is not None else torch.diag_embed(weights)


def _quadratic(r: torch.Tensor, full: Optional[torch.Tensor], weights: torch.Tensor) -> torch.Tensor:
    """Σ rᵀ Ω r over the last two axes' batch -> [...] (r [..., M, 6])."""
    if full is not None:
        return torch.einsum("...mi,mij,...mj->...", r, full, r)
    return torch.sum(weights * r * r, dim=(-2, -1))


def linearize_pose_graph(pg: PoseGraphEdges, poses: torch.Tensor) -> SparseSystem:
    """One batched linearization of every edge and prior at poses [P, 4, 4]."""
    P = poses.shape[0]
    t, s, q = pg.t_idx.long(), pg.s_idx.long(), pg.prior_idx.long()
    T_a, T_b, T_q = poses[t], poses[s], poses[q]
    zero = torch.zeros((12,), dtype=torch.float32, device=poses.device)

    def edges_at(xi):
        E = se3.se3_exp(xi.reshape(2, 6))
        return _between_residual(pg.measured, T_a @ E[0], T_b @ E[1])

    r0 = _between_residual(pg.measured, T_a, T_b)
    J = torch.func.jacfwd(edges_at)(zero)  # [E, 6, 12]
    Om = _information(pg.info, pg.weights)
    WJ = Om @ J
    H = J.transpose(-1, -2) @ WJ
    Wr = (Om @ r0[..., None])[..., 0]
    g = -(J.transpose(-1, -2) @ Wr[..., None])[..., 0]

    rp0 = _prior_residual(pg.prior_T, T_q)
    Jp = torch.func.jacfwd(lambda xi: _prior_residual(pg.prior_T, T_q @ se3.se3_exp(xi[None])))(zero[:6])
    pOm = _information(pg.prior_info, pg.prior_w)
    pWr = (pOm @ rp0[..., None])[..., 0]
    pH = Jp.transpose(-1, -2) @ (pOm @ Jp)
    pg_b = -(Jp.transpose(-1, -2) @ pWr[..., None])[..., 0]

    slot = torch.cat([t, s, q])
    diag = scatter_sum(torch.cat([H[:, :6, :6], H[:, 6:, 6:], pH]), slot, P)
    b = scatter_sum(torch.cat([g[:, :6], g[:, 6:], pg_b]), slot, P)
    err = torch.sum(torch.sum(r0 * Wr, dim=-1)) + torch.sum(torch.sum(rp0 * pWr, dim=-1))
    return SparseSystem(diag=diag, edge=H[:, :6, 6:], t_idx=pg.t_idx, s_idx=pg.s_idx, b=b, error=err)


def pose_graph_error(pg: PoseGraphEdges, poses: torch.Tensor) -> torch.Tensor:
    """The graph's error at poses [..., P, 4, 4] -> [...]."""
    r = _between_residual(pg.measured, poses[..., pg.t_idx.long(), :, :], poses[..., pg.s_idx.long(), :, :])
    rp = _prior_residual(pg.prior_T, poses[..., pg.prior_idx.long(), :, :])
    return _quadratic(r, pg.info, pg.weights) + _quadratic(rp, pg.prior_info, pg.prior_w)


def sparse_matvec(sys: SparseSystem, x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """(H + lam · diag(H)) @ x without materializing H; x [P, 6]."""
    P = x.shape[0]
    t, s = sys.t_idx.long(), sys.s_idx.long()
    y = torch.einsum("pij,pj->pi", sys.diag, x)
    d = torch.diagonal(sys.diag, dim1=-2, dim2=-1)
    y = y + lam * torch.clamp(d, min=1e-10) * x
    off = torch.cat([torch.einsum("eij,ej->ei", sys.edge, x[s]), torch.einsum("eji,ej->ei", sys.edge, x[t])])
    return y + scatter_sum(off, torch.cat([t, s]), P)


def solve_cg_block(sys: SparseSystem, lam: torch.Tensor, tol: float = 1e-6, maxiter: int = 100) -> torch.Tensor:
    """Block-Jacobi preconditioned CG on the damped system -> delta [P, 6]."""
    eye6 = torch.eye(6, dtype=sys.diag.dtype, device=sys.diag.device)
    damped = sys.diag + lam * torch.diag_embed(torch.clamp(torch.diagonal(sys.diag, dim1=-2, dim2=-1), min=1e-10))
    Minv, _ = torch.linalg.inv_ex(damped + 1e-8 * eye6)  # [P, 6, 6]

    def precond(r):
        return torch.einsum("pij,pj->pi", Minv, r)

    b = sys.b
    x = torch.zeros_like(b)
    r = b - sparse_matvec(sys, x, lam)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    limit = tol * tol * torch.clamp(torch.sum(b * b), min=1e-30)
    for it in range(maxiter):
        active = torch.sum(r * r) > limit
        if it % CG_CHECK == 0 and not bool(active):
            break
        Ap = sparse_matvec(sys, p, lam)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = torch.where(active, x + alpha * p, x)
        r_n = r - alpha * Ap
        z_n = precond(r_n)
        rz_n = torch.sum(r_n * z_n)
        beta = rz_n / torch.clamp(rz, min=1e-30)
        p = torch.where(active, z_n + beta * p, p)
        r, z, rz = torch.where(active, r_n, r), torch.where(active, z_n, z), torch.where(active, rz_n, rz)
    return x


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor
    error: torch.Tensor
    iterations: torch.Tensor


def optimize_pose_graph(
    pg: PoseGraphEdges,
    poses: torch.Tensor,
    max_iterations: int = 30,
    lambda_initial: float = 1e-6,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 100,
    relative_error_tol: float = 1e-6,
) -> PoseGraphResult:
    """LM on the block-sparse system from poses [P, 4, 4]: up to 8 lambda
    tries an iteration, each a CG solve; memory O(P + E)."""
    f32 = dict(dtype=torch.float32, device=poses.device)
    lam = torch.full((), lambda_initial, **f32)
    err = torch.full((), float("inf"), **f32)
    it = torch.zeros((), dtype=torch.int32, device=poses.device)
    for _ in range(max_iterations):
        sys = linearize_pose_graph(pg, poses)
        best = sys.error
        accepted = torch.zeros((), dtype=torch.bool, device=poses.device)
        for _ in range(8):
            if bool(accepted | (lam >= 1e6)):
                break
            delta = solve_cg_block(sys, lam, cg_tol, cg_maxiter)
            cand = poses @ se3.se3_exp(delta)
            cand_err = pose_graph_error(pg, cand)
            accept = torch.isfinite(cand_err) & (cand_err < sys.error)
            poses = torch.where(accept, cand, poses)
            lam = torch.where(accept, torch.clamp(lam * 0.1, min=1e-10), lam * 10.0)
            best = torch.where(accept, cand_err, best)
            accepted = accepted | accept
        rel = torch.abs(sys.error - best) / torch.clamp(sys.error, min=1e-30)
        err = best
        it = it + 1
        if bool(~accepted | (rel < relative_error_tol)):
            break
    return PoseGraphResult(poses=poses, error=err, iterations=it)
