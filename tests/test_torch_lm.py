"""The port's Levenberg-Marquardt loop without host reads, against the early
exit and against the JAX package.

One VGICP registration of a ring scan against the map of the scan before it
(2048 points, leaf 1.0), from three starts that cover the loop's paths:

- "accept0": candidate 0 is accepted in every iteration but the last, and
  the run takes all max_iterations;
- "reject0": a fidelity threshold that some first candidates miss, so
  iterations score candidates 1..K-1 and accept a later one;
- "converge": the run comes to rest before max_iterations;
- "cache": the correspondence cache on (nonzero rotation and translation
  tolerances), so iterations run on cached correspondences, refresh when a
  pose moves past the tolerance, and a fixed point on cached correspondences
  forces one more refreshed round before the run ends.

With the cache on, where a run settles can rest on the last bit of the
error: from accept0's start, one cached round predicts a decrease of 4.6e-5
on an error of 551.6, whose float32 spacing is 6.1e-5. The port rounds the
decrease to 0 and rejects, JAX accepts, and the two runs settle at two
refreshed fixed points 3.0e-3 m apart, each 1.9-2.2 cm from the truth; a
1e-6 change of the start moves the port's run as far. The "cache" start
takes no decision on the last bit, so it is held to JAX like the others.

`optimize_lm_unrolled` (all max_iterations through `lm_iteration`, with
`done` masking and no host read: what a CUDA graph replays) and the early
exit `optimize_lm` are held bit for bit to the loop the port ran before it
had `lm_iteration`, kept below as `_optimize_lm_two_stage`: it scored
candidates 1..K-1 only after reading that candidate 0 was rejected. All are
held to the JAX `optimize_lm` within 1e-3 m and 1e-3 rad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors.vgicp import make_vgicp_factor as jfactor
from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs
from gtsam_points_tpu.optim import lm as jlm
from gtsam_points_tpu.optim.graph import FactorGraph as JGraph
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch.factors.vgicp import make_vgicp_factor as tfactor
from gtsam_points_tpu_torch.ops.features import estimate_normals_covs_moments as tcovs
from gtsam_points_tpu_torch.optim import lm as tlm
from gtsam_points_tpu_torch.optim.graph import FactorGraph as TGraph
from gtsam_points_tpu_torch.optim.graph import retract
from gtsam_points_tpu_torch.types.frame import make_frame as tmake
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
SCAN_N = 2048
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3

# name: (start twist applied to the true relative pose, LMParams fields)
CASES = {
    "accept0": ([0.02, -0.01, 0.01, 0.3, -0.2, 0.1], dict(max_iterations=10, max_inner_iterations=5)),
    "reject0": (
        [-0.006241279, 0.0391773, 0.046366274, -0.11655848, 0.29172504, 0.02889492],
        dict(max_iterations=10, max_inner_iterations=5, min_fidelity=0.9999),
    ),
    "converge": ([0.0] * 6, dict(max_iterations=10, max_inner_iterations=5)),
    "cache": (
        [0.0, 0.01, 0.0, 0.0, 0.1, 0.05],
        dict(max_iterations=10, max_inner_iterations=5, correspondence_update_tolerance_rot=0.02,
             correspondence_update_tolerance_trans=0.05),
    ),
}


def _optimize_lm_two_stage(graph, poses, p, refreshes=None):
    """The port's LM loop as it was before `lm_iteration`: the host reads
    candidate 0's verdict and scores candidates 1..K-1 only when it is
    rejected, reads the correspondence cache's gate and probes only when it
    opens, and stops when the run is done. Appends each iteration's gate,
    as "cached", "moved" or "forced", to `refreshes` where it is given."""
    f32 = dict(dtype=torch.float32, device=poses.device)
    max_it, K = p.max_iterations, p.max_inner_iterations
    st_error = torch.full((max_it,), float("inf"), **f32)
    st_lambda = torch.zeros((max_it,), **f32)
    st_inner = torch.zeros((max_it,), dtype=torch.int32)
    ladder = p.lambda_factor ** torch.arange(K, **f32)
    lam = torch.full((), p.lambda_initial, **f32)
    err0 = torch.full((), float("inf"), **f32)
    use_cache = p.correspondence_update_tolerance_rot > 0.0 or p.correspondence_update_tolerance_trans > 0.0
    corr = graph.correspondences(poses) if use_cache else None
    probe_poses, force_refresh = poses, False
    it, done = 0, False
    while it < max_it and not done:
        if use_cache:
            rot_d, trans_d = tse3.pose_error(probe_poses, poses)
            moved = bool(
                ((torch.max(rot_d) > p.correspondence_update_tolerance_rot)
                 | (torch.max(trans_d) > p.correspondence_update_tolerance_trans)).item()
            )
            refreshed = force_refresh or moved
            if refreshes is not None:
                refreshes.append("forced" if force_refresh else "moved" if moved else "cached")
            if refreshed:
                corr = graph.correspondences(poses)
                probe_poses = poses
        else:
            refreshed = True
            corr = graph.correspondences(poses)
        A, b, err_lin, frozen_error = graph.linearize_frozen(poses, corr)
        lams = lam * ladder
        in_bound = lams <= p.lambda_upper_bound
        deltas, oks = tlm._solve_damped(A, b, lams, p.diagonal_damping)
        pred = 2.0 * (deltas @ b) - torch.einsum("ki,ij,kj->k", deltas, A, deltas)
        cands = retract(poses, deltas)
        num_tried = torch.sum(in_bound.to(torch.int32))

        def finish(cand_errs):
            rho = (err_lin - cand_errs) / torch.clamp(pred, min=1e-10)
            accept_k = oks & in_bound & (pred > 0) & (rho > p.min_fidelity) & torch.isfinite(cand_errs)
            accepted = torch.any(accept_k)
            first = torch.argmax(accept_k.to(torch.uint8))

            def pick(x):
                return torch.index_select(x, 0, first.reshape(1))[0]

            lam_n = torch.where(
                accepted,
                torch.clamp(pick(lams) / p.lambda_factor, min=p.lambda_lower_bound),
                lam * p.lambda_factor ** num_tried.to(torch.float32),
            )
            tries = torch.where(accepted, first.to(torch.int32) + 1, num_tried)
            step_norm = torch.where(accepted, torch.linalg.norm(pick(deltas)), 0.0)
            decrease = err0 - err_lin
            small_change = (torch.abs(decrease) < p.absolute_error_tol) | (
                torch.abs(decrease) < p.relative_error_tol * torch.abs(err0)
            )
            converged = accepted & ((step_norm < p.step_tol) | (small_change & (it > 0)))
            at_rest = converged | ~accepted
            return at_rest, accept_k[0], torch.where(accepted, pick(cands), poses), lam_n, tries

        err0_c = frozen_error(cands[0])
        out = finish(torch.cat([err0_c[None], torch.full((K - 1,), float("inf"), **f32)]))
        at_rest, accept0 = (bool(v) for v in torch.stack(out[:2]).tolist())
        if K > 1 and not accept0:
            out = finish(torch.cat([err0_c[None], frozen_error(cands[1:])]))
            at_rest = bool(out[0].item())
        _, _, poses_n, lam_n, tries = out
        done = at_rest and refreshed
        force_refresh = at_rest and not refreshed
        st_error[it], st_lambda[it], st_inner[it] = err_lin, lam_n, tries
        poses, lam, err0 = poses_n, lam_n, err_lin
        it += 1
    status = tlm.LMStatus(st_error, st_lambda, st_inner, torch.full((), it, dtype=torch.int32))
    return tlm.LMResult(poses=poses, error=err0, status=status)


@pytest.fixture(scope="module")
def scene():
    world = ring_world(0, 24000)
    T_true = ring_trajectory(2, lap=100)
    scans = ring_scans(world, T_true, scan_n=SCAN_N, seed=1)
    prior = (np.linalg.inv(T_true[0]) @ T_true[1]).astype(np.float32)
    tf = [tcovs(tmake(s, device="cpu")) for s in scans]
    jf = [jax.jit(jcovs)(jmake(s)) for s in scans]
    tgraph = TGraph([tfactor(-1, 0, tf[0], tf[1], 1.0, 5.0)], num_poses=1)
    jgraph = JGraph(num_poses=1).add(jfactor(-1, 0, jf[0], jf[1], 1.0, 5.0))
    return prior, tgraph, jgraph


def _fields(res):
    return [res.poses, res.error, *res.status]


@pytest.mark.parametrize("case", list(CASES))
def test_lm_without_host_reads_matches_early_exit_and_jax(scene, case):
    prior, tgraph, jgraph = scene
    twist, fields = CASES[case]
    start = prior @ tse3.se3_exp(torch.tensor(twist, dtype=torch.float32)).numpy()
    poses = torch.from_numpy(start[None])
    p = tlm.LMParams(**fields)

    refreshes = []
    ref = _optimize_lm_two_stage(tgraph, poses, p, refreshes)
    for res in (tlm.optimize_lm_unrolled(tgraph, poses, p), tlm.optimize_lm(tgraph, poses, p)):
        for a, b in zip(_fields(res), _fields(ref)):
            assert a.dtype == b.dtype and torch.equal(a, b), (a, b)

    tries = ref.status.inner_iterations.tolist()
    iters = int(ref.status.num_iterations)
    if case == "accept0":
        assert iters == p.max_iterations and tries[:-1] == [1] * (iters - 1), tries
    elif case == "reject0":
        # candidate 0 rejected and a later one accepted: the run went on
        assert any(t >= 2 for t in tries[: iters - 1]), tries
    elif case == "converge":
        assert iters < p.max_iterations, tries
    else:
        # cached rounds, a refresh on motion, and a forced refresh that ends
        # the run before max_iterations
        assert {"cached", "moved", "forced"} <= set(refreshes), refreshes
        assert refreshes[-1] == "forced" and iters < p.max_iterations, refreshes

    jp = jlm.LMParams(**fields)
    jres = jax.jit(lambda x: jlm.optimize_lm(jgraph, x, jp))(jnp.asarray(start[None]))
    rot, trans = jse3.pose_error(jres.poses, jnp.asarray(ref.poses.numpy()))
    print(f"{case}: iterations {iters} (JAX {int(jres.status.num_iterations)}), tries {tries}, {refreshes}; "
          f"vs JAX {float(jnp.max(trans)):.3e} m {float(jnp.max(rot)):.3e} rad")
    assert float(jnp.max(trans)) < POSE_TOL_M and float(jnp.max(rot)) < POSE_TOL_RAD


def test_lm_iteration_after_done_changes_nothing(scene):
    """A state with `done` set comes back from `lm_iteration` unchanged, bit
    for bit, in every field."""
    prior, tgraph, _ = scene
    p = tlm.LMParams(**CASES["converge"][1])
    st = tlm.lm_start(tgraph, torch.from_numpy(prior[None]), p)
    for _ in range(2):
        st = tlm.lm_iteration(tgraph, st, p)
    st = st._replace(done=torch.ones((), dtype=torch.bool))
    again = tlm.lm_iteration(tgraph, st, p)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(again)), jax.tree_util.tree_leaves(tuple(st))):
        assert torch.equal(a, b)
    assert int(again.status.num_iterations) == 2
