"""PyTorch port vs the JAX package: the block-sparse pose graph.

A pose graph as chip_smoke.py's phase 24 builds it
(`chip_smoke.pose_graph_arrays`), at P = 50 (five laps of ten poses on the
ring): odometry edges (i, i+1) measured with noise (RandomState(7), normal,
0.02 m and 0.002 rad), loop edges (i, i+10) at the true relative pose,
weights 1e2, a 1e6 prior on pose 0; the start chains the noisy odometry. Both packages get the same arrays
(`interop.pose_graph_from_numpy`).

- `linearize_pose_graph` at a perturbed start, with diagonal and with full
  information matrices: every block within 1e-4 x max|ref|;
- `sparse_matvec` within 1e-5 x max|ref|, and `solve_cg_block`: the port's
  solution within 1e-3 x max|ref| of JAX's and its residual no larger than
  twice JAX's (float32 CG on this system converges to 1e-4 of the solution);
- `optimize_pose_graph` from the chained start: the final error within
  1e-4 of JAX's, each pose within 1e-3 m and 1e-3 rad of JAX's or within
  twice the distance by which the order of the edges alone moves JAX's own
  pose (JAX against JAX with the edges in two other orders): on this graph
  the LM stops in a valley where float32 sums in another order end up to
  1e-2 m apart;
- the sparse LM against the dense `optimize_lm` on the same BetweenFactor
  graph at P = 20 (four laps of five), poses within 1e-4 m.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gtsam_points_tpu.optim import sparse as jsparse
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu.utils.synthetic import ring_trajectory
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import BetweenFactor, PriorFactor
from gtsam_points_tpu_torch.optim import (
    FactorGraph,
    LMParams,
    linearize_pose_graph,
    make_pose_graph,
    optimize_lm,
    optimize_pose_graph,
    pose_graph_error,
    solve_cg_block,
    sparse_matvec,
)
from gtsam_points_tpu_torch.utils import se3 as tse3
from chip_smoke import pose_graph_arrays  # noqa: E402  (phase 24's graph, cut to size)

torch.set_num_threads(1)
SYSTEM_TOL = 1e-4
MATVEC_TOL = 1e-5
CG_TOL = 1e-3
TOL_M = 1e-3
TOL_RAD = 1e-3
SHIFT_MARGIN = 2.0
DENSE_TOL_M = 1e-4
ORDERS = 2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_graph(arrays):
    return jsparse.PoseGraphEdges(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def graph():
    T, arrays, start = pose_graph_arrays(50, 10)
    xi = np.random.RandomState(3).uniform(-0.05, 0.05, (50, 6)).astype(np.float32)
    perturbed = (T @ np.asarray(jse3.se3_exp(jnp.asarray(xi)))).astype(np.float32)
    return {"T": T, "arrays": arrays, "start": start, "perturbed": perturbed}


@pytest.mark.parametrize("info", [False, True], ids=["diagonal", "full"])
def test_linearize_pose_graph_matches_jax(graph, info):
    arrays = dict(graph["arrays"])
    if info:
        rng = np.random.RandomState(11)
        M = rng.randn(len(arrays["t_idx"]), 6, 6).astype(np.float32)
        arrays["info"] = (M @ M.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)).astype(np.float32)
        arrays["prior_info"] = np.diag(np.full(6, 1e6, np.float32))[None]
    j = jax.jit(jsparse.linearize_pose_graph)(_jax_graph(arrays), graph["perturbed"])
    t = linearize_pose_graph(interop.pose_graph_from_numpy(arrays, device="cpu"), torch.from_numpy(graph["perturbed"]))
    for name in ("diag", "edge", "b", "error"):
        assert _rel(getattr(t, name), getattr(j, name)) < SYSTEM_TOL, name
    np.testing.assert_array_equal(t.t_idx.numpy(), np.asarray(j.t_idx))
    tp = torch.from_numpy(graph["perturbed"])
    terr = pose_graph_error(interop.pose_graph_from_numpy(arrays, device="cpu"), torch.stack([tp, tp]))
    assert terr.shape == (2,) and terr[0] == terr[1]
    assert _rel(terr[0], jax.jit(jsparse.pose_graph_error)(_jax_graph(arrays), graph["perturbed"])) < SYSTEM_TOL


def test_sparse_matvec_and_cg_match_jax(graph):
    jpg = _jax_graph(graph["arrays"])
    tpg = interop.pose_graph_from_numpy(graph["arrays"], device="cpu")
    js = jax.jit(jsparse.linearize_pose_graph)(jpg, graph["perturbed"])
    ts = linearize_pose_graph(tpg, torch.from_numpy(graph["perturbed"]))
    x = np.random.RandomState(1).randn(50, 6).astype(np.float32)
    lam = np.float32(1e-3)
    jy = jax.jit(jsparse.sparse_matvec)(js, x, lam)
    ty = sparse_matvec(ts, torch.from_numpy(x), torch.tensor(lam))
    assert _rel(ty, jy) < MATVEC_TOL
    jx = jax.jit(jsparse.solve_cg_block)(js, lam)
    tx = solve_cg_block(ts, torch.tensor(lam))
    assert _rel(tx, jx) < CG_TOL
    b = np.linalg.norm(np.asarray(js.b))
    jres = np.linalg.norm(np.asarray(jsparse.sparse_matvec(js, jx, lam) - js.b)) / b
    tres = float(torch.linalg.norm(sparse_matvec(ts, tx, torch.tensor(lam)) - ts.b)) / b
    assert tres <= 2 * jres + 1e-6, (tres, jres)


def test_optimize_pose_graph_matches_jax(graph):
    arrays, start = graph["arrays"], graph["start"]
    run = jax.jit(jsparse.optimize_pose_graph)
    jr = run(_jax_graph(arrays), start)
    tr = optimize_pose_graph(interop.pose_graph_from_numpy(arrays, device="cpu"), torch.from_numpy(start))
    jposes = torch.from_numpy(np.asarray(jr.poses))
    shift_m, shift_rad = torch.zeros(50), torch.zeros(50)
    for i in range(ORDERS):
        perm = np.random.RandomState(100 + i).permutation(len(arrays["t_idx"]))
        other = dict(arrays, **{k: arrays[k][perm] for k in ("measured", "weights", "t_idx", "s_idx")})
        rot, trans = tse3.pose_error(jposes, torch.from_numpy(np.asarray(run(_jax_graph(other), start).poses)))
        shift_m, shift_rad = torch.maximum(shift_m, trans), torch.maximum(shift_rad, rot)
    rot, trans = tse3.pose_error(jposes, tr.poses)
    assert bool(torch.all(trans <= torch.clamp(SHIFT_MARGIN * shift_m, min=TOL_M))), float((trans - SHIFT_MARGIN * shift_m).max())
    assert bool(torch.all(rot <= torch.clamp(SHIFT_MARGIN * shift_rad, min=TOL_RAD)))
    assert _rel(tr.error, jr.error) < SYSTEM_TOL
    assert 1 < int(tr.iterations) <= 30 and float(tr.error) < float(
        linearize_pose_graph(interop.pose_graph_from_numpy(arrays, device="cpu"), torch.from_numpy(start)).error)


def test_sparse_lm_matches_dense_lm():
    T, arrays, start = pose_graph_arrays(20, 5)
    between = [BetweenFactor(measured=torch.from_numpy(arrays["measured"][k]), weights=torch.from_numpy(arrays["weights"][k]),
                             target_key=int(arrays["t_idx"][k]), source_key=int(arrays["s_idx"][k]))
               for k in range(len(arrays["t_idx"]))]
    prior = PriorFactor(prior=torch.from_numpy(T[0]), weights=torch.full((6,), 1e6), key=0)
    pg = make_pose_graph(between, [prior])
    for k in ("measured", "weights", "t_idx", "s_idx", "prior_T", "prior_w", "prior_idx"):
        np.testing.assert_array_equal(getattr(pg, k).numpy(), arrays[k])
    sr = optimize_pose_graph(pg, torch.from_numpy(start))
    dr = optimize_lm(FactorGraph([prior] + between, num_poses=20), torch.from_numpy(start), LMParams(max_iterations=30))
    rot, trans = tse3.pose_error(sr.poses, dr.poses)
    assert float(trans.max()) < DENSE_TOL_M and float(rot.max()) < DENSE_TOL_M
    assert _rel(sr.error, dr.error) < SYSTEM_TOL
