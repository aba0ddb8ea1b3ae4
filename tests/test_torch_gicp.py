"""PyTorch port vs the JAX package: the two-scan registration path.

GICP, ICP point to point and ICP point to plane factors, the PriorFactor,
the graph's branch for factors without a correspondence cache (and its
branch for factors that add themselves to the system), and the LM on two
poses (a 12x12 system), as in the reference's basic_scan_matching:
PriorFactor(eye, 1e6, key=0) plus a binary factor (0 -> 1,
max_corr_dist=2.0). The scene is a small ring world; both packages get the
same frames (the JAX package's kNN normals and covariances, carried across
by interop, so the factors see identical inputs; tests/test_torch_features.py
holds the features themselves). The port runs K3's plain version, as CPU
tensors do; the JAX package its XLA planar path, which it takes off the TPU.

Correspondence masks match bit for bit, target points exactly, weights and
linear systems within 1e-4 x max|ref| on every block (H_tt, H_ts, H_ss,
b_t, b_s, error), poses within 1e-3 m and 1e-3 rad.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors import PriorFactor as JPrior
from gtsam_points_tpu.factors import make_gicp_factor as jgicp
from gtsam_points_tpu.factors import make_icp_factor as jicp
from gtsam_points_tpu.factors.base import MatchingFactorMixin as JMixin
from gtsam_points_tpu.ops.features import estimate_normals_covs as jfeatures
from gtsam_points_tpu.optim import FactorGraph as JGraph
from gtsam_points_tpu.optim import optimize_lm as jlm
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import PriorFactor, make_gicp_factor, make_icp_factor
from gtsam_points_tpu_torch.factors.base import MatchingFactorMixin
from gtsam_points_tpu_torch.optim import FactorGraph, optimize_lm
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
WORLD_N = 2200
SCAN_N = 2048
MAX_CORR = 2.0
SYSTEM_TOL = 1e-4
TOL_M = 1e-3
TOL_RAD = 1e-3
KINDS = ["gicp", "icp", "icp_plane"]
BLOCKS = ("H_tt", "H_ts", "H_ss", "b_t", "b_s", "error")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def scene():
    world = ring_world(0, WORLD_N)
    T = ring_trajectory(2, lap=100)
    scans = ring_scans(world, T, scan_n=SCAN_N, seed=1)
    feats = jax.jit(lambda f: jfeatures(f, k=10, grid_leaf=1.0))
    jframes = [feats(jmake(s)) for s in scans]
    tframes = [interop.frame_from_numpy({k: np.asarray(getattr(f, k)) for k in ("points", "mask", "normals", "covs")},
                                        device="cpu") for f in jframes]
    T_rel = (np.linalg.inv(T[0]) @ T[1]).astype(np.float32)
    xi = np.random.RandomState(2).uniform(-0.1, 0.1, 6).astype(np.float32)
    P0 = np.stack([np.eye(4, dtype=np.float32), T_rel @ np.asarray(jse3.se3_exp(jnp.asarray(xi)))])
    return {"jframes": jframes, "tframes": tframes, "T_rel": T_rel, "P0": P0}


def _factors(scene, kind, target_key=0):
    jt, js = scene["jframes"]
    tt, ts = scene["tframes"]
    if kind == "gicp":
        return (jgicp(target_key, 1, jt, js, max_corr_dist=MAX_CORR),
                make_gicp_factor(target_key, 1, tt, ts, max_corr_dist=MAX_CORR))
    plane = kind == "icp_plane"
    return (jicp(target_key, 1, jt, js, point_to_plane=plane, max_corr_dist=MAX_CORR),
            make_icp_factor(target_key, 1, tt, ts, point_to_plane=plane, max_corr_dist=MAX_CORR))


def _assert_system(t, j):
    for name in BLOCKS:
        assert _rel(getattr(t, name), getattr(j, name)) < SYSTEM_TOL, name
    assert int(t.num_inliers) == int(j.num_inliers)


@pytest.mark.parametrize("target_key", [0, -1], ids=["binary", "unary"])
@pytest.mark.parametrize("kind", KINDS)
def test_factor_linearize_matches_jax(scene, kind, target_key):
    """Correspondences at the perturbed start, then the K3 linearization on
    them (the graph's matching branch) and the frozen error of a pose
    batch. Binary: every block of the 12x12 system; unary: the source
    blocks against the fixed identity target."""
    jf, tf = _factors(scene, kind, target_key)
    P0 = scene["P0"]
    jc = jax.jit(jf.correspondences)(P0)
    tc = tf.correspondences(torch.from_numpy(P0))
    if kind == "gicp":
        (jv, jq, jw), (tv, tq, tw) = jc, tc
        assert _rel(tw.numpy(), jw) < SYSTEM_TOL
    else:
        (jq, jn, jv), (tq, tn, tv) = jc, tc
        assert (jn is None) == (tn is None) == (kind == "icp")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert int(tv.sum()) > SCAN_N // 2

    cands = np.stack([P0, np.stack([P0[0], scene["T_rel"]])])
    jl, jerrs = jax.jit(lambda p, c, x: (lambda lin, efn: (lin, jax.vmap(efn)(x)))(*jf.linearize_corr(p, c)))(
        P0, jc, cands)
    tl, terr = tf.linearize_corr(torch.from_numpy(P0), tc)
    _assert_system(tl, jl)
    assert _rel(terr(torch.from_numpy(cands)).numpy(), jerrs) < SYSTEM_TOL


@pytest.mark.parametrize("kind", KINDS)
def test_residual_linearize_matches_jax(scene, kind):
    """The factors' residual closures through linearize_residuals
    (`torch.func.jacfwd` of the residual, the base mixin's route) and
    `error`, against the JAX mixin's `jax.jacfwd` route."""
    jf, tf = _factors(scene, kind)
    P0 = scene["P0"]
    jl = jax.jit(lambda p: JMixin.linearize(jf, p))(P0)
    tl = MatchingFactorMixin.linearize(tf, torch.from_numpy(P0))
    _assert_system(tl, jl)
    assert _rel(tf.error(torch.from_numpy(P0)).numpy(), jax.jit(jf.error)(P0)) < SYSTEM_TOL
    # the analytic K3 route and the AD route form the same system
    _assert_system(tf.linearize_corr(torch.from_numpy(P0), tf.correspondences(torch.from_numpy(P0)))[0], tl)


def test_prior_factor_matches_jax(scene):
    xi = np.random.RandomState(7).uniform(-0.2, 0.2, (3, 6)).astype(np.float32)
    prior = np.asarray(jse3.se3_exp(jnp.asarray(xi[0])))
    poses = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(x))) for x in xi[1:]])
    w = np.asarray([1e6, 1e6, 1e6, 1e4, 1e4, 1e4], np.float32)
    jf = JPrior(prior=jnp.asarray(prior), weights=jnp.asarray(w), key=1)
    tf = PriorFactor(prior=torch.from_numpy(prior), weights=torch.from_numpy(w), key=1)
    jl = jax.jit(jf.linearize)(poses)
    tl = tf.linearize(torch.from_numpy(poses))
    for name in ("H_tt", "b_t", "error"):
        assert _rel(getattr(tl, name), getattr(jl, name)) < SYSTEM_TOL, name
    assert not tl.H_ss.any() and not tl.H_ts.any() and not tl.b_s.any() and tf.keys == (1,)
    batch = np.stack([poses, poses[::-1]])
    assert _rel(tf.error(torch.from_numpy(batch)).numpy(), jax.jit(jax.vmap(jf.error))(batch)) < SYSTEM_TOL


def _graphs(scene, kind):
    jf, tf = _factors(scene, kind)
    jg = JGraph(num_poses=2)
    jg.add(JPrior(prior=jnp.eye(4), weights=jnp.full((6,), 1e6), key=0))
    jg.add(jf)
    tg = FactorGraph(num_poses=2)
    tg.add(PriorFactor(prior=torch.eye(4), weights=torch.full((6,), 1e6), key=0))
    tg.add(tf)
    return jg, tg


def test_graph_linearize_frozen_matches_jax(scene):
    """The prior through the graph's branch for factors without a
    correspondence cache (`linearize` + `error`), the GICP factor through
    the matching branch: A [12, 12], b, the error, and the frozen error of
    a candidate batch."""
    jg, tg = _graphs(scene, "gicp")
    P0 = scene["P0"]
    cands = np.stack([P0, np.stack([np.asarray(jse3.se3_exp(jnp.full((6,), 1e-4))), scene["T_rel"]])])

    def jax_side(p, x):
        A, b, err, efn = jg.linearize_frozen(p)
        return A, b, err, jnp.stack([efn(c) for c in x])

    A, b, err, errs = jax.jit(jax_side)(P0, cands)
    tA, tb, terr, tefn = tg.linearize_frozen(torch.from_numpy(P0))
    assert tA.shape == (12, 12)
    assert _rel(tA, A) < SYSTEM_TOL and _rel(tb, b) < SYSTEM_TOL and _rel(terr, err) < SYSTEM_TOL
    assert _rel(tefn(torch.from_numpy(cands)).numpy(), errs) < SYSTEM_TOL


def test_graph_refuses_unported_factor_kinds():
    """Named for what the graph once did with a factor that adds itself to
    the system: it raised. Now the graph hands it A [P, P, 6, 6] and b [P, 6]
    in its order of dispatch, and what the factor returns is the system: its
    blocks land in A and b beside the prior's, its error and its frozen
    error function join the graph's."""

    @dataclasses.dataclass(frozen=True)
    class Dense:
        key: int = 1

        @property
        def keys(self):
            return (self.key,)

        def add_to_system(self, A, b, poses):
            A = A.clone()
            A[self.key, self.key] += 2.0 * torch.eye(6)
            b = b + torch.arange(12.0).reshape(2, 6)
            return A, b, torch.tensor(3.0), lambda p: 4.0 * torch.ones(p.shape[:-3])

    prior = PriorFactor(prior=torch.eye(4), weights=torch.ones(6), key=0)
    poses = torch.eye(4).expand(2, 4, 4).clone()
    A, b, err, efn = FactorGraph([prior, Dense()], num_poses=2).linearize_frozen(poses)
    pA, pb, perr, pefn = FactorGraph([prior], num_poses=2).linearize_frozen(poses)
    dA = (A - pA).reshape(2, 6, 2, 6).permute(0, 2, 1, 3)
    assert torch.equal(dA[1, 1], 2.0 * torch.eye(6)) and not dA[0].any() and not dA[1, 0].any()
    assert torch.equal(b - pb, torch.arange(12.0))
    assert float(err - perr) == 3.0
    assert torch.equal(efn(poses[None]) - pefn(poses[None]), torch.tensor([4.0]))


@pytest.mark.parametrize("kind", KINDS)
def test_two_scan_lm_matches_jax(scene, kind):
    """basic_scan_matching on the port: the LM on two poses (a 12x12 damped
    solve in `solve_small`) from the perturbed start; both poses within
    1e-3 m and 1e-3 rad of JAX's, the iterations equal."""
    jg, tg = _graphs(scene, kind)
    P0 = scene["P0"]
    jr = jax.jit(lambda p: jlm(jg, p))(P0)
    tr = optimize_lm(tg, torch.from_numpy(P0))
    rot, trans = tse3.pose_error(torch.from_numpy(np.asarray(jr.poses)), tr.poses)
    truth_rot, truth_trans = tse3.pose_error(torch.from_numpy(scene["T_rel"]), tr.poses[1])
    print(f"{kind}: gap {trans.max():.3e} m {rot.max():.3e} rad; iterations {int(tr.status.num_iterations)}; "
          f"against the truth {truth_trans:.3e} m {truth_rot:.3e} rad")
    assert float(trans.max()) < TOL_M and float(rot.max()) < TOL_RAD
    assert int(tr.status.num_iterations) == int(jr.status.num_iterations)
    assert float(truth_trans) < 0.05 and float(truth_rot) < 0.01


def test_remap_keys_matches_jax(scene):
    """Keys of the prior and the binary factors move as the JAX remap_keys
    moves them; the unary -1 stays."""
    from gtsam_points_tpu.factors.base import remap_keys as jremap
    from gtsam_points_tpu_torch.factors.base import remap_keys

    mapping = {0: 4, 1: 2}
    for target_key in (0, -1):
        for kind in ("gicp", "icp"):
            j, t = _factors(scene, kind, target_key)
            assert remap_keys(t, mapping).keys == jremap(j, mapping).keys == (4 if target_key == 0 else -1, 2)
    jp = JPrior(prior=jnp.eye(4), weights=jnp.ones(6), key=1)
    tp = PriorFactor(prior=torch.eye(4), weights=torch.ones(6), key=1)
    assert remap_keys(tp, mapping).keys == jremap(jp, mapping).keys == (2,)
    with pytest.raises(TypeError):
        remap_keys(torch.eye(4), mapping)
