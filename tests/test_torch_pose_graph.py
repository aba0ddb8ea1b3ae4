"""PyTorch port vs the JAX package: the multi-frame factor graph.

- the last of `se3`: `adjoint`, `quat_to_rot` and `pose_from_xyzq` within
  1e-6 of JAX's, and T Exp(xi) T⁻¹ = Exp(Ad(T) xi);
- `BetweenFactor` and `LinearDampingFactor`, and the multi-key factors
  (`Pose3CalibFactor`, `Pose3InterpolationFactor`, `RotateVector3Factor`)
  through `multi_linearize`, block by block within 1e-4 x max|ref|, their
  errors over a batch of pose sets (the LM's candidates);
- the graph's `multi_linearize` branch: A, b, the error and the frozen
  error of a batch;
- `solve_small` past its unrolled size (n = 24, 30: the Cholesky route)
  within 1e-5 x max|ref|, and a singular system, where both packages take
  the zero step;
- `optimize_gn`, `optimize_dogleg` and `gradient_descent` on a chain of
  five 2048-point ring frames (VGICP edges (i, i+1) and (i, i+2), a prior
  on pose 0, starts perturbed as the reference's demo_matching_cost_factors
  perturbs them), every pose within 1e-3 m and 1e-3 rad of the JAX poses.

The JAX `gradient_descent` returns NaN: `jax.grad` through `se3_exp` at zero
tangent meets sqrt'(0) = inf times 0 in the rotation's branch that
`jnp.where` drops. The port's is finite (`se3._safe_sqrt`); it is held to the
same descent in JAX with the gradient taken by `jax.jacfwd`, which has no
such product, and the test checks that the JAX function is still NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors import BetweenFactor as JBetween
from gtsam_points_tpu.factors import LinearDampingFactor as JDamping
from gtsam_points_tpu.factors import Pose3CalibFactor as JCalib
from gtsam_points_tpu.factors import Pose3InterpolationFactor as JInterp
from gtsam_points_tpu.factors import PriorFactor as JPrior
from gtsam_points_tpu.factors import RotateVector3Factor as JRotate
from gtsam_points_tpu.factors import make_vgicp_factor as jvgicp
from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs
from gtsam_points_tpu.optim import FactorGraph as JGraph
from gtsam_points_tpu.optim import optimize_dogleg as jdogleg
from gtsam_points_tpu.optim import optimize_gn as jgn
from gtsam_points_tpu.optim import retract as jretract
from gtsam_points_tpu.optim.dogleg import gradient_descent as jdescent
from gtsam_points_tpu.optim.lm import _solve_damped as jsolve_damped
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu.utils.solve6 import solve_small as jsolve
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import (
    BetweenFactor,
    LinearDampingFactor,
    Pose3CalibFactor,
    Pose3InterpolationFactor,
    PriorFactor,
    RotateVector3Factor,
    make_vgicp_factor,
)
from gtsam_points_tpu_torch.optim import FactorGraph, gradient_descent, optimize_dogleg, optimize_gn
from gtsam_points_tpu_torch.optim.lm import _solve_damped
from gtsam_points_tpu_torch.utils import se3 as tse3
from gtsam_points_tpu_torch.utils.solve6 import UNROLL_MAX, solve_small

torch.set_num_threads(1)
SYSTEM_TOL = 1e-4
SOLVE_TOL = 1e-5
TOL_M = 1e-3
TOL_RAD = 1e-3
P = 5
CHAIN = [(i, i + 1) for i in range(P - 1)] + [(i, i + 2) for i in range(P - 2)]
DESCENT_STEP = 1e-7  # the prior's 1e6 weight diverges gradient descent at 1e-6
DESCENT_ITERATIONS = 10
BLOCKS = ("H_tt", "H_ss", "H_ts", "b_t", "b_s", "error")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def poses():
    xi = np.random.RandomState(0).uniform(-0.5, 0.5, (P, 6)).astype(np.float32)
    return np.asarray(jse3.se3_exp(jnp.asarray(xi)))


def _pair(kind):
    """(JAX factor, port factor) of one kind, on seeded inputs."""
    rng = np.random.RandomState(3)
    w = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    if kind == "between":
        m = np.asarray(jse3.se3_exp(jnp.asarray(rng.uniform(-0.5, 0.5, 6).astype(np.float32))))
        return (JBetween(measured=jnp.asarray(m), weights=jnp.asarray(w), target_key=1, source_key=3),
                BetweenFactor(measured=_t(m), weights=_t(w), target_key=1, source_key=3))
    if kind == "damping":
        return JDamping(weights=jnp.asarray(w), key=2), LinearDampingFactor(weights=_t(w), key=2)
    if kind == "calib":
        return JCalib(weights=jnp.asarray(w), pose_keys=(0, 2, 4)), Pose3CalibFactor(weights=_t(w), pose_keys=(0, 2, 4))
    if kind == "interpolation":
        return (JInterp(t=jnp.float32(0.3), weights=jnp.asarray(w), pose_keys=(1, 2, 3)),
                Pose3InterpolationFactor(t=torch.tensor(0.3), weights=_t(w), pose_keys=(1, 2, 3)))
    local, world = [0.0, 0.0, 1.0], [0.1, -0.05, 0.99]
    return (JRotate(local=jnp.asarray(local), world=jnp.asarray(world), weights=jnp.asarray(w[:3]), pose_keys=(2,)),
            RotateVector3Factor(local=_t(local), world=_t(world), weights=_t(w[:3]), pose_keys=(2,)))


def test_se3_adjoint_and_quaternions_match_jax(poses):
    q = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    xyzq = np.concatenate([np.random.RandomState(2).randn(8, 3).astype(np.float32), q], axis=1)
    np.testing.assert_allclose(tse3.adjoint(_t(poses)).numpy(), np.asarray(jse3.adjoint(jnp.asarray(poses))), atol=1e-6)
    np.testing.assert_allclose(tse3.quat_to_rot(_t(q)).numpy(), np.asarray(jse3.quat_to_rot(jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(tse3.pose_from_xyzq(_t(xyzq)).numpy(), np.asarray(jse3.pose_from_xyzq(jnp.asarray(xyzq))),
                               atol=1e-6)
    xi = _t(np.random.RandomState(3).uniform(-0.3, 0.3, (P, 6)))
    T = _t(poses)
    lhs = T @ tse3.se3_exp(xi) @ tse3.se3_inverse(T)
    rhs = tse3.se3_exp((tse3.adjoint(T) @ xi[..., None])[..., 0])
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-5)


@pytest.mark.parametrize("kind", ["between", "damping"])
def test_pose_factor_matches_jax(poses, kind):
    jf, tf = _pair(kind)
    jl = jax.jit(jf.linearize)(poses)
    tl = tf.linearize(_t(poses))
    for name in BLOCKS:
        assert _rel(getattr(tl, name), getattr(jl, name)) < SYSTEM_TOL, name
        assert getattr(tl, name).dtype == torch.float32
    assert tf.keys == jf.keys
    batch = np.stack([poses, poses[::-1]])
    terr = tf.error(_t(batch))
    assert terr.shape == (2,)
    assert _rel(terr, jax.vmap(jf.error)(batch)) < SYSTEM_TOL


@pytest.mark.parametrize("kind", ["calib", "interpolation", "rotate"])
def test_multi_key_factor_matches_jax(poses, kind):
    jf, tf = _pair(kind)
    jH, jb, jerr = jax.jit(jf.multi_linearize)(poses)
    tH, tb, terr = tf.multi_linearize(_t(poses))
    assert _rel(tH, jH) < SYSTEM_TOL and _rel(tb, jb) < SYSTEM_TOL and _rel(terr, jerr) < SYSTEM_TOL
    assert tH.shape == (6 * len(tf.keys),) * 2 and tH.dtype == torch.float32
    batch = np.stack([poses, poses[::-1], poses[[1, 0, 3, 2, 4]]])
    assert _rel(tf.error(_t(batch)), jax.vmap(jf.error)(batch)) < SYSTEM_TOL


def test_graph_multi_linearize_matches_jax(poses):
    """A [30, 30], b, the error, and the frozen error of a batch of pose
    sets, for a graph of every factor above and a prior."""
    jg, tg = JGraph(num_poses=P), FactorGraph(num_poses=P)
    jg.add(JPrior(prior=jnp.eye(4), weights=jnp.ones(6), key=0))
    tg.add(PriorFactor(prior=torch.eye(4), weights=torch.ones(6), key=0))
    for kind in ("between", "damping", "calib", "interpolation", "rotate"):
        jf, tf = _pair(kind)
        jg.add(jf)
        tg.add(tf)
    batch = np.stack([poses, poses[::-1]])

    def jax_side(p, x):
        A, b, err, efn = jg.linearize_frozen(p)
        return A, b, err, jnp.stack([efn(c) for c in x])

    A, b, err, errs = jax.jit(jax_side)(poses, batch)
    tA, tb, terr, tefn = tg.linearize_frozen(_t(poses))
    assert tA.shape == (6 * P, 6 * P)
    assert _rel(tA, A) < SYSTEM_TOL and _rel(tb, b) < SYSTEM_TOL and _rel(terr, err) < SYSTEM_TOL
    assert _rel(tefn(_t(batch)), errs) < SYSTEM_TOL


@pytest.mark.parametrize("n", [24, 30])
def test_solve_small_cholesky_route_matches_jax(n):
    """Past UNROLL_MAX both packages factorize: a batch of SPD systems."""
    assert n > UNROLL_MAX
    rng = np.random.RandomState(n)
    M = rng.randn(4, n, n).astype(np.float32)
    H = M @ M.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    b = rng.randn(4, n).astype(np.float32)
    ref = np.asarray(jsolve(jnp.asarray(H), jnp.asarray(b)))
    assert _rel(solve_small(_t(H), _t(b)), ref) < SOLVE_TOL


def test_singular_system_takes_the_zero_step():
    """A 24x24 system with a zero block, undamped: the reference's Cholesky
    gives NaN and `_solve_damped` the zero step with ok False; so does the
    port's (NaN where `cholesky_ex` reports failure)."""
    n = 24
    A = np.zeros((n, n), np.float32)
    A[:12, :12] = 2.0 * np.eye(12, dtype=np.float32)
    b = np.ones(n, np.float32)
    jd, jok = jsolve_damped(jnp.asarray(A), jnp.asarray(b), jnp.float32(0.0), False)
    td, tok = _solve_damped(_t(A), _t(b), torch.zeros(1), False)
    assert not bool(jok) and not bool(tok[0])
    assert not np.asarray(jd).any() and not td.any()
    assert torch.isnan(solve_small(_t(A), _t(b))).all()


@pytest.fixture(scope="module")
def chain():
    """Five 2048-point ring frames with covariances (the JAX package's,
    carried across), the two packages' graphs of the chain, the start."""
    T_true = ring_trajectory(P, lap=100)
    scans = ring_scans(ring_world(0, 24000), T_true, scan_n=2048, seed=1)
    jf = [jax.jit(jcovs)(jmake(s)) for s in scans]
    tf = [interop.frame_from_numpy({k: np.asarray(getattr(f, k)) for k in ("points", "mask", "covs")}, device="cpu")
          for f in jf]
    jg, tg = JGraph(num_poses=P), FactorGraph(num_poses=P)
    jg.add(JPrior(prior=jnp.asarray(T_true[0]), weights=jnp.full((6,), 1e6), key=0))
    tg.add(PriorFactor(prior=_t(T_true[0]), weights=torch.full((6,), 1e6), key=0))
    for i, j in CHAIN:
        jg.add(jvgicp(i, j, jf[i], jf[j], voxel_resolution=1.0, min_voxel_points=4))
        tg.add(make_vgicp_factor(i, j, tf[i], tf[j], voxel_resolution=1.0, min_voxel_points=4))
    rng = np.random.RandomState(42)
    start = [T_true[0]] + [T_true[i] @ np.asarray(jse3.se3_exp(jnp.asarray(rng.uniform(-0.1, 0.1, 6).astype(np.float32))))
                           for i in range(1, P)]
    return {"jg": jg, "tg": tg, "P0": np.stack(start).astype(np.float32), "T_true": np.stack(T_true)}


def _assert_poses(t, j, limit_m=TOL_M, limit_rad=TOL_RAD):
    rot, trans = tse3.pose_error(_t(np.asarray(j)), t)
    assert float(trans.max()) < limit_m and float(rot.max()) < limit_rad, (float(trans.max()), float(rot.max()))


def test_gn_matches_jax(chain):
    jr = jax.jit(lambda p: jgn(chain["jg"], p, iterations=5))(chain["P0"])
    tr = optimize_gn(chain["tg"], _t(chain["P0"]), iterations=5)
    _assert_poses(tr.poses, jr.poses)
    assert _rel(tr.error, jr.error) < SYSTEM_TOL
    # the demo's bounds against the truth
    _assert_poses(tr.poses, chain["T_true"], 0.15, 0.015)


def test_dogleg_matches_jax(chain):
    jr = jax.jit(lambda p: jdogleg(chain["jg"], p))(chain["P0"])
    tr = optimize_dogleg(chain["tg"], _t(chain["P0"]))
    _assert_poses(tr.poses, jr.poses)
    assert _rel(tr.error, jr.error) < SYSTEM_TOL and _rel(tr.delta, jr.delta) < SYSTEM_TOL
    assert int(tr.num_iterations) == int(jr.num_iterations)
    _assert_poses(tr.poses, chain["T_true"], 0.15, 0.015)


def test_gradient_descent_matches_jax_forward_mode(chain):
    jg = chain["jg"]

    def descent(p):
        def body(_, p):
            g = jax.jacfwd(lambda xi: jg.error(jretract(p, xi)))(jnp.zeros((P * 6,), jnp.float32))
            return jretract(p, -DESCENT_STEP * g)

        p = jax.lax.fori_loop(0, DESCENT_ITERATIONS, body, p)
        return p, jg.error(p)

    jp, jerr = jax.jit(descent)(chain["P0"])
    tp, terr = gradient_descent(chain["tg"], _t(chain["P0"]), DESCENT_ITERATIONS, DESCENT_STEP)
    _assert_poses(tp, jp)
    assert _rel(terr, jerr) < SYSTEM_TOL
    assert float(terr) < float(chain["tg"].error(_t(chain["P0"])))
    nan_poses, nan_err = jax.jit(lambda p: jdescent(jg, p, iterations=1, step=DESCENT_STEP))(chain["P0"])
    assert np.isnan(np.asarray(nan_err)) and np.isnan(np.asarray(nan_poses)).any()
