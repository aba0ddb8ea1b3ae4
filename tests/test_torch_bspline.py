"""PyTorch port vs the JAX package: the continuous-time B-spline trajectory
(utils/bspline).

The same numpy inputs go to both packages: tests/test_bspline.py's smooth
trajectory, sampled at 10 Hz over 4 s (the dense route, K = 43 knots) and
over 12 s (the banded route, K = 123), knots 0.1 s apart. Each JAX fit is
built once, in a module-scoped fixture (a JAX fit compiles for about 10 s
whatever its size).

Tolerances:
- `bspline_pose` on random knots, and evaluation on JAX's own knots (carried
  by `interop.trajectory_from_numpy`): the pose within 1e-5 x max|T|, the
  velocity within 1e-4 x its max, the IMU acceleration within 1e-3 m/s²
  and the angular rate within 1e-4 rad/s; the interval and the normalized
  time `_locate` picks bit for bit. The stamps lie on every interval
  boundary, inside the intervals, and half an interval past both clipped
  ends. Farther out u grows and so does the float32 rounding of both
  packages: three intervals past the end, each is 1.3e-3 m/s² (JAX) and
  2.6e-3 (the port) from a float64 evaluation of the same spline;
- after the fit, on both routes: every knot and every fitted pose within
  1e-4 m and 1e-4 rad of JAX's; the IMU along the fit within 2e-2 m/s² and
  5e-3 rad/s, a tenth of tests/test_continuous_data.py:55-58's bounds;
- `num_knots` equal to JAX's on spans where the float32 and the float64
  ceil differ; `knot_stamp` bit for bit; `_band_matvec` within 1e-5 x
  max|ref| of a dense matrix product in float64.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.utils import bspline as jbs
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.utils import bspline as tbs
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)

KNOT_INTERVAL = 0.1
ROUTES = {"dense": 4.0, "banded": 12.0}  # seconds of samples at 10 Hz
# evaluation on the same knots
POSE_TOL = 1e-5  # x max|T|
VEL_TOL = 1e-4  # x max|velocity|, angular and linear each
ACC_TOL = 1e-3  # m/s^2
GYRO_TOL = 1e-4  # rad/s
# after the fit
FIT_TOL_M = 1e-4
FIT_TOL_RAD = 1e-4
FIT_ACC_TOL = 2e-2  # m/s^2
FIT_GYRO_TOL = 5e-3  # rad/s


def smooth_trajectory(ts):
    """tests/test_bspline.py's analytic smooth SE3 trajectory, all stamps at once."""
    w = np.stack([0.1 * np.sin(ts), 0.05 * ts, 0.2 * np.cos(0.5 * ts)], -1).astype(np.float32)
    p = np.stack([2 * ts, np.sin(ts), 0.5 * ts * ts * 0.1], -1).astype(np.float32)
    return np.array(jse3.make_transform(jse3.so3_exp(jnp.asarray(w)), jnp.asarray(p)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_eval(knots, t0, dt, q):
    traj = jbs.ContinuousTrajectory(knots, t0, dt)
    return traj.pose(q), traj.velocity(q), traj.imu(q)


def _torch_eval(traj, q):
    return traj.pose(q), traj.velocity(q), traj.imu(q)


def _numpy(out):
    return jax.tree_util.tree_map(np.asarray, out)


def _queries(T1: float, K: int):
    """Stamps on every interval boundary (the knot stamps t0 + (i - 1) dt,
    i = 1 .. K - 3, in float32), inside the intervals, and half an interval
    past both clipped ends."""
    bounds = np.asarray(jbs.ContinuousTrajectory(jnp.zeros((K, 4, 4)), 0.0, KNOT_INTERVAL).knot_stamp(
        jnp.arange(1, K - 2)))
    inside = np.random.RandomState(5).uniform(0.0, T1, 64)
    past = [-0.5 * KNOT_INTERVAL, T1 + 0.5 * KNOT_INTERVAL]
    return np.concatenate([bounds, inside, past]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_fits():
    """Each route's samples and JAX's knots; on the banded route's knots,
    JAX's `_locate` (eager, as the reference evaluates) and its pose,
    velocity and IMU (one jitted call) at `_queries`."""
    out = {}
    for route, T1 in ROUTES.items():
        ts = (np.arange(int(round(T1 * 10)) + 1) / 10).astype(np.float32)
        poses = smooth_trajectory(ts)
        traj = jbs.fit_knots(jnp.asarray(ts), jnp.asarray(poses), t0=0.0, t1=T1, knot_interval=KNOT_INTERVAL)
        out[route] = {"ts": ts, "poses": poses, "T1": T1, "knots": np.asarray(traj.knots)}
    f = out["banded"]
    f["q"] = _queries(f["T1"], len(f["knots"]))
    traj = jbs.ContinuousTrajectory(jnp.asarray(f["knots"]), 0.0, KNOT_INTERVAL)
    f["locate"] = _numpy(traj._locate(jnp.asarray(f["q"])))
    f["eval"] = _numpy(_jax_eval(traj.knots, 0.0, KNOT_INTERVAL, jnp.asarray(f["q"])))
    return out


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-30))


def test_bspline_pose_matches_jax():
    rng = np.random.RandomState(0)
    xi = rng.uniform(-0.5, 0.5, (8, 6)).astype(np.float32)
    xi[:, 3:] *= 10.0
    knots = tse3.se3_exp(torch.from_numpy(xi)).numpy()
    u = rng.uniform(0.0, 1.0, 50).astype(np.float32)
    i = rng.randint(1, 8 - 2, 50).astype(np.int32)
    ref = np.asarray(jax.jit(jbs.bspline_pose)(jnp.asarray(knots), jnp.asarray(u), jnp.asarray(i)))
    got = tbs.bspline_pose(torch.from_numpy(knots), torch.from_numpy(u), torch.from_numpy(i)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref) < POSE_TOL
    # one stamp, unbatched
    one = tbs.bspline_pose(torch.from_numpy(knots), torch.tensor(u[0]), torch.tensor(i[0])).numpy()
    assert _rel(one, ref[0]) < POSE_TOL


@pytest.mark.parametrize("span", [(0.1, 0.4, 0.1), (0.0, 2.1, 0.3), (0.2, 0.8, 0.1), (0.3, 0.4, 0.1)])
def test_num_knots_rounds_in_float32(span):
    t0, t1, dt = span
    got = tbs.ContinuousTrajectory.num_knots(t0, t1, dt)
    assert got == jbs.ContinuousTrajectory.num_knots(t0, t1, dt)
    assert got != math.ceil((t1 - t0) / dt) + 3  # the span tells the two ceils apart


def test_knot_stamp_matches_jax():
    i = np.arange(-2, 130, dtype=np.int32)
    for t0, dt in ((0.0, 0.1), (1234.5678, 0.05)):
        ref = np.asarray(jbs.ContinuousTrajectory(jnp.zeros((8, 4, 4)), t0, dt).knot_stamp(jnp.asarray(i)))
        got = tbs.ContinuousTrajectory(torch.zeros(8, 4, 4), t0, dt).knot_stamp(torch.from_numpy(i)).numpy()
        np.testing.assert_array_equal(got, ref)


def test_band_matvec_matches_dense_product():
    rng = np.random.RandomState(1)
    K = 11
    Hb = rng.randn(K, 7, 6, 6).astype(np.float32)
    x = rng.randn(K, 6).astype(np.float32)
    dense = np.zeros((K * 6, K * 6))
    for k in range(K):
        for o in range(7):
            j = k + o - 3
            if 0 <= j < K:
                dense[6 * k:6 * k + 6, 6 * j:6 * j + 6] = Hb[k, o]
    ref = (dense @ x.reshape(-1).astype(np.float64)).reshape(K, 6)
    got = tbs._band_matvec(torch.from_numpy(Hb), torch.from_numpy(x)).numpy()
    assert _rel(got, ref) < 1e-5
    assert _rel(np.asarray(jbs._band_matvec(jnp.asarray(Hb), jnp.asarray(x))), ref) < 1e-5


def test_locate_matches_jax(jax_fits):
    """The interval and the normalized time of every stamp, bit for bit: on
    the boundaries float32 picks the interval."""
    f = jax_fits["banded"]
    traj = interop.trajectory_from_numpy(f["knots"], 0.0, KNOT_INTERVAL, device="cpu")
    u, i = traj._locate(torch.from_numpy(f["q"]))
    ju, ji = f["locate"]
    assert i.dtype == torch.int32 and u.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(u.numpy(), ju)


def test_evaluation_on_jax_knots(jax_fits):
    f = jax_fits["banded"]
    traj = interop.trajectory_from_numpy(f["knots"], 0.0, KNOT_INTERVAL, device="cpu")
    T, (omega, v), (acc, gyro) = _numpy(_torch_eval(traj, torch.from_numpy(f["q"])))
    jT, (jomega, jv), (jacc, jgyro) = f["eval"]
    assert T.dtype == acc.dtype == np.float32
    assert _rel(T, jT) < POSE_TOL
    assert _rel(omega, jomega) < VEL_TOL and _rel(v, jv) < VEL_TOL
    assert np.abs(acc - jacc).max() < ACC_TOL, np.abs(acc - jacc).max()
    assert np.abs(gyro - jgyro).max() < GYRO_TOL, np.abs(gyro - jgyro).max()
    # one stamp, unbatched, through nested jvp
    k = len(f["q"]) // 2
    a1, g1 = traj.imu(torch.tensor(f["q"][k]))
    assert a1.shape == (3,) and np.abs(a1.numpy() - jacc[k]).max() < ACC_TOL
    assert np.abs(g1.numpy() - jgyro[k]).max() < GYRO_TOL


def test_imu_first_with_fresh_constants(jax_fits, monkeypatch):
    """`imu` as the first call on a trajectory whose t0 and dt no other test
    uses, with the constant caches emptied: the constants are then made
    inside imu's nested `jvp`, and the second call reads them from the
    cache under a new `jvp`. Both calls give JAX's prediction on the same
    knots, carried over by the change of time t' = t0' + t dt' / dt: the
    velocity scales by s = dt / dt', the acceleration by s^2, gravity not."""
    monkeypatch.setattr(tse3, "_CONSTS", {})
    monkeypatch.setattr(tbs, "_DEVICE_CONSTS", {})
    t0, dt = 3.75, 0.125
    f = jax_fits["banded"]
    jT, _, (jacc, jgyro) = f["eval"]
    s = KNOT_INTERVAL / dt
    g_local = np.einsum("nji,j->ni", jT[:, :3, :3].astype(np.float64), [0.0, 0.0, -9.80665])
    ref_acc, ref_gyro = s * s * (jacc + g_local) - g_local, s * jgyro
    q = (t0 + f["q"].astype(np.float64) * (dt / KNOT_INTERVAL)).astype(np.float32)
    traj = interop.trajectory_from_numpy(f["knots"], t0, dt, device="cpu")
    for _ in range(2):
        acc, gyro = _numpy(traj.imu(torch.from_numpy(q)))
        assert np.abs(acc - ref_acc).max() < ACC_TOL, np.abs(acc - ref_acc).max()
        assert np.abs(gyro - ref_gyro).max() < GYRO_TOL, np.abs(gyro - ref_gyro).max()


@pytest.mark.parametrize("route", list(ROUTES))
def test_fit_knots_matches_jax(jax_fits, route):
    """The port's fit against JAX's, both evaluated by the port (evaluation on
    the same knots is held above), so only the fits differ."""
    f = jax_fits[route]
    traj = tbs.fit_knots(torch.from_numpy(f["ts"]), torch.from_numpy(f["poses"]), t0=0.0, t1=f["T1"],
                         knot_interval=KNOT_INTERVAL, device="cpu")
    assert traj.knots.shape == f["knots"].shape and traj.knots.dtype == torch.float32
    assert (len(f["knots"]) > 96) == (route == "banded")
    rot, trans = tse3.pose_error(torch.from_numpy(f["knots"]), traj.knots)
    assert float(trans.max()) < FIT_TOL_M and float(rot.max()) < FIT_TOL_RAD, (float(trans.max()), float(rot.max()))
    jax_traj = interop.trajectory_from_numpy(f["knots"], 0.0, KNOT_INTERVAL, device="cpu")
    q = torch.from_numpy(_queries(f["T1"], len(f["knots"])))
    (T, _, (acc, gyro)), (jT, _, (jacc, jgyro)) = _numpy(_torch_eval(traj, q)), _numpy(_torch_eval(jax_traj, q))
    rot, trans = tse3.pose_error(torch.from_numpy(jT), torch.from_numpy(T))
    assert float(trans.max()) < FIT_TOL_M and float(rot.max()) < FIT_TOL_RAD, (float(trans.max()), float(rot.max()))
    inside = ((q > 0.0) & (q < f["T1"])).numpy()  # the IMU strictly inside the span, as the demo predicts it
    assert np.abs(acc - jacc)[inside].max() < FIT_ACC_TOL
    assert np.abs(gyro - jgyro)[inside].max() < FIT_GYRO_TOL
    # and the fit reproduces the samples, as tests/test_bspline.py asks of JAX's
    rot, trans = tse3.pose_error(torch.from_numpy(f["poses"]), traj.pose(torch.from_numpy(f["ts"])))
    assert float(rot.max()) < 0.01 and float(trans.max()) < 0.02


@pytest.mark.parametrize("threshold", [96, 0], ids=["dense", "banded"])
def test_fit_knots_takes_the_zero_step_where_the_step_fails(threshold):
    """A NaN sample makes every step non-finite: each route keeps its initial
    knots (the nearest sample a knot), as the reference's guard does
    (bspline.py:164, :288); the knot made from the NaN sample stays NaN."""
    ts = (np.arange(21) / 10).astype(np.float32)
    poses = smooth_trajectory(ts)
    poses[7, 0, 3] = np.nan
    traj = tbs.fit_knots(torch.from_numpy(ts), torch.from_numpy(poses), t0=0.0, t1=2.0, knot_interval=KNOT_INTERVAL,
                         iterations=1, dense_knot_threshold=threshold, device="cpu")
    knot_t = (np.arange(23) - 1).astype(np.float32) * np.float32(KNOT_INTERVAL)  # float32, as JAX's
    init = np.clip(np.searchsorted(ts, knot_t), 0, len(ts) - 1)
    knots, bad = traj.knots.numpy(), init == 7
    np.testing.assert_array_equal(knots[~bad], poses[init][~bad])
    assert bad.any() and np.isnan(knots[bad]).any(axis=(1, 2)).all()
