"""PyTorch port vs the JAX package: the IMU re-integration factor and the
Sim(3) factors.

- `make_imu_measurements`: dt, padding and cutting equal to JAX's;
- `reintegrate` (with a zero-padded tail) within 1e-5, and its Jacobians
  with respect to both biases (`torch.func.jacfwd` against `jax.jacfwd`)
  within 1e-5 x max|ref| of each (their entries reach ~5 s² after 100
  float32 steps);
- `ReintegratedImuFactor`: `multi_linearize` within 1e-4 x max|ref|, the
  error of a batch of pose sets within 1e-5 relative, `predict` within 1e-5;
- the protocols of tests/test_misc_components.py (a static IMU integrates
  to the identity; the factor pulls pose 1 onto its prediction through the
  LM, poses within 1e-3 m and 1e-3 rad of JAX's);
- the three protocols of tests/test_experimental.py (scaled_transform and
  a zero error, sim3_matrix and sim3_apply, align_trajectories_sim3
  recovering a scale of 1.6) against JAX: values within 1e-5, the
  alignment's scale within 1e-5 relative and its pose within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors import PriorFactor as JPrior
from gtsam_points_tpu.factors import experimental as jexp
from gtsam_points_tpu.factors import imu as jimu
from gtsam_points_tpu.optim import FactorGraph as JGraph
from gtsam_points_tpu.optim import optimize_lm as jlm
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import (
    PriorFactor,
    ReintegratedImuFactor,
    Sim3,
    align_trajectories_sim3,
    between_sim3_se3_error,
    make_imu_measurements,
    reintegrate,
    scaled_transform,
    sim3_apply,
    sim3_identity,
    sim3_matrix,
    sim3_retract,
)
from gtsam_points_tpu_torch.optim import FactorGraph, optimize_lm
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
VALUE_TOL = 1e-5
SYSTEM_TOL = 1e-4
ERROR_TOL = 1e-5
SCALE_TOL = 1e-5
ALIGN_TOL = 1e-4
TOL_M = 1e-3
TOL_RAD = 1e-3
G = 9.80665


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _exp(xi) -> np.ndarray:
    return np.asarray(jse3.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _imu_pair(stamps, accs, gyros, capacity=None):
    jm = jimu.make_imu_measurements(stamps, accs, gyros, capacity=capacity)
    tm = make_imu_measurements(stamps, accs, gyros, capacity=capacity, device="cpu")
    return jm, tm


def _turning(n=100, seed=0):
    """tests/test_misc_components.py::test_imu_factor_constrains_pose's
    samples (a yaw rate of 0.3 rad/s, 1 m/s² forward) with noise."""
    rng = np.random.RandomState(seed)
    gyros = np.tile([0.0, 0.0, 0.3], (n, 1)) + rng.randn(n, 3) * 0.01
    accs = np.tile([1.0, 0.0, G], (n, 1)) + rng.randn(n, 3) * 0.05
    return np.arange(0.0, n * 0.01, 0.01)[:n], accs, gyros


@pytest.mark.parametrize("capacity", [None, 128, 64])
def test_make_imu_measurements_matches_jax(capacity):
    jm, tm = _imu_pair(*_turning(), capacity=capacity)
    arrays = interop.imu_measurements_to_numpy(jm)
    for name, t in interop.imu_measurements_to_numpy(tm).items():
        np.testing.assert_array_equal(t, arrays[name], err_msg=name)
    back = interop.imu_measurements_from_numpy(arrays, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, tm))


def test_reintegrate_and_bias_jacobians_match_jax():
    jm, tm = _imu_pair(*_turning(), capacity=128)  # a zero-dt tail of 28 samples
    ba, bg = np.array([0.02, -0.01, 0.03], np.float32), np.array([0.001, 0.002, -0.003], np.float32)
    jr = jax.jit(lambda a, g: jimu.reintegrate(jm, a, g))(jnp.asarray(ba), jnp.asarray(bg))
    tr = reintegrate(tm, _t(ba), _t(bg))
    # the JAX signature's `gravity` keyword is accepted and changes nothing
    assert all(torch.equal(a, b) for a, b in zip(reintegrate(tm, _t(ba), _t(bg), gravity=jimu.GRAVITY), tr))
    for t, j in zip(tr, jr):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=VALUE_TOL)
    # the tail changes nothing: the unpadded samples give the same state bit for bit
    _, short = _imu_pair(*_turning())
    assert all(torch.equal(a, b) for a, b in zip(reintegrate(short, _t(ba), _t(bg))[:3], tr[:3]))
    jJ = jax.jit(jax.jacfwd(lambda a, g: jimu.reintegrate(jm, a, g)[:3], argnums=(0, 1)))(jnp.asarray(ba),
                                                                                          jnp.asarray(bg))
    tJ = torch.func.jacfwd(lambda a, g: reintegrate(tm, a, g)[:3], argnums=(0, 1))(_t(ba), _t(bg))
    for tout, jout in zip(tJ, jJ):
        for t, j in zip(tout, jout):
            assert t.dtype == torch.float32 and t.shape == j.shape
            assert _rel(t, j) < VALUE_TOL


def _factor_pair(seed=0):
    jm, tm = _imu_pair(*_turning(seed=seed))
    v = np.array([1.0, 0.2, -0.1], np.float32)
    ba, bg = np.array([0.01, 0.0, -0.02], np.float32), np.array([0.0, 0.001, 0.0], np.float32)
    w = np.array([100.0, 100.0, 100.0, 10.0, 10.0, 10.0], np.float32)
    jf = jimu.ReintegratedImuFactor(measurements=jm, v_i=jnp.asarray(v), bias_acc=jnp.asarray(ba),
                                    bias_gyro=jnp.asarray(bg), weights=jnp.asarray(w), pose_keys=(0, 1))
    tf = ReintegratedImuFactor(measurements=tm, v_i=_t(v), bias_acc=_t(ba), bias_gyro=_t(bg), weights=_t(w),
                               pose_keys=(0, 1))
    return jf, tf


def test_imu_factor_linearize_matches_jax():
    jf, tf = _factor_pair()
    T0 = _exp([0.05, -0.02, 0.1, 0.3, 0.1, -0.2])
    jT1, _ = jf.predict(jnp.asarray(T0))
    T1 = (np.asarray(jT1) @ _exp(np.full(6, 0.02))).astype(np.float32)
    poses = np.stack([T0, T1]).astype(np.float32)
    jH, jb, je = jax.jit(jf.multi_linearize)(jnp.asarray(poses))
    tH, tb, te = tf.multi_linearize(_t(poses))
    assert tH.shape == (12, 12)
    assert _rel(tH, jH) < SYSTEM_TOL and _rel(tb, jb) < SYSTEM_TOL and _rel(te, je) < ERROR_TOL
    batch = np.stack([poses, np.stack([T0, np.asarray(jT1)])]).astype(np.float32)
    assert _rel(tf.error(_t(batch)), jax.vmap(jf.error)(jnp.asarray(batch))) < ERROR_TOL
    tp, tv = tf.predict(_t(T0))
    jp, jv = jf.predict(jnp.asarray(T0))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=VALUE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=VALUE_TOL)


def test_imu_static_protocol_matches_jax():
    """tests/test_misc_components.py::test_imu_reintegration_static: a static
    IMU measuring -gravity integrates to the identity motion."""
    jm, tm = _imu_pair(np.arange(0.0, 1.0, 0.01), np.tile([0.0, 0.0, G], (100, 1)), np.zeros((100, 3)))
    z = np.zeros(3, np.float32)
    jdR = np.asarray(jimu.reintegrate(jm, jnp.zeros(3), jnp.zeros(3))[0])
    tdR = reintegrate(tm, torch.zeros(3), torch.zeros(3))[0].numpy()
    np.testing.assert_allclose(tdR, jdR, atol=VALUE_TOL)
    np.testing.assert_allclose(tdR, np.eye(3), atol=1e-5)
    tf = ReintegratedImuFactor(measurements=tm, v_i=_t(z), bias_acc=_t(z), bias_gyro=_t(z),
                               weights=torch.ones(6) * 100.0, pose_keys=(0, 1))
    jf = jimu.ReintegratedImuFactor(measurements=jm, v_i=jnp.zeros(3), bias_acc=jnp.zeros(3),
                                    bias_gyro=jnp.zeros(3), weights=jnp.ones(6) * 100.0, pose_keys=(0, 1))
    tp, tv = tf.predict(torch.eye(4))
    jp, jv = jf.predict(jnp.eye(4))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=VALUE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=VALUE_TOL)
    np.testing.assert_allclose(tp.numpy(), np.eye(4), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.zeros(3), atol=1e-4)


def test_imu_constrains_pose_protocol_matches_jax():
    """tests/test_misc_components.py::test_imu_factor_constrains_pose: a
    prior of 1e6 on pose 0, the factor, pose 1 started at its prediction
    noised by RandomState(2), optimize_lm with its defaults."""
    gyros = np.tile([0.0, 0.0, 0.3], (100, 1))
    accs = np.tile([1.0, 0.0, G], (100, 1))
    jm, tm = _imu_pair(np.arange(0.0, 1.0, 0.01), accs, gyros)
    jf = jimu.ReintegratedImuFactor(measurements=jm, v_i=jnp.zeros(3), bias_acc=jnp.zeros(3),
                                    bias_gyro=jnp.zeros(3), weights=jnp.ones(6) * 100.0, pose_keys=(0, 1))
    tf = ReintegratedImuFactor(measurements=tm, v_i=torch.zeros(3), bias_acc=torch.zeros(3),
                               bias_gyro=torch.zeros(3), weights=torch.ones(6) * 100.0, pose_keys=(0, 1))
    T_pred = np.asarray(jf.predict(jnp.eye(4))[0])
    noise = np.random.RandomState(2).randn(6).astype(np.float32) * 0.1
    poses0 = np.stack([np.eye(4), T_pred @ _exp(noise)]).astype(np.float32)
    jg = JGraph(num_poses=2)
    jg.add(JPrior(prior=jnp.eye(4), weights=jnp.full((6,), 1e6), key=0))
    jg.add(jf)
    j = np.asarray(jax.jit(lambda p: jlm(jg, p))(jnp.asarray(poses0)).poses)
    tg = FactorGraph(num_poses=2)
    tg.add(PriorFactor(prior=torch.eye(4), weights=torch.full((6,), 1e6), key=0))
    tg.add(tf)
    t = optimize_lm(tg, _t(poses0)).poses.numpy()
    rot, trans = tse3.pose_error(_t(j), _t(t))
    assert float(trans.max()) < TOL_M and float(rot.max()) < TOL_RAD
    rot, trans = tse3.pose_error(_t(T_pred), _t(t[1]))
    assert float(rot) < 1e-3 and float(trans) < 1e-2


def _rand_pose(rng, rot=0.3, trans=2.0) -> np.ndarray:
    return _exp(np.concatenate([rng.randn(3) * rot, rng.randn(3) * trans]))


def test_sim3_scaled_transform_and_error_zero_match_jax():
    """tests/test_experimental.py::test_scaled_transform_and_error_zero."""
    T = _rand_pose(np.random.RandomState(0))
    js = jexp.Sim3(pose=jnp.asarray(T), scale=jnp.float32(2.0))
    ts = Sim3(pose=_t(T), scale=torch.tensor(2.0))
    st = scaled_transform(ts).numpy()
    np.testing.assert_allclose(st, np.asarray(jexp.scaled_transform(js)), atol=VALUE_TOL)
    np.testing.assert_allclose(st[:3, 3], 2.0 * T[:3, 3], atol=1e-6)
    r = between_sim3_se3_error(ts, _t(st))
    np.testing.assert_allclose(r.numpy(), np.asarray(jexp.between_sim3_se3_error(js, jnp.asarray(st))),
                               atol=VALUE_TOL)
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-5)
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32)
    T2 = _rand_pose(np.random.RandomState(9), 0.1, 0.5)
    np.testing.assert_allclose(between_sim3_se3_error(ts, _t(T2), _t(w)).numpy(),
                               np.asarray(jexp.between_sim3_se3_error(js, jnp.asarray(T2), jnp.asarray(w))),
                               atol=VALUE_TOL)
    assert torch.equal(ts.pose, _t(T))  # the operand is unchanged


def test_sim3_matrix_apply_retract_match_jax():
    """tests/test_experimental.py::test_sim3_matrix_apply, and sim3_retract."""
    rng = np.random.RandomState(1)
    T = _rand_pose(rng)
    js = jexp.Sim3(pose=jnp.asarray(T), scale=jnp.float32(1.7))
    ts = Sim3(pose=_t(T), scale=torch.tensor(1.7))
    pts = rng.randn(10, 3).astype(np.float32)
    np.testing.assert_allclose(sim3_apply(ts, _t(pts)).numpy(), np.asarray(jexp.sim3_apply(js, jnp.asarray(pts))),
                               atol=VALUE_TOL)
    M = sim3_matrix(ts).numpy()
    np.testing.assert_allclose(M, np.asarray(jexp.sim3_matrix(js)), atol=VALUE_TOL)
    np.testing.assert_allclose(sim3_apply(ts, _t(pts)).numpy(), pts @ M[:3, :3].T + M[:3, 3], atol=1e-5)
    assert torch.equal(ts.pose, _t(T))
    xi = np.array([0.1, -0.2, 0.05, 0.3, 0.2, -0.1, 0.2], np.float32)
    tr, jr = sim3_retract(ts, _t(xi)), jexp.sim3_retract(js, jnp.asarray(xi))
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=VALUE_TOL)
    assert abs(float(tr.scale) - float(jr.scale)) <= VALUE_TOL
    ident = sim3_identity(device="cpu")
    assert torch.equal(ident.pose, torch.eye(4)) and float(ident.scale) == 1.0


def test_align_trajectories_sim3_matches_jax():
    """tests/test_experimental.py::test_align_trajectories_sim3_recovers_scale:
    12 poses, a Sim(3) of scale 1.6, 30 iterations; then the same with
    weights and noise on the second trajectory, 20 iterations."""
    rng = np.random.RandomState(2)
    poses_a = np.stack([_rand_pose(rng, rot=0.2, trans=3.0) for _ in range(12)])
    S_pose = _rand_pose(rng, rot=0.3, trans=1.0)
    S = jexp.Sim3(pose=jnp.asarray(S_pose), scale=jnp.float32(1.6))
    poses_b = np.stack([np.asarray(jexp.scaled_transform(jexp.Sim3(pose=S.pose @ jnp.asarray(p), scale=S.scale)))
                        for p in poses_a]).astype(np.float32)
    noisy = np.stack([p @ _exp(np.random.RandomState(30 + i).randn(6) * 0.01) for i, p in enumerate(poses_b)])
    w = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 2.0], np.float32)
    for b, weights, iterations in ((poses_b, None, 30), (noisy.astype(np.float32), w, 20)):
        jw = None if weights is None else jnp.asarray(weights)
        j = jax.jit(lambda a, b: jexp.align_trajectories_sim3(a, b, jw, iterations=iterations))(
            jnp.asarray(poses_a), jnp.asarray(b))
        t = align_trajectories_sim3(_t(poses_a), _t(b), None if weights is None else _t(weights),
                                    iterations=iterations)
        assert abs(float(t.scale) - float(j.scale)) <= SCALE_TOL * float(j.scale)
        rot, trans = tse3.pose_error(_t(np.asarray(j.pose)), t.pose)
        assert float(trans) < ALIGN_TOL and float(rot) < ALIGN_TOL
        arrays = interop.sim3_to_numpy(t)
        assert torch.equal(interop.sim3_from_numpy(arrays, device="cpu").pose, t.pose)
    assert abs(float(t.scale) - 1.6) < 1e-2
    # a weights or second-trajectory tensor on another device is refused
    with pytest.raises(ValueError):
        align_trajectories_sim3(_t(poses_a), _t(poses_b), _t(w).to("meta"), iterations=1)
    with pytest.raises(ValueError):
        align_trajectories_sim3(_t(poses_a), _t(poses_b).to("meta"), iterations=1)
