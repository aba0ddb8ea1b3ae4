"""The slice end to end: point-path VGICP scan-to-map odometry, PyTorch port
vs the JAX package, on a 6-scan ring sequence.

Each package preprocesses the same numpy scans itself (covariances from
estimate_normals_covs_moments) and runs odometry_step with clusters=None
from its own init_odometry. Held: every pose within 1e-3 m and 1e-3 rad of
the JAX pose, LM iterations per step within 1, equal final map keys. Both
trajectories' errors against ring_trajectory (ATE) are recorded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs
from gtsam_points_tpu.pipelines import odometry as jodo
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch.ops.features import estimate_normals_covs_moments as tcovs
from gtsam_points_tpu_torch.pipelines import odometry as todo
from gtsam_points_tpu_torch.registration.cluster import SourceClusters, cluster_source
from gtsam_points_tpu_torch.types.frame import make_frame as tmake

torch.set_num_threads(1)
N_SCANS = 6
SCAN_N = 2048
MAP_CAPACITY = 16384
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3


def _ate(T_true, poses):
    """Translation error of each pose (odometry starts at T_true[0])."""
    return [float(np.linalg.norm((T_true[0] @ p)[:3, 3] - T[:3, 3])) for p, T in zip(poses, T_true)]


@pytest.fixture(scope="module")
def runs():
    world = ring_world(0, 24000)
    T_true = ring_trajectory(N_SCANS, lap=100)
    scans = ring_scans(world, T_true, scan_n=SCAN_N, seed=1)

    jp = jodo.OdometryParams(map_capacity=MAP_CAPACITY)
    step_j = jax.jit(jodo.odometry_step, static_argnums=2)
    jframes = [jax.jit(jcovs)(jmake(s)) for s in scans]
    jstate = jodo.init_odometry(jframes[0], jp)
    jposes, jiters = [np.eye(4, dtype=np.float32)], []
    for f in jframes[1:]:
        jstate, T, diag = step_j(jstate, f, jp)
        jposes.append(np.asarray(T))
        jiters.append(int(diag["iterations"]))

    tp = todo.OdometryParams(map_capacity=MAP_CAPACITY)
    step_t = todo.make_odometry_stepper(tp, device="cpu")
    tframes = [tcovs(tmake(s, device="cpu")) for s in scans]
    tstate = todo.init_odometry(tframes[0], tp, device="cpu")
    tposes, titers, inserted = [np.eye(4, dtype=np.float32)], [], []
    for f in tframes[1:]:
        tstate, T, diag = step_t(tstate, f)
        tposes.append(T.numpy())
        titers.append(int(diag["iterations"]))
        inserted.append(diag["inserted"])
    return dict(T_true=T_true, jstate=jstate, jposes=jposes, jiters=jiters,
                tstate=tstate, tposes=tposes, titers=titers, inserted=inserted)


def test_odometry_poses_match_jax(runs):
    rot, trans = jse3.pose_error(jnp.asarray(np.stack(runs["jposes"])), jnp.asarray(np.stack(runs["tposes"])))
    print(f"max per-pose difference {float(jnp.max(trans)):.3e} m, {float(jnp.max(rot)):.3e} rad")
    assert float(jnp.max(trans)) < POSE_TOL_M, np.asarray(trans)
    assert float(jnp.max(rot)) < POSE_TOL_RAD, np.asarray(rot)
    assert all(np.isfinite(p).all() for p in runs["tposes"])


def test_odometry_iterations_and_map_match_jax(runs):
    assert len(runs["titers"]) == N_SCANS - 1
    assert max(abs(a - b) for a, b in zip(runs["titers"], runs["jiters"])) <= 1, (runs["titers"], runs["jiters"])
    assert all(runs["inserted"])  # 1.38 m per scan opens the keyframe gate every step
    jm, tm = runs["jstate"].vmap, runs["tstate"].vmap
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    assert int(tm.num_voxels) == int(jm.num_voxels) > 0
    assert int(runs["tstate"].num_frames) == int(runs["jstate"].num_frames) == N_SCANS


def test_odometry_ate_recorded(runs):
    """Both ATEs, side by side (measured on the CPU: about 0.13 m after 5
    steps for both; the ring corridor is weakly constrained along its axis)."""
    ate_j, ate_t = _ate(runs["T_true"], runs["jposes"]), _ate(runs["T_true"], runs["tposes"])
    print("ATE jax  ", np.round(ate_j, 4))
    print("ATE torch", np.round(ate_t, 4))
    assert max(abs(a - b) for a, b in zip(ate_j, ate_t)) < POSE_TOL_M
    assert max(ate_t) < 0.5


def test_odometry_register_and_cluster_path():
    """odometry_register returns the registration half; the cluster path runs
    (tests/test_torch_cluster.py holds it to JAX) and refuses clusters on
    another device than the state, in the step and in the stepper."""
    world = ring_world(0, 24000)
    T_true = ring_trajectory(2, lap=100)
    scans = ring_scans(world, T_true, scan_n=SCAN_N, seed=1)
    frames = [tcovs(tmake(s, device="cpu")) for s in scans]
    tp = todo.OdometryParams(map_capacity=MAP_CAPACITY)
    state = todo.init_odometry(frames[0], tp, device="cpu")
    prior = torch.from_numpy(np.linalg.inv(T_true[0]) @ T_true[1])
    T_new, T_delta, diag = todo.odometry_register(state, frames[1], tp, prior)
    assert np.linalg.norm(T_new[:3, 3].numpy() - prior[:3, 3].numpy()) < 0.1
    assert 1 <= int(diag["iterations"]) <= tp.max_iterations
    np.testing.assert_allclose(T_delta.numpy(), T_new.numpy(), atol=1e-6)  # T_world was identity
    clusters = cluster_source(frames[1], tp.voxel_resolution, 2048, device="cpu")
    state2, T, diag = todo.odometry_step(state, frames[1], tp, prior, clusters=clusters)
    assert np.linalg.norm(T[:3, 3].numpy() - prior[:3, 3].numpy()) < 0.1
    assert diag["inserted"] and int(state2.vmap.num_voxels) > int(state.vmap.num_voxels)
    elsewhere = SourceClusters(*(t.to("meta") for t in clusters))
    with pytest.raises(ValueError):
        todo.odometry_step(state, frames[1], tp, clusters=elsewhere)
    with pytest.raises(ValueError):
        todo.make_odometry_stepper(tp, device="cpu")(state, frames[1], clusters=elsewhere)


def test_stepper_signature_and_params():
    """The reference's signatures: `make_odometry_stepper(params, donate)`
    takes `donate` second (it does nothing here) and `device` only by
    keyword; `OdometryParams` has `full_insert_miss_fraction` with the
    reference's default."""
    assert todo.OdometryParams().full_insert_miss_fraction == jodo.OdometryParams().full_insert_miss_fraction == 0.05
    world = ring_world(0, 24000)
    T_true = ring_trajectory(3, lap=100)
    frames = [tcovs(tmake(s, device="cpu")) for s in ring_scans(world, T_true, scan_n=SCAN_N, seed=1)]
    tp = todo.OdometryParams(map_capacity=MAP_CAPACITY)

    def run(step):
        state = todo.init_odometry(frames[0], tp, device="cpu")
        poses = []
        for f in frames[1:]:
            state, T, diag = step(state, f)
            poses += [T, diag["error"], diag["iterations"]]
        return poses

    kept = run(todo.make_odometry_stepper(tp, False, device="cpu"))
    for a, b in zip(kept, run(todo.make_odometry_stepper(tp, device="cpu"))):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        todo.make_odometry_stepper(tp, True, "cpu")
