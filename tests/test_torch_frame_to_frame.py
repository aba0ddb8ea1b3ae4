"""PyTorch port vs the JAX package: GICP frame-to-frame odometry.

Six steps of `frame_to_frame_step` on a small ring world (2048-point
scans), each package with its own preprocessing, as the pipeline runs it:
`estimate_normals_covs(k=10, grid_leaf=1.0)` on every frame and
`build_hash_grid` (leaf 1.0) on the previous one. Each step is given the
true motion as its prediction `T_delta` (the ring corridor is nearly flat
along its length, so constant velocity from rest drifts in both packages).
Every step's delta and the chained world pose lie within 1e-3 m and 1e-3
rad of JAX's. The port runs on the CPU, where K3 takes its plain version.
"""

import jax
import numpy as np
import torch

from gtsam_points_tpu.ops.features import estimate_normals_covs as jfeatures
from gtsam_points_tpu.ops.hash_grid import build_hash_grid as jgrid
from gtsam_points_tpu.pipelines import odometry as jodo
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch.ops.features import estimate_normals_covs as tfeatures
from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid as tgrid
from gtsam_points_tpu_torch.pipelines import FrameToFrameState, frame_to_frame_step
from gtsam_points_tpu_torch.types.frame import make_frame as tmake
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
WORLD_N = 2200
SCAN_N = 2048
STEPS = 6
MAX_ITERATIONS = 10
TOL_M = 1e-3
TOL_RAD = 1e-3


def test_frame_to_frame_matches_jax():
    world = ring_world(0, WORLD_N)
    T_true = ring_trajectory(STEPS + 1, lap=100)
    scans = ring_scans(world, T_true, scan_n=SCAN_N, seed=1)
    motions = [(np.linalg.inv(a) @ b).astype(np.float32) for a, b in zip(T_true[:-1], T_true[1:])]

    prep = jax.jit(lambda f: jfeatures(f, k=10, grid_leaf=1.0))
    grid = jax.jit(lambda f: jgrid(f.points, f.mask, 1.0))
    jframes = [prep(jmake(s)) for s in scans]
    T_world = np.eye(4, dtype=np.float32)
    jdeltas, jworld = [], []
    for prev, frame, motion in zip(jframes[:-1], jframes[1:], motions):
        T_world, delta, _ = jodo.frame_to_frame_step(prev, grid(prev), T_world, motion, MAX_ITERATIONS, frame)
        jdeltas.append(np.asarray(delta))
        jworld.append(np.asarray(T_world))

    tframes = [tfeatures(tmake(s, device="cpu"), k=10, grid_leaf=1.0) for s in scans]
    state = FrameToFrameState(prev=tframes[0], prev_grid_points=tframes[0].points, T_world=torch.eye(4),
                              T_delta=torch.eye(4))
    tdeltas, tworld, errors = [], [], []
    for frame, motion in zip(tframes[1:], motions):
        prev_grid = tgrid(state.prev.points, state.prev.mask, 1.0)
        T_world, delta, error = frame_to_frame_step(state.prev, prev_grid, state.T_world, torch.from_numpy(motion),
                                                    MAX_ITERATIONS, frame)
        state = FrameToFrameState(prev=frame, prev_grid_points=frame.points, T_world=T_world, T_delta=delta)
        tdeltas.append(delta)
        tworld.append(T_world)
        errors.append(float(error))

    rot, trans = tse3.pose_error(torch.from_numpy(np.stack(jdeltas)), torch.stack(tdeltas))
    wrot, wtrans = tse3.pose_error(torch.from_numpy(np.stack(jworld)), torch.stack(tworld))
    truth = tse3.pose_error(torch.from_numpy(np.stack(T_true[1:])), torch.from_numpy(T_true[0]) @ torch.stack(tworld))[1]
    print(f"{STEPS} steps: delta gap max {trans.max():.3e} m {rot.max():.3e} rad, world gap max {wtrans.max():.3e} m; "
          f"ATE max {truth.max():.4f} m")
    assert float(trans.max()) < TOL_M and float(rot.max()) < TOL_RAD
    assert float(wtrans.max()) < TOL_M and float(wrot.max()) < TOL_RAD
    assert all(np.isfinite(errors)) and float(truth.max()) < 0.05
