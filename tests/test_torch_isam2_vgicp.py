"""PyTorch port vs the JAX package: the incremental back end on VGICP factors.

- `VGICPFactor.linearize` and `linearize_with_error_fn` (K3's plain version
  on fresh correspondences) against the JAX factor's, and against the port's
  own AD path (`residual_closure`), within 1e-4 x max|ref| a block;
- a VGICP stream on the 24000-point ring with 2048-point scans (six poses,
  window 3, a late loop closure to pose 0 after it froze): every update's
  estimates within 1e-3 m and 1e-3 rad, `num_compiles`, `compiled`, the
  window and the frozen keys equal, the snapshot within 1e-3.

The protocol helpers and the JAX program sharing are tests/test_torch_isam2.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors import make_vgicp_factor as jvgicp
from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import make_vgicp_factor
from gtsam_points_tpu_torch.factors.base import factor_poses
from gtsam_points_tpu_torch.factors.linearized import linearize_residuals
from test_torch_isam2 import (  # noqa: F401  (shared_jax_programs: the module's autouse fixture)
    JAX,
    PORT,
    SYSTEM_TOL,
    Pkg,
    _assert_snapshots,
    _assert_streams,
    _exp,
    _record,
    _rel,
    _t,
    shared_jax_programs,
)

torch.set_num_threads(1)
VGICP_TOL_M = 1e-3
VGICP_TOL_RAD = 1e-3
BLOCKS = ("H_tt", "H_ss", "H_ts", "b_t", "b_s", "error")
RING_WORLD_N = 24000
RING_SCAN_N = 2048
RING_POSES = 6


# -- the fault: VGICPFactor.linearize -----------------------------------------


@pytest.fixture(scope="module")
def ring():
    """RING_POSES scans of a RING_WORLD_N-point ring with covariances (the
    JAX package's, carried across), the truth."""
    T_true = ring_trajectory(RING_POSES, lap=100)
    scans = ring_scans(ring_world(0, RING_WORLD_N), T_true, scan_n=RING_SCAN_N, seed=1)
    jf = [jax.jit(jcovs)(jmake(s)) for s in scans]
    tf = [interop.frame_from_numpy({k: np.asarray(getattr(f, k)) for k in ("points", "mask", "covs")}, device="cpu")
          for f in jf]
    return {"T_true": np.stack(T_true), "jax": jf, "torch": tf}


def test_vgicp_linearize_matches_jax(ring):
    """The port's VGICPFactor.linearize and linearize_with_error_fn (K3's
    plain version on fresh correspondences) against the JAX factor's, and
    the port's AD path (residual_closure) against both."""
    T = ring["T_true"]
    poses = np.stack([T[0], T[1] @ _exp([0.01, -0.02, 0.015, 0.05, -0.04, 0.03])]).astype(np.float32)
    for target_key in (0, -1):
        kw = dict(voxel_resolution=1.0, min_voxel_points=4)
        jf = jvgicp(target_key, 1, ring["jax"][0], ring["jax"][1], fixed_target_pose=jnp.asarray(T[0]), **kw)
        tf = make_vgicp_factor(target_key, 1, ring["torch"][0], ring["torch"][1], fixed_target_pose=_t(T[0]), **kw)
        jl = jax.jit(jf.linearize)(poses)
        tl = tf.linearize(_t(poses))
        tl2, efn = tf.linearize_with_error_fn(_t(poses))
        T_t, T_s = factor_poses(tf, _t(poses))
        ad = linearize_residuals(tf.residual_closure(T_t, T_s), T_t, T_s)
        for name in BLOCKS:
            ref = getattr(jl, name)
            if target_key < 0 and name in ("H_tt", "H_ts", "b_t"):
                continue
            assert _rel(getattr(tl, name), ref) < SYSTEM_TOL, (target_key, name)
            assert torch.equal(getattr(tl2, name), getattr(tl, name)), name
            assert _rel(getattr(ad, name), ref) < SYSTEM_TOL, ("AD", target_key, name)
        assert int(tl.num_inliers) == int(jl.num_inliers) > 500
        moved = (poses @ _exp([0.0, 0.0, 0.01, 0.02, 0.0, 0.0])).astype(np.float32)
        jerr = jax.jit(lambda p, q: jf.linearize_with_error_fn(p)[1](q))(poses, moved)
        assert _rel(efn(_t(moved)), jerr) < SYSTEM_TOL
        assert _rel(efn(_t(poses)), tl.error) < SYSTEM_TOL


# -- the VGICP stream with a late loop -----------------------------------------------


def vgicp_stream(pkg: Pkg, frames, T_true):
    """The incremental_isam2_slam protocol on the ring: a prior on pose 0,
    then a VGICP factor (i-1, i) an update, inits estimate(i-1) @ the true
    motion @ se3_exp(uniform(-0.1, 0.1, 6)) from RandomState(42), window 3,
    30 LM iterations; then the loop (0, last) after pose 0 froze."""
    rng = np.random.RandomState(42)
    kw = dict(voxel_resolution=1.0, min_voxel_points=4)
    isam = pkg.ISAM2(window_size=3, lm_params=pkg.LM(max_iterations=30), **pkg.kw)
    out = [_record(isam, isam.update([pkg.Prior(prior=pkg.arr(T_true[0]), weights=pkg.arr(np.full(6, 1e6)), key=0)],
                                     {0: pkg.arr(T_true[0])}))]
    for i in range(1, len(frames)):
        init = isam.calculate_estimate_pose(i - 1) @ np.linalg.inv(T_true[i - 1]) @ T_true[i] @ _exp(
            rng.uniform(-0.1, 0.1, 6))
        out.append(_record(isam, isam.update([pkg.vgicp(i - 1, i, frames[i - 1], frames[i], **kw)],
                                             {i: pkg.arr(init)})))
    n = len(frames) - 1
    out.append(_record(isam, isam.update([pkg.vgicp(0, n, frames[0], frames[n], **kw)])))
    return out, isam


def test_isam2_vgicp_stream_matches_jax(ring):
    jr, jisam = vgicp_stream(JAX, ring["jax"], ring["T_true"])
    tr, tisam = vgicp_stream(PORT, ring["torch"], ring["T_true"])
    _assert_streams(jr, tr, VGICP_TOL_M, VGICP_TOL_RAD)
    _assert_snapshots(interop.isam2_to_numpy(jisam), interop.isam2_to_numpy(tisam), tol=1e-3)
    assert tr[-1]["loops"] == 1 and tr[-1]["frozen"] == [0, 1, 2]
    (baked, key), = tisam._baked_loops
    assert key == 0 and baked.target_key == -1 and baked.fixed_target_pose.device.type == "cpu"
    assert "_source_planar" not in vars(baked)
    np.testing.assert_array_equal(baked.fixed_target_pose.numpy(), tisam.frozen[0])
