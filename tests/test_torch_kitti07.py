"""PyTorch port vs the JAX package: the slice as a whole, at a small size:
examples/kitti07_slam.py's protocol (chip_smoke.kitti07_protocol) on
  KITTI-format files of the simulated drive: 5 scans thinned to 4096 points,
  written as `points.bin` and `graph.txt` and read back through each
  package's `io`, preprocessed at small capacities (the port's points bit
  for bit with JAX's, its covariances within 1e-4 but at degenerate
  neighbourhoods), then, on JAX's frames in both packages, 4 odometry
  steps, FPFH + GNC and the 5-factor GICP graph: every odometry and final
  pose of the port within 1e-3 m and 1e-3 rad of the JAX package's, the
  iterations equal.
The endurance session at a small size, the offload pool's caller, is in
tests/test_torch_utils.py.
"""

import io as _io

import numpy as np
import torch

import chip_smoke
from gtsam_points_tpu_torch import interop
from test_torch_real_size import _pose_shift, jax_kitti07_api

torch.set_num_threads(1)
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3
SMALL_SCAN_N = 4096
# The two packages' kNN covariances part where a neighbourhood is
# degenerate: a far point with one or two neighbours, or a ring of
# collinear returns, has a repeated smallest eigenvalue, and each eigh3
# picks its own eigenvectors there (about 4% of these 4096-point scans).
# The rest of the protocol therefore runs on JAX's frames in both packages.
FEATURE_TOL = 1e-4
FEATURE_SHARE = 0.9


def test_kitti07_protocol_small_matches_jax(tmp_path):
    drive = chip_smoke.kitti07_drive(SMALL_SCAN_N)
    chip_smoke.write_kitti07(str(tmp_path), drive)
    out = _io.StringIO()
    sizes = dict(capacity=SMALL_SCAN_N, sample_capacity=SMALL_SCAN_N, out=out)
    j = chip_smoke.kitti07_protocol(jax_kitti07_api(), str(tmp_path), **sizes)

    # the port's own preprocess of the same files: the points bit for bit, the
    # normals and covariances within FEATURE_TOL but at degenerate neighbourhoods
    api = chip_smoke.port_kitti07_api(torch, "cpu")
    for i, jf in enumerate(j["frames"]):
        points = api["io"].read_points(str(tmp_path / f"{i:06d}" / "points.bin"))
        tf = api["preprocess"](api["make_frame"](points, SMALL_SCAN_N), SMALL_SCAN_N)
        assert tf.points.numpy().tobytes() == np.asarray(jf.points).tobytes()
        assert tf.mask.numpy().tobytes() == np.asarray(jf.mask).tobytes()
        cov_gap = np.abs(tf.covs.numpy() - np.asarray(jf.covs)).reshape(len(tf.mask), -1).max(1)
        agree = (cov_gap < FEATURE_TOL)[tf.mask.numpy()]
        assert agree.mean() > FEATURE_SHARE, agree.mean()

    # the rest of the protocol on JAX's frames, carried across bit for bit
    carried = iter([interop.frame_from_numpy(interop.frame_to_numpy(f), device="cpu") for f in j["frames"]])
    api["preprocess"] = lambda frame, capacity: next(carried)
    t = chip_smoke.kitti07_protocol(api, str(tmp_path), **sizes)
    assert next(carried, None) is None
    assert t["odo_iters"] == j["odo_iters"] and t["graph_iters"] == j["graph_iters"]
    for name in ("odom", "poses"):
        gap_m, gap_rad = _pose_shift(j[name], t[name])
        assert gap_m.max() < POSE_TOL_M and gap_rad.max() < POSE_TOL_RAD, (name, gap_m, gap_rad)
    assert np.abs(t["T_gt"] - j["T_gt"]).max() < 1e-6
    rot, trans = chip_smoke.kitti07_truth(t["T_gt"], t["poses"])
    assert rot < chip_smoke.KITTI_TRUTH_RAD and trans < chip_smoke.KITTI_TRUTH_M
    labels = [line.split(":")[0].strip() for line in out.getvalue().splitlines() if ":" in line]
    assert labels.count("preprocess (5 scans)") == 2 and list(t["segments"]) == list(j["segments"])
