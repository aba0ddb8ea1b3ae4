"""The point path at the real size on the CPU: the JAX package against the port.

The same configuration as chip_smoke.py's main path: a 400k-point ring world,
25k-point scans (`ring_scans(seed=1)`, `ring_trajectory(lap=100)`), the
default `OdometryParams()` (262144-voxel map, leaf 1.0 m, 10 LM iterations of
5 tries). Each package preprocesses the same numpy scans itself and runs its
own odometry_step from its own init_odometry, with or without the true
inter-frame motion as `T_pred_delta`.

As a test it runs the first three steps with the prior and holds every pose of
the port to the JAX pose. Run as a script for the full report, both prior
modes over as many steps as chip_smoke.py runs:

    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 24 --out report.json

It prints one line per run (per-pose gap, both ATEs, LM iterations) and
writes the whole report as JSON to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script from the root of a checkout
    sys.path.insert(0, ROOT)

import jax  # noqa: E402

from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs  # noqa: E402
from gtsam_points_tpu.pipelines import odometry as jodo  # noqa: E402
from gtsam_points_tpu.types.frame import make_frame as jmake  # noqa: E402
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world  # noqa: E402
from gtsam_points_tpu_torch.ops.features import estimate_normals_covs_moments as tcovs  # noqa: E402
from gtsam_points_tpu_torch.pipelines import odometry as todo  # noqa: E402
from gtsam_points_tpu_torch.types.frame import make_frame as tmake  # noqa: E402
from gtsam_points_tpu_torch.utils import se3 as tse3  # noqa: E402

WORLD_N = 400_000
SCAN_N = 25_000
TEST_STEPS = 3
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3


def _ate(T_true, poses):
    """Translation error of each pose (odometry starts at T_true[0])."""
    return [float(np.linalg.norm((T_true[0] @ p)[:3, 3] - T[:3, 3])) for p, T in zip(poses, T_true)]


def _jax_run(scans, priors):
    jp = jodo.OdometryParams()
    step = jax.jit(jodo.odometry_step, static_argnums=2)
    frames = [jax.jit(jcovs)(jmake(s)) for s in scans]
    state = jodo.init_odometry(frames[0], jp)
    poses, iters = [np.eye(4, dtype=np.float32)], []
    for f, prior in zip(frames[1:], priors):
        state, T, diag = step(state, f, jp, None if prior is None else jax.numpy.asarray(prior))
        poses.append(np.asarray(T))
        iters.append(int(diag["iterations"]))
    return poses, iters, np.asarray(state.vmap.keys), int(state.vmap.num_voxels)


def _torch_run(scans, priors):
    tp = todo.OdometryParams()
    step = todo.make_odometry_stepper(tp, device="cpu")
    frames = [tcovs(tmake(s, device="cpu")) for s in scans]
    state = todo.init_odometry(frames[0], tp, device="cpu")
    poses, iters = [np.eye(4, dtype=np.float32)], []
    for f, prior in zip(frames[1:], priors):
        state, T, diag = step(state, f, None if prior is None else torch.from_numpy(prior))
        poses.append(T.numpy())
        iters.append(int(diag["iterations"]))
    return poses, iters, state.vmap.keys.numpy(), int(state.vmap.num_voxels)


def compare(steps: int, with_prior: bool) -> dict:
    """Run both packages for `steps` steps -> per-pose gaps, ATEs, LM
    iterations, map sizes and seconds of each."""
    world = ring_world(0, WORLD_N)
    T_true = ring_trajectory(steps + 1, lap=100)
    scans = ring_scans(world, T_true, scan_n=SCAN_N, seed=1)
    priors = [
        (np.linalg.inv(a) @ b).astype(np.float32) if with_prior else None
        for a, b in zip(T_true[:-1], T_true[1:])
    ]
    t0 = time.perf_counter()
    jposes, jiters, jkeys, jvox = _jax_run(scans, priors)
    t1 = time.perf_counter()
    tposes, titers, tkeys, tvox = _torch_run(scans, priors)
    t2 = time.perf_counter()
    rot, trans = tse3.pose_error(torch.from_numpy(np.stack(jposes)), torch.from_numpy(np.stack(tposes)))
    return {
        "steps": steps,
        "prior": with_prior,
        "world_n": WORLD_N,
        "scan_n": SCAN_N,
        "gap_m": trans.tolist(),
        "gap_rad": rot.tolist(),
        "ate_jax_m": _ate(T_true, jposes),
        "ate_torch_m": _ate(T_true, tposes),
        "iters_jax": jiters,
        "iters_torch": titers,
        "voxels_jax": jvox,
        "voxels_torch": tvox,
        "map_keys_equal": bool(np.array_equal(jkeys, tkeys)),
        "seconds_jax": t1 - t0,
        "seconds_torch": t2 - t1,
    }


def summary(r: dict) -> str:
    aj, at = np.asarray(r["ate_jax_m"]), np.asarray(r["ate_torch_m"])
    return (
        f"steps {r['steps']} prior {r['prior']}: max per-pose gap {max(r['gap_m']):.6e} m "
        f"{max(r['gap_rad']):.6e} rad; ATE jax mean {aj.mean():.6f} max {aj.max():.6f} m, "
        f"port mean {at.mean():.6f} max {at.max():.6f} m; LM iterations jax {r['iters_jax']} "
        f"port {r['iters_torch']}; voxels {r['voxels_jax']} / {r['voxels_torch']}, "
        f"keys equal {r['map_keys_equal']}; {r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s"
    )


def test_real_size_first_steps_match_jax():
    torch.set_num_threads(1)
    r = compare(TEST_STEPS, with_prior=True)
    print(summary(r))
    assert max(r["gap_m"]) < POSE_TOL_M, r["gap_m"]
    assert max(r["gap_rad"]) < POSE_TOL_RAD, r["gap_rad"]
    assert max(abs(a - b) for a, b in zip(r["iters_jax"], r["iters_torch"])) <= 1
    assert r["map_keys_equal"] and r["voxels_jax"] == r["voxels_torch"] > 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=24)
    parser.add_argument("--out", help="write the report as JSON here")
    args = parser.parse_args()
    torch.set_num_threads(4)
    report = []
    for with_prior in (True, False):
        r = compare(args.steps, with_prior)
        print(summary(r), flush=True)
        report.append(r)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
