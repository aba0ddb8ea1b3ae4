"""The real size on the CPU: the JAX package against the port.

Odometry: the same configuration as chip_smoke.py's odometry phase: a
400k-point ring world, 25k-point scans (`ring_scans(seed=1)`,
`ring_trajectory(lap=100)`), the default `OdometryParams()` (262144-voxel
map, leaf 1.0 m, 10 LM iterations of 5 tries). Each package preprocesses the
same numpy scans itself and runs its own odometry_step from its own
init_odometry, with or without the true inter-frame motion as
`T_pred_delta`. As a test it runs the first three steps with the prior and
holds every pose of the port to the JAX pose.

Pyramid: chip_smoke.py's pyramid phase. Scan 0 is the target, scan 1 the
source, moved back near it by the true relative pose; both carry
covariances from estimate_normals_covs_moments. Each package builds its own
DEFAULT_STAGES pyramid and registers the source from eight perturbed initial
poses, se3_exp(uniform(-0.1, 0.1, 6)) with RandomState(2); the JAX package
runs its XLA twin. As a test it runs the first init, holds the port's pose to
the JAX pose, and holds the JAX pose to the one chip_smoke.py keeps.

Run as a script for the full report: both odometry prior modes over as many
steps as chip_smoke.py runs, and the pyramid over all eight inits, whose JAX
poses it prints in the form chip_smoke.py keeps them:

    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 24 --out report.json

It prints one line per run (per-pose gap, errors against the truth) and
writes the whole report as JSON to --out.

Odometry order shift (`--odometry-orders K`): the JAX package alone runs
the odometry with the motion prior again with each scan's points in K other
orders, and reports the largest per-pose gap to its own run in the scans'
order, beside the port's gap to it: how far the order of the sums alone
moves the JAX trajectory. A script mode only; Tier-1 does not run it.

    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 24 --inits 0 --orders 0 --odometry-orders 4

Cluster path (`--cluster-inits N`, `--cluster-steps K`): chip_smoke.py's
cluster phases, on a 26k-point ring world whose 25k-point scans see nearly
all of it (3238 leaf-1.0 cells a scan). The cluster pyramid registers scan
1, moved back by the true relative pose and clustered at
DEFAULT_CLUSTER_LEAF into DEFAULT_CLUSTER_CAPACITY slots, against scan 0's
DEFAULT_CLUSTER_STAGES pyramid from N inits se3_exp(uniform(-0.1, 0.1, 6))
with RandomState(3); the cluster odometry runs K steps with
`OdometryParams()`, each scan clustered at the map's leaf and each step
given the true motion as its prior. Both packages run; the report prints
the JAX poses and the JAX cluster ATE (mean and max) in the form
chip_smoke.py keeps them:

    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0 --inits 0 --orders 0 --cluster-inits 64 --cluster-steps 24

With `--cluster-orders K` the JAX package alone runs the cluster pyramid
again with both scans' points in K other orders and prints each init's
largest pose shift as chip_smoke.py keeps it (CLUSTER_ORDER_SHIFT_M and
_RAD, the per-init bounds of its cluster pyramid phase):

    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0 --inits 0 --orders 0 --cluster-inits 64 --cluster-orders 8

As a test it registers from the first init that no order moves, holds the
port's pose to the JAX pose and the JAX pose to the one chip_smoke.py keeps.

Two-scan path (`--gicp-pairs N`, `--gicp-steps K`, `--gicp-orders M`):
chip_smoke.py's phases 21-22 on the cluster phases' scene, every scan with
kNN normals and covariances (k = 10, grid leaf 1.0). Pairs: PriorFactor
(eye, 1e6) and a binary GICP, ICP or ICP point-to-plane factor (max corr
2.0) from N starts T_rel @ se3_exp(uniform(-0.1, 0.1, 6)), RandomState(2),
through optimize_lm on two poses; steps: K GICP frame-to-frame steps with
constant velocity. Both packages run; the report prints the JAX poses 1,
the JAX deltas and the JAX ATE in the form chip_smoke.py keeps them, and
with M orders the JAX package alone reruns both with the scans' points in
M other orders and prints each init's and step's largest shift (the
per-pose bounds of phases 21-22):

    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0 --inits 0 --orders 0 --gicp-pairs 8 --gicp-steps 24 --gicp-orders 6

As a test it registers the first init with GICP, holds the port's pose to
the JAX pose and the JAX pose to the one chip_smoke.py keeps.

Slice 16 (`--kitti07`, `--endurance N`): chip_smoke.py's phases 37-38.
`--kitti07` runs examples/kitti07_slam.py's protocol
(chip_smoke.kitti07_protocol) on KITTI-format files of the simulated drive
at the example's size in both packages; `--endurance N` runs
tests/test_endurance_1000.py's session cut to N poses
(chip_smoke.endurance_protocol) in the JAX package, and with
`--endurance-port` in the port beside it. Each prints the JAX constants
chip_smoke.py keeps (KITTI_*, ENDURANCE_*), with `--kitti07-orders` and
`--endurance-orders` the JAX poses' shift over other point orders:

    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0 --inits 0 --orders 0 --kitti07 --kitti07-orders 3
    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0 --inits 0 --orders 0 --endurance 250 --endurance-orders 3 --endurance-port

Slice 17 (`--bspline`): chip_smoke.py's phase 39,
examples/demo_continuous_trajectory.py's protocol on
chip_smoke.continuous_drive() (238 s of poses at 10 Hz, knots 0.1 s apart,
the IMU at 100 Hz inside the span) in both packages. It prints the JAX
constants chip_smoke.py keeps (CONT_JAX_*) and the port's gaps on the CPU:

    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0 --inits 0 --orders 0 --bspline

Slice 18 (`--raycast`, `--jacobian`): chip_smoke.py's phases 40-41.
`--raycast` runs the voxel raycaster of both packages on phase 40's rays
(the 127639 rays of phase 37's first sweep, and the lattice rays) and
prints the digests chip_smoke.py keeps (RAYCAST_*); `--jacobian` runs the
JAX package's check_factor_jacobian on phase 41's demo GICP factor at the
truth pose, on frames with chip_smoke.plain_covariances, and the port's on
the CPU beside it, prints JACOBIAN_JAX, then, on each package's own kNN
features, where the two part and JAX's check at the truth, at the demo's
start and halfway between (about 1.5 min):

    JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0 --inits 0 --orders 0 --raycast --jacobian

As a test it runs the whole sweep through both packages, holds them bit
for bit and holds JAX's digests to the ones chip_smoke.py keeps.

Order shift: the port alone builds the target's pyramid from the same
points in other orders, so only the order of the moment sums changes, and
registers from the eight inits again. The largest pose shift (1.767e-3 m
over twelve orders) is more than chip_smoke.py's 1e-3 m bound: the reason
the card's map build sums each voxel in the CPU's order. As a test it runs
two orders.
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

if __name__ == "__main__":  # --parallel's meshes: tests/conftest.py's 8 virtual CPU devices
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from gtsam_points_tpu.factors import PriorFactor as JPrior  # noqa: E402
from gtsam_points_tpu.factors import make_gicp_factor as jgicp  # noqa: E402
from gtsam_points_tpu.factors import make_icp_factor as jicp  # noqa: E402
from gtsam_points_tpu.factors import make_vgicp_factor as jvgicp  # noqa: E402
from gtsam_points_tpu.factors import make_vgicp_factor_batch as jbatch  # noqa: E402
from gtsam_points_tpu.ops.downsample import voxelgrid_sampling as jvoxelgrid  # noqa: E402
from gtsam_points_tpu.ops.features import estimate_normals_covs as jfeatures  # noqa: E402
from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs  # noqa: E402
from gtsam_points_tpu.ops.hash_grid import build_hash_grid as jgrid  # noqa: E402
from gtsam_points_tpu.optim import FactorGraph as JGraph  # noqa: E402
from gtsam_points_tpu.optim import LMParams as JLMParams  # noqa: E402
from gtsam_points_tpu.optim import optimize_dogleg as jdogleg  # noqa: E402
from gtsam_points_tpu.optim import optimize_gn as jgn  # noqa: E402
from gtsam_points_tpu.optim import optimize_lm as jlm  # noqa: E402
from gtsam_points_tpu.optim import sparse as jsparse  # noqa: E402
from gtsam_points_tpu.optim.dogleg import DoglegParams as JDoglegParams  # noqa: E402
from gtsam_points_tpu.ops.voxelmap import build_voxelmap as jbuild  # noqa: E402
from gtsam_points_tpu.pipelines import odometry as jodo  # noqa: E402
from gtsam_points_tpu.registration import cluster as jcl  # noqa: E402
from gtsam_points_tpu.registration import pyramid as jpyr  # noqa: E402
from gtsam_points_tpu.types.frame import make_frame as jmake  # noqa: E402
from gtsam_points_tpu.types.frame import transform_frame as jtransform  # noqa: E402
from gtsam_points_tpu.utils import se3 as jse3  # noqa: E402
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world  # noqa: E402
from gtsam_points_tpu_torch.factors import PriorFactor as TPrior  # noqa: E402
from gtsam_points_tpu_torch.factors import make_gicp_factor as tgicp  # noqa: E402
from gtsam_points_tpu_torch.factors import make_icp_factor as ticp  # noqa: E402
from gtsam_points_tpu_torch.factors import make_vgicp_factor as tvgicp  # noqa: E402
from gtsam_points_tpu_torch.factors import make_vgicp_factor_batch as tbatch  # noqa: E402
from gtsam_points_tpu_torch import interop  # noqa: E402
from gtsam_points_tpu_torch.ops.downsample import voxelgrid_sampling as tvoxelgrid  # noqa: E402
from gtsam_points_tpu_torch.ops.voxelmap import build_voxelmap as tbuild  # noqa: E402
from gtsam_points_tpu_torch.ops.features import estimate_normals_covs as tfeatures  # noqa: E402
from gtsam_points_tpu_torch.ops.features import estimate_normals_covs_moments as tcovs  # noqa: E402
from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid as tgrid  # noqa: E402
from gtsam_points_tpu_torch.optim import FactorGraph as TGraph  # noqa: E402
from gtsam_points_tpu_torch.optim import LMParams as TLMParams  # noqa: E402
from gtsam_points_tpu_torch.optim import DoglegParams as TDoglegParams  # noqa: E402
from gtsam_points_tpu_torch.optim import optimize_dogleg as tdogleg  # noqa: E402
from gtsam_points_tpu_torch.optim import optimize_gn as tgn  # noqa: E402
from gtsam_points_tpu_torch.optim import optimize_lm as tlm  # noqa: E402
from gtsam_points_tpu_torch.optim import optimize_pose_graph as tpose_graph  # noqa: E402
from gtsam_points_tpu_torch.pipelines import odometry as todo  # noqa: E402
from gtsam_points_tpu_torch.registration import cluster as tcl  # noqa: E402
from gtsam_points_tpu_torch.registration import pyramid as tpyr  # noqa: E402
from gtsam_points_tpu_torch.types.frame import make_frame as tmake  # noqa: E402
from gtsam_points_tpu_torch.types.frame import transform_frame as ttransform  # noqa: E402
from gtsam_points_tpu_torch.utils import se3 as tse3  # noqa: E402

import chip_smoke  # noqa: E402  (the JAX poses it holds the card to)

WORLD_N = 400_000
SCAN_N = 25_000
TEST_STEPS = 3
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3
PYRAMID_INITS = 8
PYRAMID_TEST_INITS = 1
ORDERS = 12
ORDER_TEST_ORDERS = 2
# the JAX pose of this run against the one chip_smoke.py keeps: XLA on
# another CPU may round differently, far below the card's bound
KEPT_POSE_TOL = 1e-4
# the order shift's bound: the bound the card-built pyramid was held to
# while the card's map build summed in no fixed order
ORDER_SHIFT_BOUND_M = 5e-3
# an init whose JAX pose the order of the sums moves by less than this
# (chip_smoke.CLUSTER_ORDER_SHIFT_M) is stable: the test registers from one
STABLE_SHIFT_M = 1e-4


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


def odometry_order_shift(steps: int, n_orders: int) -> dict:
    """The JAX package alone, with the motion prior, over `steps` steps: each
    scan's points in `n_orders` other orders (one RandomState(200 + i)
    permutation per scan) against the scans' own order -> per order the
    per-pose gaps, LM iterations and whether the final map keys are equal."""
    world = ring_world(0, WORLD_N)
    T_true = ring_trajectory(steps + 1, lap=100)
    scans = ring_scans(world, T_true, scan_n=SCAN_N, seed=1)
    priors = [(np.linalg.inv(a) @ b).astype(np.float32) for a, b in zip(T_true[:-1], T_true[1:])]
    poses, iters, keys, _ = _jax_run(scans, priors)
    r = {"steps": steps, "orders": n_orders, "iters": iters, "gap_m": [], "gap_rad": [],
         "order_iters": [], "map_keys_equal": []}
    for i in range(n_orders):
        rng = np.random.RandomState(200 + i)
        permuted = [s[rng.permutation(len(s))] for s in scans]
        oposes, oiters, okeys, _ = _jax_run(permuted, priors)
        rot, trans = tse3.pose_error(torch.from_numpy(np.stack(poses)), torch.from_numpy(np.stack(oposes)))
        r["gap_m"].append(trans.tolist())
        r["gap_rad"].append(rot.tolist())
        r["order_iters"].append(oiters)
        r["map_keys_equal"].append(bool(np.array_equal(keys, okeys)))
    return r


def odometry_order_summary(r: dict) -> str:
    per_order = ", ".join(f"{max(g):.6e}" for g in r["gap_m"])
    worst = max(range(r["orders"]), key=lambda i: max(r["gap_m"][i]))
    return (
        f"odometry, JAX against JAX with each scan in {r['orders']} other orders, {r['steps']} steps: "
        f"largest per-pose gap per order (m) {per_order}; max {max(map(max, r['gap_m'])):.6e} m "
        f"{max(map(max, r['gap_rad'])):.6e} rad; worst order's gap per step (m) "
        + ", ".join(f"{x:.3e}" for x in r["gap_m"][worst])
        + f"; LM iterations {r['iters']}, per order {r['order_iters']}; final map keys equal {r['map_keys_equal']}"
    )


def summary(r: dict) -> str:
    aj, at = np.asarray(r["ate_jax_m"]), np.asarray(r["ate_torch_m"])
    return (
        f"steps {r['steps']} prior {r['prior']}: max per-pose gap {max(r['gap_m']):.6e} m "
        f"{max(r['gap_rad']):.6e} rad; ATE jax mean {aj.mean():.6f} max {aj.max():.6f} m, "
        f"port mean {at.mean():.6f} max {at.max():.6f} m; LM iterations jax {r['iters_jax']} "
        f"port {r['iters_torch']}; voxels {r['voxels_jax']} / {r['voxels_torch']}, "
        f"keys equal {r['map_keys_equal']}; {r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s"
    )


def pyramid_inputs(n_inits: int):
    """-> (target scan, source scan, true relative pose, [n_inits, 6] xis)."""
    world = ring_world(0, WORLD_N)
    T_true = ring_trajectory(2, lap=100)
    scans = ring_scans(world, T_true, scan_n=SCAN_N, seed=1)
    T_rel = (np.linalg.inv(T_true[0]) @ T_true[1]).astype(np.float32)
    xis = np.random.RandomState(2).uniform(-0.1, 0.1, (PYRAMID_INITS, 6)).astype(np.float32)
    return scans[0], scans[1], T_rel, xis[:n_inits]


def _jax_pyramid(tgt, src, T_rel, xis):
    target = jax.jit(jcovs)(jmake(tgt))
    source = jtransform(jax.numpy.asarray(T_rel), jax.jit(jcovs)(jmake(src)))
    maps = jax.jit(jpyr.build_pyramid)(target)
    reg = jax.jit(lambda maps, source, T0: jpyr.register_scan_pyramid(maps, source, T0))
    return [np.asarray(reg(maps, source, jse3.se3_exp(jax.numpy.asarray(xi)))) for xi in xis]


def _torch_pyramid(tgt, src, T_rel, xis):
    target = tcovs(tmake(tgt, device="cpu"))
    source = ttransform(torch.from_numpy(T_rel), tcovs(tmake(src, device="cpu")))
    maps = tpyr.build_pyramid(target, device="cpu")
    T0s = tse3.se3_exp(torch.from_numpy(xis))
    return [tpyr.register_scan_pyramid(maps, source, T0, device="cpu").numpy() for T0 in T0s]


def compare_pyramid(n_inits: int) -> dict:
    """Register with both packages from the first `n_inits` inits -> per-pose
    gaps, errors against the truth (identity), the JAX poses, seconds."""
    tgt, src, T_rel, xis = pyramid_inputs(n_inits)
    t0 = time.perf_counter()
    jposes = _jax_pyramid(tgt, src, T_rel, xis)
    t1 = time.perf_counter()
    tposes = _torch_pyramid(tgt, src, T_rel, xis)
    t2 = time.perf_counter()
    jp, tp = torch.from_numpy(np.stack(jposes)), torch.from_numpy(np.stack(tposes))
    rot, trans = tse3.pose_error(jp, tp)
    eye = torch.eye(4).expand(len(xis), 4, 4)
    jrot, jtrans = tse3.pose_error(eye, jp)
    trot, ttrans = tse3.pose_error(eye, tp)
    return {
        "inits": n_inits,
        "gap_m": trans.tolist(),
        "gap_rad": rot.tolist(),
        "truth_jax_m": jtrans.tolist(),
        "truth_jax_rad": jrot.tolist(),
        "truth_torch_m": ttrans.tolist(),
        "truth_torch_rad": trot.tolist(),
        "jax_poses": _pose_rows(jposes),
        "seconds_jax": t1 - t0,
        "seconds_torch": t2 - t1,
    }


def pyramid_summary(r: dict) -> str:
    return (
        f"pyramid, {r['inits']} inits: max per-pose gap {max(r['gap_m']):.6e} m {max(r['gap_rad']):.6e} rad; "
        f"error against the truth jax max {max(r['truth_jax_m']):.6f} m {max(r['truth_jax_rad']):.6f} rad, "
        f"port max {max(r['truth_torch_m']):.6f} m {max(r['truth_torch_rad']):.6f} rad; "
        f"{r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s"
    )


def kept_pose_error(r: dict):
    """Largest (translation, rotation) gap between this run's JAX poses and
    the ones chip_smoke.py keeps."""
    return _kept_gap(chip_smoke.PYRAMID_JAX_POSES[: r["inits"]], r["jax_poses"])


def _pose_rows(poses) -> list:
    return [np.asarray(p)[:3].reshape(12).tolist() for p in poses]


def _print_kept(name: str, rows: list) -> None:
    print(f"JAX poses (top three rows, row-major), as chip_smoke.{name}:")
    for p in rows:
        print("    [" + ", ".join(np.format_float_positional(np.float32(x), unique=True) for x in p) + "],")


def _kept_gap(kept_rows, rows):
    """Largest (translation, rotation) gap between two lists of top-three-row poses."""
    kept = np.asarray(kept_rows, np.float32).reshape(-1, 3, 4)
    new = np.asarray(rows, np.float32).reshape(-1, 3, 4)
    bottom = np.broadcast_to(np.asarray([0, 0, 0, 1], np.float32), (len(kept), 1, 4))
    rot, trans = tse3.pose_error(
        torch.from_numpy(np.concatenate([kept, bottom], 1)), torch.from_numpy(np.concatenate([new, bottom], 1))
    )
    return float(trans.max()), float(rot.max())


def cluster_scans(n_poses: int):
    """chip_smoke.py's cluster scene -> (true poses, scans)."""
    world = ring_world(0, chip_smoke.CLUSTER_WORLD_N)
    T_true = ring_trajectory(n_poses, lap=100)
    return T_true, ring_scans(world, T_true, scan_n=SCAN_N, seed=1)


def _jax_cluster_pyramid(tgt, src, T_rel, xis):
    """The JAX cluster pyramid from each init -> (poses, source frame, clusters)."""
    target = jax.jit(jcovs)(jmake(tgt))
    source = jtransform(jax.numpy.asarray(T_rel), jax.jit(jcovs)(jmake(src)))
    maps = jax.jit(lambda f: jpyr.build_pyramid(f, jcl.DEFAULT_CLUSTER_STAGES))(target)
    jc = jax.jit(jcl.cluster_source, static_argnums=(1, 2))(
        source, jcl.DEFAULT_CLUSTER_LEAF, jcl.DEFAULT_CLUSTER_CAPACITY)
    reg = jax.jit(lambda maps, cl, T0: jcl.register_clusters_pyramid(maps, cl, T0))
    return [np.asarray(reg(maps, jc, jse3.se3_exp(jax.numpy.asarray(xi)))) for xi in xis], source, jc


def _cluster_pyramid_inputs(inits):
    """-> (target scan, source scan, true relative pose, [len(inits), 6] xis)
    for the inits of these indices."""
    T_true, scans = cluster_scans(2)
    T_rel = (np.linalg.inv(T_true[0]) @ T_true[1]).astype(np.float32)
    xis = np.random.RandomState(chip_smoke.CLUSTER_SEED).uniform(
        -0.1, 0.1, (chip_smoke.CLUSTER_INITS, 6)).astype(np.float32)[list(inits)]
    return scans[0], scans[1], T_rel, xis


def compare_cluster_pyramid(inits) -> dict:
    """The cluster pyramid in both packages from the inits of these indices
    -> per-pose gaps, errors against the truth (identity), the JAX poses,
    the occupied and dropped cells, seconds."""
    tgt, src, T_rel, xis = _cluster_pyramid_inputs(inits)
    leaf, cap = jcl.DEFAULT_CLUSTER_LEAF, jcl.DEFAULT_CLUSTER_CAPACITY

    t0 = time.perf_counter()
    jposes, source, jc = _jax_cluster_pyramid(tgt, src, T_rel, xis)
    t1 = time.perf_counter()
    ttarget = tcovs(tmake(tgt, device="cpu"))
    tsource = ttransform(torch.from_numpy(T_rel), tcovs(tmake(src, device="cpu")))
    tmaps = tpyr.build_pyramid(ttarget, tcl.DEFAULT_CLUSTER_STAGES, device="cpu")
    tc = tcl.cluster_source(tsource, leaf, cap, device="cpu")
    tposes = [tcl.register_clusters_pyramid(tmaps, tc, T0, device="cpu").numpy()
              for T0 in tse3.se3_exp(torch.from_numpy(xis))]
    t2 = time.perf_counter()

    jp, tp = torch.from_numpy(np.stack(jposes)), torch.from_numpy(np.stack(tposes))
    rot, trans = tse3.pose_error(jp, tp)
    eye = torch.eye(4).expand(len(xis), 4, 4)
    jrot, jtrans = tse3.pose_error(eye, jp)
    trot, ttrans = tse3.pose_error(eye, tp)
    # every point of the source is in a cluster unless a cell was dropped
    dropped = int(np.asarray(source.mask).sum()) - int(np.asarray(jc.weight).sum())
    return {
        "inits": list(inits),
        "cells": int(np.asarray(jc.mask).sum()),
        "capacity": cap,
        "dropped_points": dropped,
        "gap_m": trans.tolist(),
        "gap_rad": rot.tolist(),
        "truth_jax_m": jtrans.tolist(),
        "truth_jax_rad": jrot.tolist(),
        "truth_torch_m": ttrans.tolist(),
        "truth_torch_rad": trot.tolist(),
        "jax_poses": _pose_rows(jposes),
        "seconds_jax": t1 - t0,
        "seconds_torch": t2 - t1,
    }


def cluster_order_shift(n_inits: int, n_orders: int) -> dict:
    """The JAX package alone: the cluster pyramid again with both scans'
    points in `n_orders` other orders (RandomState(300 + i) permutations,
    so every cell and every covariance is summed in another order) against
    the scans' own order -> per order the shift of each init's pose."""
    tgt, src, T_rel, xis = _cluster_pyramid_inputs(range(n_inits))
    base = torch.from_numpy(np.stack(_jax_cluster_pyramid(tgt, src, T_rel, xis)[0]))
    truth = tse3.pose_error(torch.eye(4).expand(len(xis), 4, 4), base)[1]
    r = {"inits": n_inits, "orders": n_orders, "truth_m": truth.tolist(), "shift_m": [], "shift_rad": []}
    for i in range(n_orders):
        rng = np.random.RandomState(300 + i)
        other = _jax_cluster_pyramid(tgt[rng.permutation(len(tgt))], src[rng.permutation(len(src))], T_rel, xis)[0]
        rot, trans = tse3.pose_error(base, torch.from_numpy(np.stack(other)))
        r["shift_m"].append(trans.tolist())
        r["shift_rad"].append(rot.tolist())
    return r


def cluster_order_summary(r: dict) -> str:
    shift = np.asarray(r["shift_m"])
    worst = shift.max(0)
    order = np.argsort(-worst)[:5]
    stable = [int(i) for i in np.nonzero(worst < STABLE_SHIFT_M)[0]]
    return (
        f"cluster pyramid, JAX against JAX with both scans in {r['orders']} other orders, {r['inits']} inits: "
        f"largest shift per order (m) " + ", ".join(f"{x:.6e}" for x in shift.max(1))
        + f"; max {shift.max():.6e} m {np.max(r['shift_rad']):.6e} rad; inits over 1e-3 m in any order "
        f"{int((worst > 1e-3).sum())}; the five most moved (init, shift m, its JAX pose's error against the "
        f"truth m): " + ", ".join(f"({i}, {worst[i]:.3e}, {r['truth_m'][i]:.4f})" for i in order)
        + f"; the {len(stable)} inits moved less than {STABLE_SHIFT_M} m in every order (at most "
        f"{worst[stable].max():.3e} m): {stable}"
    )


def _print_shifts(r: dict) -> None:
    """Each init's largest shift over the orders, as chip_smoke.py keeps them."""
    for unit in ("m", "rad"):
        worst = np.asarray(r[f"shift_{unit}"]).max(0)
        print(f"CLUSTER_ORDER_SHIFT_{unit.upper()} = [" + ", ".join(f"{x:.3e}" for x in worst) + "]", flush=True)


def cluster_pyramid_summary(r: dict) -> str:
    return (
        f"cluster pyramid, {len(r['inits'])} inits, {r['cells']} of {r['capacity']} cluster slots occupied, "
        f"{r['dropped_points']} points in dropped cells: max per-pose gap {max(r['gap_m']):.6e} m "
        f"{max(r['gap_rad']):.6e} rad; error against the truth jax max {max(r['truth_jax_m']):.6f} m "
        f"{max(r['truth_jax_rad']):.6f} rad, port max {max(r['truth_torch_m']):.6f} m "
        f"{max(r['truth_torch_rad']):.6f} rad; {r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s"
    )


def compare_cluster_odometry(steps: int) -> dict:
    """Cluster odometry in both packages over `steps` steps with the motion
    prior -> per-pose gaps, ATEs, LM iterations, map sizes, seconds."""
    T_true, scans = cluster_scans(steps + 1)
    priors = [(np.linalg.inv(a) @ b).astype(np.float32) for a, b in zip(T_true[:-1], T_true[1:])]
    cap = jcl.DEFAULT_CLUSTER_CAPACITY

    t0 = time.perf_counter()
    jp = jodo.OdometryParams()
    step = jax.jit(jodo.odometry_step, static_argnums=2)
    clus = jax.jit(jcl.cluster_source, static_argnums=(1, 2))
    frames = [jax.jit(jcovs)(jmake(s)) for s in scans]
    state = jodo.init_odometry(frames[0], jp)
    jposes, jiters = [np.eye(4, dtype=np.float32)], []
    for f, prior in zip(frames[1:], priors):
        state, T, diag = step(state, f, jp, jax.numpy.asarray(prior), clus(f, jp.voxel_resolution, cap))
        jposes.append(np.asarray(T))
        jiters.append(int(diag["iterations"]))
    jvox = int(state.vmap.num_voxels)
    t1 = time.perf_counter()
    tp = todo.OdometryParams()
    tstep = todo.make_odometry_stepper(tp, device="cpu")
    tframes = [tcovs(tmake(s, device="cpu")) for s in scans]
    tstate = todo.init_odometry(tframes[0], tp, device="cpu")
    tposes, titers = [np.eye(4, dtype=np.float32)], []
    for f, prior in zip(tframes[1:], priors):
        cl = tcl.cluster_source(f, tp.voxel_resolution, cap, device="cpu")
        tstate, T, diag = tstep(tstate, f, torch.from_numpy(prior), cl)
        tposes.append(T.numpy())
        titers.append(int(diag["iterations"]))
    t2 = time.perf_counter()
    rot, trans = tse3.pose_error(torch.from_numpy(np.stack(jposes)), torch.from_numpy(np.stack(tposes)))
    return {
        "steps": steps,
        "gap_m": trans.tolist(),
        "gap_rad": rot.tolist(),
        "ate_jax_m": _ate(T_true, jposes),
        "ate_torch_m": _ate(T_true, tposes),
        "iters_jax": jiters,
        "iters_torch": titers,
        "voxels_jax": jvox,
        "voxels_torch": int(tstate.vmap.num_voxels),
        "seconds_jax": t1 - t0,
        "seconds_torch": t2 - t1,
    }


def cluster_odometry_summary(r: dict) -> str:
    aj, at = np.asarray(r["ate_jax_m"]), np.asarray(r["ate_torch_m"])
    return (
        f"cluster odometry, {r['steps']} steps with the prior: max per-pose gap {max(r['gap_m']):.6e} m "
        f"{max(r['gap_rad']):.6e} rad; ATE jax mean {aj.mean():.6f} max {aj.max():.6f} m (as "
        f"chip_smoke.CLUSTER_ATE_JAX_MEAN_M, CLUSTER_ATE_JAX_MAX_M), port mean {at.mean():.6f} "
        f"max {at.max():.6f} m; LM iterations jax {r['iters_jax']} port {r['iters_torch']}; voxels "
        f"{r['voxels_jax']} / {r['voxels_torch']}; {r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s"
    )


def _gicp_frames(scans, package: str):
    """Each scan with kNN normals and covariances, as the two-scan path and
    the frame-to-frame step preprocess it."""
    if package == "jax":
        prep = jax.jit(lambda f: jfeatures(f, k=10, grid_leaf=1.0))
        return [prep(jmake(s)) for s in scans]
    return [tfeatures(tmake(s, device="cpu"), k=10, grid_leaf=1.0) for s in scans]


def _pair_graph(package: str, kind: str, target, source):
    """PriorFactor(eye, GICP_PRIOR_WEIGHT, key=0) + the binary factor 0 -> 1."""
    if package == "jax":
        make, prior, graph = (jgicp if kind == "gicp" else jicp), JPrior, JGraph(num_poses=2)
        eye, w = jax.numpy.eye(4), jax.numpy.full((6,), chip_smoke.GICP_PRIOR_WEIGHT)
    else:
        make, prior, graph = (tgicp if kind == "gicp" else ticp), TPrior, TGraph(num_poses=2)
        eye, w = torch.eye(4), torch.full((6,), chip_smoke.GICP_PRIOR_WEIGHT)
    kw = {} if kind == "gicp" else {"point_to_plane": kind == "icp_plane"}
    graph.add(prior(prior=eye, weights=w, key=0))
    graph.add(make(0, 1, target, source, max_corr_dist=chip_smoke.GICP_MAX_CORR, **kw))
    return graph


def gicp_pair_inputs(inits):
    """chip_smoke.py's two-scan scene -> (scans 0 and 1, true relative pose,
    the start poses [len(inits), 2, 4, 4] of these init indices)."""
    T_true, scans = cluster_scans(2)
    T_rel = (np.linalg.inv(T_true[0]) @ T_true[1]).astype(np.float32)
    xis = np.random.RandomState(chip_smoke.GICP_SEED).uniform(
        -0.1, 0.1, (chip_smoke.GICP_INITS, 6)).astype(np.float32)[list(inits)]
    P0 = np.stack([np.stack([np.eye(4, dtype=np.float32), T_rel @ tse3.se3_exp(torch.from_numpy(xi)).numpy()])
                   for xi in xis])
    return scans, T_rel, P0


def _pair_poses(package: str, scans, P0, kinds=chip_smoke.GICP_KINDS) -> dict:
    """kind -> the registered pose 1 [len(P0), 4, 4] and the LM iterations."""
    target, source = _gicp_frames(scans, package)
    out = {}
    for kind in kinds:
        graph = _pair_graph(package, kind, target, source)
        if package == "jax":
            run = jax.jit(lambda p, g=graph: jlm(g, p))
            res = [run(p) for p in P0]
            out[kind] = (np.stack([np.asarray(r.poses[1]) for r in res]), [int(r.status.num_iterations) for r in res])
        else:
            res = [tlm(graph, torch.from_numpy(p)) for p in P0]
            out[kind] = (np.stack([r.poses[1].numpy() for r in res]), [int(r.status.num_iterations) for r in res])
    return out


def compare_gicp_pairs(inits, kinds=chip_smoke.GICP_KINDS) -> dict:
    """The two-scan registration in both packages from the inits of these
    indices, each factor kind -> per-pose gaps of pose 1, errors against
    the truth, iterations, the JAX poses, seconds."""
    scans, T_rel, P0 = gicp_pair_inputs(inits)
    t0 = time.perf_counter()
    j = _pair_poses("jax", scans, P0, kinds)
    t1 = time.perf_counter()
    t = _pair_poses("torch", scans, P0, kinds)
    t2 = time.perf_counter()
    truth = torch.from_numpy(T_rel).expand(len(P0), 4, 4)
    r = {"inits": list(inits), "seconds_jax": t1 - t0, "seconds_torch": t2 - t1}
    for kind in kinds:
        rot, trans = tse3.pose_error(torch.from_numpy(j[kind][0]), torch.from_numpy(t[kind][0]))
        jrot, jtrans = tse3.pose_error(truth, torch.from_numpy(j[kind][0]))
        r[kind] = {"gap_m": trans.tolist(), "gap_rad": rot.tolist(), "truth_jax_m": jtrans.tolist(),
                   "truth_jax_rad": jrot.tolist(), "iters_jax": j[kind][1], "iters_torch": t[kind][1],
                   "jax_poses": _pose_rows(j[kind][0])}
    return r


def gicp_pair_summary(r: dict) -> str:
    return "; ".join(
        f"{kind} pairs, {len(r['inits'])} inits: max gap {max(r[kind]['gap_m']):.6e} m "
        f"{max(r[kind]['gap_rad']):.6e} rad, jax against the truth max {max(r[kind]['truth_jax_m']):.6f} m "
        f"{max(r[kind]['truth_jax_rad']):.6f} rad, iterations jax {r[kind]['iters_jax']} port {r[kind]['iters_torch']}"
        for kind in chip_smoke.GICP_KINDS if kind in r
    ) + f"; {r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s"


def gicp_pair_order_shift(n_inits: int, n_orders: int) -> dict:
    """The JAX package alone: the two-scan registration again with both
    scans' points in `n_orders` other orders (RandomState(400 + i)
    permutations: other kNN candidates survive a full cell, the sums run in
    another order) -> per kind the shift of each init's pose 1, per order."""
    scans, _, P0 = gicp_pair_inputs(range(n_inits))
    base = _pair_poses("jax", scans, P0)
    r = {"inits": n_inits, "orders": n_orders}
    for kind in chip_smoke.GICP_KINDS:
        r[kind] = {"shift_m": [], "shift_rad": []}
    for i in range(n_orders):
        rng = np.random.RandomState(400 + i)
        other = _pair_poses("jax", [s[rng.permutation(len(s))] for s in scans], P0)
        for kind in chip_smoke.GICP_KINDS:
            rot, trans = tse3.pose_error(torch.from_numpy(base[kind][0]), torch.from_numpy(other[kind][0]))
            r[kind]["shift_m"].append(trans.tolist())
            r[kind]["shift_rad"].append(rot.tolist())
    return r


def _print_gicp_shifts(r: dict, name: str, kinds) -> None:
    """Each init's (or step's) largest shift over the orders, as chip_smoke.py
    keeps them: a dict by factor kind, or for the steps one list."""
    for unit in ("m", "rad"):
        worst = {kind: ", ".join(f"{x:.3e}" for x in np.asarray(r[kind][f"shift_{unit}"]).max(0)) for kind in kinds}
        if kinds in (["steps"], ["pose_graph"]):
            print(f"{name}_{unit.upper()} = [{worst[kinds[0]]}]", flush=True)
            continue
        print(f"{name}_{unit.upper()} = {{", flush=True)
        for kind in kinds:
            print(f'    "{kind}": [{worst[kind]}],', flush=True)
        print("}", flush=True)


def gicp_order_summary(r: dict, kinds) -> str:
    return "; ".join(
        f"{kind}, JAX against JAX in {r['orders']} other orders: max shift {np.max(r[kind]['shift_m']):.6e} m "
        f"{np.max(r[kind]['shift_rad']):.6e} rad, entries over 5e-4 m {int((np.asarray(r[kind]['shift_m']).max(0) > 5e-4).sum())}"
        for kind in kinds
    )


def _frame_to_frame(package: str, scans, motions):
    """GICP frame-to-frame odometry over the scans: each step's prediction is
    its entry of `motions`, or with `motions` None the previous step's delta
    (constant velocity from rest) -> (deltas, world poses)."""
    frames = _gicp_frames(scans, package)
    if package == "jax":
        grid = jax.jit(lambda f: jgrid(f.points, f.mask, 1.0))
        T_world, T_delta = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
        step = jodo.frame_to_frame_step
    else:
        grid = lambda f: tgrid(f.points, f.mask, 1.0)  # noqa: E731
        T_world, T_delta = torch.eye(4), torch.eye(4)
        step = todo.frame_to_frame_step
    deltas, world = [], [np.eye(4, dtype=np.float32)]
    for i, (prev, frame) in enumerate(zip(frames[:-1], frames[1:])):
        pred = T_delta if motions is None else (motions[i] if package == "jax" else torch.from_numpy(motions[i]))
        T_world, T_delta, _ = step(prev, grid(prev), T_world, pred, chip_smoke.GICP_STEP_ITERATIONS, frame)
        deltas.append(np.asarray(T_delta))
        world.append(np.asarray(T_world))
    return np.stack(deltas), world


def gicp_step_inputs(steps: int):
    T_true, scans = cluster_scans(steps + 1)
    motions = [(np.linalg.inv(a) @ b).astype(np.float32) for a, b in zip(T_true[:-1], T_true[1:])]
    return T_true, scans, motions


def compare_gicp_steps(steps: int) -> dict:
    """GICP frame-to-frame odometry over `steps` steps: both packages with
    constant velocity (each step predicted by the previous step's delta,
    from rest), and the JAX package with the true motion as each step's
    prediction -> per-step delta gaps, ATEs, the JAX deltas, seconds."""
    T_true, scans, motions = gicp_step_inputs(steps)
    t0 = time.perf_counter()
    jd, jw = _frame_to_frame("jax", scans, None)
    t1 = time.perf_counter()
    td, tw = _frame_to_frame("torch", scans, None)
    t2 = time.perf_counter()
    _, mw = _frame_to_frame("jax", scans, motions)
    rot, trans = tse3.pose_error(torch.from_numpy(jd), torch.from_numpy(td))
    return {
        "steps": steps,
        "gap_m": trans.tolist(),
        "gap_rad": rot.tolist(),
        "ate_jax_m": _ate(T_true, jw),
        "ate_torch_m": _ate(T_true, tw),
        "ate_jax_true_motion_m": _ate(T_true, mw),
        "jax_deltas": _pose_rows(jd),
        "seconds_jax": t1 - t0,
        "seconds_torch": t2 - t1,
    }


def gicp_step_summary(r: dict) -> str:
    aj, at, am = (np.asarray(r[k]) for k in ("ate_jax_m", "ate_torch_m", "ate_jax_true_motion_m"))
    return (
        f"frame-to-frame, {r['steps']} steps with constant velocity: max per-step delta gap "
        f"{max(r['gap_m']):.6e} m {max(r['gap_rad']):.6e} rad; ATE jax mean {aj.mean():.6f} max {aj.max():.6f} m "
        f"(as chip_smoke.GICP_ATE_JAX_MEAN_M, GICP_ATE_JAX_MAX_M), port mean {at.mean():.6f} max {at.max():.6f} m; "
        f"jax with the true motion as prediction: ATE mean {am.mean():.6f} max {am.max():.6f} m; "
        f"{r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s"
    )


def gicp_step_order_shift(steps: int, n_orders: int) -> dict:
    """The JAX package alone, with constant velocity: every scan's points in
    `n_orders` other orders (RandomState(500 + i)) -> per order the shift
    of each step's delta."""
    _, scans, _ = gicp_step_inputs(steps)
    base, _ = _frame_to_frame("jax", scans, None)
    r = {"orders": n_orders, "steps": {"shift_m": [], "shift_rad": []}}
    for i in range(n_orders):
        rng = np.random.RandomState(500 + i)
        other, _ = _frame_to_frame("jax", [s[rng.permutation(len(s))] for s in scans], None)
        rot, trans = tse3.pose_error(torch.from_numpy(base), torch.from_numpy(other))
        r["steps"]["shift_m"].append(trans.tolist())
        r["steps"]["shift_rad"].append(rot.tolist())
    return r


def order_shift(n_orders: int) -> dict:
    """The port alone, on the CPU: the target scan's points in `n_orders`
    other orders (RandomState(100 + i) permutations) give the same voxels
    with their moments summed in another order. -> per order: whether every
    map kept its keys and counts, the largest moment change over its voxel's
    largest |moment|, and the largest per-pose shift over the eight inits
    against the scan's own order; and the largest change of a target
    point's covariance."""
    tgt, src, T_rel, xis = pyramid_inputs(PYRAMID_INITS)
    source = ttransform(torch.from_numpy(T_rel), tcovs(tmake(src, device="cpu")))
    T0s = tse3.se3_exp(torch.from_numpy(xis))

    def register(points):
        target = tcovs(tmake(points, device="cpu"))
        maps = tpyr.build_pyramid(target, device="cpu")
        poses = torch.stack([tpyr.register_scan_pyramid(maps, source, T0, device="cpu") for T0 in T0s])
        return target.covs[: len(points)], maps, poses

    def moment_rel(a, b):
        x, y = a.moments[:, 1:10].double(), b.moments[:, 1:10].double()
        return float(((x - y).abs().amax(1) / (y.abs().amax(1) + 1e-30)).max())

    covs, maps, poses = register(tgt)
    r = {"orders": n_orders, "same_keys": [], "moment_rel": [], "cov_abs": [], "shift_m": [], "shift_rad": []}
    for i in range(n_orders):
        perm = np.random.RandomState(100 + i).permutation(len(tgt))
        ocovs, omaps, oposes = register(tgt[perm])
        r["cov_abs"].append(float((ocovs - covs[torch.from_numpy(perm)]).abs().max()))
        r["same_keys"].append(all(
            torch.equal(a.keys, b.keys) and torch.equal(a.moments[:, 0], b.moments[:, 0])
            for a, b in zip(omaps, maps)
        ))
        r["moment_rel"].append(max(moment_rel(a, b) for a, b in zip(omaps, maps)))
        rot, trans = tse3.pose_error(poses, oposes)
        r["shift_m"].append(float(trans.max()))
        r["shift_rad"].append(float(rot.max()))
    return r


def _graph_frames(package: str, scans):
    """Phase 23's preprocessing of each scan: voxelgrid_sampling at
    GRAPH_LEAF into GRAPH_CAPACITY slots, then kNN normals and covariances."""
    leaf, cap = chip_smoke.GRAPH_LEAF, chip_smoke.GRAPH_CAPACITY
    if package == "jax":
        prep = jax.jit(lambda f: jfeatures(jvoxelgrid(f, leaf, capacity=cap), k=10, grid_leaf=1.0))
        return [prep(jmake(s)) for s in scans]
    return [tfeatures(tvoxelgrid(tmake(s, device="cpu"), leaf, capacity=cap), k=10, grid_leaf=1.0) for s in scans]


def _graph_runs(package: str, frames, T0, start, runs=chip_smoke.GRAPH_RUNS) -> dict:
    """Phase 23's runs on one package -> run: (poses [P, 4, 4], error, iterations)."""
    c = chip_smoke
    edges = c.graph_edges(len(frames))
    jx = package == "jax"
    if jx:
        gicp, vgicp, batch, build, prior, graph = jgicp, jvgicp, jbatch, jbuild, JPrior, JGraph
        lm, gn, dogleg, LMP, DLP = jlm, jgn, jdogleg, JLMParams, JDoglegParams
        T0_, w = jax.numpy.asarray(T0), jax.numpy.full((6,), c.GRAPH_PRIOR_WEIGHT)
    else:
        gicp, vgicp, batch, build, prior, graph = tgicp, tvgicp, tbatch, tbuild, TPrior, TGraph
        lm, gn, dogleg, LMP, DLP = tlm, tgn, tdogleg, TLMParams, TDoglegParams
        T0_, w = torch.from_numpy(T0), torch.full((6,), c.GRAPH_PRIOR_WEIGHT)

    def with_prior(factors):
        g = graph(num_poses=len(frames))
        g.add(prior(prior=T0_, weights=w, key=0))
        for f in factors:
            g.add(f)
        return g

    graphs = {
        "gicp": lambda: with_prior([gicp(i, j, frames[i], frames[j], max_corr_dist=c.GICP_MAX_CORR) for i, j in edges]),
        "vgicp": lambda: with_prior([vgicp(i, j, frames[i], frames[j], voxel_resolution=c.GRAPH_VGICP_LEAF,
                                           min_voxel_points=c.GRAPH_VGICP_MIN_POINTS) for i, j in edges]),
        "vgicp_batch": lambda: with_prior([batch([build(frames[i], c.GRAPH_VGICP_LEAF) for i, _ in edges],
                                                 [frames[j] for _, j in edges], [i for i, _ in edges],
                                                 [j for _, j in edges], min_voxel_points=c.GRAPH_VGICP_MIN_POINTS)]),
    }
    built = {}
    out = {}
    for run in runs:
        name, opt = run.rsplit("_", 1)
        g = built[name] = built.get(name) or graphs[name]()
        if opt == "lm":
            fn = lambda p, g=g: lm(g, p, LMP(max_iterations=c.GRAPH_LM_ITERATIONS))  # noqa: E731
            iters = lambda r: r.status.num_iterations  # noqa: E731
        elif opt == "gn":
            fn = lambda p, g=g: gn(g, p, iterations=c.GRAPH_GN_ITERATIONS)  # noqa: E731
            iters = lambda r: c.GRAPH_GN_ITERATIONS  # noqa: E731
        else:
            fn = lambda p, g=g: dogleg(g, p, DLP(max_iterations=c.GRAPH_DOGLEG_ITERATIONS))  # noqa: E731
            iters = lambda r: r.num_iterations  # noqa: E731
        res = jax.jit(fn)(start) if jx else fn(torch.from_numpy(start))
        out[run] = (np.asarray(res.poses), float(res.error), int(iters(res)))
    return out


def _truth_error(T_true, poses):
    """The demo's error: each pose relative to pose 0 against the truth's
    -> (max m, max rad)."""
    est = torch.from_numpy(np.linalg.inv(poses[0]) @ poses)
    ref = torch.from_numpy((np.linalg.inv(T_true[0]) @ np.stack(T_true)).astype(np.float32))
    rot, trans = tse3.pose_error(ref, est)
    return float(trans.max()), float(rot.max())


def compare_graph(n_poses: int, runs=chip_smoke.GRAPH_RUNS) -> dict:
    """Phase 23 in both packages on the CPU -> per run: per-pose gaps, the
    JAX poses, errors, iterations, errors against the truth, seconds."""
    T_true, scans = cluster_scans(n_poses)
    start = chip_smoke.graph_start(T_true)
    t0 = time.perf_counter()
    jf = _graph_frames("jax", scans)
    j = _graph_runs("jax", jf, T_true[0], start, runs)
    t1 = time.perf_counter()
    tf = _graph_frames("torch", scans)
    t = _graph_runs("torch", tf, T_true[0], start, runs)
    t2 = time.perf_counter()
    r = {"poses": n_poses, "kept": [int(np.asarray(f.mask).sum()) for f in jf],
         "kept_torch": [int(f.mask.sum()) for f in tf], "seconds_jax": t1 - t0, "seconds_torch": t2 - t1}
    for run in runs:
        rot, trans = tse3.pose_error(torch.from_numpy(j[run][0]), torch.from_numpy(t[run][0]))
        r[run] = {"gap_m": trans.tolist(), "gap_rad": rot.tolist(), "jax_poses": _pose_rows(j[run][0]),
                  "error_jax": j[run][1], "error_torch": t[run][1], "iters_jax": j[run][2], "iters_torch": t[run][2],
                  "truth_jax": _truth_error(T_true, j[run][0]), "truth_torch": _truth_error(T_true, t[run][0])}
    return r


def graph_summary(r: dict) -> str:
    return f"chain graph, {r['poses']} poses, kept points jax {r['kept']} port {r['kept_torch']}: " + "; ".join(
        f"{run}: max gap {max(r[run]['gap_m']):.6e} m {max(r[run]['gap_rad']):.6e} rad, error jax "
        f"{r[run]['error_jax']:.6f} port {r[run]['error_torch']:.6f}, iterations jax {r[run]['iters_jax']} port "
        f"{r[run]['iters_torch']}, against the truth jax {r[run]['truth_jax'][0]:.6f} m {r[run]['truth_jax'][1]:.6f} "
        f"rad port {r[run]['truth_torch'][0]:.6f} m {r[run]['truth_torch'][1]:.6f} rad"
        for run in chip_smoke.GRAPH_RUNS if run in r
    ) + f"; {r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s"


def graph_order_shift(n_poses: int, n_orders: int, runs=chip_smoke.GRAPH_RUNS, package: str = "jax") -> dict:
    """Phase 23 again with every scan's points in `n_orders` other orders
    (RandomState(600 + i) permutations), run by `package`, against the JAX
    package's run in the scans' own order -> per run the shift of each pose
    and the iterations, per order."""
    T_true, scans = cluster_scans(n_poses)
    start = chip_smoke.graph_start(T_true)
    base = _graph_runs("jax", _graph_frames("jax", scans), T_true[0], start, runs)
    r = {"orders": n_orders, "package": package, **{run: {"shift_m": [], "shift_rad": [], "iters": []} for run in runs}}
    for i in range(n_orders):
        rng = np.random.RandomState(600 + i)
        other = _graph_runs(package, _graph_frames(package, [s[rng.permutation(len(s))] for s in scans]), T_true[0],
                            start, runs)
        for run in runs:
            rot, trans = tse3.pose_error(torch.from_numpy(base[run][0]), torch.from_numpy(other[run][0]))
            r[run]["shift_m"].append(trans.tolist())
            r[run]["shift_rad"].append(rot.tolist())
            r[run]["iters"].append(other[run][2])
    return r


def graph_order_iterations(r: dict, runs) -> str:
    return f"{r['package']} in the other orders against JAX in the scans' own: " + "; ".join(
        f"{run}: iterations per order {r[run]['iters']}, largest shift per order (m) "
        + ", ".join(f"{max(x):.6e}" for x in r[run]["shift_m"])
        for run in runs
    )


def _pose_graph_runs(package: str, arrays, start) -> tuple:
    """optimize_pose_graph on one package -> (poses [P, 4, 4], error, iterations)."""
    if package == "jax":
        pg = jsparse.PoseGraphEdges(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
        res = jax.jit(lambda p: jsparse.optimize_pose_graph(pg, p, max_iterations=chip_smoke.PG_ITERATIONS))(start)
    else:
        pg = interop.pose_graph_from_numpy(arrays, device="cpu")
        res = tpose_graph(pg, torch.from_numpy(start), max_iterations=chip_smoke.PG_ITERATIONS)
    return np.asarray(res.poses), float(res.error), int(res.iterations)


def compare_pose_graph(n_poses: int) -> dict:
    """Phase 24's pose graph in both packages on the CPU -> gaps at every
    PG_SAMPLE-th pose, the JAX poses there, errors, iterations, seconds."""
    _, arrays, start = chip_smoke.pose_graph_arrays(n_poses)
    t0 = time.perf_counter()
    j = _pose_graph_runs("jax", arrays, start)
    t1 = time.perf_counter()
    t = _pose_graph_runs("torch", arrays, start)
    t2 = time.perf_counter()
    keys = slice(0, n_poses, chip_smoke.PG_SAMPLE)
    rot, trans = tse3.pose_error(torch.from_numpy(j[0][keys]), torch.from_numpy(t[0][keys]))
    return {"poses": n_poses, "gap_m": trans.tolist(), "gap_rad": rot.tolist(), "jax_poses": _pose_rows(j[0][keys]),
            "error_jax": j[1], "error_torch": t[1], "iters_jax": j[2], "iters_torch": t[2],
            "seconds_jax": t1 - t0, "seconds_torch": t2 - t1}


def pose_graph_summary(r: dict) -> str:
    return (f"pose graph, {r['poses']} poses: every {chip_smoke.PG_SAMPLE}th pose max gap {max(r['gap_m']):.6e} m "
            f"{max(r['gap_rad']):.6e} rad; error jax {r['error_jax']:.6f} port {r['error_torch']:.6f}; iterations "
            f"jax {r['iters_jax']} port {r['iters_torch']}; {r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s")


def pose_graph_order_shift(n_poses: int, n_orders: int) -> dict:
    """The JAX package alone: the pose graph again with its edges in
    `n_orders` other orders (RandomState(700 + i)) -> the shift of every
    PG_SAMPLE-th pose, per order."""
    _, arrays, start = chip_smoke.pose_graph_arrays(n_poses)
    base = _pose_graph_runs("jax", arrays, start)[0]
    keys = slice(0, n_poses, chip_smoke.PG_SAMPLE)
    r = {"orders": n_orders, "pose_graph": {"shift_m": [], "shift_rad": []}}
    for i in range(n_orders):
        perm = np.random.RandomState(700 + i).permutation(len(arrays["t_idx"]))
        other = dict(arrays, **{k: arrays[k][perm] for k in ("measured", "weights", "t_idx", "s_idx")})
        rot, trans = tse3.pose_error(torch.from_numpy(base[keys]), torch.from_numpy(_pose_graph_runs("jax", other, start)[0][keys]))
        r["pose_graph"]["shift_m"].append(trans.tolist())
        r["pose_graph"]["shift_rad"].append(rot.tolist())
    return r


def _isam2_api(package: str) -> dict:
    """chip_smoke.isam2_stream's names for one package, on the CPU."""
    if package == "jax":
        from gtsam_points_tpu.factors import PriorFactor, make_vgicp_factor
        from gtsam_points_tpu.optim import FixedLagSmoother, ISAM2Ext, LMParams

        return {"ISAM2Ext": ISAM2Ext, "FixedLagSmoother": FixedLagSmoother, "LMParams": LMParams,
                "PriorFactor": PriorFactor, "make_vgicp_factor": make_vgicp_factor,
                "arr": lambda x: jax.numpy.asarray(np.asarray(x, np.float32)), "kw": {}}
    from gtsam_points_tpu_torch.factors import PriorFactor, make_vgicp_factor
    from gtsam_points_tpu_torch.optim import FixedLagSmoother, ISAM2Ext, LMParams

    return {"ISAM2Ext": ISAM2Ext, "FixedLagSmoother": FixedLagSmoother, "LMParams": LMParams,
            "PriorFactor": PriorFactor, "make_vgicp_factor": make_vgicp_factor,
            "arr": lambda x: torch.from_numpy(np.array(x, dtype=np.float32)), "kw": {"device": "cpu"}}


STREAMS = ("isam2", "fixed_lag")


def _isam2_streams(package: str, scans, T_true) -> dict:
    """Phases 26-27's streams on one package -> stream: the records."""
    frames = _graph_frames(package, scans)
    api = _isam2_api(package)
    return {name: chip_smoke.isam2_stream(api, frames, T_true, smoother=name == "fixed_lag")[0] for name in STREAMS}


def _stream_gaps(a, b) -> tuple:
    """Per update the largest (m, rad) gap between two runs' moved poses."""
    m, rad = [], []
    for ra, rb in zip(chip_smoke._stream_rows(a), chip_smoke._stream_rows(b)):
        bottom = np.broadcast_to(np.asarray([0, 0, 0, 1], np.float32), (len(ra), 1, 4))
        pa = np.concatenate([np.asarray(ra, np.float32).reshape(-1, 3, 4), bottom], 1)
        pb = np.concatenate([np.asarray(rb, np.float32).reshape(-1, 3, 4), bottom], 1)
        rot, trans = tse3.pose_error(torch.from_numpy(pa), torch.from_numpy(pb))
        m.append(float(trans.max()))
        rad.append(float(rot.max()))
    return m, rad


def compare_isam2(n_poses: int) -> dict:
    """Phases 26-27 in both packages on the CPU -> per stream: per-update
    gaps, the JAX records in chip_smoke's form, seconds."""
    T_true, scans = cluster_scans(n_poses)
    t0 = time.perf_counter()
    j = _isam2_streams("jax", scans, T_true)
    t1 = time.perf_counter()
    t = _isam2_streams("torch", scans, T_true)
    t2 = time.perf_counter()
    r = {"poses": n_poses, "seconds_jax": t1 - t0, "seconds_torch": t2 - t1}
    for name in STREAMS:
        gap_m, gap_rad = _stream_gaps(j[name], t[name])
        same = {k: [x[k] for x in t[name]] == [x[k] for x in j[name]]
                for k in ("window", "frozen", "num_compiles", "compiled")}
        r[name] = {"gap_m": gap_m, "gap_rad": gap_rad, "same": same,
                   "jax": {k: [x[k] for x in j[name]] for k in ("window", "frozen", "num_compiles", "compiled")},
                   "jax_poses": chip_smoke._stream_rows(j[name]),
                   "iters_jax": [x["iterations"] for x in j[name]], "iters_torch": [x["iterations"] for x in t[name]],
                   "ms_torch": [x["ms"] for x in t[name]]}
    return r


def isam2_summary(r: dict) -> str:
    return f"ISAM2 and fixed-lag streams, {r['poses']} poses: " + "; ".join(
        f"{name}: max gap {max(r[name]['gap_m']):.6e} m {max(r[name]['gap_rad']):.6e} rad (per update "
        + ", ".join(f"{x:.2e}" for x in r[name]["gap_m"]) + f"), equal {r[name]['same']}, num_compiles "
        f"{r[name]['jax']['num_compiles'][-1]}, iterations jax {r[name]['iters_jax']} port {r[name]['iters_torch']}"
        for name in STREAMS
    ) + f"; {r['seconds_jax']:.1f} s / {r['seconds_torch']:.1f} s"


def isam2_order_shift(n_poses: int, n_orders: int) -> dict:
    """The JAX package alone: phases 26-27 again with every scan's points in
    `n_orders` other orders (RandomState(600 + i)) -> per stream the
    per-update shift of the moved poses, per order."""
    T_true, scans = cluster_scans(n_poses)
    base = _isam2_streams("jax", scans, T_true)
    r = {"orders": n_orders, **{name: {"shift_m": [], "shift_rad": []} for name in STREAMS}}
    for i in range(n_orders):
        rng = np.random.RandomState(600 + i)
        other = _isam2_streams("jax", [s[rng.permutation(len(s))] for s in scans], T_true)
        for name in STREAMS:
            m, rad = _stream_gaps(base[name], other[name])
            r[name]["shift_m"].append(m)
            r[name]["shift_rad"].append(rad)
    return r


def _same_but_compiled(a: dict, b: dict) -> bool:
    """Two streams' JAX records equal but for `compiled`."""
    return all(a["jax"][k] == b["jax"][k] for k in a["jax"] if k != "compiled") and len(a["jax_poses"]) == len(
        b["jax_poses"]) and all(np.array_equal(x, y) for x, y in zip(a["jax_poses"], b["jax_poses"]))


def _print_stream(name: str, r: dict) -> None:
    """A stream's JAX records as chip_smoke.py keeps them."""
    print(f"{name} = {{", flush=True)
    for k, v in r["jax"].items():
        print(f'    "{k}": {v!r},')
    print('    "poses": [')
    for rows in r["jax_poses"]:
        print("        [" + ", ".join("[" + ", ".join(np.format_float_positional(np.float32(x), unique=True)
                                                      for x in p) + "]" for p in rows) + "],")
    print("    ],\n}", flush=True)


def _gnc(package: str, scans, pair):
    """Phase 25 on one package: FPFH of the pair's frames, GNC between
    them -> (T [4, 4], inlier rate)."""
    a, b = _graph_frames(package, [scans[k] for k in pair])
    if package == "jax":
        from gtsam_points_tpu.registration import GNCParams, estimate_fpfh, estimate_pose_gnc

        fa, fb = jax.jit(estimate_fpfh)(a), jax.jit(estimate_fpfh)(b)
        res = jax.jit(lambda: estimate_pose_gnc(a, b, fa, fb, GNCParams()))()
    else:
        from gtsam_points_tpu_torch.registration import GNCParams, estimate_fpfh, estimate_pose_gnc

        fa, fb = estimate_fpfh(a, device="cpu"), estimate_fpfh(b, device="cpu")
        res = estimate_pose_gnc(a, b, fa, fb, GNCParams(), device="cpu")
    return np.asarray(res.T_target_source), float(res.inlier_rate)


def compare_gnc(n_poses: int, pair) -> dict:
    """Phase 25 in both packages on the CPU, on scans `pair` of n_poses ->
    the gap, the JAX pose and inlier rate, both against the truth."""
    T_true, scans = cluster_scans(n_poses)
    j, jr = _gnc("jax", scans, pair)
    t, tr = _gnc("torch", scans, pair)
    truth = (np.linalg.inv(T_true[pair[0]]) @ T_true[pair[1]]).astype(np.float32)
    gap = tse3.pose_error(torch.from_numpy(j), torch.from_numpy(t))
    tj = tse3.pose_error(torch.from_numpy(truth), torch.from_numpy(j))
    tt = tse3.pose_error(torch.from_numpy(truth), torch.from_numpy(t))
    return {"pair": list(pair), "gap_m": float(gap[1]), "gap_rad": float(gap[0]), "jax_pose": _pose_rows([j])[0],
            "inlier_jax": jr, "inlier_torch": tr, "truth_jax": (float(tj[1]), float(tj[0])),
            "truth_torch": (float(tt[1]), float(tt[0]))}


def gnc_order_shift(n_poses: int, pair, n_orders: int) -> dict:
    """The JAX package alone: phase 25 on scans `pair` with the scans'
    points in `n_orders` other orders (RandomState(600 + i)) -> the pose's
    shift per order."""
    T_true, scans = cluster_scans(n_poses)
    base, _ = _gnc("jax", scans, pair)
    r = {"pair": list(pair), "orders": n_orders, "shift_m": [], "shift_rad": []}
    for i in range(n_orders):
        rng = np.random.RandomState(600 + i)
        other, _ = _gnc("jax", [s[rng.permutation(len(s))] for s in scans], pair)
        rot, trans = tse3.pose_error(torch.from_numpy(base), torch.from_numpy(other))
        r["shift_m"].append(float(trans))
        r["shift_rad"].append(float(rot))
    return r


# -- phases 28-30: global registration and its refine, LOAM, CT-ICP, BA ------------------


def _api(package: str) -> dict:
    """One package's names for phases 28-30."""
    if package == "jax":
        from gtsam_points_tpu import factors as F
        from gtsam_points_tpu import optim as O
        from gtsam_points_tpu.optim.lm import LMParams
        from gtsam_points_tpu.registration import RANSACParams, estimate_fpfh, estimate_pose_ransac
        from gtsam_points_tpu.types.frame import transform_frame

        return {"F": F, "O": O, "LM": LMParams, "RANSAC": RANSACParams, "fpfh": jax.jit(estimate_fpfh),
                "ransac": lambda *a: jax.jit(lambda: estimate_pose_ransac(*a))(), "transform": transform_frame,
                "arr": jax.numpy.asarray, "make": jmake, "features": jfeatures, "kw": {},
                "lm": lambda g, p, it: jax.jit(lambda x: O.optimize_lm(g, x, LMParams(max_iterations=it)))(p)}
    from gtsam_points_tpu_torch import factors as F
    from gtsam_points_tpu_torch import optim as O
    from gtsam_points_tpu_torch.registration import RANSACParams, estimate_fpfh, estimate_pose_ransac

    return {"F": F, "O": O, "LM": O.LMParams, "RANSAC": RANSACParams,
            "fpfh": lambda f: estimate_fpfh(f, device="cpu"),
            "ransac": lambda *a: estimate_pose_ransac(*a, device="cpu"), "transform": ttransform,
            "arr": lambda x: torch.from_numpy(np.array(x, dtype=np.float32)),
            "make": lambda *a, **k: tmake(*a, device="cpu", **k), "features": tfeatures, "kw": {"device": "cpu"},
            "lm": lambda g, p, it: O.optimize_lm(g, p, O.LMParams(max_iterations=it))}


def _refine(api: dict, target, source, T_coarse):
    """demo_global_registration's refine: the source moved by the coarse
    pose, a unary GICP factor (max corr 2.0), REFINE_ITERATIONS LM
    iterations from I -> (T_fine = refined · coarse, numpy; iterations)."""
    T = api["arr"](T_coarse)
    graph = api["O"].FactorGraph(num_poses=1)
    graph.add(api["F"].make_gicp_factor(-1, 0, target, api["transform"](T, source),
                                        max_corr_dist=chip_smoke.REFINE_MAX_CORR))
    res = api["lm"](graph, api["arr"](np.eye(4, dtype=np.float32)[None]), chip_smoke.REFINE_ITERATIONS)
    return np.asarray(res.poses[0] @ T), int(res.status.num_iterations)


def _global_frames(package: str, scans, pair):
    """Phase 28's inputs on one package: phase 23's frames of the pair and
    their FPFH."""
    api = _api(package)
    frames = _graph_frames(package, [scans[k] for k in pair])
    return api, frames, [api["fpfh"](f) for f in frames]


def compare_global(n_poses: int, pair, starts: dict) -> dict:
    """Phase 28 on the CPU, scans `pair` of n_poses: each package's own
    RANSAC (JAX on its threefry draws, the port on its generator's) and the
    refine from each start in `starts` (name -> [4, 4]; the RANSAC start
    None means the port's RANSAC pose) in both packages."""
    T_true, scans = cluster_scans(n_poses)
    truth = (np.linalg.inv(T_true[pair[0]]) @ T_true[pair[1]]).astype(np.float32)
    out = {"pair": list(pair)}
    runs = {}
    for package in ("jax", "torch"):
        api, (a, b), (fa, fb) = _global_frames(package, scans, pair)
        res = api["ransac"](a, b, fa, fb, api["RANSAC"](max_iterations=chip_smoke.RANSAC_ITERATIONS))
        out[f"ransac_{package}"] = (np.asarray(res.T_target_source), float(res.inlier_rate))
        runs[package] = (api, a, b)
    out["starts"] = {k: (out["ransac_torch"][0] if v is None else np.asarray(v, np.float32)) for k, v in starts.items()}
    for name, T0 in out["starts"].items():
        for package, (api, a, b) in runs.items():
            out[f"refine_{name}_{package}"] = _refine(api, a, b, T0)
        j, t = out[f"refine_{name}_jax"][0], out[f"refine_{name}_torch"][0]
        out[f"refine_{name}_gap"] = _max_gap(j, t)
        out[f"refine_{name}_truth_jax"] = _max_gap(truth, j)
    out["ransac_truth"] = {p: _max_gap(truth, out[f"ransac_{p}"][0]) for p in ("jax", "torch")}
    return out


def global_order_shift(n_poses: int, pair, starts: dict, n_orders: int) -> dict:
    """The JAX package alone: the refine from each start with the scans'
    points in n_orders other orders (RandomState(700 + i)) -> per start the
    largest shift (m, rad) against the scans' own order."""
    T_true, scans = cluster_scans(n_poses)
    api, (a, b), _ = _global_frames("jax", scans, pair)
    base = {k: _refine(api, a, b, T0)[0] for k, T0 in starts.items()}
    shift = {k: [0.0, 0.0] for k in starts}
    for i in range(n_orders):
        rng = np.random.RandomState(700 + i)
        oa, ob = _graph_frames("jax", [scans[k][rng.permutation(len(scans[k]))] for k in pair])
        for k, T0 in starts.items():
            rot, trans = tse3.pose_error(torch.from_numpy(base[k]), torch.from_numpy(_refine(api, oa, ob, T0)[0]))
            shift[k] = [max(shift[k][0], float(trans)), max(shift[k][1], float(rot))]
    return shift


def _loam_pose(package: str, clouds, validate: bool):
    """Phase 29's LOAM pair on one package -> (pose 1 [4, 4], iterations)."""
    api = _api(package)
    (tp, te), (sp, se) = clouds
    f = api["F"].make_loam_factor(0, 1, api["make"](te), api["make"](tp), api["make"](se), api["make"](sp),
                                  max_corr_dist=chip_smoke.LOAM_MAX_CORR, grid_leaf=chip_smoke.LOAM_GRID_LEAF,
                                  enable_correspondence_validation=validate)
    g = api["O"].FactorGraph(num_poses=2)
    eye = np.eye(4, dtype=np.float32)
    g.add(api["F"].PriorFactor(prior=api["arr"](eye), weights=api["arr"](np.full(6, chip_smoke.LOAM_PRIOR_WEIGHT)),
                               key=0))
    g.add(f)
    res = api["lm"](g, api["arr"](np.stack([eye, eye])), chip_smoke.LOAM_ITERATIONS)
    return np.asarray(res.poses[1]), int(res.status.num_iterations)


def _ct_run(package: str, target_pts, raw, times, mode: str):
    """Phase 29's CT-ICP on one package -> (poses [2, 4, 4], iterations,
    deskewed points [N, 3])."""
    api = _api(package)
    k, leaf = chip_smoke.CT_FEATURE_K, chip_smoke.CT_FEATURE_LEAF
    prep = (jax.jit(lambda f: jfeatures(f, k=k, grid_leaf=leaf)) if package == "jax"
            else lambda f: tfeatures(f, k=k, grid_leaf=leaf))
    target = prep(api["make"](target_pts))
    source = prep(api["make"](raw, times=times))
    f = api["F"].make_ct_icp_factor(0, 1, target, source, gicp=mode == "gicp", point_to_plane=mode == "plane",
                                    max_corr_dist=chip_smoke.CT_MAX_CORR, grid_leaf=chip_smoke.CT_GRID_LEAF)
    g = api["O"].FactorGraph(num_poses=2)
    eye = np.eye(4, dtype=np.float32)
    g.add(api["F"].PriorFactor(prior=api["arr"](eye), weights=api["arr"](np.full(6, chip_smoke.CT_PRIOR_WEIGHT)),
                               key=0))
    g.add(f)
    res = api["lm"](g, api["arr"](np.stack([eye, eye])), chip_smoke.CT_ITERATIONS)
    desk = api["F"].deskew(res.poses[0], res.poses[1], f.source)
    return np.asarray(res.poses), int(res.status.num_iterations), np.asarray(desk.points)


def _ba_run(package: str, problem, mode: str):
    """Phase 30 on one package -> (poses [K, 4, 4], iterations)."""
    api = _api(package)
    T_gt = problem["T_gt"]
    g = api["O"].FactorGraph(num_poses=len(T_gt))
    g.add(api["F"].PriorFactor(prior=api["arr"](T_gt[0]), weights=api["arr"](np.full(6, 1e6)), key=0))
    g.add(api["F"].PriorFactor(prior=api["arr"](T_gt[1]), weights=api["arr"](np.full(6, 1e2)), key=1))
    if mode == "evm":
        for f in problem["plane_feats"]:
            g.add(api["F"].make_evm_factor("plane", f, **api["kw"]))
        for f in problem["edge_feats"]:
            g.add(api["F"].make_evm_factor("edge", f, **api["kw"]))
    else:
        for f in problem["plane_feats"]:
            g.add(api["F"].make_lsq_ba_factor(chip_smoke.ba_moments(f), **api["kw"]))
    res = api["lm"](g, api["arr"](problem["start"]), chip_smoke.BA_ITERATIONS)
    return np.asarray(res.poses), int(res.status.num_iterations)


def _max_gap(a, b) -> tuple:
    rot, trans = tse3.pose_error(torch.from_numpy(np.asarray(a, np.float32)), torch.from_numpy(np.asarray(b, np.float32)))
    return float(trans.max()), float(rot.max())


def _permuted(arrays, seed: int):
    """Each array's rows in one other order (RandomState(seed)), the same
    permutation for arrays of one length (points and their times)."""
    rng = np.random.RandomState(seed)
    perms = {}
    return [a[perms.setdefault(len(a), rng.permutation(len(a)))] for a in arrays]


def compare_scan_factors(orders: int, loam: bool, ct: bool) -> dict:
    """Phase 29 in both packages on the CPU (and with `orders`, the JAX
    package alone with every cloud's points in other orders)."""
    out = {}
    if loam:
        T, clouds = chip_smoke.loam_clouds()
        truth = (np.linalg.inv(T[0]) @ T[1]).astype(np.float32)
        for validate in (False, True):
            name = "validated" if validate else "plain"
            j, ji = _loam_pose("jax", clouds, validate)
            t, ti = _loam_pose("torch", clouds, validate)
            shift = [0.0, 0.0]
            for i in range(orders):
                other = [tuple(_permuted(c, 800 + 10 * i + k)) for k, c in enumerate(clouds)]
                m, r = _max_gap(j, _loam_pose("jax", other, validate)[0])
                shift = [max(shift[0], m), max(shift[1], r)]
            out[f"loam_{name}"] = {"jax": j, "iters": (ji, ti), "gap": _max_gap(j, t), "truth_jax": _max_gap(truth, j),
                                   "truth_torch": _max_gap(truth, t), "shift": shift}
    if ct:
        target, raw, times = chip_smoke.ct_clouds()
        for mode in chip_smoke.CT_MODES:
            j, ji, jd = _ct_run("jax", target, raw, times, mode)
            t, ti, td = _ct_run("torch", target, raw, times, mode)
            shift = [0.0, 0.0]
            for i in range(orders):
                ot, = _permuted([target], 900 + i)
                orw, otm = _permuted([raw, times], 950 + i)
                m, r = _max_gap(j, _ct_run("jax", ot, orw, otm, mode)[0])
                shift = [max(shift[0], m), max(shift[1], r)]
            out[f"ct_{mode}"] = {"jax": j, "iters": (ji, ti), "gap": _max_gap(j, t), "shift": shift,
                                 "deskew_gap": float(np.abs(jd - td).max())}
    return out


def compare_ba(orders: int) -> dict:
    """Phase 30 in both packages on the CPU (and with `orders`, the JAX
    package alone with each feature's points in other orders)."""
    problem = chip_smoke.ba_problem()
    out = {"features": (len(problem["plane_feats"]), len(problem["edge_feats"]))}
    for mode in ("evm", "lsq"):
        j, ji = _ba_run("jax", problem, mode)
        t, ti = _ba_run("torch", problem, mode)
        shift = [0.0, 0.0]
        for i in range(orders):
            other = dict(problem)
            for kind in ("plane_feats", "edge_feats"):
                other[kind] = [{k: _permuted([v], 1000 + 100 * i + n)[0] for k, v in f.items()}
                               for n, f in enumerate(problem[kind])]
            m, r = _max_gap(j, _ba_run("jax", other, mode)[0])
            shift = [max(shift[0], m), max(shift[1], r)]
        out[mode] = {"jax": j, "iters": (ji, ti), "gap": _max_gap(j, t), "shift": shift,
                     "truth_jax": _max_gap(problem["T_gt"], j), "truth_torch": _max_gap(problem["T_gt"], t)}
    return out


def _colored_frame(package: str, cloud: dict, features: bool, capacity=None):
    """A cloud {points, intensities, covs (or None)} as one package's frame,
    with kNN features (phase 32's k and leaf) where `features`."""
    f = _api(package)["make"](cloud["points"], intensities=cloud["intensities"], covs=cloud["covs"],
                              capacity=capacity)
    if not features:
        return f
    k, leaf = chip_smoke.COLORED_FEATURE_K, chip_smoke.COLORED_FEATURE_LEAF
    return (jax.jit(lambda x: jfeatures(x, k=k, grid_leaf=leaf))(f) if package == "jax"
            else tfeatures(f, k=k, grid_leaf=leaf))


def _colored_clouds(perms=None) -> dict:
    """Phase 32's four clouds (plane target and source, surface target and
    source), each with its points' attributes; `perms` reorders each cloud."""
    scene, surface = chip_smoke.colored_scene(), chip_smoke.surface_scene()
    clouds = {
        "target": {"points": scene["target"], "intensities": scene["intensities"], "covs": None},
        "source": {"points": scene["source"], "intensities": scene["intensities"], "covs": None},
        "surface_target": {"points": surface["target"], "intensities": surface["intensities"], "covs": surface["covs"]},
        "surface_source": {"points": surface["source"], "intensities": surface["intensities"], "covs": surface["covs"]},
    }
    for name, perm in (perms or {}).items():
        clouds[name] = {k: None if v is None else v[perm] for k, v in clouds[name].items()}
    return clouds


def _colored_runs(package: str, clouds: dict) -> dict:
    """Phase 32 on one package: the demo's three registrations of the
    painted plane and the colored GICP against the surface's voxel map ->
    {run: (pose 1 [4, 4], iterations)}."""
    api = _api(package)
    F = api["F"]
    target, source = _colored_frame(package, clouds["target"], True), _colored_frame(package, clouds["source"], True)
    kw = dict(max_corr_dist=chip_smoke.COLORED_MAX_CORR, photometric_weight=chip_smoke.COLORED_PHOTOMETRIC_WEIGHT)
    gicp = dict(max_corr_dist=chip_smoke.COLORED_MAX_CORR)
    build = jbuild if package == "jax" else tbuild
    vframe = build(_colored_frame(package, clouds["surface_target"], False, 4096),
                   chip_smoke.SURFACE_LEAF).as_frame(with_normals=True)
    src = _colored_frame(package, clouds["surface_source"], False, 4096)
    factors = {
        "gicp": [F.make_gicp_factor(0, 1, target, source, **gicp)],
        "colored_gicp": [F.make_colored_gicp_factor(0, 1, target, source, **kw)],
        "consistency_gicp": [F.make_gicp_factor(0, 1, target, source, **gicp),
                             F.make_color_consistency_factor(0, 1, target, source, **kw)],
        "surface": [F.make_colored_gicp_factor(0, 1, vframe, src, max_corr_dist=chip_smoke.SURFACE_MAX_CORR,
                                               grid_leaf=chip_smoke.SURFACE_LEAF)],
    }
    eye = np.eye(4, dtype=np.float32)
    out = {}
    for run, fs in factors.items():
        g = api["O"].FactorGraph(num_poses=2)
        g.add(F.PriorFactor(prior=api["arr"](eye), weights=api["arr"](np.full(6, 1e6)), key=0))
        for f in fs:
            g.add(f)
        it = chip_smoke.SURFACE_ITERATIONS if run == "surface" else chip_smoke.COLORED_ITERATIONS
        res = api["lm"](g, api["arr"](np.stack([eye, eye])), it)
        out[run] = (np.asarray(res.poses[1]), int(res.status.num_iterations))
    return out


def compare_colored(orders: int) -> dict:
    """Phase 32 in both packages on the CPU (and with `orders`, the JAX
    package alone with each cloud's points in other orders)."""
    clouds = _colored_clouds()
    truth = {"surface": chip_smoke.surface_scene()["T_true"]}
    j, t = _colored_runs("jax", clouds), _colored_runs("torch", clouds)
    out = {}
    for run in j:
        T = truth.get(run, chip_smoke.colored_scene()["T_true"])
        out[run] = {"jax": j[run][0], "iters": (j[run][1], t[run][1]), "gap": _max_gap(j[run][0], t[run][0]),
                    "truth_jax": _max_gap(T, j[run][0]), "truth_torch": _max_gap(T, t[run][0]), "shift": [0.0, 0.0]}
    for i in range(orders):
        perms = {name: np.random.RandomState(1100 + 10 * i + n).permutation(len(c["points"]))
                 for n, (name, c) in enumerate(clouds.items())}
        for run, (pose, _) in _colored_runs("jax", _colored_clouds(perms)).items():
            m, r = _max_gap(j[run][0], pose)
            out[run]["shift"] = [max(out[run]["shift"][0], m), max(out[run]["shift"][1], r)]
    return out


def _imu_run(package: str, chain) -> tuple:
    """Phase 33's IMU chain on one package -> (poses [P, 4, 4], iterations,
    the chained prediction of the last pose [4, 4])."""
    api = _api(package)
    F = api["F"]
    P = len(chain["T"])
    m = F.make_imu_measurements(chain["stamps"], chain["accs"], chain["gyros"], **api["kw"])
    z = api["arr"](np.zeros(3, np.float32))
    w = api["arr"](np.full(6, chip_smoke.IMU_WEIGHT, np.float32))
    g = api["O"].FactorGraph(num_poses=P)
    g.add(F.PriorFactor(prior=api["arr"](chain["T"][0]), weights=api["arr"](np.full(6, chip_smoke.IMU_PRIOR_WEIGHT)),
                        key=0))
    factors = [F.ReintegratedImuFactor(measurements=m, v_i=api["arr"](chain["v"][i]), bias_acc=z, bias_gyro=z,
                                       weights=w, pose_keys=(i, i + 1)) for i in range(P - 1)]
    for f in factors:
        g.add(f)
    res = api["lm"](g, api["arr"](chain["start"]), chip_smoke.IMU_ITERATIONS)
    T = api["arr"](chain["T"][0])
    for f in factors:
        T, _ = f.predict(T)
    return np.asarray(res.poses), int(res.status.num_iterations), np.asarray(T)


def _sim3_run(package: str, traj):
    api = _api(package)
    fn = api["F"].align_trajectories_sim3
    a, b = api["arr"](traj["a"]), api["arr"](traj["b"])
    s = (jax.jit(lambda x, y: fn(x, y, iterations=chip_smoke.SIM3_ITERATIONS))(a, b) if package == "jax"
         else fn(a, b, iterations=chip_smoke.SIM3_ITERATIONS))
    return np.asarray(s.pose), float(s.scale)


def compare_imu_sim3(imu: bool, sim3: bool) -> dict:
    """Phase 33 in both packages on the CPU."""
    out = {}
    if imu:
        chain = chip_smoke.imu_chain()
        (jp, ji, jT), (tp, ti, tT) = _imu_run("jax", chain), _imu_run("torch", chain)
        out["imu"] = {"jax": jp, "iters": (ji, ti), "gap": _max_gap(jp, tp), "truth_jax": _max_gap(chain["T"], jp),
                      "truth_torch": _max_gap(chain["T"], tp), "predict_jax": jT,
                      "predict_gap": float(np.abs(jT[:3, 3] - tT[:3, 3]).max()),
                      "predict_truth": _max_gap(chain["T"][-1], jT)}
    if sim3:
        traj = chip_smoke.sim3_trajectories()
        (jp, js), (tp, ts) = _sim3_run("jax", traj), _sim3_run("torch", traj)
        out["sim3"] = {"jax": jp, "scale": js, "scale_torch": ts, "gap": _max_gap(jp, tp),
                       "truth": _max_gap(chip_smoke.se3_exp_np(chip_smoke.SIM3_XI), jp)}
    return out


def _segment(package: str, scan):
    """Phase 35 on one package -> {points kept, each mask's size}."""
    api = _api(package)
    seg = __import__("gtsam_points_tpu.segmentation" if package == "jax" else "gtsam_points_tpu_torch.segmentation",
                     fromlist=["x"])
    k, leaf = chip_smoke.SEG_FEATURE_K, chip_smoke.SEG_FEATURE_LEAF
    if package == "jax":
        prep = jax.jit(lambda f: jfeatures(jvoxelgrid(f, chip_smoke.SEG_LEAF, capacity=chip_smoke.SEG_CAPACITY),
                                           k=k, grid_leaf=leaf))
    else:
        def prep(f):
            return tfeatures(tvoxelgrid(f, chip_smoke.SEG_LEAF, capacity=chip_smoke.SEG_CAPACITY), k=k, grid_leaf=leaf)
    frame = prep(api["make"](scan))
    seed = np.asarray(chip_smoke.SEG_SEED_POINT, np.float32)
    rg = seg.region_growing(frame, api["arr"](seed), seg.RegionGrowingParams(**chip_smoke.SEG_REGION))
    sizes = {"points": int(np.asarray(frame.mask).sum()), "region_growing": int(np.asarray(rg).sum())}
    for name, kw in chip_smoke.SEG_MIN_CUT.items():
        sizes[f"min_cut_{name}"] = int(np.asarray(seg.min_cut(frame, seed, seg.MinCutParams(**kw))).sum())
    return sizes


def compare_segmentation() -> dict:
    scan = chip_smoke.segmentation_scan()
    return {"jax": _segment("jax", scan), "torch": _segment("torch", scan)}


def _rows(T) -> str:
    """Poses [P, 4, 4] or one [4, 4] as top-three-row lists, as chip_smoke.py keeps them."""
    T = np.asarray(T, np.float32).reshape(-1, 4, 4)
    rows = ["[" + ", ".join(np.format_float_positional(np.float32(x), unique=True) for x in p[:3].reshape(-1)) + "]"
            for p in T]
    return rows[0] if len(rows) == 1 else "[" + ", ".join(rows) + "]"


def _print_rows(name: str, rows_by_run: dict) -> None:
    """Poses (top three rows, row-major) by run, as chip_smoke.py keeps them."""
    print(f"{name} = {{", flush=True)
    for run, rows in rows_by_run.items():
        print(f'    "{run}": [')
        for p in rows:
            print("        [" + ", ".join(np.format_float_positional(np.float32(x), unique=True) for x in p) + "],")
        print("    ],", flush=True)
    print("}", flush=True)



def order_summary(r: dict) -> str:
    return (
        f"pyramid, target summed in {r['orders']} other orders: keys and counts equal {all(r['same_keys'])}, "
        f"moments {max(r['moment_rel']):.6e} of each voxel's largest, covariances {max(r['cov_abs']):.6e}; largest pose shift per order (m) "
        + ", ".join(f"{x:.6e}" for x in r["shift_m"])
        + f"; max {max(r['shift_m']):.6e} m {max(r['shift_rad']):.6e} rad"
    )


def test_real_size_pyramid_order_shift():
    """The order of the moment sums alone moves the pose, by less than
    ORDER_SHIFT_BOUND_M: keys and counts stay, the moments and covariances
    move within chip_smoke.py's map tolerances."""
    torch.set_num_threads(1)
    r = order_shift(ORDER_TEST_ORDERS)
    print(order_summary(r))
    assert all(r["same_keys"])
    assert max(r["moment_rel"]) < chip_smoke.MAP_TOL, r["moment_rel"]
    assert max(r["cov_abs"]) < chip_smoke.COV_TOL, r["cov_abs"]
    assert max(r["shift_m"]) < ORDER_SHIFT_BOUND_M, r["shift_m"]
    assert max(r["shift_rad"]) < chip_smoke.PYRAMID_BOUND_RAD, r["shift_rad"]


def test_real_size_pyramid_matches_jax():
    torch.set_num_threads(1)
    r = compare_pyramid(PYRAMID_TEST_INITS)
    print(pyramid_summary(r))
    assert max(r["gap_m"]) < POSE_TOL_M, r["gap_m"]
    assert max(r["gap_rad"]) < POSE_TOL_RAD, r["gap_rad"]
    trans, rot = kept_pose_error(r)
    assert trans < KEPT_POSE_TOL and rot < KEPT_POSE_TOL, (trans, rot)


def test_real_size_cluster_pyramid_matches_jax():
    """The first init whose pose the order of the sums does not move
    (chip_smoke.CLUSTER_ORDER_SHIFT_M under STABLE_SHIFT_M)."""
    torch.set_num_threads(1)
    init = next(i for i, shift in enumerate(chip_smoke.CLUSTER_ORDER_SHIFT_M) if shift < STABLE_SHIFT_M)
    r = compare_cluster_pyramid([init])
    print(cluster_pyramid_summary(r))
    assert r["cells"] < r["capacity"] and r["dropped_points"] == 0
    assert max(r["gap_m"]) < POSE_TOL_M, r["gap_m"]
    assert max(r["gap_rad"]) < POSE_TOL_RAD, r["gap_rad"]
    trans, rot = _kept_gap(chip_smoke.CLUSTER_PYRAMID_JAX_POSES[init:init + 1], r["jax_poses"])
    assert trans < KEPT_POSE_TOL and rot < KEPT_POSE_TOL, (trans, rot)


def test_real_size_gicp_pair_matches_jax():
    """The first init of chip_smoke.py's two-scan GICP registration: the
    port's pose 1 within POSE_TOL of JAX's, and JAX's within KEPT_POSE_TOL
    of the one chip_smoke.py keeps."""
    torch.set_num_threads(1)
    r = compare_gicp_pairs([0], kinds=("gicp",))
    print(gicp_pair_summary(r))
    assert max(r["gicp"]["gap_m"]) < POSE_TOL_M and max(r["gicp"]["gap_rad"]) < POSE_TOL_RAD, r["gicp"]
    assert r["gicp"]["iters_jax"] == r["gicp"]["iters_torch"]
    trans, rot = _kept_gap(chip_smoke.GICP_PAIR_JAX_POSES["gicp"][:1], r["gicp"]["jax_poses"])
    assert trans < KEPT_POSE_TOL and rot < KEPT_POSE_TOL, (trans, rot)


def test_real_size_first_steps_match_jax():
    torch.set_num_threads(1)
    r = compare(TEST_STEPS, with_prior=True)
    print(summary(r))
    assert max(r["gap_m"]) < POSE_TOL_M, r["gap_m"]
    assert max(r["gap_rad"]) < POSE_TOL_RAD, r["gap_rad"]
    assert max(abs(a - b) for a, b in zip(r["iters_jax"], r["iters_torch"])) <= 1
    assert r["map_keys_equal"] and r["voxels_jax"] == r["voxels_torch"] > 0


def test_real_size_raycast_matches_jax():
    """Phase 40's rays, the whole sweep and the lattice rays: the port's
    coords and valid equal JAX's bit for bit, and JAX's digests, valid
    steps and input digest equal the ones chip_smoke.py keeps."""
    torch.set_num_threads(1)
    r = compare_raycast()
    assert r["sweep"]["rays"] == 127639 and r["sweep"]["input"] == chip_smoke.RAYCAST_INPUT_SHA256
    assert r["sweep"]["equal"] and r["lattice"]["equal"]
    assert r["sweep"]["digests"][:2] == [chip_smoke.RAYCAST_JAX_COORDS_SHA256, chip_smoke.RAYCAST_JAX_VALID_SHA256]
    assert r["sweep"]["steps"] == chip_smoke.RAYCAST_JAX_VALID_STEPS and r["sweep"]["unfinished"] == 0
    assert r["lattice"]["digests"][2] == chip_smoke.RAYCAST_LATTICE_JAX_SHA256 and r["lattice"]["unfinished"] == 0


def _parallel_demo_jax(d: dict, perm_seed=None) -> tuple:
    """Phase 36's distributed_mapping demo on the JAX package, 8 shards on
    8 devices, from the drive's demo scans `d` (chip_smoke.parallel_street);
    with `perm_seed`, both scans' points in another order.
    -> (pose 1 [4, 4], LM iterations)."""
    from jax.sharding import Mesh as JMesh

    from gtsam_points_tpu import parallel as jpar

    tgt, src = d["target"], d["source"]
    if perm_seed is not None:
        tgt, src = (a[np.random.RandomState(perm_seed + i).permutation(len(a))] for i, a in enumerate((tgt, src)))
    sample = jax.jit(lambda f: jvoxelgrid(f, chip_smoke.PAR_SAMPLE_LEAF, capacity=chip_smoke.PAR_SAMPLE_CAPACITY))
    target, source = (sample(jmake(a, capacity=chip_smoke.PAR_SCAN_CAPACITY)) for a in (tgt, src))
    mesh = JMesh(np.asarray(jax.devices()[:chip_smoke.PAR_RANKS]), ("shard",))
    svmap = jpar.place_sharded(jpar.build_sharded_voxelmap(target, chip_smoke.PAR_LEAF, chip_smoke.PAR_RANKS,
                                                           chip_smoke.PAR_DEMO_SHARD_CAPACITY), mesh)
    g = JGraph(num_poses=2)
    g.add(JPrior(prior=jax.numpy.eye(4), weights=jax.numpy.full((6,), chip_smoke.PAR_PRIOR_WEIGHT), key=0))
    g.add(jpar.make_vgicp_sharded_factor(0, 1, svmap, source, mesh, min_voxel_points=chip_smoke.PAR_DEMO_MIN_POINTS))
    start = np.stack([np.eye(4, dtype=np.float32), d["start"]])
    res = jax.jit(lambda p: jlm(g, p, JLMParams(max_iterations=chip_smoke.PAR_DEMO_ITERATIONS)))(start)
    return np.asarray(res.poses[1]), int(res.status.num_iterations)


def _parallel_batch_jax(perm_seed=None) -> tuple:
    """Phase 36's factor axis on the JAX package: optimize_lm_sharded of the
    8-factor batch over 8 devices; with `perm_seed`, every cloud's points in
    another order. -> (poses [8, 4, 4], LM iterations)."""
    from gtsam_points_tpu.parallel import make_mesh as jmesh
    from gtsam_points_tpu.parallel.distributed import optimize_lm_sharded, shard_factor_batch

    prob = chip_smoke.parallel_batch_problem()
    clouds = [prob["target"], *prob["sources"]]
    if perm_seed is not None:
        clouds = [a[np.random.RandomState(perm_seed + i).permutation(len(a))] for i, a in enumerate(clouds)]
    f = len(prob["sources"])
    vmap = jbuild(jmake(clouds[0]), leaf=chip_smoke.PAR_LEAF, capacity=chip_smoke.PAR_BATCH_MAP_CAPACITY)
    batch = jbatch([vmap] * f, [jmake(c) for c in clouds[1:]], [-1] * f, list(range(f)),
                   min_voxel_points=chip_smoke.PAR_BATCH_MIN_POINTS)
    mesh = jmesh(chip_smoke.PAR_RANKS, axis="factor")
    g = JGraph(num_poses=f)
    g.add(shard_factor_batch(batch, mesh, "factor"))
    res = optimize_lm_sharded(g, jax.numpy.tile(jax.numpy.eye(4)[None], (f, 1, 1)), mesh,
                              JLMParams(max_iterations=chip_smoke.PAR_BATCH_ITERATIONS))
    return np.asarray(res.poses), int(res.status.num_iterations)


def compare_parallel(n_orders: int) -> dict:
    """The JAX package's poses of phase 36's demo registration and factor
    axis, and with `n_orders` the largest shift of each pose over that many
    other point orders."""
    d = chip_smoke.parallel_street()["demo"]
    demo, demo_iters = _parallel_demo_jax(d)
    batch, batch_iters = _parallel_batch_jax()
    r = {"demo": demo, "demo_iters": demo_iters, "batch": batch, "batch_iters": batch_iters,
         "demo_truth": _max_gap(d["delta"], demo),
         "batch_truth": _max_gap(np.stack(chip_smoke.parallel_batch_problem()["T"]), batch),
         "demo_shift": [0.0, 0.0], "batch_shift_m": [0.0] * len(batch), "batch_shift_rad": [0.0] * len(batch)}
    for k in range(n_orders):
        p, _ = _parallel_demo_jax(d, perm_seed=100 * (k + 1))
        r["demo_shift"] = [max(a, b) for a, b in zip(r["demo_shift"], _max_gap(demo, p))]
        q, _ = _parallel_batch_jax(perm_seed=100 * (k + 1))
        rot, trans = tse3.pose_error(torch.from_numpy(batch), torch.from_numpy(q))
        r["batch_shift_m"] = [max(a, float(b)) for a, b in zip(r["batch_shift_m"], trans)]
        r["batch_shift_rad"] = [max(a, float(b)) for a, b in zip(r["batch_shift_rad"], rot)]
    return r


def jax_kitti07_api() -> dict:
    """chip_smoke.kitti07_protocol's names for the JAX package on the CPU,
    jitted as examples/kitti07_slam.py jits them, and FPFH and each GICP
    factor's hash grid jitted too (one program each in place of eager
    dispatch; the same poses)."""
    from gtsam_points_tpu.pipelines.odometry import OdometryParams, init_odometry, odometry_step
    from gtsam_points_tpu.registration import GNCParams, estimate_fpfh, estimate_pose_gnc
    from gtsam_points_tpu.utils import io
    from gtsam_points_tpu.utils.profiling import EasyProfiler

    preprocess = {}
    grid = jax.jit(jgrid, static_argnums=2)

    def pre(f, capacity):
        if capacity not in preprocess:
            preprocess[capacity] = jax.jit(lambda g: jfeatures(
                jvoxelgrid(g, chip_smoke.KITTI_SAMPLE_LEAF, capacity=capacity), k=chip_smoke.KITTI_KNN_K,
                grid_leaf=chip_smoke.KITTI_GRID_LEAF))
        return preprocess[capacity](f)

    return {
        "io": io, "EasyProfiler": EasyProfiler, "pose_from_xyzq": jse3.pose_from_xyzq, "se3_exp": jse3.se3_exp,
        "make_frame": lambda points, capacity: jmake(points, capacity=capacity), "preprocess": pre,
        "OdometryParams": OdometryParams, "init_odometry": init_odometry, "odometry_step": odometry_step,
        "estimate_fpfh": jax.jit(estimate_fpfh),
        "gnc": lambda t, s, ft, fs: jax.jit(lambda: estimate_pose_gnc(t, s, ft, fs, GNCParams()))(),
        "FactorGraph": JGraph, "PriorFactor": JPrior, "LMParams": JLMParams,
        "make_gicp_factor": lambda i, j, target, source, max_corr_dist, grid_leaf: jgicp(
            i, j, target, source, max_corr_dist=max_corr_dist, grid=grid(target.points, target.mask, grid_leaf)),
        "optimize_lm": lambda g, p, params: jax.jit(lambda q: jlm(g, q, params))(p),
        "arr": lambda x: jax.numpy.asarray(np.asarray(x, np.float32)), "host": np.asarray,
    }


def jax_endurance_api() -> dict:
    """chip_smoke.endurance_protocol's names for the JAX package on the CPU,
    the sharded insert jitted as tests/test_endurance_1000.py jits it, and
    the map build and each VGICP factor's voxel map jitted too (one program
    each, in place of eager dispatch)."""
    from gtsam_points_tpu.optim.isam2 import ISAM2Ext
    from gtsam_points_tpu.parallel import build_sharded_voxelmap, sharded_insert_frame
    from gtsam_points_tpu.utils.memory import nbytes
    from gtsam_points_tpu.utils.offload import OffloadPool

    vmap = jax.jit(jbuild, static_argnums=1)
    sharded = jax.jit(build_sharded_voxelmap, static_argnums=(1, 2, 3))
    return {
        "OffloadPool": OffloadPool, "nbytes": nbytes, "ISAM2Ext": ISAM2Ext, "LMParams": JLMParams,
        "PriorFactor": JPrior,
        "make_vgicp_factor": lambda i, j, target, source, voxel_resolution, min_voxel_points: jvgicp(
            i, j, vmap(target, voxel_resolution), source, min_voxel_points=min_voxel_points),
        "make_frame": lambda points, capacity: jmake(points, capacity=capacity),
        "build_sharded_voxelmap": sharded,
        "sharded_insert_frame": jax.jit(sharded_insert_frame),
        "arr": lambda x: jax.numpy.asarray(np.asarray(x, np.float32)), "host": np.asarray, "kw": {},
    }


def _pose_shift(a, b) -> tuple:
    """Per pose (m, rad) between two [P, 4, 4] numpy stacks."""
    rot, trans = tse3.pose_error(torch.from_numpy(np.array(a, np.float32)), torch.from_numpy(np.array(b, np.float32)))
    return trans.numpy(), rot.numpy()


def compare_kitti07(n_orders: int, port: bool = True) -> dict:
    """Phase 37's protocol on the drive's files at the example's size: the
    JAX package's poses, odometry, GNC and truth errors, the port's on the
    CPU beside them, and with `n_orders` the largest shift of each final JAX
    pose over that many other point orders of the scans."""
    import io as _io
    import tempfile

    drive = chip_smoke.kitti07_drive()
    out = _io.StringIO()
    with tempfile.TemporaryDirectory() as root:
        chip_smoke.write_kitti07(root, drive)
        j = chip_smoke.kitti07_protocol(jax_kitti07_api(), root, out=out)
        t = chip_smoke.kitti07_protocol(chip_smoke.port_kitti07_api(torch, "cpu"), root, out=out) if port else None
    r = {"jax": j, "torch": t, "shift_m": np.zeros(chip_smoke.KITTI_POSES),
         "shift_rad": np.zeros(chip_smoke.KITTI_POSES)}
    for k in range(n_orders):
        with tempfile.TemporaryDirectory() as root:
            chip_smoke.write_kitti07(root, drive, perm_seed=100 * (k + 1))
            q = chip_smoke.kitti07_protocol(jax_kitti07_api(), root, out=out)
        m, rad = _pose_shift(j["poses"], q["poses"])
        r["shift_m"], r["shift_rad"] = np.maximum(r["shift_m"], m), np.maximum(r["shift_rad"], rad)
    return r


def compare_bspline() -> dict:
    """Phase 39's protocol at the demo's size: the JAX package's fit, its
    pose at every sample and IMU at every IMU stamp, with the times of each
    (s, this CPU, JAX's compile included); the port's on the CPU beside it;
    the largest gaps between the two over every knot, sample and IMU stamp;
    how far JAX's own knots move when every input translation is scaled by
    (1 + 2^-23); and how far both packages' knots lie from the port's fit
    of the same inputs in float64."""
    import jax.numpy as jnp

    from gtsam_points_tpu.utils import bspline as jbs
    from gtsam_points_tpu_torch.utils import bspline as tbs

    d = chip_smoke.continuous_drive()
    t0, t1, dt = float(d["stamps"][0]), float(d["stamps"][-1]), chip_smoke.CONT_KNOT_INTERVAL
    r = {}
    for name, package in (("jax", (jbs, jnp.asarray)), ("torch", (tbs, torch.from_numpy))):
        mod, arr = package
        t = time.perf_counter()
        kw = {"device": "cpu"} if name == "torch" else {}
        traj = mod.fit_knots(arr(d["stamps"]), arr(d["poses"]), t0=t0, t1=t1, knot_interval=dt, **kw)
        knots = np.asarray(traj.knots)
        t_fit = time.perf_counter() - t
        t = time.perf_counter()
        pred = np.asarray(traj.pose(arr(d["stamps"])))
        t_pose = time.perf_counter() - t
        t = time.perf_counter()
        acc, gyro = traj.imu(arr(d["imu_stamps"]))
        imu = np.concatenate([np.asarray(acc), np.asarray(gyro)], -1)
        t_imu = time.perf_counter() - t
        err_m, err_rad = _pose_shift(d["poses"], pred)
        r[name] = {"knots": knots, "pred": pred, "imu": imu, "fit_error": (float(err_rad.max()), float(err_m.max())),
                   "s": (t_fit, t_pose, t_imu), "imu_err": np.abs(imu - d["imu_truth"])}
    # JAX's own fit with every input translation scaled by one float32 ulp
    scaled = np.array(d["poses"])
    scaled[:, :3, 3] *= np.float32(1 + 2**-23)
    ulp = jbs.fit_knots(jnp.asarray(d["stamps"]), jnp.asarray(scaled), t0=t0, t1=t1, knot_interval=dt)
    r["ulp_shift"] = [float(x.max()) for x in _pose_shift(r["jax"]["knots"], np.asarray(ulp.knots))]
    # a float64 witness: the port's banded fit of the same inputs in float64
    st, ps = torch.from_numpy(d["stamps"]).double(), torch.from_numpy(d["poses"]).double()
    K = tbs.ContinuousTrajectory.num_knots(t0, t1, dt)
    k64 = tbs._fit_knots_banded(st, ps, t0, dt, K, tbs._initial_knots(st, ps, t0, dt, K), 20, 1e-2)
    for name in ("jax", "torch"):
        rot, trans = tse3.pose_error(k64, torch.from_numpy(np.array(r[name]["knots"])).double())
        r[f"{name}_f64"] = [float(trans.max()), float(rot.max())]
    j, p = r["jax"], r["torch"]
    r["gap_knots"] = [float(x.max()) for x in _pose_shift(j["knots"], p["knots"])]
    r["gap_poses"] = [float(x.max()) for x in _pose_shift(j["pred"], p["pred"])]
    r["gap_imu"] = [float(np.abs(j["imu"] - p["imu"])[:, k].max()) for k in (slice(0, 3), slice(3, 6))]
    return r


def compare_raycast() -> dict:
    """Phase 40's rays through both packages' raycast_voxels on the CPU, the
    sweep and the lattice rays: JAX's digests (chip_smoke._digest, the
    sweep's coords and valid apart, the lattice's together), its valid
    steps and rays still emitting at the last step, the digest of the
    sweep's rays, whether the port's output equals JAX's bit for bit, and
    each package's seconds."""
    import jax.numpy as jnp

    from gtsam_points_tpu.utils.raycast import raycast_voxels as jray
    from gtsam_points_tpu_torch.utils.raycast import raycast_voxels as tray

    r = {}
    for name, rays, steps in (("sweep", chip_smoke.raycast_sweep(), chip_smoke.RAYCAST_STEPS),
                              ("lattice", chip_smoke.lattice_rays(), chip_smoke.LATTICE_STEPS)):
        t = time.perf_counter()
        jc, jv = (np.array(a) for a in jray(jnp.asarray(rays["origins"]), jnp.asarray(rays["targets"]),
                                               chip_smoke.RAYCAST_LEAF, steps))
        t_jax = time.perf_counter() - t
        t = time.perf_counter()
        tc, tv = tray(rays["origins"], rays["targets"], chip_smoke.RAYCAST_LEAF, steps, device="cpu")
        t_torch = time.perf_counter() - t
        out = [torch.from_numpy(jc), torch.from_numpy(jv)]
        r[name] = {"digests": [chip_smoke._digest(out[:1]), chip_smoke._digest(out[1:]), chip_smoke._digest(out)],
                   "input": chip_smoke._digest([torch.from_numpy(rays[k]) for k in ("origins", "targets")]),
                   "equal": bool(np.array_equal(jc, tc.numpy()) and np.array_equal(jv, tv.numpy())),
                   "rays": len(jc), "steps": int(jv.sum()), "unfinished": int(jv[:, -1].sum()), "s": (t_jax, t_torch)}
    return r


def _jacobian_factors(d: dict, covs: dict):
    """The demo's GICP factor in both packages on the same frames: the
    scans of `d` with the covariances `covs` ({"target", "source"})."""
    def frames(make, **kw):
        return [make(d[k], covs=covs[k], **kw) for k in ("target", "source")]

    return (jgicp(0, 1, *frames(jmake), max_corr_dist=chip_smoke.JACOBIAN_MAX_CORR),
            tgicp(0, 1, *frames(tmake, device="cpu"), max_corr_dist=chip_smoke.JACOBIAN_MAX_CORR))


def compare_jacobian() -> dict:
    """Phase 41's demo on the CPU. JAX's check_factor_jacobian of GICP at
    the truth pose on frames with chip_smoke.plain_covariances (its -2 b,
    numeric gradients and error, the constants) and the port's on the same
    frames beside it (-2 b over max|ref|, the numeric gradients in
    quanta); then, on JAX's own estimate_normals_covs(k=10, grid_leaf=1.0),
    its -2 b at the truth (constants too), the port's own features beside
    it (the share of points whose smallest two eigenvalues lie within 1e-2
    of the largest, the share whose covariances part by more than 1e-4,
    the port's -2 b against JAX's), and JAX's check at the truth, the start
    (delta Exp(PAR_DEMO_XI)) and halfway between: passed, or the mismatch
    it raised."""
    from gtsam_points_tpu.utils.jacobian_test import check_factor_jacobian as jcheck
    from gtsam_points_tpu_torch.utils.jacobian_test import check_factor_jacobian as tcheck

    d = chip_smoke.street_demo(*chip_smoke.street_draws())
    truth = np.stack([np.eye(4, dtype=np.float32), d["delta"]])
    jf, tf = _jacobian_factors(d, {k: chip_smoke.plain_covariances(d[k]) for k in ("target", "source")})
    t = time.perf_counter()
    jg = jcheck(jf, truth)
    t_jax = time.perf_counter() - t
    t = time.perf_counter()
    tg = tcheck(tf, truth)
    t_torch = time.perf_counter() - t
    jl, tl = jf.linearize(jax.numpy.asarray(truth)), tf.linearize(torch.from_numpy(truth))
    ref = {"error": float(jl.error), **{f"b_{k}": -2.0 * np.asarray(getattr(jl, f"b_{k[0]}"), np.float64)
                                         for k in ("source", "target")},
           **{f"g_{k}": jg[k] for k in jg}}
    quantum = chip_smoke.gradient_quantum(max(float(jl.error), float(tl.error)))
    r = {"jax": ref, "s": (t_jax, t_torch), "quantum": quantum, "error_torch": float(tl.error),
         "b_gap": chip_smoke._gap(chip_smoke._minus_2b(tl), ref, "b_"),
         "g_quanta": max(float(np.abs(tg[k] - jg[k]).max()) for k in jg) / quantum, "own": {}}
    own = [jfeatures(jmake(d[k]), k=chip_smoke.JACOBIAN_K, grid_leaf=1.0) for k in ("target", "source")]
    jf_own = jgicp(0, 1, *own, max_corr_dist=chip_smoke.JACOBIAN_MAX_CORR)
    own_lin = jf_own.linearize(jax.numpy.asarray(truth))
    ref.update({f"own_b_{k}": -2.0 * np.asarray(getattr(own_lin, f"b_{k[0]}"), np.float64) for k in ("source", "target")})
    # the port's own kNN features beside JAX's: where their covariances part, and what that does to -2 b
    t_own, r["near_ties"], r["covs_differ"] = [], [], []
    for k, jframe in zip(("target", "source"), own):
        n = len(d[k])
        t_own.append(tfeatures(tmake(d[k], device="cpu"), k=chip_smoke.JACOBIAN_K, grid_leaf=1.0))
        raw = tfeatures(tmake(d[k], device="cpu"), k=chip_smoke.JACOBIAN_K, grid_leaf=1.0, regularization="none")
        w = np.linalg.eigvalsh(raw.covs.numpy()[:n].astype(np.float64))
        r["near_ties"].append(float(np.mean((w[:, 1] - w[:, 0]) / w[:, 2] < 1e-2)))
        gap = np.abs(np.asarray(jframe.covs)[:n] - t_own[-1].covs.numpy()[:n]).reshape(n, -1).max(1)
        r["covs_differ"].append(float(np.mean(gap > 1e-4)))
    tb_own = chip_smoke._minus_2b(tgicp(0, 1, *t_own, max_corr_dist=chip_smoke.JACOBIAN_MAX_CORR).linearize(
        torch.from_numpy(truth)))
    r["own_b_gap"] = chip_smoke._gap(tb_own, ref, "own_b_")
    r["own_b_component"] = max(float(np.max(np.abs(tb_own[k] - ref[f"own_b_{k}"]) / np.abs(ref[f"own_b_{k}"])))
                               for k in tb_own)
    half = (d["delta"] @ chip_smoke.se3_exp_np(0.5 * np.asarray(chip_smoke.PAR_DEMO_XI, np.float32))).astype(np.float32)
    for name, T in (("truth", d["delta"]), ("halfway", half), ("start", d["start"])):
        poses = np.stack([np.eye(4, dtype=np.float32), T])
        try:
            jcheck(jf_own, poses)
            r["own"][name] = "passed"
        except AssertionError as e:
            r["own"][name] = " ".join(str(e).split())
        r["own"][name] += f"; E {float(jf_own.error(jax.numpy.asarray(poses)))!r}"
    return r


def compare_endurance(n_poses: int, n_orders: int, port: bool = False) -> dict:
    """Phase 38's session on the JAX package at `n_poses` poses (every
    ENDURANCE_SAMPLE-th pose, the ATE, the relaxes and spills), with
    `port` the port's on the CPU beside it, and with `n_orders` the largest
    shift of each sampled JAX pose over that many other point orders."""
    j = chip_smoke.endurance_protocol(jax_endurance_api(), n_poses)
    t = chip_smoke.endurance_protocol(chip_smoke.port_endurance_api(torch, "cpu"), n_poses) if port else None
    sample = list(range(0, n_poses, chip_smoke.ENDURANCE_SAMPLE))
    r = {"jax": j, "torch": t, "sample": sample, "shift_m": np.zeros(len(sample)), "shift_rad": np.zeros(len(sample))}
    for k in range(n_orders):
        q = chip_smoke.endurance_protocol(jax_endurance_api(), n_poses, perm_seed=100 * (k + 1))
        m, rad = _pose_shift(j["est"][sample], q["est"][sample])
        r["shift_m"], r["shift_rad"] = np.maximum(r["shift_m"], m), np.maximum(r["shift_rad"], rad)
    return r


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=24, help="odometry steps (0: no odometry run)")
    parser.add_argument("--inits", type=int, default=PYRAMID_INITS, help="pyramid inits (0: no pyramid run)")
    parser.add_argument("--orders", type=int, default=ORDERS,
                        help="other point orders of the target for the pyramid's order shift (0: none)")
    parser.add_argument("--odometry-orders", type=int, default=0,
                        help="other point orders of every scan for the JAX odometry's order shift (0: none)")
    parser.add_argument("--cluster-inits", type=int, default=0,
                        help="cluster pyramid inits, both packages (0: no cluster pyramid run)")
    parser.add_argument("--cluster-steps", type=int, default=0,
                        help="cluster odometry steps with the motion prior, both packages (0: none)")
    parser.add_argument("--cluster-orders", type=int, default=0,
                        help="other point orders of both scans for the JAX cluster pyramid's order shift, "
                             "over --cluster-inits inits (0: none)")
    parser.add_argument("--gicp-pairs", type=int, default=0,
                        help="two-scan GICP / ICP / ICP point-to-plane registrations from this many inits, both "
                             "packages (0: none)")
    parser.add_argument("--gicp-steps", type=int, default=0,
                        help="GICP frame-to-frame steps, both packages (0: none)")
    parser.add_argument("--gicp-orders", type=int, default=0,
                        help="other point orders of the scans for the JAX two-scan registrations' and "
                             "frame-to-frame steps' order shift, over --gicp-pairs inits and --gicp-steps "
                             "steps (0: none)")
    parser.add_argument("--graph-poses", type=int, default=0,
                        help="phase 23's chain graph over this many scans, both packages: GICP LM, VGICP LM, GN "
                             "and Dogleg, the VGICP batch LM (0: none)")
    parser.add_argument("--pose-graph", type=int, default=0,
                        help="phase 24's block-sparse pose graph of this many poses, both packages (0: none)")
    parser.add_argument("--graph-orders", type=int, default=0,
                        help="other point orders of the scans (--graph-poses) and other edge orders (--pose-graph) "
                             "for the JAX package's order shift (0: none)")
    parser.add_argument("--graph-order-runs", default=",".join(chip_smoke.GRAPH_RUNS),
                        help="the runs of phase 23 that --graph-orders repeats, comma-separated")
    parser.add_argument("--graph-order-package", choices=("jax", "torch"), default="jax",
                        help="the package that runs the other orders of --graph-orders (the shift is taken "
                             "against the JAX package's run in the scans' own order)")
    parser.add_argument("--isam2", type=int, default=0,
                        help="phases 26-27's ISAM2 and fixed-lag streams over this many scans, both packages (0: none)")
    parser.add_argument("--isam2-orders", type=int, default=0,
                        help="other point orders of the scans for the JAX streams' order shift (0: none)")
    parser.add_argument("--gnc", type=int, default=0,
                        help="phase 25's FPFH and GNC between scan 0 and scan N - 1 of N scans, and between "
                             "chip_smoke.GNC_NEAR_PAIR, both packages (0: none)")
    parser.add_argument("--gnc-orders", type=int, default=0,
                        help="other point orders of the scans for the JAX GNC pose's order shift (0: none)")
    parser.add_argument("--ransac", type=int, default=0,
                        help="phase 28's RANSAC and GICP refines between scan 0 and scan N - 1 of N scans and "
                             "between chip_smoke.GNC_NEAR_PAIR, both packages (0: none)")
    parser.add_argument("--ransac-orders", type=int, default=0,
                        help="other point orders of the scans for the JAX refines' order shift (0: none)")
    parser.add_argument("--loam", action="store_true", help="phase 29's LOAM pair, both packages")
    parser.add_argument("--ct-icp", action="store_true", help="phase 29's CT-ICP in its three modes, both packages")
    parser.add_argument("--scan-orders", type=int, default=0,
                        help="other point orders of the clouds for the JAX LOAM and CT-ICP poses' order shift")
    parser.add_argument("--ba", action="store_true", help="phase 30's bundle adjustment, EVM and LSQ, both packages")
    parser.add_argument("--ba-orders", type=int, default=0,
                        help="other point orders of the features for the JAX BA poses' order shift (0: none)")
    parser.add_argument("--colored", action="store_true",
                        help="phase 32's colored registrations (GICP, ColoredGICP, color consistency + GICP, "
                             "the voxel-map surface), both packages")
    parser.add_argument("--colored-orders", type=int, default=0,
                        help="with --colored: the JAX package again with each cloud's points in this many orders")
    parser.add_argument("--imu", action="store_true", help="phase 33's IMU keyframe chain, both packages")
    parser.add_argument("--sim3", action="store_true", help="phase 33's Sim(3) alignment, both packages")
    parser.add_argument("--segmentation", action="store_true",
                        help="phase 35's region growing and min-cut on phase 4's scan 0, both packages")
    parser.add_argument("--parallel", action="store_true",
                        help="phase 36's demo registration on the 8-shard map and its factor-axis LM, the JAX "
                             "package on 8 virtual CPU devices")
    parser.add_argument("--parallel-orders", type=int, default=0,
                        help="with --parallel: the JAX package again with the points in this many other orders")
    parser.add_argument("--kitti07", action="store_true",
                        help="phase 37's kitti07_slam protocol on the drive's files, both packages")
    parser.add_argument("--kitti07-orders", type=int, default=0,
                        help="with --kitti07: the JAX package again with each scan's points in this many orders")
    parser.add_argument("--endurance", type=int, default=0,
                        help="phase 38's endurance session cut to this many poses, the JAX package (0: none)")
    parser.add_argument("--endurance-orders", type=int, default=0,
                        help="with --endurance: the JAX package again with each scan's points in this many orders")
    parser.add_argument("--endurance-port", action="store_true",
                        help="with --endurance: the port on the CPU beside it")
    parser.add_argument("--bspline", action="store_true",
                        help="phase 39's demo_continuous_trajectory protocol at the demo's size, both packages")
    parser.add_argument("--raycast", action="store_true", help="phase 40's rays, both packages' raycast_voxels")
    parser.add_argument("--jacobian", action="store_true",
                        help="phase 41's demo GICP factor, both packages' check_factor_jacobian")
    parser.add_argument("--out", help="write the report as JSON here")
    args = parser.parse_args()
    torch.set_num_threads(4)
    report = []
    for with_prior in (True, False) if args.steps else ():
        r = compare(args.steps, with_prior)
        print(summary(r), flush=True)
        report.append(r)
    if args.inits:
        r = compare_pyramid(args.inits)
        print(pyramid_summary(r), flush=True)
        _print_kept("PYRAMID_JAX_POSES", r["jax_poses"])
        report.append(r)
    if args.orders:
        r = order_shift(args.orders)
        print(order_summary(r), flush=True)
        report.append(r)
    if args.cluster_inits:
        r = compare_cluster_pyramid(range(args.cluster_inits))
        print(cluster_pyramid_summary(r), flush=True)
        _print_kept("CLUSTER_PYRAMID_JAX_POSES", r["jax_poses"])
        report.append(r)
    if args.cluster_orders:
        r = cluster_order_shift(args.cluster_inits, args.cluster_orders)
        print(cluster_order_summary(r), flush=True)
        _print_shifts(r)
        report.append(r)
    if args.cluster_steps:
        r = compare_cluster_odometry(args.cluster_steps)
        print(cluster_odometry_summary(r), flush=True)
        report.append(r)
    if args.gicp_pairs:
        r = compare_gicp_pairs(range(args.gicp_pairs))
        print(gicp_pair_summary(r), flush=True)
        print("JAX poses 1 (top three rows, row-major), as chip_smoke.GICP_PAIR_JAX_POSES:")
        for kind in chip_smoke.GICP_KINDS:
            print(f'    "{kind}": [')
            for p in r[kind]["jax_poses"]:
                print("        [" + ", ".join(np.format_float_positional(np.float32(x), unique=True) for x in p) + "],")
            print("    ],", flush=True)
        report.append(r)
    if args.gicp_steps:
        r = compare_gicp_steps(args.gicp_steps)
        print(gicp_step_summary(r), flush=True)
        _print_kept("GICP_STEP_JAX_DELTAS", r["jax_deltas"])
        report.append(r)
    if args.gicp_orders and args.gicp_pairs:
        r = gicp_pair_order_shift(args.gicp_pairs, args.gicp_orders)
        print(gicp_order_summary(r, chip_smoke.GICP_KINDS), flush=True)
        _print_gicp_shifts(r, "GICP_PAIR_ORDER_SHIFT", chip_smoke.GICP_KINDS)
        report.append(r)
    if args.gicp_orders and args.gicp_steps:
        r = gicp_step_order_shift(args.gicp_steps, args.gicp_orders)
        print(gicp_order_summary(r, ["steps"]), flush=True)
        _print_gicp_shifts(r, "GICP_STEP_ORDER_SHIFT", ["steps"])
        report.append(r)
    if args.graph_poses:
        r = compare_graph(args.graph_poses)
        print(graph_summary(r), flush=True)
        _print_rows("GRAPH_JAX_POSES", {run: r[run]["jax_poses"] for run in chip_smoke.GRAPH_RUNS})
        print("GRAPH_JAX_ERRORS = {" + ", ".join(f'"{run}": {r[run]["error_jax"]!r}' for run in chip_smoke.GRAPH_RUNS)
              + "}", flush=True)
        print("GRAPH_JAX_ITERATIONS = {" + ", ".join(f'"{run}": {r[run]["iters_jax"]}' for run in chip_smoke.GRAPH_RUNS)
              + "}", flush=True)
        print("GRAPH_JAX_TRUTH = {" + ", ".join(f'"{run}": ({r[run]["truth_jax"][0]:.6f}, {r[run]["truth_jax"][1]:.6f})'
                                               for run in chip_smoke.GRAPH_RUNS) + "}", flush=True)
        report.append(r)
    if args.graph_orders and args.graph_poses:
        runs = args.graph_order_runs.split(",")
        r = graph_order_shift(args.graph_poses, args.graph_orders, runs, args.graph_order_package)
        print(graph_order_iterations(r, runs), flush=True)
        if args.graph_order_package == "jax":
            print(gicp_order_summary(r, runs), flush=True)
            _print_gicp_shifts(r, "GRAPH_ORDER_SHIFT", runs)
        report.append(r)
    if args.pose_graph:
        r = compare_pose_graph(args.pose_graph)
        print(pose_graph_summary(r), flush=True)
        _print_kept("PG_JAX_POSES", r["jax_poses"])
        print(f"PG_JAX_ERROR = {r['error_jax']!r}\nPG_JAX_ITERATIONS = {r['iters_jax']}", flush=True)
        report.append(r)
    if args.graph_orders and args.pose_graph:
        r = pose_graph_order_shift(args.pose_graph, args.graph_orders)
        print(gicp_order_summary(r, ["pose_graph"]), flush=True)
        _print_gicp_shifts(r, "PG_ORDER_SHIFT", ["pose_graph"])
        report.append(r)
    if args.isam2:
        r = compare_isam2(args.isam2)
        print(isam2_summary(r), flush=True)
        _print_stream("ISAM2_JAX", r["isam2"])
        if _same_but_compiled(r["fixed_lag"], r["isam2"]):
            print(f'FIXED_LAG_JAX = {{**ISAM2_JAX, "compiled": {r["fixed_lag"]["jax"]["compiled"]!r}}}', flush=True)
        else:
            _print_stream("FIXED_LAG_JAX", r["fixed_lag"])
        report.append(r)
    if args.isam2_orders and args.isam2:
        r = isam2_order_shift(args.isam2, args.isam2_orders)
        for unit in ("m", "rad"):
            worst = np.asarray(r["isam2"][f"shift_{unit}"]).max(0)
            print(f"ISAM2_ORDER_SHIFT_{unit.upper()} = [" + ", ".join(f"{x:.3e}" for x in worst) + "]", flush=True)
            lag = np.asarray(r["fixed_lag"][f"shift_{unit}"]).max(0)
            # phase 27 holds the smoother to the window's order shifts
            print(f"fixed-lag order shift ({unit}) " + ("equal to the window's" if np.array_equal(lag, worst) else
                  "[" + ", ".join(f"{x:.3e}" for x in lag) + "]"), flush=True)
        report.append(r)
    # phase 25's far pair (scan 0 and the last) and its near pair
    for name, pair in (("GNC", (0, args.gnc - 1)), ("GNC_NEAR", chip_smoke.GNC_NEAR_PAIR)) if args.gnc else ():
        r = compare_gnc(args.gnc, pair)
        print(f"GNC, scan {pair[0]} <- scan {pair[1]}: port against JAX {r['gap_m']:.6e} m {r['gap_rad']:.6e} rad; "
              f"inlier rate jax {r['inlier_jax']:.6f} port {r['inlier_torch']:.6f}; against the truth jax "
              f"{r['truth_jax']} port {r['truth_torch']}", flush=True)
        print(f"{name}_JAX_POSE = [" + ", ".join(np.format_float_positional(np.float32(x), unique=True)
                                                  for x in r["jax_pose"]) + "]")
        print(f"{name}_JAX_INLIER = {r['inlier_jax']!r}", flush=True)
        report.append(r)
        if args.gnc_orders:
            r = gnc_order_shift(args.gnc, pair, args.gnc_orders)
            print(f"{name}_ORDER_SHIFT_M = {max(r['shift_m']):.3e}\n{name}_ORDER_SHIFT_RAD = "
                  f"{max(r['shift_rad']):.3e} (per order {r['shift_m']})", flush=True)
            report.append(r)
    # phase 28: RANSAC, then the refine from the port's RANSAC pose and from JAX's GNC pose
    for name, pair, gnc in ((("FAR", (0, args.ransac - 1), chip_smoke.GNC_JAX_POSE),
                             ("NEAR", chip_smoke.GNC_NEAR_PAIR, chip_smoke.GNC_NEAR_JAX_POSE))
                            if args.ransac else ()):
        gnc_T = np.concatenate([np.asarray(gnc, np.float32).reshape(3, 4), [[0, 0, 0, 1]]]).astype(np.float32)
        r = compare_global(args.ransac, pair, {"ransac": None, "gnc": gnc_T})
        (jT, jr), (tT, tr) = r["ransac_jax"], r["ransac_torch"]
        print(f"RANSAC, scan {pair[0]} <- scan {pair[1]}: inlier rate jax {jr:.6f} (own draws) port {tr:.6f} "
              f"(generator), against the truth {r['ransac_truth']}; refines port against JAX: " + ", ".join(
                  f"{k} {r[f'refine_{k}_gap'][0]:.3e} m {r[f'refine_{k}_gap'][1]:.3e} rad (iterations "
                  f"{r[f'refine_{k}_jax'][1]}, {r[f'refine_{k}_torch'][1]}; JAX against the truth "
                  f"{r[f'refine_{k}_truth_jax']})" for k in r["starts"]), flush=True)
        print(f"RANSAC_{name}_JAX_POSE = {_rows(jT)}\nRANSAC_{name}_JAX_INLIER = {jr!r}")
        print(f"RANSAC_{name}_START = {_rows(tT)}\nRANSAC_{name}_START_INLIER = {tr!r}")
        for k in r["starts"]:
            print(f"REFINE_{name}_JAX_POSES[{k!r}] = {_rows(r[f'refine_{k}_jax'][0])}", flush=True)
        if args.ransac_orders:
            shift = global_order_shift(args.ransac, pair, r["starts"], args.ransac_orders)
            print(f"REFINE_{name}_ORDER_SHIFT = {shift!r}", flush=True)
        report.append({k: (v[0].tolist(), v[1]) if isinstance(v, tuple) and isinstance(v[0], np.ndarray) else v
                       for k, v in r.items() if k != "starts"})
    if args.loam or args.ct_icp:
        r = compare_scan_factors(args.scan_orders, args.loam, args.ct_icp)
        for k, v in r.items():
            print(f"{k}: port against JAX {v['gap'][0]:.3e} m {v['gap'][1]:.3e} rad, iterations {v['iters']}, "
                  f"order shift {v['shift']}" + (f", JAX against the truth {v['truth_jax']}, port {v['truth_torch']}"
                                                 if "truth_jax" in v else f", deskew gap {v['deskew_gap']:.3e} m"),
                  flush=True)
            print(f"SCAN_JAX_POSES[{k!r}] = {_rows(v['jax'])}\nSCAN_ORDER_SHIFT[{k!r}] = {v['shift']!r}", flush=True)
        report.append({k: {n: (x.tolist() if isinstance(x, np.ndarray) else x) for n, x in v.items()}
                       for k, v in r.items()})
    if args.ba:
        r = compare_ba(args.ba_orders)
        print(f"BA features {r['features']}", flush=True)
        for mode in ("evm", "lsq"):
            v = r[mode]
            print(f"BA {mode}: port against JAX {v['gap'][0]:.3e} m {v['gap'][1]:.3e} rad, iterations {v['iters']}, "
                  f"order shift {v['shift']}, against the truth JAX {v['truth_jax']} port {v['truth_torch']}",
                  flush=True)
            print(f"BA_JAX_POSES[{mode!r}] = {_rows(v['jax'])}\nBA_ORDER_SHIFT[{mode!r}] = {v['shift']!r}", flush=True)
        report.append({m: {n: (x.tolist() if isinstance(x, np.ndarray) else x) for n, x in v.items()}
                       if isinstance(v, dict) else v for m, v in r.items()})
    if args.colored:
        r = compare_colored(args.colored_orders)
        for k, v in r.items():
            print(f"colored {k}: port against JAX {v['gap'][0]:.3e} m {v['gap'][1]:.3e} rad, iterations {v['iters']}, "
                  f"order shift {v['shift']}, against the truth JAX {v['truth_jax']} port {v['truth_torch']}",
                  flush=True)
            print(f"COLORED_JAX_POSES[{k!r}] = {_rows(v['jax'])}\nCOLORED_ORDER_SHIFT[{k!r}] = {v['shift']!r}",
                  flush=True)
        report.append({k: {n: (x.tolist() if isinstance(x, np.ndarray) else x) for n, x in v.items()}
                       for k, v in r.items()})
    if args.imu or args.sim3:
        r = compare_imu_sim3(args.imu, args.sim3)
        if "imu" in r:
            v = r["imu"]
            print(f"IMU chain: port against JAX {v['gap'][0]:.3e} m {v['gap'][1]:.3e} rad, iterations {v['iters']}, "
                  f"against the truth JAX {v['truth_jax']} port {v['truth_torch']}; chained predict port against "
                  f"JAX {v['predict_gap']:.3e} m, JAX's against the truth {v['predict_truth']}", flush=True)
            print(f"IMU_JAX_POSES = {_rows(v['jax'])}\nIMU_JAX_PREDICT = {_rows(v['predict_jax'])}", flush=True)
        if "sim3" in r:
            v = r["sim3"]
            print(f"Sim(3): port against JAX {v['gap'][0]:.3e} m {v['gap'][1]:.3e} rad, scale JAX {v['scale']!r} "
                  f"port {v['scale_torch']!r}; JAX's pose against S {v['truth']}", flush=True)
            print(f"SIM3_JAX = {{'pose': {_rows(v['jax'])}, 'scale': {v['scale']!r}}}", flush=True)
        report.append({k: {n: (x.tolist() if isinstance(x, np.ndarray) else x) for n, x in v.items()}
                       for k, v in r.items()})
    if args.segmentation:
        r = compare_segmentation()
        print(f"segmentation sizes: JAX {r['jax']} port {r['torch']}", flush=True)
        print(f"SEG_JAX = {r['jax']!r}", flush=True)
        report.append(r)
    if args.parallel:
        r = compare_parallel(args.parallel_orders)
        print(f"parallel demo: JAX {r['demo_iters']} iterations, against the truth {r['demo_truth']}; factor axis: "
              f"{r['batch_iters']} iterations, against the truth {r['batch_truth']}", flush=True)
        print(f"PAR_DEMO_JAX_POSE = {_rows(r['demo'])}\nPAR_DEMO_JAX_ITERATIONS = {r['demo_iters']}\n"
              f"PAR_DEMO_ORDER_SHIFT = [{r['demo_shift'][0]:.3e}, {r['demo_shift'][1]:.3e}]\n"
              f"PAR_BATCH_JAX_POSES = {_rows(r['batch'])}\nPAR_BATCH_JAX_ITERATIONS = {r['batch_iters']}\n"
              "PAR_BATCH_ORDER_SHIFT_M = [" + ", ".join(f"{x:.3e}" for x in r["batch_shift_m"]) + "]\n"
              "PAR_BATCH_ORDER_SHIFT_RAD = [" + ", ".join(f"{x:.3e}" for x in r["batch_shift_rad"]) + "]",
              flush=True)
        report.append({k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in r.items()})
    if args.kitti07:
        r = compare_kitti07(args.kitti07_orders)
        j, t = r["jax"], r["torch"]
        gap_m, gap_rad = _pose_shift(j["poses"], t["poses"])
        print(f"kitti07: port against JAX {gap_m.max():.3e} m {gap_rad.max():.3e} rad; odometry iterations JAX "
              f"{j['odo_iters']} port {t['odo_iters']}, graph JAX {j['graph_iters']} port {t['graph_iters']}; "
              f"against the truth JAX {chip_smoke.kitti07_truth(j['T_gt'], j['poses'])} port "
              f"{chip_smoke.kitti07_truth(t['T_gt'], t['poses'])}; GNC inlier rate JAX {j['lc_inlier']:.6f} port "
              f"{t['lc_inlier']:.6f}", flush=True)
        truth = chip_smoke.kitti07_truth(j["T_gt"], j["poses"])
        print(f"KITTI_JAX_POSES = {_rows(j['poses'])}\nKITTI_JAX_ODO_ITERS = {j['odo_iters']}\n"
              f"KITTI_JAX_GRAPH_ITERS = {j['graph_iters']}\nKITTI_JAX_INLIER = {j['lc_inlier']!r}\n"
              f"KITTI_JAX_TRUTH = ({truth[0]:.6f}, {truth[1]:.6f})\n"
              "KITTI_ORDER_SHIFT_M = [" + ", ".join(f"{x:.3e}" for x in r["shift_m"]) + "]\n"
              "KITTI_ORDER_SHIFT_RAD = [" + ", ".join(f"{x:.3e}" for x in r["shift_rad"]) + "]", flush=True)
        report.append({"gap_m": gap_m.tolist(), "gap_rad": gap_rad.tolist(), "shift_m": r["shift_m"].tolist()})
    if args.endurance:
        r = compare_endurance(args.endurance, args.endurance_orders, args.endurance_port)
        j = r["jax"]
        ate = chip_smoke.endurance_ate(j["T_true"], j["est"])
        print(f"endurance {args.endurance} poses, closures {chip_smoke.ENDURANCE_LOOPS}: JAX ATE {ate[0]:.6f} rad {ate[1]:.6f} m, "
              f"relaxes {j['relaxes']}, reloads {j['reloads']}, spilled {j['spilled']}, update ms median "
              f"{np.median(j['update_ms']):.3f}", flush=True)
        if r["torch"] is not None:
            gap_m, gap_rad = _pose_shift(j["est"][r["sample"]], r["torch"]["est"][r["sample"]])
            print(f"endurance: port against JAX {gap_m.max():.3e} m {gap_rad.max():.3e} rad (per sampled pose "
                  f"{gap_m.tolist()})", flush=True)
        print(f"ENDURANCE_JAX_POSES = {_rows(j['est'][r['sample']])}\nENDURANCE_JAX_ATE = ({ate[0]:.6f}, {ate[1]:.6f})\n"
              "ENDURANCE_ORDER_SHIFT_M = [" + ", ".join(f"{x:.3e}" for x in r["shift_m"]) + "]\n"
              "ENDURANCE_ORDER_SHIFT_RAD = [" + ", ".join(f"{x:.3e}" for x in r["shift_rad"]) + "]", flush=True)
        report.append({"ate": ate, "shift_m": r["shift_m"].tolist()})
    if args.bspline:
        r = compare_bspline()
        j, p = r["jax"], r["torch"]
        for name in ("jax", "torch"):
            e = r[name]["imu_err"]
            print(f"bspline {name}: fit, pose, imu {[round(x, 3) for x in r[name]['s']]} s; K {len(r[name]['knots'])}; "
                  f"fit error {r[name]['fit_error']} (rad, m); IMU against the walk's acc p50 "
                  f"{np.median(e[:, :3]):.4f} p99 {np.quantile(e[:, :3], 0.99):.4f} m/s^2, gyro p50 "
                  f"{np.median(e[:, 3:]):.5f} p99 {np.quantile(e[:, 3:], 0.99):.5f} rad/s", flush=True)
        print(f"bspline: port against JAX knots {r['gap_knots']} (m, rad), fitted poses {r['gap_poses']}, IMU "
              f"{r['gap_imu']} (acc m/s^2, gyro rad/s); JAX's knots moved {r['ulp_shift']} (m, rad) by one ulp of "
              f"every input translation; from the port's float64 fit: JAX's knots {r['jax_f64']}, the port's "
              f"{r['torch_f64']} (m, rad)", flush=True)
        k, n = chip_smoke.CONT_SAMPLE, chip_smoke.CONT_IMU_SAMPLE
        print(f"CONT_JAX_KNOTS = {_rows(j['knots'][::k])}\nCONT_JAX_POSES = {_rows(j['pred'][::k])}\n"
              "CONT_JAX_IMU = [" + ", ".join("[" + ", ".join(np.format_float_positional(np.float32(x), unique=True)
                                                            for x in row) + "]" for row in j["imu"][::n]) + "]\n"
              f"CONT_JAX_FIT_ERROR = ({j['fit_error'][0]!r}, {j['fit_error'][1]!r})", flush=True)
        report.append({k: r[k] for k in ("gap_knots", "gap_poses", "gap_imu", "ulp_shift", "jax_f64", "torch_f64")})
    if args.raycast:
        r = compare_raycast()
        for name, x in r.items():
            print(f"raycast {name}: {x['rays']} rays, JAX {x['s'][0]:.2f} s, the port {x['s'][1]:.2f} s, equal bit for bit "
                  f"{x['equal']}; valid steps {x['steps']}, still emitting at the last step {x['unfinished']}", flush=True)
        print(f"RAYCAST_INPUT_SHA256 = {r['sweep']['input']!r}\nRAYCAST_JAX_COORDS_SHA256 = {r['sweep']['digests'][0]!r}\n"
              f"RAYCAST_JAX_VALID_SHA256 = {r['sweep']['digests'][1]!r}\nRAYCAST_JAX_VALID_STEPS = {r['sweep']['steps']}\n"
              f"RAYCAST_LATTICE_JAX_SHA256 = {r['lattice']['digests'][2]!r}", flush=True)
        report.append(r)
    if args.jacobian:
        r = compare_jacobian()
        print(f"jacobian demo at the truth: JAX {r['s'][0]:.2f} s, the port {r['s'][1]:.2f} s; E JAX {r['jax']['error']!r} "
              f"the port {r['error_torch']!r}; the port's -2 b against JAX's {r['b_gap']:.3e} x max|ref|, numeric "
              f"gradients {r['g_quanta']:.1f} quanta of {r['quantum']!r}", flush=True)
        print(f"jacobian kNN features (k = {chip_smoke.JACOBIAN_K}) of the target and the source: the smallest two "
              f"eigenvalues within 1e-2 of the largest at {r['near_ties']} of the points, the two packages' "
              f"covariances more than 1e-4 apart at {r['covs_differ']}; on each package's own features the port's -2 b "
              f"at the truth lies {r['own_b_gap']:.3e} x max|ref| from JAX's, {r['own_b_component']:.3e} of one "
              f"component at most", flush=True)
        for name, text in r["own"].items():
            print(f"jacobian JAX on its own kNN features at the {name}: {text}", flush=True)
        print("JACOBIAN_JAX = {" + ", ".join(
            f"{k!r}: {v!r}" if k == "error" else f"{k!r}: [" + ", ".join(repr(float(x)) for x in v) + "]"
            for k, v in r["jax"].items()) + "}", flush=True)
        report.append({k: r[k] for k in ("b_gap", "g_quanta", "quantum", "own", "near_ties", "covs_differ", "own_b_gap",
                                         "own_b_component")})
    if args.odometry_orders:
        r = odometry_order_shift(args.steps, args.odometry_orders)
        print(odometry_order_summary(r), flush=True)
        report.append(r)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
