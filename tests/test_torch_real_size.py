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

import jax  # noqa: E402

from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs  # noqa: E402
from gtsam_points_tpu.pipelines import odometry as jodo  # noqa: E402
from gtsam_points_tpu.registration import pyramid as jpyr  # noqa: E402
from gtsam_points_tpu.types.frame import make_frame as jmake  # noqa: E402
from gtsam_points_tpu.types.frame import transform_frame as jtransform  # noqa: E402
from gtsam_points_tpu.utils import se3 as jse3  # noqa: E402
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world  # noqa: E402
from gtsam_points_tpu_torch.ops.features import estimate_normals_covs_moments as tcovs  # noqa: E402
from gtsam_points_tpu_torch.pipelines import odometry as todo  # noqa: E402
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
        "jax_poses": [p[:3].reshape(12).tolist() for p in jposes],
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
    kept = np.asarray(chip_smoke.PYRAMID_JAX_POSES[: r["inits"]], np.float32).reshape(-1, 3, 4)
    new = np.asarray(r["jax_poses"], np.float32).reshape(-1, 3, 4)
    bottom = np.broadcast_to(np.asarray([0, 0, 0, 1], np.float32), (len(kept), 1, 4))
    rot, trans = tse3.pose_error(
        torch.from_numpy(np.concatenate([kept, bottom], 1)), torch.from_numpy(np.concatenate([new, bottom], 1))
    )
    return float(trans.max()), float(rot.max())


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
    parser.add_argument("--steps", type=int, default=24, help="odometry steps (0: no odometry run)")
    parser.add_argument("--inits", type=int, default=PYRAMID_INITS, help="pyramid inits (0: no pyramid run)")
    parser.add_argument("--orders", type=int, default=ORDERS,
                        help="other point orders of the target for the pyramid's order shift (0: none)")
    parser.add_argument("--odometry-orders", type=int, default=0,
                        help="other point orders of every scan for the JAX odometry's order shift (0: none)")
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
        print("JAX poses (top three rows, row-major), as chip_smoke.PYRAMID_JAX_POSES:")
        for p in r["jax_poses"]:
            print("    [" + ", ".join(np.format_float_positional(np.float32(x), unique=True) for x in p) + "],")
        report.append(r)
    if args.orders:
        r = order_shift(args.orders)
        print(order_summary(r), flush=True)
        report.append(r)
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
