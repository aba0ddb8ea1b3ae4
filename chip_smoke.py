#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gtsam_points_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py                     # the check, one card
    python3 chip_smoke.py --profile out.txt   # also trace three odometry
                                              # steps; the table goes to out.txt

Phases, each of which ends the run with a nonzero exit if it fails:
  1. environment: card name and power limit (nvidia-smi), torch version;
  2. build: every kernel source with nvcc for sm_90a;
  3. K3 (csrc/linearize_fused.cu) against its plain PyTorch version on the
     card at N = 1, 1000, 25000, 25001 and with half the mask False;
  4. the main path at a real size: point-path VGICP scan-to-map odometry with
     25k-point scans of a 400k-point ring world into the default 262144-voxel
     map, through init_odometry and make_odometry_stepper; K3's launch count
     must rise by at least one per LM outer iteration;
  5. five steps through the CUDA path and through the plain path on the card,
     held to a stated bound per pose;
then one JSON line per kernel and, last, the device line.

Nothing of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s off the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# K3 fp32 operations per masked-in point, counted from csrc/linearize_fused.cu:
# transform 18, residual 3, -R skew(p) 27, W r 15, W J 180, H upper triangle
# 78 x 6 = 468, g 12 x 6 = 72, error 6, count 1.
K3_FLOPS_PER_POINT = 790
K3_BYTES_PER_POINT = 12 + 12 + 24 + 1  # p, mu, W6 (f32) and the mask byte

REAL_WORLD_N = 400_000
REAL_SCAN_N = 25_000
REAL_STEPS = 24
PLAIN_STEPS = 5
# Per-pose bound, CUDA path vs plain path after PLAIN_STEPS steps. The two
# sum H in another order (1e-6 relative); the LM runs to its 10-iteration cap
# along the ring corridor's weakly constrained axis, which grows that to
# about 6e-4 m in 5 steps (measured on an H100). 5 mm stays far below the
# ~0.1 m a step's registration error on this scene.
POSE_BOUND_M = 5e-3
POSE_BOUND_RAD = 1e-3
# Each step gets the true inter-frame motion as its T_pred_delta, the prior an
# IMU or wheel odometry gives. With the constant-velocity model alone both
# packages lose the ring corridor (its weakly constrained direction) after
# about 20 steps of this sequence and diverge (tests/test_torch_real_size.py).
# ATE bound with the prior: the JAX package's own ATE over these 24 steps
# (tests/test_torch_real_size.py on the CPU: mean 2.134785 m, max 3.793032 m;
# the registration slides a voxel along the corridor at step 4) plus 10%.
# The port lands within 0.4% of it (CPU 3.806439 m, card 3.79-3.80 m max);
# the per-pose gap to JAX grows to 2e-2 m by step 24 as sums of another order
# drift along the corridor, and 10% leaves room for that.
ATE_JAX_MEAN_M = 2.134785
ATE_JAX_MAX_M = 3.793032
ATE_SLACK = 1.10


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    return name


def phase_build() -> None:
    from gtsam_points_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    log(f"[build] {len(logs)} kernel source(s) in {time.perf_counter() - t0:.3f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")


def _k3_payload(torch, n: int, seed: int, half_mask: bool = False):
    """Random planar payload like tests/test_pallas_linearize.py's, on the card."""
    import numpy as np

    from gtsam_points_tpu_torch.utils import se3

    rng = np.random.RandomState(seed)
    p = rng.randn(3, n).astype(np.float32) * 5
    mu = p + rng.randn(3, n).astype(np.float32) * 0.1
    A = rng.randn(n, 3, 3).astype(np.float32)
    W = np.einsum("nij,nkj->nik", A, A) + np.eye(3, dtype=np.float32) * 0.1
    W6 = np.stack([W[:, 0, 0], W[:, 0, 1], W[:, 0, 2], W[:, 1, 1], W[:, 1, 2], W[:, 2, 2]])
    mask = rng.rand(n) > (0.5 if half_mask else 0.0)
    xi = torch.tensor([0.03, -0.02, 0.05, 0.4, -0.2, 0.3])
    delta = se3.se3_exp(xi).to(torch.float32)
    dev = torch.device("cuda")
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (p, mu, W6, mask)
    ) + (delta.to(dev).contiguous(),)


def _max_err(torch, lin, ref):
    """-> (max abs error, worst error/scale) over the Linearized fields; the
    scale of a field is max|ref| (the JAX kernel-vs-XLA tolerance's base)."""
    worst_abs, worst_rel = 0.0, 0.0
    for a, b in zip(lin, ref):
        a, b = a.double(), b.double()
        err = float(torch.max(torch.abs(a - b)))
        scale = float(torch.max(torch.abs(b))) + 1e-9
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
    return worst_abs, worst_rel


def _median_ms(torch, fn, reps: int = 200, warmup: int = 20) -> float:
    """Median over `reps` calls, each timed with CUDA events on the stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k3_bound_ms(n: int, n_valid: int) -> tuple:
    bytes_ms = (K3_BYTES_PER_POINT * n + 64 + 92 * 4) / PEAK_BYTES_PER_S * 1e3
    ops_ms = K3_FLOPS_PER_POINT * n_valid / PEAK_FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def measure_k3(torch, args) -> dict:
    """Kernel vs plain on one payload: error, median times and the bound."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL

    lin = FL.linearize_fused_cuda(*args)
    ref = FL.linearize_fused_plain(*args)
    torch.cuda.synchronize()
    abs_err, rel_err = _max_err(torch, lin, ref)
    n, n_valid = args[0].shape[1], int(args[3].sum())
    bound, bound_by = k3_bound_ms(n, n_valid)
    return {
        "n": n,
        "n_valid": n_valid,
        "max_abs_err": abs_err,
        "rel_err": rel_err,
        "ms": _median_ms(torch, lambda: FL.linearize_fused_cuda(*args)),
        "plain_ms": _median_ms(torch, lambda: FL.linearize_fused_plain(*args)),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def phase_k3(torch) -> None:
    cases = [(1, False), (1000, False), (25_000, False), (25_001, False), (25_000, True)]
    for i, (n, half) in enumerate(cases):
        r = measure_k3(torch, _k3_payload(torch, n, seed=10 + i, half_mask=half))
        ok = r["rel_err"] <= 1e-4
        log(
            f"[k3] N={n}{' half-mask' if half else ''} valid={r['n_valid']} "
            f"max_abs_err={r['max_abs_err']:.3e} err/max|ref|={r['rel_err']:.3e} (tol 1e-4) "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
            f"bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}); "
            "no single PyTorch call computes this function"
        )
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version at N={n}")


def _ring_frames(torch, n_poses: int):
    import numpy as np

    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs_moments
    from gtsam_points_tpu_torch.types.frame import make_frame
    from gtsam_points_tpu_torch.utils.synthetic import ring_scans, ring_trajectory, ring_world

    world = ring_world(0, REAL_WORLD_N)
    T_true = ring_trajectory(n_poses, lap=100)
    scans = ring_scans(world, T_true, scan_n=REAL_SCAN_N, seed=1)
    frames = [estimate_normals_covs_moments(make_frame(s, device="cuda")) for s in scans]
    # the motion prior an IMU or wheel odometry would give: the true motion
    # between consecutive poses (see the note at POSE_BOUND_RAD)
    priors = [
        torch.from_numpy(np.linalg.inv(a) @ b).to("cuda", torch.float32)
        for a, b in zip(T_true[:-1], T_true[1:])
    ]
    torch.cuda.synchronize()
    return T_true, frames, priors


def _run_odometry(torch, frames, priors, steps: int):
    """`steps` odometry steps; step i gets priors[i] as its motion prior."""
    from gtsam_points_tpu_torch.pipelines.odometry import (
        OdometryParams,
        init_odometry,
        make_odometry_stepper,
    )

    params = OdometryParams()
    state = init_odometry(frames[0], params, device="cuda")
    step = make_odometry_stepper(params, device="cuda")
    poses = [state.T_world]
    iters, step_ms, merges = [], [], 0
    for f, prior in zip(frames[1 : steps + 1], priors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, T, diag = step(state, f, prior)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        poses.append(T)
        iters.append(int(diag["iterations"]))
        merges += int(diag["full_merge"])
    return state, torch.stack(poses), iters, step_ms, merges


def phase_main_path(torch, profile: Optional[str]):
    import numpy as np

    from gtsam_points_tpu_torch.factors.vgicp import VGICPFactor
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.utils import se3

    t0 = time.perf_counter()
    T_true, frames, priors = _ring_frames(torch, REAL_STEPS + 1)
    log(f"[main] {len(frames)} frames of {frames[0].capacity} slots "
        f"({REAL_SCAN_N} points) from a {REAL_WORLD_N}-point ring world, "
        f"preprocessed in {time.perf_counter() - t0:.3f} s")

    FL.launches = 0
    state, poses, iters, step_ms, merges = _run_odometry(torch, frames, priors, REAL_STEPS)
    launches = FL.launches

    if not bool(torch.all(torch.isfinite(poses))):
        raise AssertionError("a pose is not finite")
    if launches < sum(iters) or launches == 0:
        raise AssertionError(f"K3 launched {launches} times for {sum(iters)} LM iterations")
    T0 = torch.from_numpy(T_true[0]).cuda()
    T_ref = torch.from_numpy(np.stack(T_true[: len(poses)])).cuda()
    rot_e, trans_e = se3.pose_error(T_ref, T0 @ poses)
    log(f"[main] {REAL_STEPS} steps, map capacity {state.vmap.capacity}, "
        f"{int(state.vmap.num_voxels)} voxels, {merges} structural merges")
    log(f"[main] LM iterations per step {iters} (total {sum(iters)}); "
        f"K3 launches {launches} ({launches / sum(iters):.3f} per LM iteration, "
        f"{launches / REAL_STEPS:.3f} per step)")
    log(f"[main] step ms median {statistics.median(step_ms):.3f} "
        f"(first {step_ms[0]:.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f})")
    ate_mean, ate_max = float(trans_e.mean()), float(trans_e.max())
    log(f"[main] ATE translation mean {ate_mean:.6f} m max {ate_max:.6f} m; "
        f"rotation max {float(rot_e.max()):.6f} rad (bound: the JAX package's mean "
        f"{ATE_JAX_MEAN_M} m, max {ATE_JAX_MAX_M} m, times {ATE_SLACK})")
    if not (ate_mean <= ATE_JAX_MEAN_M * ATE_SLACK and ate_max <= ATE_JAX_MAX_M * ATE_SLACK):
        raise AssertionError("the trajectory is further from the truth than the JAX package's")

    if profile:
        _profile_steps(torch, frames, priors, profile)

    # K3 at the main path's own shape: the last frame against the final map
    factor = VGICPFactor(
        voxelmap=state.vmap, source=frames[-1],
        fixed_target_pose=torch.eye(4, device="cuda"), target_key=-1, source_key=0,
        min_voxel_points=5.0,
    )
    pose = poses[-1][None].contiguous()
    found, mu, W6 = factor.correspondences(pose)
    pts_p, _ = factor._source_planar
    args = (pts_p, mu.contiguous(), W6.contiguous(), found.contiguous(), poses[-1].contiguous())
    r = measure_k3(torch, args)
    log(f"[main] K3 at the main path's shape N={r['n']} (valid {r['n_valid']}): "
        f"max_abs_err {r['max_abs_err']:.3e} err/max|ref| {r['rel_err']:.3e}; kernel {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']})")
    if r["rel_err"] > 1e-4:
        raise AssertionError("K3 disagrees with its plain version at the main path's shape")
    r["launches"] = launches
    return frames, priors, r


def _profile_steps(torch, frames, priors, path: str) -> None:
    """The same three steps three times in this process: untimed by any
    tracer, traced with device activity only (the busy share), and traced
    with host ops too (launch and host-read counts, the table in `path`)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    kernel_type = torch.autograd.DeviceType.CUDA
    _, _, iters, plain_ms, _ = _run_odometry(torch, frames, priors, 3)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, iters_dev, traced_ms, _ = _run_odometry(torch, frames, priors, 3)
    # kernel rows only; one stream, so their times do not overlap
    kernels = [e for e in prof.key_averages() if e.device_type == kernel_type]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k3_ms = sum(e.self_device_time_total for e in kernels if "linearize_" in e.key) / 1e3
    n_kernels = sum(e.count for e in kernels)
    log(f"[profile] 3 steps ({sum(iters)} LM iterations) untraced: wall {sum(plain_ms):.3f} ms "
        f"{[round(t, 3) for t in plain_ms]}")
    log(f"[profile] the same 3 steps ({sum(iters_dev)} LM iterations) traced with device activity only: "
        f"wall {sum(traced_ms):.3f} ms {[round(t, 3) for t in traced_ms]}, device kernel time "
        f"{device_ms:.3f} ms, busy {100 * device_ms / sum(traced_ms):.2f}% of the traced wall; "
        f"{n_kernels} kernels ({n_kernels / sum(iters_dev):.1f} per LM iteration), K3 {k3_ms:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, iters_host, host_ms, _ = _run_odometry(torch, frames, priors, 3)
    events = prof.key_averages()
    n_launch = sum(e.count for e in events if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    n_sync = sum(e.count for e in events if e.key == "cudaStreamSynchronize")  # host reads
    with open(path, "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=80))
    log(f"[profile] the same 3 steps ({sum(iters_host)} LM iterations) traced with host ops: "
        f"wall {sum(host_ms):.3f} ms, {n_launch} kernel launches "
        f"({n_launch / sum(iters_host):.1f} per LM iteration), {n_sync} host reads; table in {path}")


def phase_plain_vs_cuda(torch, frames, priors) -> None:
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.utils import se3

    _, poses_cuda, it_cuda, _, _ = _run_odometry(torch, frames, priors, PLAIN_STEPS)
    with mock.patch.object(FL, "linearize_fused", FL.linearize_fused_plain):
        _, poses_plain, it_plain, _, _ = _run_odometry(torch, frames, priors, PLAIN_STEPS)
    rot_d, trans_d = se3.pose_error(poses_plain, poses_cuda)
    rot, trans = float(rot_d.max()), float(trans_d.max())
    log(f"[plain] {PLAIN_STEPS} steps CUDA vs plain path: max per-pose difference "
        f"{trans:.3e} m, {rot:.3e} rad (bound {POSE_BOUND_M} m, {POSE_BOUND_RAD} rad); "
        f"LM iterations {it_cuda} vs {it_plain}")
    if not (trans <= POSE_BOUND_M and rot <= POSE_BOUND_RAD):
        raise AssertionError("the CUDA path and the plain path disagree")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH", help="profile three steps, table to PATH")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import gtsam_points_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    kind = phase_environment(torch)
    phase_build()
    phase_k3(torch)
    frames, priors, k3 = phase_main_path(torch, args.profile)
    phase_plain_vs_cuda(torch, frames, priors)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "linearize_fused",
        "route": "cuda",
        "source": "gtsam_points_tpu_torch/csrc/linearize_fused.cu",
        "replaces": "gtsam_points_tpu/ops/pallas_linearize.py:107",
        "launches": k3["launches"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
