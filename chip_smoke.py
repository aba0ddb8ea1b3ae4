#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gtsam_points_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py                     # the check, one card
    python3 chip_smoke.py --profile out.txt   # also trace three odometry steps,
                                              # the eight registrations, 100
                                              # single-scan linearizes on K4
                                              # and 100 on K5, and 100 batched
                                              # ones; the tables go to out.txt,
                                              # out_pyramid.txt, out_scan.txt,
                                              # out_dense.txt, out_batch.txt
    python3 chip_smoke.py --k3-witness TREE   # only K3 of the checkout at TREE
                                              # on phase 3's payloads against
                                              # float64 (an A/B of precision)

Phases, each of which ends the run with a nonzero exit if it fails:
  1. environment: card name and power limit (nvidia-smi), torch version;
  2. build: every kernel source with nvcc for sm_90a, all at once, then once
     more one at a time into a scratch directory, for the two times;
  3. K3 (csrc/linearize_fused.cu) against its plain PyTorch version (the
     92 direct sums) and against the plain version of its own arithmetic
     (29 source-frame sums, then the expansion) on the card at N = 1, 1000,
     25000, 25001, with half the mask False, far from the origin (|t| = 50
     m, points 30 m out) and near the optimum (mu = R p + t + 0.01 noise);
     two calls equal bit for bit; all three against the direct sums in
     float64, recorded and not gated;
  4. the odometry path at a real size: point-path VGICP scan-to-map odometry
     with 25k-point scans of a 400k-point ring world into the default
     262144-voxel map, through init_odometry and make_odometry_stepper; K3's
     launch count must rise by at least one per LM outer iteration; K3's
     device us per launch pair at the path's own shape and on phase 3's N =
     1 and N = 25000 payloads, taken after the step times;
  5. five steps through the CUDA path and through the plain path on the card,
     held to a stated bound per pose;
  6. the pyramid's inputs (scan 0's DEFAULT_STAGES pyramid, scan 1 with its
     covariances) built twice on the card, which must agree bit for bit, and
     once on the CPU; the card's maps and covariances held to the CPU's, and
     the card's map build from the CPU's frames compared bit for bit with
     the CPU's maps;
  7. K1 (csrc/vgicp_unary.cu) against its plain PyTorch version on the card,
     on the pyramid's own inputs at a pose off the identity and at the
     identity: N = 1, 1000, 25087, 25088, half the mask False, non-unit
     weights, with and without source covariances, and the stride-8, 4 and
     2 stages' sources;
  8. the pyramid path at a real size: one 25k-point scan registered against
     a DEFAULT_STAGES pyramid built from the one before it, from eight
     perturbed initial poses, through build_pyramid and
     register_scan_pyramid with no host read allowed inside a registration;
     K1 must launch exactly 6 times per registration, and every pose must lie
     within a stated bound of the JAX package's pose for the same inputs,
     built on the card and built on the CPU; then one digest line, the
     sha256 of phase 7's K1 outputs and phase 8's poses from card-built
     inputs, by which two trees' runs show whether K1 moved by a bit;
  9. K4 (csrc/vgicp_moments.cu) against its plain PyTorch version on the
     card, on scan 1 against scan 0's leaf-1.0 map: N = 1, 1000, 25087 and
     25088 and half the mask False, with and without source covariances,
     each at the identity and at a pose off it, and at the pose the card's
     registration of scan 1 found;
 10. the single-scan linearize path at a real size, the race bench.py runs:
     vgicp_scan_linearize (K4) against lookup_fetch_planar + sym_inv + K3,
     probe_moments + K1, probe_moments + K5 (bench.py's `unary_dense`), and
     the plain routes: vgicp_scan_linearize's, probe_moments + K1's plain
     version (bench.py's `unary_xla`) and lookup_fetch_planar + sym_inv +
     the plain point system (bench.py's `planar_xla`); with and without
     source covariances; the routes' systems held to each other; K4's and
     K5's launches equal to their routes' calls;
 11. K2 (csrc/vgicp_unary_batch.cu) against its plain PyTorch version and,
     lane by lane, against K1 on the lane's inputs, both within K1_TOL;
     against itself launched on each lane alone (B = 1), bit for bit; and
     two calls on the same input, bit for bit; on scan 1 against scan 0's
     leaf-1.0 map, each lane with the moment rows of its own probe: B = 1,
     2, 64; N = 1, 1000, 25087, 25088; with and without source covariances;
     a different half of the found flags cleared in each lane; lanes at
     tpu_parity's poses, at the identity, and spread around the pose phase
     8 registered; then K2's two load paths at B = 64, N = 25088, with and
     without source covariances: 16-byte loads, and guarded scalar loads on
     a copy of momT_b 4 bytes off a 16-byte boundary, equal bit for bit,
     each with its device us per launch pair;
 12. the batched linearize at a real size, the race of tpu_parity's batched
     dispatch gate: B = 64 lanes over scan 1 (N = 25088), K2 against K1
     launched once per lane and the plain vmapped version, with and without
     source covariances; the routes' systems held to each other, K2's
     launches equal to its route's calls;
 13. K5 (csrc/vgicp_unary_dense.cu) against its plain PyTorch version and,
     on the source block, against K1, on scan 1 against scan 0's leaf-1.0
     map and on the stride-8 stage against the leaf-4 map: N = 1, 7, 8,
     3136, 4095, 4096, 4097, 25087 and 25088; with and without source
     covariances; min_voxel_points 1 and 3 (tpu_parity's dense gate: 3,
     eps 1e-3, covariances); half the mask False; at the identity, at
     K1_TWIST's pose and at the pose phase 8 registered; each K5 call twice,
     equal bit for bit, with no host read allowed;
then one JSON line for all five kernels (K3, K1, K4, K2, K5) and, last, the
device line.

Every path is driven with the kernels' launch counts set to 0 just before it
and read just after. Nothing of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
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
# q = R p 15, residual 6, u = W r 15, skew(q) W 27, h11 18, q x u 9, error 5,
# 29 sums (the 29 -> 92 expansion is done once a call).
K3_FLOPS_PER_POINT = 124
# The 92 direct sums per point, as K4 computes them (csrc/vgicp_moments.cu):
# transform 18, residual 3, -R skew(p) 27, W r 15, W J 180, H upper triangle
# 78 x 6 = 468, g 12 x 6 = 72, error 6, count 1.
DIRECT_FLOPS_PER_POINT = 790
K3_BYTES_PER_POINT = 12 + 12 + 24 + 1  # p, mu, W6 (f32) and the mask byte
# K1 fp32 operations per point that passes its gate, counted from
# csrc/vgicp_unary.cu: moment finalize 22, Rᵀ C_t R 75, + C_s 6, inverse and
# m-scaling 44, r' 21, u 15, skew(p) A 27, h11 18, p x u 9, error 5, 29 sums.
K1_FLOPS_PER_POINT = 271

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
# The port lands within 0.4% of it (CPU 3.806439 m, card 3.79-3.80 m max).
# Its per-pose gap to JAX grows to 2.15e-2 m by step 24 on the CPU; the order
# of the sums alone moves JAX's own poses as far, up to 3.440090e-02 m when
# each scan's points come in another of four orders (`JAX_PLATFORMS=cpu
# python3 tests/test_torch_real_size.py --steps 24 --inits 0 --orders 0
# --odometry-orders 4`), so 3.44e-2 m is the per-pose bound such sums allow
# along the corridor, and the 10% (0.38 m on the max) leaves room for it.
ATE_JAX_MEAN_M = 2.134785
ATE_JAX_MAX_M = 3.793032
ATE_SLACK = 1.10

# The pyramid path: scan 1 registered against scan 0's DEFAULT_STAGES pyramid
# (4 stages, 2 + 2 + 1 + 1 Gauss-Newton iterations), moved back near it by
# the true relative pose, from se3_exp(RandomState(2).uniform(-0.1, 0.1, 6))
# perturbations of the identity.
PYRAMID_INITS = 8
PYRAMID_SEED = 2
K1_LAUNCHES_PER_REGISTRATION = 6
# The JAX package's final poses for the same inputs (its XLA twin on the CPU,
# top three rows row-major), printed by
#   JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0
# which Tier-1 also holds to these numbers for the first init.
PYRAMID_JAX_POSES = [
    [0.99917006, 0.04073076, -0.0006776679, -0.89496005, -0.040731773, 0.99916893, -0.0015731537, 0.020680804, 0.00061305065, 0.0015994513, 0.99999857, -0.004568399],
    [0.9992507, 0.038699575, -0.0006304119, -0.84908485, -0.038700424, 0.9992498, -0.0014163224, 0.018804906, 0.000575125, 0.0014396644, 0.9999988, -0.0038952539],
    [0.999232, 0.039176706, -0.0006452936, -0.8600359, -0.039177593, 0.9992311, -0.0014339732, 0.019216754, 0.00058865425, 0.0014581577, 0.99999875, -0.0040732482],
    [0.9992077, 0.03979021, -0.00065723417, -0.8735324, -0.03979113, 0.9992069, -0.0014977285, 0.019804021, 0.0005971318, 0.0015226848, 0.9999986, -0.0042593805],
    [0.999213, 0.039660767, -0.000653432, -0.870661, -0.039661705, 0.9992121, -0.0014804857, 0.019677097, 0.0005941829, 0.0015052243, 0.99999875, -0.0042005763],
    [0.999245, 0.038840655, -0.0006279604, -0.85222644, -0.03884151, 0.9992442, -0.0014209866, 0.018924057, 0.00057229644, 0.0014442758, 0.99999875, -0.0039306907],
    [0.99915254, 0.04115799, -0.00068819954, -0.9046605, -0.04115904, 0.9991512, -0.0015863514, 0.021016514, 0.00062230433, 0.0016133296, 0.99999845, -0.0046566883],
    [0.99930525, 0.03726546, -0.00060032133, -0.8172236, -0.037266232, 0.99930453, -0.0013429909, 0.0175282, 0.00054988125, 0.0013644266, 0.999999, -0.0036501382],
]
# Per-pose bound against those poses, for the frames and the pyramid built on
# the card as a user builds them and for those built on the CPU and copied to
# the card. Every sum of the map build runs in the same fixed order on both
# (the CPU port lands 8.643e-5 m from JAX).
PYRAMID_BOUND_M = 1e-3
PYRAMID_BOUND_RAD = 1e-3
# The card's maps against the CPU's: keys and counts equal, every other
# moment within MAP_TOL of its voxel's largest |moment|, the source's
# covariances within COV_TOL (another order of the sums moves them by up to
# 1.5e-5 and 3.1e-4 on the CPU, over the same twelve orders)
MAP_TOL = 1e-4
COV_TOL = 1e-2
# The CUDA path against the plain path on the same maps: only K1's summation
# order differs (2.4e-7 to 6.9e-6 m measured on an H100)
PYRAMID_PATH_BOUND_M = 1e-4
PYRAMID_PATH_BOUND_RAD = 1e-4
# K1 against its plain version, error over max|ref| per field, at the CPU
# tests' pose (tests/test_torch_unary.py) unless a case says identity
K1_TOL = 1e-4
K1_TWIST = [0.01, -0.02, 0.015, 0.1, -0.05, 0.08]
# K4 against its plain version, and the race's routes against each other,
# error over max|ref| per field; the inlier counts exactly
K4_TOL = 1e-4
# K4 fp32 operations per point that passes its gate, counted from
# csrc/vgicp_moments.cu: the 790 of the direct sums, the moment finalize 22,
# the 3x3 inverse 45, and R C_s Rᵀ + C_t 81 (3 for eps I).
K4_FLOPS_PER_POINT = {True: DIRECT_FLOPS_PER_POINT + 22 + 45 + 81, False: DIRECT_FLOPS_PER_POINT + 22 + 45 + 3}
RACE_CALLS = 200
# K2 (the batched unary linearize) raced as the batched dispatch gate of
# scripts/tpu_parity.py races it: B = 64 lanes over one 25088-slot source,
# min_voxel_points 3 and eps 1e-3, lane b at se3_exp(K1_TWIST) with its
# x translation raised by 1e-6 b. K2 is held to its plain version and, lane
# by lane, to K1 at K1_TOL; to itself launched lane by lane, and to a second
# call, bit for bit.
K2_LANES = 64
K2_MIN_POINTS = 3.0
# the spread lanes: the registered pose times se3_exp(uniform(-0.1, 0.1, 6))
K2_SPREAD_SEED = 3


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
    """Every source built for the run, all nvcc processes started together;
    then, for the record, every source once more one at a time into a
    scratch directory inside the build directory."""
    import tempfile
    from pathlib import Path

    from gtsam_points_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    together = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "entry function")) or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")
    one_by_one = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for name in _build.SOURCES:
            t1 = time.perf_counter()
            proc = _build.nvcc(name, Path(tmp) / f"lib{name}.so")
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            one_by_one[name] = time.perf_counter() - t1
    log(f"[build] {len(logs)} kernel sources, one nvcc each started together: {together:.3f} s; "
        f"one at a time: {sum(one_by_one.values()):.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in one_by_one.items()) + ")")


# Phase 3's payloads, (N, half the mask False, kind); the i-th has seed 10 + i.
K3_CASES = [(1, False, "random"), (1000, False, "random"), (25_000, False, "random"), (25_001, False, "random"),
            (25_000, True, "random"), (25_000, False, "far"), (25_000, True, "far"), (25_000, False, "near")]


def _float64(args):
    """The floating-point tensors of `args` in float64, the rest as they are."""
    return tuple(a.double() if a.is_floating_point() else a for a in args)


def _k3_payload(torch, n: int, seed: int, half_mask: bool = False, kind: str = "random"):
    """Planar payload on the card, as tests/test_torch_k3_source.py makes it:
    "random" is tests/test_pallas_linearize.py's (mu near p, large
    residuals); "far" puts the points 30 m from the sensor at |t| = 50 m with
    mu = R p + t + 0.1 noise; "near" has |t| = 20 m and mu = R p + t + 0.01
    noise, near the optimum, where the gradient is a small sum of large
    terms."""
    import numpy as np

    from gtsam_points_tpu_torch.utils import se3

    rng = np.random.RandomState(seed)
    if kind == "random":
        p = rng.randn(3, n).astype(np.float32) * 5
        trans = [0.4, -0.2, 0.3]
    else:
        d = rng.randn(3, n)
        radius = 30.0 if kind == "far" else 1.0 + rng.rand(n) * 29.0
        p = (d / np.linalg.norm(d, axis=0) * radius).astype(np.float32)
        trans = [30.0, -40.0, 0.0] if kind == "far" else [12.0, -16.0, 0.0]
    delta = se3.se3_exp(torch.tensor([0.03, -0.02, 0.05] + trans)).to(torch.float32).numpy()
    if kind == "random":
        mu = p + rng.randn(3, n).astype(np.float32) * 0.1
    else:
        noise = 0.1 if kind == "far" else 0.01
        mu = (delta[:3, :3] @ p + delta[:3, 3:] + rng.randn(3, n) * noise).astype(np.float32)
    A = rng.randn(n, 3, 3).astype(np.float32)
    W = np.einsum("nij,nkj->nik", A, A) + np.eye(3, dtype=np.float32) * 0.1
    W6 = np.stack([W[:, 0, 0], W[:, 0, 1], W[:, 0, 2], W[:, 1, 1], W[:, 1, 2], W[:, 2, 2]])
    mask = rng.rand(n) > (0.5 if half_mask else 0.0)
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (p, mu, W6, mask, delta))


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


def measure_k3(torch, args, device: bool) -> dict:
    """Kernel vs plain (the direct sums) and vs the plain version of its own
    arithmetic (`linearize_fused_source_plain`) on one payload: errors, each
    of the three against the direct sums in float64, two kernel calls
    compared bit for bit, median times, the bound and, with `device`, the
    device us per launch pair from a profiler trace."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL

    lin = FL.linearize_fused_cuda(*args)
    again = FL.linearize_fused_cuda(*args)
    ref = FL.linearize_fused_plain(*args)
    mirror = FL.linearize_fused_source_plain(*args)
    ref64 = FL.linearize_fused_plain(*_float64(args))
    torch.cuda.synchronize()
    abs_err, rel_err = _max_err(torch, lin, ref)
    _, mirror_rel = _max_err(torch, lin, mirror)
    differ = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(lin, again))
    n, n_valid = args[0].shape[1], int(args[3].sum())
    bound, bound_by = k3_bound_ms(n, n_valid)
    return {
        "n": n,
        "n_valid": n_valid,
        "max_abs_err": abs_err,
        "rel_err": rel_err,
        "mirror_rel_err": mirror_rel,
        "f64_rel_err": {name: _max_err(torch, x, ref64)[1] for name, x in (("K3", lin), ("plain", ref),
                                                                           ("own arithmetic's plain", mirror))},
        "calls_differ": differ,
        "ms": _median_ms(torch, lambda: FL.linearize_fused_cuda(*args)),
        "plain_ms": _median_ms(torch, lambda: FL.linearize_fused_plain(*args)),
        "device_us": _device_us_per_call(torch, lambda: FL.linearize_fused_cuda(*args), "linearize_")
        if device else None,
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def _check_k3(label: str, r: dict) -> None:
    """Log one measure_k3 result; fail on an error over 1e-4 x max|ref| or
    on two calls that differ."""
    device = "not measured" if r["device_us"] is None else f"{r['device_us']:.3f} us"
    log(
        f"{label} valid={r['n_valid']} max_abs_err={r['max_abs_err']:.3e} err/max|ref|={r['rel_err']:.3e} "
        f"(tol 1e-4), vs its own arithmetic's plain version {r['mirror_rel_err']:.3e} (tol 1e-4), two calls "
        f"differ in {r['calls_differ']} values (must be 0); against float64 (recorded, not gated): "
        + ", ".join(f"{k} {v:.3e}" for k, v in r["f64_rel_err"].items())
        + f"; kernel {r['ms']:.4f} ms, device {device} per "
        f"launch pair, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}); "
        "no single PyTorch call computes this function"
    )
    if r["rel_err"] > 1e-4 or r["mirror_rel_err"] > 1e-4:
        raise AssertionError(f"K3 disagrees with its plain version ({label})")
    if r["calls_differ"]:
        raise AssertionError(f"two K3 calls on the same input differ ({label})")


def phase_k3(torch) -> dict:
    """K3 against its plain versions on every payload. No profiler runs here:
    once it has traced, every later launch in the process is slower on the
    host, which would move phase 4's step times; the device us per launch
    pair of the N = 1 and N = 25000 payloads are taken after them (phase 4).
    -> those two payloads by name."""
    later = {}
    for i, (n, half, kind) in enumerate(K3_CASES):
        args = _k3_payload(torch, n, seed=10 + i, half_mask=half, kind=kind)
        _check_k3(f"[k3] N={n} {kind}{' half-mask' if half else ''}", measure_k3(torch, args, device=False))
        if kind == "random" and not half and n in (1, 25_000):
            later[f"N={n}"] = args
    return later


def k3_witness(torch, tree: str) -> None:
    """--k3-witness: the K3 of the checkout at `tree` (this commit's, or
    another's unpacked into a directory that .gitignore lists) on phase 3's
    payloads, held to nothing: its error and the float32 plain version's
    against the direct sums in float64, so that two commits' K3 can be read
    side by side in one chip call. It uses only `linearize_fused_cuda` and
    `linearize_fused_plain`, which every commit of the port has."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL

    for i, (n, half, kind) in enumerate(K3_CASES):
        args = _k3_payload(torch, n, seed=10 + i, half_mask=half, kind=kind)
        lin, ref = FL.linearize_fused_cuda(*args), FL.linearize_fused_plain(*args)
        ref64 = FL.linearize_fused_plain(*_float64(args))
        torch.cuda.synchronize()
        log(f"[k3-witness] {tree} N={n} {kind}{' half-mask' if half else ''}: err/max|ref| against float64: "
            f"K3 {_max_err(torch, lin, ref64)[1]:.3e}, plain {_max_err(torch, ref, ref64)[1]:.3e}; "
            f"K3 vs plain {_max_err(torch, lin, ref)[1]:.3e}")


def _zero_counts(FL) -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    FL.launches = 0
    FL.unary_launches = 0
    FL.unary_batch_launches = 0
    FL.moments_launches = 0
    FL.dense_launches = 0


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
    return T_true, scans, frames, priors


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


def phase_main_path(torch, profile: Optional[str], k3_payloads: dict):
    import numpy as np

    from gtsam_points_tpu_torch.factors.vgicp import VGICPFactor
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.utils import se3

    t0 = time.perf_counter()
    T_true, scans, frames, priors = _ring_frames(torch, REAL_STEPS + 1)
    log(f"[main] {len(frames)} frames of {frames[0].capacity} slots "
        f"({REAL_SCAN_N} points) from a {REAL_WORLD_N}-point ring world, "
        f"preprocessed in {time.perf_counter() - t0:.3f} s")

    _zero_counts(FL)
    state, poses, iters, step_ms, merges = _run_odometry(torch, frames, priors, REAL_STEPS)
    launches, k1_launches = FL.launches, FL.unary_launches

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
        f"{launches / REAL_STEPS:.3f} per step); K1 launches {k1_launches}")
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
    r = measure_k3(torch, args, device=True)
    _check_k3(f"[main] K3 at the main path's shape N={r['n']}", r)
    for name, payload in k3_payloads.items():
        us = _device_us_per_call(torch, lambda: FL.linearize_fused_cuda(*payload), "linearize_")
        log(f"[main] K3 on phase 3's {name} payload: device "
            f"{'not measured' if us is None else f'{us:.3f} us'} per launch pair")
    r["launches"] = launches
    return scans, frames, priors, r


def _trace(torch, label: str, run, unit: str, key: str, path: str) -> None:
    """`run()` -> (wall ms, units of work), three times in this process:
    untraced, traced with device activity only (the busy share), and traced
    with host ops too (launch and host-read counts; the table goes to
    `path`). `key` names the kernels whose device time is also given alone."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    kernel_type = torch.autograd.DeviceType.CUDA
    plain_ms, units = run()
    log(f"[profile] {label} ({units} {unit}s) untraced: wall {plain_ms:.3f} ms")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_ms, units = run()
    # kernel rows only; one stream, so their times do not overlap
    kernels = [e for e in prof.key_averages() if e.device_type == kernel_type]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    key_ms = sum(e.self_device_time_total for e in kernels if key in e.key) / 1e3
    key_pairs = sum(e.count for e in kernels if key in e.key) / 2  # partial + final
    n_kernels = sum(e.count for e in kernels)
    per_pair = f"{key_ms * 1e3 / key_pairs:.3f} us" if key_pairs else "not measured"
    log(f"[profile] the same {label} traced with device activity only: wall {traced_ms:.3f} ms, "
        f"device kernel time {device_ms:.3f} ms, busy {100 * device_ms / traced_ms:.2f}% of the traced "
        f"wall; {n_kernels} kernels ({n_kernels / units:.1f} per {unit}), '{key}' kernels {key_ms:.3f} ms "
        f"in {key_pairs:g} launch pairs, {per_pair} per pair")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_ms, units = run()
    events = prof.key_averages()
    n_launch = sum(e.count for e in events if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    n_sync = sum(e.count for e in events if e.key == "cudaStreamSynchronize")  # host reads
    with open(path, "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=80))
    log(f"[profile] the same {label} traced with host ops: wall {host_ms:.3f} ms, {n_launch} kernel "
        f"launches ({n_launch / units:.1f} per {unit}), {n_sync} host reads; table in {path}")


def _profile_steps(torch, frames, priors, path: str) -> None:
    """Three odometry steps, traced (see _trace)."""

    def run():
        _, _, iters, step_ms, _ = _run_odometry(torch, frames, priors, 3)
        return sum(step_ms), sum(iters)

    _trace(torch, "3 odometry steps", run, "LM iteration", "linearize_", path)


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


def _to_card(frame):
    return frame.replace(**{f.name: getattr(frame, f.name).cuda()
                            for f in dataclasses.fields(frame) if getattr(frame, f.name) is not None})


def _pyramid_inputs(torch, scans, prior, device: str):
    """Scan 0 as the target and its DEFAULT_STAGES pyramid; scan 1 moved back
    near it by the true relative pose `prior`, so identity is the truth. Both
    are built on `device` and returned on the card, with the target frame."""
    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs_moments
    from gtsam_points_tpu_torch.registration import build_pyramid
    from gtsam_points_tpu_torch.types.frame import make_frame, transform_frame

    target, source = (estimate_normals_covs_moments(make_frame(s, device=device)) for s in scans[:2])
    source = transform_frame(prior.to(device), source)
    maps = build_pyramid(target, device=device)
    if device != "cuda":
        target, source = _to_card(target), _to_card(source)
        maps = tuple(type(vm)(*(t.cuda() for t in vm)) for vm in maps)
    torch.cuda.synchronize()
    return source, maps, target


def phase_pyramid_inputs(torch, scans, priors) -> dict:
    """The pyramid's inputs three times: built on the card as a user builds
    them ("card", the main path's), built on the card once more from the same
    scans ("again"), and built on the CPU, then copied to the card ("cpu").
    The two card builds must agree bit for bit. The card's maps must hold the
    CPU's keys and counts, and their other moments and the source's
    covariances must agree to MAP_TOL and COV_TOL. Then the map build alone:
    the pyramid of the CPU's target frame built on the card, against the
    CPU's pyramid, bit for bit (reported)."""
    from gtsam_points_tpu_torch.registration import build_pyramid

    inputs = {k: _pyramid_inputs(torch, scans, priors[0], d)
              for k, d in (("card", "cuda"), ("again", "cuda"), ("cpu", "cpu"))}
    (src, maps, tgt), (src2, maps2, tgt2), (csrc, cmaps, ctgt) = inputs["card"], inputs["again"], inputs["cpu"]
    pairs = [(src.covs, src2.covs), (tgt.covs, tgt2.covs)] + [(a.moments, b.moments) for a, b in zip(maps, maps2)]
    pairs += [(a.table.view(torch.int32), b.table.view(torch.int32)) for a, b in zip(maps, maps2)]
    differ = sum(int((a != b).sum()) for a, b in pairs)
    log(f"[inputs] two card builds from the same scans: {differ} of {sum(a.numel() for a, _ in pairs)} "
        "covariance, moment and probe-table values differ (must be 0)")
    if differ:
        raise AssertionError("two card builds of the same inputs differ")
    for i, (a, b) in enumerate(zip(maps, cmaps)):
        same = torch.equal(a.keys, b.keys) and torch.equal(a.moments[:, 0], b.moments[:, 0])
        x, y = a.moments[:, 1:10].double(), b.moments[:, 1:10].double()
        rel = float(((x - y).abs().amax(1) / (y.abs().amax(1) + 1e-30)).max())
        log(f"[inputs] map {i} (leaf {float(a.leaf)}, {int(a.num_voxels)} voxels), card vs CPU: "
            f"keys and counts equal {same}, moments {rel:.3e} of each voxel's largest (tol {MAP_TOL})")
        if not same or rel > MAP_TOL:
            raise AssertionError(f"the card's map {i} differs from the CPU's")
    cov_err = float((src.covs - csrc.covs).abs().max())
    log(f"[inputs] source covariances, card vs CPU: max abs difference {cov_err:.3e} (tol {COV_TOL})")
    if cov_err > COV_TOL:
        raise AssertionError("the card's source covariances differ from the CPU's")
    for i, (a, b) in enumerate(zip(build_pyramid(ctgt, device="cuda"), cmaps)):
        bits = torch.equal(a.moments.view(torch.int32), b.moments.view(torch.int32))
        diff = float((a.moments.double() - b.moments.double()).abs().max())
        log(f"[inputs] map {i} built on the card from the CPU's target frame vs the CPU's map: moments "
            f"equal bit for bit {bits}, largest difference {diff:.3e}")
    return inputs
def k1_bound_ms(args) -> tuple:
    """The least time for K1 on these inputs: each input read once (p, momT,
    found, and C_s and the weights when given, delta), the 29 sums written
    once; K1_FLOPS_PER_POINT for each point that passes the gate here."""
    p, momT, found, _, mvp, _, sc, w = args
    n = p.shape[1]
    nbytes = (12 + 40 + 1 + (24 if sc is not None else 0) + (4 if w is not None else 0)) * n + 64 + 29 * 4
    gate = found & (momT[0] >= mvp)
    if w is not None:
        gate = gate & (w > 0)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = K1_FLOPS_PER_POINT * int(gate.sum()) / PEAK_FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _device_us_per_call(torch, fn, key: str, calls: int = 100):
    """Device time of the kernels whose name holds `key`, per call of fn, from
    a profiler trace of `calls` calls; None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernel_type = torch.autograd.DeviceType.CUDA
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == kernel_type and key in e.key)
    return total / calls if total > 0 else None


def _digest(tensors) -> str:
    """sha256 over the bytes of `tensors`, in order: equal digests from two
    runs mean equal values bit for bit."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _k1_cases(torch, source, maps) -> list:
    """Phase 7's K1 inputs on the pyramid's own inputs, at the pose of
    K1_TWIST and at the identity: [(name, args)]."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.registration.pyramid import DEFAULT_STAGES, _source_planar
    from gtsam_points_tpu_torch.utils import se3

    delta = se3.se3_exp(torch.tensor(K1_TWIST)).to("cuda", torch.float32).contiguous()
    eye = torch.eye(4, device="cuda")
    pts_all, covs_all = _source_planar(source)
    pts_all = pts_all.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(3)
    half = torch.rand(pts_all.shape[1], generator=gen, device="cuda") > 0.5
    weights = torch.rand(pts_all.shape[1], generator=gen, device="cuda") * 1.5 + 0.5

    def stage_args(stride, vm, n=None, covs=True, half_mask=False, weighted=False, pose=delta):
        """K1's inputs at one stage: every plane contiguous, as the pyramid makes them."""
        cut = slice(0, n, stride)
        pts = pts_all[:, cut].contiguous()
        momT, found = FL.probe_moments(vm, pts, source.mask[cut], pose)
        if half_mask:
            found = found & half[cut]
        return (pts, momT, found, pose, 1.0, 1e-3, covs_all[:, cut].contiguous() if covs else None,
                weights[cut].contiguous() if weighted else None)

    strides = [st.stride for st in DEFAULT_STAGES]  # 8, 4, 2, 1
    return [
        ("N=1", stage_args(1, maps[-1], n=1)),
        ("N=1000", stage_args(1, maps[-1], n=1000)),
        ("N=25087", stage_args(1, maps[-1], n=25087)),
        ("N=25088", stage_args(1, maps[-1])),
        ("N=25088 identity", stage_args(1, maps[-1], pose=eye)),
        ("N=25088 eps", stage_args(1, maps[-1], covs=False)),
        ("N=25088 half-mask", stage_args(1, maps[-1], half_mask=True)),
        ("N=25088 weights", stage_args(1, maps[-1], weighted=True)),
        ("N=25088 eps half-mask weights", stage_args(1, maps[-1], covs=False, half_mask=True, weighted=True)),
        (f"stride {strides[2]} leaf 1", stage_args(strides[2], maps[2])),
        (f"stride {strides[1]} leaf 1", stage_args(strides[1], maps[1])),
        (f"stride {strides[0]} leaf 4", stage_args(strides[0], maps[0])),
        (f"stride {strides[0]} leaf 4 eps", stage_args(strides[0], maps[0], covs=False)),
    ]


def phase_k1(torch, source, maps) -> dict:
    """K1 against its plain version on the pyramid's own inputs (_k1_cases);
    times at the last stage's shape (N = 25088) and at the first stage's
    (stride 8)."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.registration.pyramid import DEFAULT_STAGES

    cases = _k1_cases(torch, source, maps)
    strided = (source.points.T.contiguous()[:, :: DEFAULT_STAGES[0].stride],) + cases[-2][1][1:]
    try:
        FL.linearize_vgicp_unary_cuda(*strided)
        raise AssertionError("K1's wrapper took a non-contiguous source")
    except ValueError:
        pass
    outputs = []
    for name, args in cases:
        lin = FL.linearize_vgicp_unary_cuda(*args)
        ref = FL.linearize_vgicp_unary_plain(*args)
        outputs.append(lin)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(torch, lin, ref)
        log(f"[k1] {name}: valid {int(ref.num_inliers)} max_abs_err={abs_err:.3e} "
            f"err/max|ref|={rel_err:.3e} (tol {K1_TOL})")
        if rel_err > K1_TOL or int(lin.num_inliers) != int(ref.num_inliers):
            raise AssertionError(f"K1 disagrees with its plain version ({name})")

    out = {"outputs": outputs}
    for key, (name, args) in (("main", cases[3]), ("stride8", cases[-2])):
        lin = FL.linearize_vgicp_unary_cuda(*args)
        abs_err, _ = _max_err(torch, lin, FL.linearize_vgicp_unary_plain(*args))
        bound, bound_by = k1_bound_ms(args)
        r = {
            "n": args[0].shape[1],
            "max_abs_err": abs_err,
            "ms": _median_ms(torch, lambda: FL.linearize_vgicp_unary_cuda(*args)),
            "plain_ms": _median_ms(torch, lambda: FL.linearize_vgicp_unary_plain(*args)),
            "device_us": _device_us_per_call(torch, lambda: FL.linearize_vgicp_unary_cuda(*args), "unary_"),
            "bound_ms": bound,
            "bound_by": bound_by,
        }
        device = "not measured" if r["device_us"] is None else f"{r['device_us']:.3f} us"
        log(f"[k1] {name} (N={r['n']}): kernel {r['ms']:.4f} ms (wrapper, CUDA events), device {device} "
            f"per launch pair, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bound_by']}); no single PyTorch call computes this function")
        out[key] = r
    return out


def _register_all(torch, source, maps):
    """Phase 8's registrations: `source` against the pyramid `maps` from
    each of the PYRAMID_INITS initial poses, each with no host read allowed
    inside it. -> (poses [PYRAMID_INITS, 4, 4], ms per registration)"""
    import numpy as np

    from gtsam_points_tpu_torch.registration import register_scan_pyramid
    from gtsam_points_tpu_torch.utils import se3

    xis = np.random.RandomState(PYRAMID_SEED).uniform(-0.1, 0.1, (PYRAMID_INITS, 6)).astype(np.float32)
    T0s = se3.se3_exp(torch.from_numpy(xis).cuda())
    poses, reg_ms = [], []
    for T0 in T0s:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")  # a host read inside raises
        try:
            poses.append(register_scan_pyramid(maps, source, T0))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        reg_ms.append((time.perf_counter() - t0) * 1e3)
    return torch.stack(poses), reg_ms


def phase_pyramid(torch, inputs: dict, profile: Optional[str]) -> dict:
    """The pyramid path: eight registrations on the card-built inputs, each
    with no host read allowed inside it; K1's count over them and their
    median time. Their poses against the JAX package's and equal, bit for
    bit, to the poses from the second card build; the poses from the
    CPU-built inputs against the JAX package's; all at PYRAMID_BOUND_M. The
    CUDA path against the plain path on those. With `profile`, the eight are
    traced too (table next to `profile`)."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.utils import se3

    top = torch.tensor(PYRAMID_JAX_POSES, dtype=torch.float32).reshape(-1, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(len(top), 1, 4)
    jax_poses = torch.cat([top, bottom], 1).cuda()
    torch.cuda.synchronize()

    def gap(label, a, b, bound_m, bound_rad):
        """Largest per-pose gap between a and b; over the bound fails the phase."""
        rot, trans = se3.pose_error(a, b)
        t, r = float(trans.max()), float(rot.max())
        log(f"[pyramid] {label}: max per-pose gap {t:.3e} m {r:.3e} rad (bound {bound_m} m, {bound_rad} rad)")
        if not (t <= bound_m and r <= bound_rad):
            raise AssertionError(f"pyramid: {label} over its bound")

    source, maps, _ = inputs["card"]
    _zero_counts(FL)
    poses, reg_ms = _register_all(torch, source, maps)
    k1_launches, k3_launches = FL.unary_launches, FL.launches

    if not bool(torch.all(torch.isfinite(poses))):
        raise AssertionError("a pyramid pose is not finite")
    log(f"[pyramid] {PYRAMID_INITS} registrations of {source.capacity} slots against "
        f"{len(maps)} maps: K1 launches {k1_launches} "
        f"({k1_launches / PYRAMID_INITS:.3f} per registration), K3 launches {k3_launches}, "
        f"host reads inside a registration: 0 (sync debug mode 'error')")
    log(f"[pyramid] ms per registration median {statistics.median(reg_ms):.3f} "
        f"(first {reg_ms[0]:.3f}, min {min(reg_ms):.3f}, max {max(reg_ms):.3f})")
    if k1_launches != K1_LAUNCHES_PER_REGISTRATION * PYRAMID_INITS:
        raise AssertionError(f"K1 launched {k1_launches} times in {PYRAMID_INITS} registrations")
    truth_rot, truth_trans = se3.pose_error(torch.eye(4, device="cuda"), poses)
    log(f"[pyramid] error against the truth max {float(truth_trans.max()):.6f} m "
        f"{float(truth_rot.max()):.6f} rad")

    gap("card-built inputs vs the JAX package", jax_poses, poses, PYRAMID_BOUND_M, PYRAMID_BOUND_RAD)
    poses_again, _ = _register_all(torch, *inputs["again"][:2])
    same = torch.equal(poses, poses_again)
    log(f"[pyramid] second card build's poses equal the first's bit for bit: {same}")
    if not same:
        raise AssertionError("pyramid: two card builds of the same inputs register to other poses")
    poses_cpu, _ = _register_all(torch, *inputs["cpu"][:2])
    gap("CPU-built inputs vs the JAX package", jax_poses, poses_cpu, PYRAMID_BOUND_M, PYRAMID_BOUND_RAD)
    with mock.patch.object(FL, "linearize_vgicp_unary", FL.linearize_vgicp_unary_plain):
        poses_plain, _ = _register_all(torch, *inputs["cpu"][:2])
    gap("CUDA path vs plain path, CPU-built inputs", poses_plain, poses_cpu,
        PYRAMID_PATH_BOUND_M, PYRAMID_PATH_BOUND_RAD)

    if profile:
        root, ext = os.path.splitext(profile)
        _trace(torch, f"{PYRAMID_INITS} pyramid registrations",
               lambda: (sum(_register_all(torch, source, maps)[1]), K1_LAUNCHES_PER_REGISTRATION * PYRAMID_INITS),
               "Gauss-Newton iteration", "unary_", f"{root}_pyramid{ext}")
    return {"launches": k1_launches, "median_ms": statistics.median(reg_ms), "poses": poses}


def k4_bound_ms(args) -> tuple:
    """The least time for K4 on these inputs: each input read once (p, momT,
    found, C_s when given, delta), the 92 sums written once;
    K4_FLOPS_PER_POINT for each point that passes the gate here."""
    p, momT, found, _, mvp, _, sc = args
    n = p.shape[1]
    nbytes = (12 + 40 + 1 + (24 if sc is not None else 0)) * n + 64 + 92 * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    gate = int((found & (momT[0] >= mvp)).sum())
    ops_ms = K4_FLOPS_PER_POINT[sc is not None] * gate / PEAK_FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _check_close(torch, label: str, lin, ref, tol: float) -> float:
    """Error over max|ref| of every field, and equal inlier counts, or raise."""
    abs_err, rel_err = _max_err(torch, lin, ref)
    same_count = int(lin.num_inliers) == int(ref.num_inliers)
    log(f"{label}: valid {int(ref.num_inliers)} max_abs_err={abs_err:.3e} err/max|ref|={rel_err:.3e} "
        f"(tol {tol}), inlier counts equal {same_count}")
    if rel_err > tol or not same_count:
        raise AssertionError(f"{label} disagree")
    return abs_err


def phase_k4(torch, source, vmap, T_reg) -> dict:
    """K4 against its plain version on scan 1 (`source`, moved back by the
    true prior) against scan 0's leaf-1.0 map, at the identity, at
    K1_TWIST's pose and at `T_reg`, the card's registration of scan 1; times
    at N = 25088 with source covariances at K1_TWIST's pose."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.registration.pyramid import _source_planar
    from gtsam_points_tpu_torch.utils import se3

    pts_all, covs_all = (t.contiguous() for t in _source_planar(source))
    n_all = pts_all.shape[1]
    half = torch.rand(n_all, generator=torch.Generator(device="cuda").manual_seed(4), device="cuda") > 0.5
    poses = {
        "identity": torch.eye(4, device="cuda"),
        "twist": se3.se3_exp(torch.tensor(K1_TWIST)).to("cuda", torch.float32).contiguous(),
    }

    def k4_args(pose, n=None, covs=True, half_mask=False):
        """K4's inputs as vgicp_scan_linearize makes them, min_voxel_points 1."""
        pts = pts_all[:, :n].contiguous()
        momT, found = FL.probe_moments(vmap, pts, source.mask[:n], pose)
        if half_mask:
            found = found & half[:n]
        return (pts, momT, found, pose, 1.0, 1e-3, covs_all[:, :n].contiguous() if covs else None)

    cases = []
    for pname, pose in poses.items():
        for covs in (True, False):
            mode = "covs" if covs else "eps"
            cases += [(f"N={n} {mode} {pname}", k4_args(pose, n, covs)) for n in (1, 1000, n_all - 1, n_all)]
            cases.append((f"N={n_all} {mode} half-mask {pname}", k4_args(pose, covs=covs, half_mask=True)))
    T_reg = T_reg.contiguous()
    cases += [(f"N={n_all} {'covs' if c else 'eps'} registered pose", k4_args(T_reg, covs=c)) for c in (True, False)]
    strided = (pts_all[:, ::8],) + k4_args(poses["twist"], covs=False)[1:]
    try:
        FL.linearize_vgicp_moments_cuda(*strided)
        raise AssertionError("K4's wrapper took a non-contiguous source")
    except ValueError:
        pass
    for name, args in cases:
        lin = FL.linearize_vgicp_moments_cuda(*args)
        ref = FL.linearize_vgicp_moments_plain(*args)
        torch.cuda.synchronize()
        _check_close(torch, f"[k4] {name}", lin, ref, K4_TOL)

    args = k4_args(poses["twist"])
    lin = FL.linearize_vgicp_moments_cuda(*args)
    abs_err, _ = _max_err(torch, lin, FL.linearize_vgicp_moments_plain(*args))
    bound, bound_by = k4_bound_ms(args)
    r = {
        "n": n_all,
        "max_abs_err": abs_err,
        "ms": _median_ms(torch, lambda: FL.linearize_vgicp_moments_cuda(*args)),
        "plain_ms": _median_ms(torch, lambda: FL.linearize_vgicp_moments_plain(*args)),
        "device_us": _device_us_per_call(torch, lambda: FL.linearize_vgicp_moments_cuda(*args), "moments_"),
        "bound_ms": bound,
        "bound_by": bound_by,
    }
    device = "not measured" if r["device_us"] is None else f"{r['device_us']:.3f} us"
    log(f"[k4] N={n_all} covs twist: kernel {r['ms']:.4f} ms (wrapper, CUDA events), device {device} per "
        f"launch pair, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}); "
        "no single PyTorch call computes this function")
    return r


SourceBlock = collections.namedtuple("SourceBlock", "H_ss b_s error num_inliers")


def _source_block(lin):
    return SourceBlock(lin.H_ss, lin.b_s, lin.error, lin.num_inliers)


def phase_race(torch, source, vmap, profile: Optional[str]) -> dict:
    """The single-scan linearize path, raced as bench.py races it, at
    K1_TWIST's pose, with and without source covariances: each route's median
    wrapper ms over RACE_CALLS calls (CUDA events) and device us per call
    from a profiler trace, all kernels and the route's own kernels. The
    routes' systems are held to each other: K4's full system to the K3
    route's, its source block to K1's (C_t + R C_s Rᵀ = R (Rᵀ C_t R + C_s)
    Rᵀ), K5's source block to K1's, and each plain route to its kernel's.
    K4's and K5's launches over the race are counted, must equal their
    routes' calls, and are returned. With `profile`, 100 calls each of
    vgicp_scan_linearize and of probe_moments + K5 with covariances are
    traced too (tables next to `profile`)."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.ops import planar
    from gtsam_points_tpu_torch.ops.voxelmap import lookup_fetch_planar
    from gtsam_points_tpu_torch.registration.pyramid import _source_planar
    from gtsam_points_tpu_torch.utils import se3

    pts, covs_all = (t.contiguous() for t in _source_planar(source))
    mask = source.mask
    T = se3.se3_exp(torch.tensor(K1_TWIST)).to("cuda", torch.float32).contiguous()
    eps_eye6 = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0], device="cuda")[:, None] * 1e-3
    calls = {"moments_fused": 0, "unary_dense_cuda": 0}

    def routes(covs6):
        def moments_fused():
            calls["moments_fused"] += 1
            return FL.vgicp_scan_linearize(vmap, pts, mask, T, 1.0, src_covs6=covs6)

        def planar_fused():
            pm = planar.transform(T, pts)
            found, _, mu, C6 = lookup_fetch_planar(vmap, pm, mask)
            fused = C6 + (planar.sym_rotate(T[:3, :3], covs6) if covs6 is not None else eps_eye6)
            return FL.linearize_fused(pts, mu, planar.sym_inv(fused), found, T)

        def unary_cuda():
            momT, found = FL.probe_moments(vmap, pts, mask, T)
            return FL.linearize_vgicp_unary(pts, momT, found, T, 1.0, src_covs6=covs6)

        def unary_dense_cuda():
            calls["unary_dense_cuda"] += 1
            momT, found = FL.probe_moments(vmap, pts, mask, T)
            return FL.linearize_vgicp_unary_dense(pts, momT, found, T, 1.0, src_covs6=covs6)

        def moments_plain():
            momT, found = FL.probe_moments(vmap, pts, mask, T)
            return FL.linearize_vgicp_moments_plain(pts, momT, found, T, 1.0, 1e-3, covs6)

        def unary_plain():
            momT, found = FL.probe_moments(vmap, pts, mask, T)
            return FL.linearize_vgicp_unary_plain(pts, momT, found, T, 1.0, 1e-3, covs6)

        def planar_plain():
            pm = planar.transform(T, pts)
            found, _, mu, C6 = lookup_fetch_planar(vmap, pm, mask)
            fused = C6 + (planar.sym_rotate(T[:3, :3], covs6) if covs6 is not None else eps_eye6)
            return planar.linearize_point_system(pts, pm, pm - mu, planar.sym_inv(fused), found, T[:3, :3])

        return {"moments_fused": (moments_fused, "moments_"), "planar_fused": (planar_fused, "linearize_"),
                "unary_cuda": (unary_cuda, "unary_"), "unary_dense_cuda": (unary_dense_cuda, "unary_"),
                "moments_plain": (moments_plain, None), "unary_plain": (unary_plain, None),
                "planar_plain": (planar_plain, None)}

    out = {}
    _zero_counts(FL)
    for covs6 in (covs_all, None):
        mode = "covs" if covs6 is not None else "eps"
        race = routes(covs6)
        k4, k3, k1, k5, u_plain, p_plain = (race[k][0]() for k in (
            "moments_fused", "planar_fused", "unary_cuda", "unary_dense_cuda", "unary_plain", "planar_plain"))
        torch.cuda.synchronize()
        _check_close(torch, f"[race] {mode}: K4 vs the K3 route, full system", k4, k3, K4_TOL)
        _check_close(torch, f"[race] {mode}: K4 vs K1, source block", _source_block(k4), _source_block(k1), K4_TOL)
        _check_close(torch, f"[race] {mode}: K5 vs K1, source block", _source_block(k5), _source_block(k1), K4_TOL)
        _check_close(torch, f"[race] {mode}: K1's plain route vs K1, source block", _source_block(u_plain),
                     _source_block(k1), K4_TOL)
        _check_close(torch, f"[race] {mode}: the plain point system vs the K3 route, full system", p_plain, k3, K4_TOL)
        for name, (fn, key) in race.items():
            ms = _median_ms(torch, fn, reps=RACE_CALLS)
            all_us = _device_us_per_call(torch, fn, "")
            own_us = None if key is None else _device_us_per_call(torch, fn, key)
            out[f"{name} {mode}"] = {"ms": ms, "device_us": all_us, "own_us": own_us}
            own = "" if key is None else (f", its '{key}' kernels {own_us:.3f} us" if own_us is not None
                                          else ", its kernels not measured")
            device = "not measured" if all_us is None else f"{all_us:.3f} us"
            log(f"[race] {mode} {name}: {ms:.4f} ms median of {RACE_CALLS} calls (wrapper, CUDA events), "
                f"device {device} per call (all kernels){own}")
    if profile:
        root, ext = os.path.splitext(profile)
        scan_linearize = routes(covs_all)["moments_fused"][0]

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                scan_linearize()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, 100

        _trace(torch, "100 single-scan linearizes", run, "call", "moments_", f"{root}_scan{ext}")
        dense = routes(covs_all)["unary_dense_cuda"][0]

        def run_dense():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                dense()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, 100

        _trace(torch, "100 single-scan linearizes on K5", run_dense, "call", "unary_", f"{root}_dense{ext}")
    launches, dense_launches = FL.moments_launches, FL.dense_launches
    log(f"[race] K4 launches {launches} for {calls['moments_fused']} vgicp_scan_linearize calls; "
        f"K5 launches {dense_launches} for {calls['unary_dense_cuda']} probe_moments + "
        f"linearize_vgicp_unary_dense calls; K3 {FL.launches}, K1 {FL.unary_launches}")
    if launches != calls["moments_fused"] or launches == 0:
        raise AssertionError(f"K4 launched {launches} times for {calls['moments_fused']} calls")
    if dense_launches != calls["unary_dense_cuda"] or dense_launches == 0:
        raise AssertionError(f"K5 launched {dense_launches} times for {calls['unary_dense_cuda']} calls")
    return {"launches": launches, "dense_launches": dense_launches, "race": out}


def k2_bound_ms(args) -> tuple:
    """The least time for K2 on these inputs: each input read once (each
    lane's moment rows, found flags and pose; the shared p and C_s when
    given), each lane's 29 sums written once; K1_FLOPS_PER_POINT for each
    point of each lane that passes the gate here."""
    p, momT_b, found_b, _, mvp, _, sc = args
    lanes, n = momT_b.shape[0], p.shape[1]
    nbytes = lanes * (40 + 1) * n + (12 + (24 if sc is not None else 0)) * n + lanes * 64 + lanes * 29 * 4
    gate = int((found_b & (momT_b[:, 0] >= mvp)).sum())
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = K1_FLOPS_PER_POINT * gate / PEAK_FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _k2_poses(torch, kind: str, T_reg=None):
    """K2_LANES poses [B, 4, 4], contiguous: "parity", tpu_parity's lanes;
    "identity"; "spread", T_reg times se3_exp of a uniform(-0.1, 0.1, 6)
    twist of RandomState(K2_SPREAD_SEED) for each lane."""
    import numpy as np

    from gtsam_points_tpu_torch.utils import se3

    if kind == "identity":
        return torch.eye(4, device="cuda").repeat(K2_LANES, 1, 1)
    if kind == "parity":
        T = se3.se3_exp(torch.tensor(K1_TWIST)).to("cuda", torch.float32).repeat(K2_LANES, 1, 1)
        T[:, 0, 3] += 1e-6 * torch.arange(K2_LANES, dtype=torch.float32, device="cuda")
        return T
    xis = np.random.RandomState(K2_SPREAD_SEED).uniform(-0.1, 0.1, (K2_LANES, 6)).astype(np.float32)
    return (T_reg @ se3.se3_exp(torch.from_numpy(xis).cuda())).contiguous()


def _k2_args(torch, vmap, pts, mask, covs6, poses, n=None, half=None):
    """K2's inputs for the lanes `poses` [B, 4, 4] on the first n points:
    each lane's moment rows and found flags from its own probe at its own
    pose, stacked into contiguous [B, 10, N] and [B, N]; `half` [B, N]
    clears a different half of each lane's found flags."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL

    pts = pts[:, :n].contiguous()
    probes = [FL.probe_moments(vmap, pts, mask[:n], T) for T in poses]
    momT_b = torch.stack([m for m, _ in probes])
    found_b = torch.stack([f for _, f in probes])
    if half is not None:
        found_b = found_b & half[:, :n]
    return (pts, momT_b, found_b, poses, K2_MIN_POINTS, 1e-3,
            None if covs6 is None else covs6[:, :n].contiguous())


def _lane_err(torch, lin, ref) -> tuple:
    """-> (max abs error, worst error / max|ref|) over the lanes and fields;
    the scale is max|ref| of the field in its own lane."""
    worst_abs, worst_rel = 0.0, 0.0
    for a, b in zip(lin, ref):
        a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
        err = (a - b).abs().amax(1)
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, float((err / (b.abs().amax(1) + 1e-9)).max()))
    return worst_abs, worst_rel


def _check_lanes(torch, label: str, lin, ref, tol: float) -> float:
    """Per lane: error over max|ref| of every field, and equal inlier counts,
    or raise. -> the max abs error."""
    abs_err, rel_err = _lane_err(torch, lin, ref)
    same_count = torch.equal(lin.num_inliers, ref.num_inliers)
    log(f"{label}: valid {int(ref.num_inliers.sum())} in {ref.num_inliers.shape[0]} lanes "
        f"max_abs_err={abs_err:.3e} err/max|ref|={rel_err:.3e} (tol {tol}), inlier counts equal {same_count}")
    if rel_err > tol or not same_count:
        raise AssertionError(f"{label} disagree")
    return abs_err


def _k1_lanes(torch, args):
    """K1 launched once per lane on that lane's inputs, stacked."""
    from gtsam_points_tpu_torch.factors.linearized import Linearized
    from gtsam_points_tpu_torch.ops import fused_linearize as FL

    p, momT_b, found_b, deltas, *rest = args
    lins = [FL.linearize_vgicp_unary_cuda(p, momT_b[b], found_b[b], deltas[b], *rest)
            for b in range(deltas.shape[0])]
    return Linearized(*(torch.stack(f) for f in zip(*lins)))


def phase_k2(torch, source, vmap, T_reg) -> None:
    """K2 against its plain version and, lane by lane, against K1 on the
    lane's own inputs, both at K1_TOL; against K2 launched on each lane
    alone (B = 1) and against a second K2 call, both bit for bit; on scan 1
    (`source`) against scan 0's leaf-1.0 map: B = 1, 2 and 64; N = 1, 1000,
    25087 and 25088; with and without source covariances; a different half
    of the found flags cleared in each lane; lanes at tpu_parity's poses, at
    the identity, and spread around `T_reg`, the card's registration of scan
    1. (K2 sums in its own order, so K1's bits are not its bits.) Then its
    16-byte and scalar load paths on the same values, bit for bit, each
    with its device us per launch pair."""
    from gtsam_points_tpu_torch.factors.linearized import Linearized

    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.registration.pyramid import _source_planar

    pts, covs_all = (t.contiguous() for t in _source_planar(source))
    n_all = pts.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(5)
    half = torch.rand((K2_LANES, n_all), generator=gen, device="cuda") > 0.5
    poses = {k: _k2_poses(torch, k, T_reg) for k in ("parity", "identity", "spread")}

    def args(kind="parity", lanes=K2_LANES, n=None, covs=True, half_mask=False):
        return _k2_args(torch, vmap, pts, source.mask, covs_all if covs else None, poses[kind][:lanes].contiguous(),
                        n, half[:lanes] if half_mask else None)

    cases = [(f"B=1 N={n_all} covs parity", dict(lanes=1)),
             (f"B=2 N={n_all} covs parity", dict(lanes=2)),
             (f"B=2 N={n_all} eps parity", dict(lanes=2, covs=False))]
    cases += [(f"B={K2_LANES} N={n} covs parity", dict(n=n)) for n in (1, 1000, n_all - 1)]
    cases += [(f"B={K2_LANES} N={n_all - 1} eps parity", dict(n=n_all - 1, covs=False))]
    for kind in poses:
        for covs in (True, False):
            mode = "covs" if covs else "eps"
            cases.append((f"B={K2_LANES} N={n_all} {mode} {kind}", dict(kind=kind, covs=covs)))
            cases.append((f"B={K2_LANES} N={n_all} {mode} half-mask {kind}", dict(kind=kind, covs=covs, half_mask=True)))
    expanded = args(lanes=2)
    expanded = expanded[:1] + (expanded[1][:1].expand(2, -1, -1),) + expanded[2:]
    try:
        FL.linearize_vgicp_unary_batch_cuda(*expanded)
        raise AssertionError("K2's wrapper took an expanded momT_b")
    except ValueError:
        pass
    def bits_differ(x, y) -> int:
        """Lane-fields of two Linearized whose values differ in any bit."""
        return sum(int((a.reshape(a.shape[0], -1).view(torch.int32) != b.reshape(b.shape[0], -1).view(torch.int32))
                       .any(1).sum()) for a, b in zip(x, y))

    for name, kw in cases:
        a = args(**kw)
        lin = FL.linearize_vgicp_unary_batch_cuda(*a)
        again = FL.linearize_vgicp_unary_batch_cuda(*a)
        alone = Linearized(*(torch.cat(f) for f in zip(*(
            FL.linearize_vgicp_unary_batch_cuda(a[0], a[1][b:b + 1], a[2][b:b + 1], a[3][b:b + 1], *a[4:])
            for b in range(a[3].shape[0])))))
        ref = FL.linearize_vgicp_unary_batch_plain(*a)
        k1 = _k1_lanes(torch, a)
        torch.cuda.synchronize()
        _check_lanes(torch, f"[k2] {name}: K2 vs plain", lin, ref, K1_TOL)
        _check_lanes(torch, f"[k2] {name}: K2 vs K1 lane by lane", lin, k1, K1_TOL)
        alone_differ, again_differ = bits_differ(lin, alone), bits_differ(lin, again)
        log(f"[k2] {name}: K2 vs K2 launched on each lane alone: {alone_differ} lane-fields differ in any bit "
            f"(must be 0); two K2 calls: {again_differ} (must be 0)")
        if alone_differ:
            raise AssertionError(f"K2's lane depends on the lanes beside it ({name})")
        if again_differ:
            raise AssertionError(f"two K2 calls on the same input differ ({name})")

    # The same values through K2's other load path: the kernel takes 16-byte
    # loads only where N % 4 == 0 and every plane is 16-byte aligned, so a
    # copy of momT_b 4 bytes off that boundary takes the guarded scalar loads.
    for covs in (True, False):
        a = args(covs=covs)
        shifted = torch.empty(a[1].numel() + 1, dtype=torch.float32, device="cuda")[1:].view(a[1].shape)
        shifted.copy_(a[1])
        if a[1].data_ptr() % 16 or not shifted.data_ptr() % 16 or a[0].shape[1] % 4:
            raise AssertionError("K2's load paths are not the ones meant")
        paths = {"16-byte loads": a, "scalar loads": a[:1] + (shifted,) + a[2:]}
        lins = [FL.linearize_vgicp_unary_batch_cuda(*x) for x in paths.values()]
        torch.cuda.synchronize()
        differ = bits_differ(*lins)
        us = {k: _device_us_per_call(torch, lambda x=x: FL.linearize_vgicp_unary_batch_cuda(*x), "unary_batch_")
              for k, x in paths.items()}
        log(f"[k2] B={K2_LANES} N={n_all} {'covs' if covs else 'eps'}: load paths differ in {differ} lane-fields "
            f"(must be 0); device per launch pair " + ", ".join(
                f"{k} {'not measured' if v is None else f'{v:.3f} us'}" for k, v in us.items()))
        if differ:
            raise AssertionError("K2's two load paths disagree")


def phase_batch_race(torch, source, vmap, profile: Optional[str]) -> dict:
    """The batched linearize, raced as scripts/tpu_parity.py's batched
    dispatch gate races it: K2_LANES lanes at tpu_parity's poses over scan 1
    (N = 25088), each with the moment rows of its own probe, with and
    without source covariances. Three routes: K2 (one launch pair), K1
    launched once per lane (then stacked) and the plain vmapped version, the
    port of the reference's production route. Each route's median wrapper
    ms over RACE_CALLS calls (CUDA events) and device us per call from a
    profiler trace, all kernels and the route's own pair; the routes'
    systems held to each other. K2's launches over the phase are counted and
    must equal its route's calls. With `profile`, 100 K2 calls with
    covariances are traced too (table next to `profile`)."""
    from gtsam_points_tpu_torch.factors.linearized import Linearized
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.registration.pyramid import _source_planar

    pts, covs_all = (t.contiguous() for t in _source_planar(source))
    deltas = _k2_poses(torch, "parity")
    calls = {"unary_batch_cuda": 0}

    def routes(a):
        def unary_batch_cuda():
            calls["unary_batch_cuda"] += 1
            return FL.linearize_vgicp_unary_batch(*a)

        def unary_loop_cuda():
            lins = [FL.linearize_vgicp_unary(a[0], a[1][b], a[2][b], a[3][b], *a[4:]) for b in range(K2_LANES)]
            return Linearized(*(torch.stack(f) for f in zip(*lins)))

        def unary_batch_plain():
            return FL.linearize_vgicp_unary_batch_plain(*a)

        return {"unary_batch_cuda": (unary_batch_cuda, "unary_"), "unary_loop_cuda": (unary_loop_cuda, "unary_"),
                "unary_batch_plain": (unary_batch_plain, None)}

    out = {"race": {}}
    _zero_counts(FL)
    for covs6 in (covs_all, None):
        mode = "covs" if covs6 is not None else "eps"
        a = _k2_args(torch, vmap, pts, source.mask, covs6, deltas)
        race = routes(a)
        k2, loop, plain = (fn() for fn, _ in race.values())
        torch.cuda.synchronize()
        err = _check_lanes(torch, f"[batch] {mode}: K2 vs the plain vmapped route", k2, plain, K1_TOL)
        _check_lanes(torch, f"[batch] {mode}: K2 vs K1 once per lane", k2, loop, K1_TOL)
        bound, bound_by = k2_bound_ms(a)
        log(f"[batch] {mode}: B={K2_LANES} N={a[0].shape[1]}, {int(plain.num_inliers.sum())} gated points over "
            f"the lanes, K2 bound {bound * 1e3:.4f} us ({bound_by}); no single PyTorch call computes this function")
        if mode == "covs":
            out.update(max_abs_err=err, bound_ms=bound, bound_by=bound_by)
        for name, (fn, key) in race.items():
            ms = _median_ms(torch, fn, reps=RACE_CALLS)
            all_us = _device_us_per_call(torch, fn, "")
            own_us = None if key is None else _device_us_per_call(torch, fn, key)
            out["race"][f"{name} {mode}"] = {"ms": ms, "device_us": all_us, "own_us": own_us}
            own = "" if key is None else (f", its '{key}' kernels {own_us:.3f} us" if own_us is not None
                                          else ", its kernels not measured")
            device = "not measured" if all_us is None else f"{all_us:.3f} us"
            log(f"[batch] {mode} {name}: {ms:.4f} ms median of {RACE_CALLS} calls (wrapper, CUDA events), "
                f"device {device} per call (all kernels){own}")
        by_ms = min(race, key=lambda k: out["race"][f"{k} {mode}"]["ms"])
        timed = [k for k in race if out["race"][f"{k} {mode}"]["device_us"] is not None]
        by_us = min(timed, key=lambda k: out["race"][f"{k} {mode}"]["device_us"]) if timed else "not measured"
        log(f"[batch] {mode}: fastest route by wrapper ms {by_ms}, by device us {by_us} (recorded, not gated)")
    if profile:
        root, ext = os.path.splitext(profile)
        batch = routes(_k2_args(torch, vmap, pts, source.mask, covs_all, deltas))["unary_batch_cuda"][0]

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                batch()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, 100

        _trace(torch, f"100 batched linearizes of {K2_LANES} lanes", run, "call", "unary_", f"{root}_batch{ext}")
    launches = FL.unary_batch_launches
    log(f"[batch] K2 launches {launches} for {calls['unary_batch_cuda']} linearize_vgicp_unary_batch calls; "
        f"K1 {FL.unary_launches}")
    if launches != calls["unary_batch_cuda"] or launches == 0:
        raise AssertionError(f"K2 launched {launches} times for {calls['unary_batch_cuda']} calls")
    out["launches"] = launches
    return out


def phase_k5(torch, source, maps, T_reg) -> dict:
    """K5 against its plain version and, on the source block, against K1,
    on scan 1 (`source`, moved back by the true prior) against scan 0's
    leaf-1.0 map (`maps[-1]`) and on the stride-8 stage against the leaf-4
    map (`maps[0]`): the tails of the dense view, both modes, both gates,
    half masks, at the identity, at K1_TWIST's pose and at `T_reg`, the
    card's registration of scan 1. Each case calls K5 twice with no host
    read allowed, and the two calls must agree bit for bit. Then times and
    device us per launch pair beside K1's, on bench.py's race case (N = 25088,
    covariances, min_voxel_points 1) and at N = 1, 8 and the stride-8 stage."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.registration.pyramid import _source_planar
    from gtsam_points_tpu_torch.utils import se3

    pts_all, covs_all = (t.contiguous() for t in _source_planar(source))
    n_all = pts_all.shape[1]
    half = torch.rand(n_all, generator=torch.Generator(device="cuda").manual_seed(6), device="cuda") > 0.5
    poses = {
        "identity": torch.eye(4, device="cuda"),
        "twist": se3.se3_exp(torch.tensor(K1_TWIST)).to("cuda", torch.float32).contiguous(),
        "registered": T_reg.contiguous(),
    }

    def k5_args(pose="twist", n=None, covs=True, mvp=1.0, half_mask=False, stride=1):
        """K5's inputs as bench.py's `unary_dense` route makes them: every
        plane contiguous, the moment rows of a probe at the pose."""
        cut = slice(0, n, stride)
        pts = pts_all[:, cut].contiguous()
        momT, found = FL.probe_moments(maps[0] if stride == 8 else maps[-1], pts, source.mask[cut], poses[pose])
        if half_mask:
            found = found & half[cut]
        return (pts, momT, found, poses[pose], mvp, 1e-3, covs_all[:, cut].contiguous() if covs else None)

    cases = [(f"N={n_all} {'covs' if c else 'eps'} {k}", dict(pose=k, covs=c)) for k in poses for c in (True, False)]
    cases += [(f"N={n} covs twist", dict(n=n)) for n in (1, 7, 8, 3136, 4095, 4096, 4097, n_all - 1)]
    cases += [(f"N={n} eps twist", dict(n=n, covs=False)) for n in (1, 7, 4097)]
    cases += [
        (f"N={n_all} covs twist min_voxel_points 3 (tpu_parity's dense gate)", dict(mvp=3.0)),
        (f"N={n_all} eps twist min_voxel_points 3", dict(mvp=3.0, covs=False)),
        (f"N={n_all} covs half-mask twist", dict(half_mask=True)),
        (f"N={n_all} eps half-mask registered", dict(pose="registered", covs=False, half_mask=True)),
        (f"N={n_all} covs half-mask identity min_voxel_points 3", dict(pose="identity", half_mask=True, mvp=3.0)),
        ("stride 8 leaf 4 covs twist", dict(stride=8)),
        ("stride 8 leaf 4 eps registered", dict(stride=8, covs=False, pose="registered")),
    ]
    strided = k5_args(stride=8)
    try:
        FL.linearize_vgicp_unary_dense_cuda(pts_all[:, ::8], *strided[1:])
        raise AssertionError("K5's wrapper took a non-contiguous source")
    except ValueError as e:
        if "contiguous" not in str(e):
            raise
    for name, kw in cases:
        args = k5_args(**kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host read inside raises
        try:
            lin = FL.linearize_vgicp_unary_dense_cuda(*args)
            again = FL.linearize_vgicp_unary_dense_cuda(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref = FL.linearize_vgicp_unary_dense_plain(*args)
        k1 = FL.linearize_vgicp_unary_cuda(*args)
        torch.cuda.synchronize()
        _check_close(torch, f"[k5] {name}: K5 vs plain", lin, ref, K1_TOL)
        _check_close(torch, f"[k5] {name}: K5 vs K1, source block", _source_block(lin), _source_block(k1), K1_TOL)
        differ = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(lin, again))
        log(f"[k5] {name}: two K5 calls differ in {differ} values (must be 0)")
        if differ:
            raise AssertionError(f"two K5 calls on the same input differ ({name})")

    out = {}
    for key, kw in (("main", {}), ("stride8", dict(stride=8)), ("N=8", dict(n=8)), ("N=1", dict(n=1))):
        args = k5_args(**kw)
        lin = FL.linearize_vgicp_unary_dense_cuda(*args)
        abs_err, _ = _max_err(torch, lin, FL.linearize_vgicp_unary_dense_plain(*args))
        bound, bound_by = k1_bound_ms(args + (None,))
        r = {
            "n": args[0].shape[1],
            "max_abs_err": abs_err,
            "ms": _median_ms(torch, lambda: FL.linearize_vgicp_unary_dense_cuda(*args)),
            "plain_ms": _median_ms(torch, lambda: FL.linearize_vgicp_unary_dense_plain(*args)),
            "device_us": _device_us_per_call(torch, lambda: FL.linearize_vgicp_unary_dense_cuda(*args), "unary_"),
            "k1_device_us": _device_us_per_call(torch, lambda: FL.linearize_vgicp_unary_cuda(*args), "unary_"),
            "bound_ms": bound,
            "bound_by": bound_by,
        }
        device, k1_device = ("not measured" if v is None else f"{v:.3f} us" for v in (r["device_us"], r["k1_device_us"]))
        log(f"[k5] {key} (N={r['n']}, {FL.unary_dense_num_blocks(r['n'])} blocks): kernel {r['ms']:.4f} ms (wrapper, "
            f"CUDA events), device {device} per launch pair, K1 {k1_device} per launch pair on the same inputs, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}); no single "
            "PyTorch call computes this function")
        out[key] = r
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="profile three steps, the pyramid, the single-scan linearize on K4 and on K5 "
                             "and the batched linearize, tables to PATH, PATH_pyramid, PATH_scan, PATH_dense "
                             "and PATH_batch")
    parser.add_argument("--k3-witness", metavar="TREE",
                        help="only read the K3 of the checkout at TREE on phase 3's payloads against float64, "
                             "then exit")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.k3_witness) if args.k3_witness else ROOT
    sys.path.insert(0, tree)
    import gtsam_points_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.k3_witness:
        if not gtsam_points_tpu_torch.__file__.startswith(tree + os.sep):
            raise RuntimeError(f"gtsam_points_tpu_torch came from {gtsam_points_tpu_torch.__file__}, not {tree}")
        phase_environment(torch)
        k3_witness(torch, args.k3_witness)
        return 0

    t_start = time.perf_counter()
    kind = phase_environment(torch)
    phase_build()
    k3_payloads = phase_k3(torch)
    scans, frames, priors, k3 = phase_main_path(torch, args.profile, k3_payloads)
    phase_plain_vs_cuda(torch, frames, priors)
    inputs = phase_pyramid_inputs(torch, scans, priors)
    k1 = phase_k1(torch, *inputs["card"][:2])
    pyramid = phase_pyramid(torch, inputs, args.profile)
    log(f"[digest] phase 7's K1 outputs and phase 8's poses: sha256 "
        f"{_digest([t for lin in k1['outputs'] for t in lin] + [pyramid['poses']])}")
    source, maps, _ = inputs["card"]
    k4 = phase_k4(torch, source, maps[-1], pyramid["poses"][0])
    race = phase_race(torch, source, maps[-1], args.profile)
    phase_k2(torch, source, maps[-1], pyramid["poses"][0])
    batch = phase_batch_race(torch, source, maps[-1], args.profile)
    k5 = phase_k5(torch, source, maps, pyramid["poses"][0])
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
    }, {
        "name": "vgicp_unary",
        "route": "cuda",
        "source": "gtsam_points_tpu_torch/csrc/vgicp_unary.cu",
        "replaces": "gtsam_points_tpu/ops/pallas_linearize.py:500",
        "launches": pyramid["launches"],
        "max_abs_err": k1["main"]["max_abs_err"],
        "ms": k1["main"]["ms"],
        "plain_ms": k1["main"]["plain_ms"],
        "bound_ms": k1["main"]["bound_ms"],
        "bound_by": k1["main"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "vgicp_moments",
        "route": "cuda",
        "source": "gtsam_points_tpu_torch/csrc/vgicp_moments.cu",
        "replaces": "gtsam_points_tpu/ops/pallas_linearize.py:275",
        "launches": race["launches"],
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
    }, {
        "name": "vgicp_unary_batch",
        "route": "cuda",
        "source": "gtsam_points_tpu_torch/csrc/vgicp_unary_batch.cu",
        "replaces": "gtsam_points_tpu/ops/pallas_linearize.py:626",
        "launches": batch["launches"],
        "max_abs_err": batch["max_abs_err"],
        "ms": batch["race"]["unary_batch_cuda covs"]["ms"],
        "plain_ms": batch["race"]["unary_batch_plain covs"]["ms"],
        "bound_ms": batch["bound_ms"],
        "bound_by": batch["bound_by"],
        "library_ms": None,
    }, {
        "name": "vgicp_unary_dense",
        "route": "cuda",
        "source": "gtsam_points_tpu_torch/csrc/vgicp_unary_dense.cu",
        "replaces": "gtsam_points_tpu/ops/pallas_linearize.py:817",
        "launches": race["dense_launches"],
        "max_abs_err": k5["main"]["max_abs_err"],
        "ms": k5["main"]["ms"],
        "plain_ms": k5["main"]["plain_ms"],
        "bound_ms": k5["main"]["bound_ms"],
        "bound_by": k5["main"]["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
