#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gtsam_points_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py                     # the check, one card
    python3 chip_smoke.py --profile out.txt   # also trace three odometry steps
                                              # (graph and eager), take the
                                              # census of one LM iteration by
                                              # source, trace the eight
                                              # registrations, 100 single-scan
                                              # linearizes on K4 and 100 on K5,
                                              # and 100 batched ones; the tables
                                              # go to out.txt, out_eager.txt,
                                              # out_pyramid.txt, out_scan.txt,
                                              # out_dense.txt, out_batch.txt;
                                              # and three cluster odometry
                                              # steps, out_clusters.txt
    python3 chip_smoke.py --k3-witness TREE   # only K3 of the checkout at TREE
                                              # on phase 3's payloads against
                                              # float64 (an A/B of precision)
    python3 chip_smoke.py --unary-witness TREE  # only K1 and K5 of the checkout
                                              # at TREE timed on phase 7's
                                              # inputs (an A/B of speed)
    python3 chip_smoke.py --sass-diff TREE    # only: every kernel source of
                                              # this checkout and of TREE
                                              # built, and their SASS compared
                                              # function by function

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
     262144-voxel map, through init_odometry and make_odometry_stepper, whose
     registration is one CUDA graph replayed a step (all 10 LM iterations,
     no host read); the step median, min and max over the 24 steps; K3's
     launch count (10 a replay, added by the stepper) must be at least the LM
     iterations; K3's device us per launch pair at the path's own shape and
     on phase 3's N = 1 and N = 25000 payloads, taken after the step times;
     with --profile, three graph steps and three eager ones traced (busy
     share, kernels, launches, graph launches and host reads a step) and the
     census: each piece of one LM iteration run alone, its kernels and
     device us;
  5. the 24 steps through the graph stepper and through the eager
     odometry_step, equal bit for bit; then five steps through the CUDA path
     and through the plain path on the card, held to a stated bound per pose;
  6. the pyramid's inputs (scan 0's DEFAULT_STAGES pyramid, scan 1 with its
     covariances) built twice on the card, which must agree bit for bit, and
     once on the CPU; the card's maps and covariances held to the CPU's, and
     the card's map build from the CPU's frames compared bit for bit with
     the CPU's maps;
  7. K1 (csrc/vgicp_unary.cu) against its plain PyTorch version on the card,
     on the pyramid's own inputs at a pose off the identity and at the
     identity: N = 1, 8, 1000, 25087, 25088, half the mask False, non-unit
     weights, with and without source covariances, and the stride-8, 4 and
     2 stages' sources; each case called twice with no host read allowed,
     the two calls equal bit for bit; device us per launch pair, split
     between the partial and the final kernel, beside the bound, at N = 1
     and at the four stage shapes (N = 3136, 6272, 12544, 25088);
  8. the pyramid path at a real size: one 25k-point scan registered against
     a DEFAULT_STAGES pyramid built from the one before it, from eight
     perturbed initial poses, through build_pyramid and
     register_scan_pyramid with no host read allowed inside a registration;
     K1 must launch exactly 6 times per registration, and every pose must lie
     within a stated bound of the JAX package's pose for the same inputs,
     built on the card and built on the CPU; then one digest line, the
     sha256 of phase 7's K1 outputs and phase 8's poses from card-built
     inputs, by which two trees' runs show whether K1 moved by a bit;
  9. K4 (csrc/vgicp_moments.cu: K1's partial kernel on K1's grid, then its
     own final pass that expands K1's 29 sums to the 12x12 system) against
     its plain PyTorch version on the card, on scan 1 against scan 0's
     leaf-1.0 map: N = 1, 1000, 25087 and 25088 and half the mask False,
     with and without source covariances, each at the identity and at a pose
     off it, and at the pose the card's registration of scan 1 found; each
     case twice, equal bit for bit, and its source block equal to K1's
     without weights bit for bit;
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
 13. K5 (csrc/vgicp_unary_dense.cu) against its plain PyTorch version and
     against K1 without weights, bit for bit (K5 runs K1's partial kernel on
     K1's grid), on scan 1 against scan 0's leaf-1.0
     map and on the stride-8 stage against the leaf-4 map: N = 1, 7, 8,
     3136, 4095, 4096, 4097, 25087 and 25088; with and without source
     covariances; min_voxel_points 1 and 3 (tpu_parity's dense gate: 3,
     eps 1e-3, covariances); half the mask False; at the identity, at
     K1_TWIST's pose and at the pose phase 8 registered; each K5 call twice,
     equal bit for bit, with no host read allowed; device us per launch pair
     beside K1's at N = 1, 8, 3136 and 25088;
 14. the cluster path's inputs, on a 26k-point ring world whose 25k-point
     scans see nearly all of it (built once on the card, covariances as in
     phase 4): scan 1, moved back by the true relative pose, clustered by
     cluster_source at DEFAULT_CLUSTER_LEAF into DEFAULT_CLUSTER_CAPACITY
     slots twice on the card (equal bit for bit) and once on the CPU (mask
     and weights bit for bit, centroids and covariances within their
     tolerances); the occupied and the dropped cells; every odometry frame
     clustered at the map's leaf;
 15. K1 with weights and covariances on the cluster pyramid's shapes (N =
     1408, 2816, 5632) at the identity and at the pose phase 16 registers,
     held to its plain version at K1_TOL of each field's summand scale
     (max|ref| for H_ss and the error), each case twice bit for bit with
     no host read allowed;
     the plain version with its weights or C_s dropped must fail that
     check; device us per launch pair beside the bound; the plain weighted
     route's device us at N = 5632, a witness;
 16. the cluster pyramid at the JAX package's headline shape: 64
     registrations of the clusters against scan 0's DEFAULT_CLUSTER_STAGES
     pyramid through register_clusters_pyramid, no host read inside a
     registration, K1 exactly 7 launches each, each pose within 1e-3 m and
     1e-3 rad of the JAX package's pose for the same inputs, or within
     twice the distance by which the order of the sums alone moves that
     init's JAX pose where that is larger; ms a registration;
 17. cluster odometry at the real size: 24 steps of the default
     262144-voxel map with each frame's clusters, through the graph stepper
     (K1 10 launches a replay) and the eager odometry_step, equal bit for
     bit; the step median held to 100 ms, host reads a step, ATE held to the
     JAX package's cluster ATE plus 10%; with --profile, three graph steps
     traced (table in PATH_clusters);
 18-22. the two-scan path on the same world: the hash grid and kNN against
     the CPU port (18), the kNN features (19), K3 on GICP, ICP and
     point-to-plane payloads (20), the two-scan registrations against the
     JAX package's poses (21), GICP frame-to-frame odometry (22);
 23. the multi-frame chain graph (the reference's demo_matching_cost_factors
     protocol) over the first 16 scans: voxelgrid_sampling on the card equal
     to the CPU port's bit for bit, kNN features, a prior and the binary
     edges (i, i+1), (i, i+2) (29 factors, a 96x96 system); GICP through
     optimize_lm, VGICP through optimize_lm, optimize_gn and optimize_dogleg,
     and the same VGICP factors as one VGICPFactorBatch through optimize_lm;
     each run three times, equal bit for bit, K3 launched iterations x 29
     times; every pose against the JAX package's, the batch against the
     list run, and against the truth within the demo's bounds;
 24. the block-sparse pose graph: 1000 poses (ten laps), noisy odometry
     BetweenFactors and loop edges, through optimize_pose_graph three times,
     equal bit for bit, every 25th pose and the error against the JAX
     package's, host reads; and a small graph of the pose and multi-key
     factors, linearize_frozen on the card against the CPU port;
 25. loop detection on phase 23's frames: estimate_fpfh of frames 0, 1 and
     15 on the card against the CPU port (neighbour tables equal, pair bins
     equal but for flips each at a bin edge or a swap tie, the rows no flip
     reaches within a bound), feature_knn's indices against the CPU port's
     (ties counted), estimate_pose_gnc on the pairs (0, 1) and (0, 15)
     against the JAX package's poses, the IRLS on the CPU port's (0, 15)
     matches against the CPU port's, errors against the truth, inlier
     rates, FPFH and GNC ms;
 26. ISAM2Ext on the first 6 of those frames (the incremental_isam2_slam
     protocol: window 3, 30 LM iterations, a prior, a VGICP factor an
     update, then the late loop closure (0, 5)), twice, equal bit for bit; every LM
     call's K3 launches equal to its iterations x its VGICP factors, K3's
     plain version not called; every update's estimates, windows, frozen
     keys, num_compiles and compiled against the JAX package's; ms an
     update, synchronizing calls an update, the relax's movement of the
     frozen poses; K3 held to its plain version on the loop factor at the
     relaxed poses;
 27. the same stream through FixedLagSmoother (3 poses kept) ending with
     add_factors([loop]), held the same way; cg_solve on phase 26's last
     window system against torch.linalg.solve;
 28. global registration (demo_global_registration) on phase 25's frames
     and FPFH, pairs (0, 1) and (0, 15): estimate_pose_ransac with 8192
     hypotheses on the card's features (timed, synchronizing calls
     counted), and on the CPU port's features and the generator's draws
     against the CPU port (within 1e-4 m and 1e-4 rad, or a tie); the GICP
     refine (unary GICP, 15 LM iterations) from the CPU port's RANSAC pose
     and from the JAX GNC pose, on K3 (launches = iterations, its plain
     version barred), against the JAX package's refined poses, and from
     the card's own RANSAC pose (the demo's chain) against the refine from
     the CPU port's pose, K3 held to its plain version on the refine's
     payload; voxelmap_overlap and
     overlap_auto of the refined pairs against the CPU port, equal;
 29. LOAM (with and without scan-line validation) and CT-ICP (GICP, ICP,
     point to plane; then deskew, the RMSE before and after) on a
     scan-size scene (scan_world: 20k plane and 3k edge points a scan),
     every pose against the JAX package's (LOAM's within 1e-3 m and
     1e-3 rad, its validated-to-plain gap within that of the JAX
     package's gap);
 30. bundle adjustment (demo_bundle_adjustment) on 5 keyframes of that
     scene, 12 plane and 8 edge features, EVM and LSQ, every pose against
     the JAX package's, the demo's error report;
 31. the data model on the card against the CPU port bit for bit:
     merge_frames, pad_frame, sort_by_voxel_key and sample with aux
     attributes, insert_frame_fast into phase 4's map, a save_voxelmap /
     load_voxelmap round trip;
 32. the colored factors: demo_colored_registration at its size (20000
     points on a painted plane; GICP on K3, ColoredGICP, the color
     consistency factor beside GICP), every pose against the JAX package's,
     K3 launched once an LM iteration and held to its plain version; the
     colored GICP against a voxel map's frame (test_voxelmap's protocol);
     the ivox intensity gradients and their lookup against the CPU port;
 33. a 24-keyframe LiDAR-inertial chain of ReintegratedImuFactors through
     the LM, the chained prediction and the bias Jacobians against the JAX
     package and the CPU port; align_trajectories_sim3 over 4541 poses
     against both, its synchronizing calls counted;
 34. on phase 4's scans: the occupancy grid of all 24 merged and each scan's
     overlap, card against the CPU port bit for bit; the incremental
     covariance map, 24 inserts into 262144 points with the default
     warm-up and with a warm-up of 1, single inserts replayed on the CPU
     port; its kNN searches on the final map;
 35. segmentation of phase 4's scan 0 (region growing and min-cut from a
     floor seed): on the CPU port's kNN tables the card's masks equal the
     CPU port's bit for bit, mask sizes against the JAX package's;
 36. the distributed layer: PAR_RANKS ranks spawned on the one card, each a
     process of its own joined over gloo (CUDA tensors), with K3's plain
     version barred, on a suburban drive seen by a simulated HDL-64E (scans
     thinned to 25000 points, as KITTI's are in the demo's data): the
     distributed_mapping demo on the drive's scans 0 and 1 (voxelgrid 0.5,
     an 8-shard map of 8192 voxels a shard, a prior and the map-sharded
     VGICP factor through 20 LM iterations, three runs; then scan 1 inserted
     and its overlap), the map of the drive's 24 keyframes, 40 m apart, at
     their true poses in 8 shards of 49152 voxels and the linearize of the
     last keyframe on it, and optimize_lm_sharded on an 8-factor VGICPFactorBatch of
     25000-point sources, one factor a rank; every sharded linearize within
     1e-4 x max|ref| of the replicated map's K3 on the card, the poses
     within 1e-3 m and 1e-3 rad of the JAX package's (or twice its order
     shift), every rank's poses and reduced systems equal bit for bit,
     overflow and voxel counts equal to the CPU port's, K3 once an LM
     iteration a local factor; ms a registration and a linearize,
     collectives and bytes an LM iteration, each rank's voxels;
then one JSON line for all five kernels (K3, K1, K4, K2, K5; K3's and K1's
launches on each of their paths) and, last, the device line.

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
K3_BYTES_PER_POINT = 12 + 12 + 24 + 1  # p, mu, W6 (f32) and the mask byte
# K1 fp32 operations per point that passes its gate, counted from
# add_point_terms in csrc/unary_point.cuh: moment finalize 22, Rᵀ C_t R 75, + C_s 6, inverse and
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
# The step limit: one period of a 10 Hz LiDAR (PERF.md section 2).
STEP_LIMIT_MS = 100.0
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
# K4 fp32 operations per point that passes its gate: K1's (csrc/vgicp_moments.cu
# runs K1's partial kernel), with eps I (3) in place of + C_s (6) in eps mode;
# the 29 -> 92 expansion is done once a call.
K4_FLOPS_PER_POINT = {True: K1_FLOPS_PER_POINT, False: K1_FLOPS_PER_POINT - 3}
# K4's kernels in a profiler's trace: K1's partial kernel and its own final
K4_KERNELS = ("unary_partial", "moments_final")
RACE_CALLS = 200
# The cluster path (phases 14-17): a 26k-point ring world whose 25k-point
# scans see nearly all of it, 3238 occupied leaf-1.0 cells a scan (the
# 400k-point world's scans above lie within ~6 m and occupy only 264-267).
CLUSTER_WORLD_N = 26_000
CLUSTER_STEPS = 24
# The cluster pyramid: scan 1 (moved back by the true relative pose) against
# scan 0's DEFAULT_CLUSTER_STAGES pyramid (3 + 2 + 2 Gauss-Newton
# iterations), from se3_exp(RandomState(3).uniform(-0.1, 0.1, 6)) inits.
CLUSTER_INITS = 64
CLUSTER_SEED = 3
K1_LAUNCHES_PER_CLUSTER_REGISTRATION = 7
# The JAX package's final poses for the same inputs (its XLA twin on the CPU,
# top three rows row-major), printed by
#   JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0 --inits 0 --orders 0 --cluster-inits 64
# which Tier-1 also holds to these numbers for the first init.
CLUSTER_PYRAMID_JAX_POSES = [
    [0.9999999, 0.00032332278, -0.000016493823, -0.007322289, -0.0003233366, 0.9999998, -0.000006646091, 0.00010149594, 0.000016484399, 0.000006646265, 0.99999994, -0.0002634306],
    [0.99913263, 0.041641958, -0.00011002633, -0.915659, -0.04164195, 0.99913263, 0.000053234202, 0.019306922, 0.0001121505, -0.000048618047, 1., -0.0010282509],
    [0.99999994, -0.00030420633, -0.000016325634, 0.0065269545, 0.00030414367, 1., -0.000008555031, 0.00014173292, 0.000016344995, 0.000008517291, 1.0000001, -0.00028170034],
    [0.99999946, 0.0010172608, -0.000022859813, -0.02258508, -0.0010172626, 0.9999994, -0.0000063960024, 0.00039070117, 0.000022854398, 0.0000064074934, 1., -0.0003284579],
    [1.0000001, 0.00013525122, -0.00001803217, -0.0029821396, -0.00013527916, 0.99999994, -0.0000063624543, 0.00007066416, 0.000018023686, 0.0000063926527, 1., -0.0002513019],
    [0.9997606, -0.021873062, -0.00004009525, 0.48235595, 0.021873076, 0.99976057, 0.000015481739, 0.0047872066, 0.00003977196, -0.000016352178, 1., -0.0021417297],
    [0.99999994, 0.000043322852, -0.000017062815, -0.000992311, -0.000043313015, 0.9999999, -0.0000065824806, 0.000033786604, 0.000017071454, 0.000006568222, 1., -0.00025139787],
    [1., 0.000043306358, -0.000017062224, -0.0009907313, -0.000043284992, 1., -0.00000658364, 0.000036122125, 0.000017075927, 0.000006593403, 1., -0.00025140957],
    [0.9999929, 0.0037324612, -0.000031969364, -0.08260375, -0.0037324454, 0.999993, -0.000005352853, 0.001091025, 0.000031933592, 0.000005470335, 0.99999994, -0.00028891896],
    [0.99999875, -0.0014717977, -0.000012954449, 0.032249585, 0.0014717891, 0.9999989, -0.000017491453, 0.00042096394, 0.000012978052, 0.000017478971, 1., -0.0004624318],
    [1.0000001, 0.00004500042, -0.000017059552, -0.0010402066, -0.000044976823, 1.0000001, -0.0000065624345, 0.000044772594, 0.000017041071, 0.0000065845124, 1., -0.00025140683],
    [0.9991626, -0.04091817, -0.000047163034, 0.90028644, 0.040918145, 0.99916244, 0.000023556226, 0.018727649, 0.000046170717, -0.000025472462, 1., -0.0014782466],
    [0.9999999, 0.000043311502, -0.00001706257, -0.000992631, -0.000043332984, 0.9999999, -0.0000065826043, 0.00003350185, 0.000017089138, 0.0000065639406, 1., -0.0002513795],
    [0.99961424, 0.027768718, -0.00011416846, -0.6116846, -0.027768672, 0.9996143, 0.00003163881, 0.008192448, 0.000115019735, -0.000028435948, 0.99999994, -0.0022339383],
    [0.9999945, -0.0032624486, -0.000013715408, 0.071553245, 0.0032624565, 0.9999945, -0.000012468097, 0.000526012, 0.000013787981, 0.000012425237, 0.99999994, -0.0007066535],
    [0.99964374, -0.026685214, -0.000026223332, 0.58886725, 0.02668521, 0.99964386, 0.000031373234, 0.008605031, 0.00002541886, -0.000032059655, 0.99999994, -0.0018418308],
    [1., 0.000043305237, -0.000017062523, -0.0009908709, -0.000043293894, 1.0000001, -0.0000065844315, 0.000037477814, 0.000017052891, 0.000006590188, 1., -0.0002514237],
    [0.9996149, -0.027747383, -0.000020999012, 0.6122603, 0.027747378, 0.9996151, 0.000015423753, 0.008578264, 0.00002053894, -0.000015999261, 0.99999994, -0.0018513432],
    [1., 0.000043314125, -0.000017062692, -0.0009913835, -0.000043291526, 0.99999994, -0.000006582478, 0.000034811866, 0.000017057724, 0.0000065850772, 0.99999994, -0.00025136347],
    [0.99999994, 0.00004330764, -0.000017063003, -0.0009922638, -0.00004331831, 0.99999994, -0.0000065826216, 0.000034657784, 0.00001706324, 0.0000065668564, 1., -0.00025138794],
    [1., 0.000043319193, -0.000017062659, -0.0009912805, -0.00004328602, 1., -0.0000065835934, 0.000035693134, 0.0000170947, 0.000006559276, 1., -0.00025139193],
    [0.9997951, 0.020236112, -0.00015818531, -0.44626868, -0.020236101, 0.99979526, 0.00006903798, 0.0040280237, 0.00015955213, -0.0000658305, 1., -0.0010421607],
    [0.99991506, 0.013032126, -0.000086685424, -0.28791204, -0.013032112, 0.9999152, 0.000060028313, 0.0014808918, 0.000087448454, -0.00005892536, 1., -0.00038331712],
    [0.9996128, -0.027816476, -0.000020205302, 0.6136225, 0.027816465, 0.999613, 0.0000144292735, 0.008476274, 0.000019778287, -0.000014992407, 1., -0.0018656567],
    [0.99999607, -0.002856743, -0.000014472226, 0.06289789, 0.002856779, 0.99999595, -0.000014343979, 0.0003599355, 0.000014518074, 0.00001432706, 1., -0.00057484244],
    [0.9995616, -0.029603172, -0.000035655517, 0.65309656, 0.029603176, 0.99956167, 0.00004578619, 0.009440793, 0.00003427194, -0.000046830275, 0.99999994, -0.001396609],
    [0.99999964, 0.000733907, -0.00002251475, -0.016289845, -0.0007339338, 0.9999997, -0.0000059180975, 0.00027403212, 0.000022502149, 0.0000059374065, 1., -0.00031586218],
    [1., 0.00009844338, -0.00001758516, -0.0022033025, -0.00009844905, 1., -0.000006443271, 0.000036470577, 0.000017605653, 0.000006450635, 1., -0.00024769138],
    [0.9998704, -0.016090648, -0.000053352844, 0.35558358, 0.016090682, 0.9998706, 0.0000005746624, 0.0023787906, 0.000053346703, -0.0000014384132, 1., -0.0014868877],
    [0.99956155, -0.02960324, -0.000035656376, 0.6530974, 0.029603243, 0.99956167, 0.0000457855, 0.009441822, 0.00003429029, -0.000046857916, 0.99999994, -0.0013966071],
    [1.0000001, 0.00004326439, -0.000017062393, -0.000991744, -0.00004332581, 1., -0.000006583405, 0.00003581686, 0.000017100827, 0.0000066134967, 1.0000001, -0.00025146277],
    [0.9999984, -0.0018052658, -0.000010865774, 0.03946349, 0.0018052696, 0.9999984, -0.000016680639, 0.0004618112, 0.000010888667, 0.000016676891, 1., -0.00043437677],
    [0.99993587, -0.011332099, -0.000023237611, 0.25058496, 0.011332097, 0.99993587, -0.000026563754, 0.0003235275, 0.000023582752, 0.000026307553, 0.9999999, -0.0018725547],
    [0.9994578, 0.032923672, -0.000107038584, -0.7244396, -0.032923687, 0.9994579, 0.00004544838, 0.011498887, 0.00010850972, -0.000041895997, 1., -0.0014443517],
    [0.9999999, 0.00004330701, -0.000017062683, -0.000992233, -0.000043320015, 0.99999994, -0.0000065824806, 0.00003464317, 0.000017050672, 0.00000659685, 1., -0.00025136705],
    [0.99999976, 0.00013530522, -0.000018032271, -0.0029834658, -0.00013530083, 0.99999994, -0.0000063625803, 0.000070989074, 0.000018030398, 0.000006384109, 1., -0.00025127397],
    [0.9984054, 0.056450248, -0.00006135898, -1.242294, -0.056450218, 0.9984054, 0.000034611134, 0.03424493, 0.00006323641, -0.000031085823, 1., -0.0021770466],
    [1.0000001, 0.00004326083, -0.000017062473, -0.0009909582, -0.00004330524, 1., -0.0000065838253, 0.00003586687, 0.000017049795, 0.000006567181, 1., -0.00025142147],
    [0.99999994, 0.000043318305, -0.000017062373, -0.0009910773, -0.00004329954, 1., -0.000006583485, 0.000036118112, 0.000017062637, 0.0000065712015, 0.99999994, -0.00025137025],
    [0.99916315, -0.040900905, -0.000050616498, 0.90007067, 0.0409009, 0.9991632, 0.000025475812, 0.018729798, 0.00004951843, -0.000027528287, 1., -0.0014748983],
    [0.99898225, 0.04510632, -0.000075847536, -0.9919623, -0.045106336, 0.9989822, 0.000056724526, 0.02182825, 0.00007832828, -0.00005324878, 1., -0.0014758924],
    [1., 0.000067987574, -0.000017375378, -0.0015284903, -0.00006803651, 1., -0.000005979866, 0.000029976101, 0.00001737126, 0.0000060183725, 0.9999999, -0.00023836861],
    [1., 0.000043272943, -0.00001706244, -0.0009920899, -0.00004333339, 1.0000001, -0.000006584529, 0.000037417816, 0.000017052414, 0.000006580108, 1., -0.00025141714],
    [1., 0.00004276745, -0.00001704838, -0.0009852581, -0.000042776817, 1., -0.0000065794634, 0.000034137818, 0.000017059037, 0.000006555712, 0.99999994, -0.00025132013],
    [0.99999976, 0.000043308723, -0.000017062643, -0.0009927441, -0.000043338063, 1., -0.0000065833165, 0.000036238336, 0.000017069859, 0.00000658928, 0.9999998, -0.00025129705],
    [0.9999999, 0.00004499403, -0.000017059783, -0.0010421867, -0.000045037967, 0.9999998, -0.000006558907, 0.00003915938, 0.000017072123, 0.0000065522704, 0.9999999, -0.00025128445],
    [0.99999994, 0.00004332616, -0.000017062592, -0.0009908958, -0.000043296743, 1.0000001, -0.0000065843155, 0.00003750733, 0.000017064465, 0.0000065833988, 1., -0.0002514134],
    [0.99939334, -0.0348273, -0.000047902773, 0.76679415, 0.034827307, 0.9993934, 0.000030151541, 0.012985179, 0.00004681631, -0.00003180958, 1.0000001, -0.0012239551],
    [0.99950475, 0.031463273, -0.00009337062, -0.6926013, -0.031463254, 0.99950486, 0.000042543063, 0.011156959, 0.00009466387, -0.000039583705, 0.99999994, -0.0016634716],
    [1.0000001, 0.00004328897, -0.000017062503, -0.0009919637, -0.00004330356, 0.99999994, -0.000006582562, 0.000034509685, 0.000017073076, 0.0000065850945, 1., -0.0002513977],
    [0.99999994, 0.00004330968, -0.000017062353, -0.0009910079, -0.000043306623, 1., -0.000006583684, 0.000036366593, 0.000017066308, 0.0000065885483, 1., -0.00025138853],
    [0.99999994, 0.000043325646, -0.000017063, -0.0009916337, -0.000043307497, 0.99999994, -0.0000065824515, 0.000034743356, 0.000017053999, 0.000006573402, 0.99999994, -0.0002513559],
    [0.99963486, 0.027017817, -0.00012691897, -0.59536743, -0.027017836, 0.999635, 0.000039320337, 0.007893115, 0.00012792206, -0.000035902962, 0.99999994, -0.0019331456],
    [0.9997112, -0.02403277, -0.000039093615, 0.53034514, 0.024032753, 0.99971116, 0.00002911758, 0.0065210694, 0.00003838718, -0.000030035146, 1., -0.0016049009],
    [0.99999994, 0.000043301192, -0.000017063094, -0.0009924739, -0.00004332223, 1.0000001, -0.000006584573, 0.000037499503, 0.000017015813, 0.0000065732725, 1.0000001, -0.00025148035],
    [0.99788654, -0.06497818, -0.000023176384, 1.4296435, 0.0649782, 0.9978869, 0.000100063335, 0.04642753, 0.000016674077, -0.000101368154, 1.0000001, -0.0010009032],
    [1., 0.000043298613, -0.000017062212, -0.0009906958, -0.000043295942, 1.0000001, -0.0000065842205, 0.00003740318, 0.000017083632, 0.0000065949985, 1., -0.0002514143],
    [0.99903435, 0.043933794, -0.00009455319, -0.9661888, -0.0439338, 0.99903435, 0.000037915728, 0.021166096, 0.000096135, -0.00003372592, 0.9999998, -0.0014632129],
    [0.9998053, 0.019727763, -0.0001573879, -0.43533412, -0.0197278, 0.9998051, 0.00006316747, 0.0035386481, 0.00015856748, -0.000060038565, 1., -0.0012802408],
    [0.99999994, 0.000043297598, -0.000017062728, -0.0009916357, -0.000043314732, 1., -0.0000065835097, 0.00003609756, 0.000017051732, 0.000006594255, 1., -0.00025140008],
    [0.99998647, 0.0051806243, -0.000043771994, -0.11466384, -0.005180596, 0.9999866, -0.000000987442, 0.00070097577, 0.000043747415, 0.0000012060591, 1., -0.00033683475],
    [0.99999994, 0.00004503631, -0.000017060012, -0.0010413988, -0.000044990447, 1., -0.0000065611707, 0.00004294767, 0.000017083872, 0.000006573756, 0.99999994, -0.0002513505],
    [1., 0.000043304553, -0.000017062906, -0.0009915773, -0.00004331487, 0.9999999, -0.000006582246, 0.00003335495, 0.000017027187, 0.000006589727, 1., -0.00025138454],
    [0.9999508, 0.009898736, -0.0000345234, -0.21847859, -0.009898749, 0.9999509, 0.000028451374, 0.0013856343, 0.000034770375, -0.000028094504, 1., 0.000054127653],
]
# Per-pose bounds against those poses. On this scene 19 of the 64 inits end
# mid-slide along the ring corridor, where the cost is nearly flat, and the
# order of the sums alone moves them: with both scans' points in 8 other
# orders the JAX package's own poses move by up to 3.287888e-02 m and
# 1.508815e-03 rad. CLUSTER_ORDER_SHIFT_M and _RAD are each init's largest
# shift over those orders (`JAX_PLATFORMS=cpu python3
# tests/test_torch_real_size.py --steps 0 --inits 0 --orders 0
# --cluster-inits 64 --cluster-orders 8`). Each pose is held to
# CLUSTER_PYRAMID_BOUND_M and _RAD, or to CLUSTER_SHIFT_MARGIN times its own
# init's shift where that is larger: 41 inits keep 1e-3 m, the other 23
# get 1.09e-3 to 6.58e-2 m. The port on the CPU lands at most 0.51 of its
# init's bound from JAX (init 2: 1.601e-3 m against a shift of 1.576e-3 m;
# init 63: 1.992e-2 m against 2.062e-2 m; the same script's
# --cluster-inits 64), the card's run so far at most 0.51 (init 2).
CLUSTER_ORDER_SHIFT_M = [4.993e-04, 4.618e-04, 1.576e-03, 2.180e-03, 3.066e-05, 6.081e-04, 1.821e-05, 1.778e-05,
                         9.678e-03, 1.506e-03, 2.133e-05, 5.167e-03, 1.563e-05, 4.725e-03, 2.178e-02, 2.766e-04,
                         2.092e-05, 1.434e-03, 1.817e-05, 1.802e-05, 1.860e-05, 3.692e-04, 1.085e-03, 7.502e-04,
                         3.168e-05, 1.318e-04, 8.211e-05, 6.940e-04, 1.773e-02, 1.297e-04, 1.805e-05, 3.210e-05,
                         4.630e-04, 2.537e-04, 1.771e-05, 2.211e-05, 2.901e-02, 1.938e-05, 1.956e-05, 1.867e-03,
                         1.098e-03, 1.689e-05, 2.082e-05, 2.006e-05, 1.686e-05, 1.412e-05, 2.074e-05, 4.423e-03,
                         4.155e-04, 1.917e-05, 1.996e-05, 1.945e-05, 3.288e-02, 7.767e-04, 2.074e-05, 1.189e-04,
                         2.088e-05, 2.533e-03, 1.374e-03, 1.935e-05, 6.676e-03, 1.834e-05, 1.693e-05, 2.062e-02]
CLUSTER_ORDER_SHIFT_RAD = [2.063e-05, 1.917e-05, 7.350e-05, 9.989e-05, 1.031e-06, 2.730e-05, 2.290e-07, 2.633e-07,
                           4.279e-04, 6.574e-05, 2.516e-07, 2.323e-04, 2.342e-07, 2.200e-04, 9.753e-04, 1.376e-05,
                           2.615e-07, 7.230e-05, 2.485e-07, 2.380e-07, 2.419e-07, 1.601e-05, 4.888e-05, 3.338e-05,
                           1.054e-06, 6.080e-06, 3.625e-06, 3.294e-05, 8.031e-04, 5.965e-06, 2.517e-07, 1.033e-06,
                           1.912e-05, 1.070e-05, 2.428e-07, 7.746e-07, 1.314e-03, 2.544e-07, 2.326e-07, 8.854e-05,
                           4.761e-05, 3.009e-07, 2.356e-07, 2.494e-07, 2.320e-07, 2.528e-07, 2.500e-07, 1.994e-04,
                           1.818e-05, 2.468e-07, 2.503e-07, 2.415e-07, 1.509e-03, 3.648e-05, 2.362e-07, 4.684e-06,
                           2.671e-07, 1.208e-04, 6.484e-05, 2.529e-07, 3.041e-04, 2.458e-07, 2.453e-07, 9.374e-04]
CLUSTER_PYRAMID_BOUND_M = 1e-3
CLUSTER_PYRAMID_BOUND_RAD = 1e-3
CLUSTER_SHIFT_MARGIN = 2.0
# The cluster odometry's ATE bound: the JAX package's own cluster ATE over
# these 24 steps with the motion prior (the same script, --cluster-steps 24)
# plus ATE_SLACK.
CLUSTER_ATE_JAX_MEAN_M = 0.033184
CLUSTER_ATE_JAX_MAX_M = 0.161544
# The cluster-source build on the card against the CPU's, over max|ref| per
# field (the raw-moment cancellation of the covariances, ROADMAP's
# tolerances); keys, mask and weights bit for bit.
CLUSTER_CENTROID_TOL = 1e-5
CLUSTER_COV_TOL = 2e-3

# Phases 18-22: the two-scan registration (the reference's
# basic_scan_matching: PriorFactor(eye, GICP_PRIOR_WEIGHT, key=0) and a
# binary factor 0 -> 1 at GICP_MAX_CORR) and GICP frame-to-frame odometry,
# on the cluster phases' 26k-point ring world, every frame with kNN normals
# and covariances (k = 10, grid leaf 1.0). Pairs: scan 1 against scan 0
# from GICP_INITS starts T_rel @ se3_exp(uniform(-0.1, 0.1, 6)),
# RandomState(GICP_SEED), for each factor kind; steps: GICP_STEPS
# frame-to-frame steps of GICP_STEP_ITERATIONS LM iterations.
GICP_KINDS = ("gicp", "icp", "icp_plane")
GICP_INITS = 8
GICP_SEED = 2
GICP_PRIOR_WEIGHT = 1e6
GICP_MAX_CORR = 2.0
GICP_STEPS = 24
GICP_STEP_ITERATIONS = 10
# Phase 18: the coarse level's factor and a cell capacity below the ~3240
# cells scan 0 occupies at leaf 1.0 (the overflow case).
GRID_COARSE_FACTOR = 4
GRID_OVERFLOW_CELLS = 1024
# Phase 19: the card's kNN normals against the CPU port's within
# FEATURE_TOL for at least FEATURE_SHARE of the points; each other point is
# printed with its cause: a repeated smallest eigenvalue (the gap to the
# middle one under FEATURE_GAP_REL of the largest), a normal square to the
# view direction (|n·v| < FEATURE_VIEW_DOT), or its eigen gap.
FEATURE_TOL = 1e-4
FEATURE_SHARE = 0.999
FEATURE_GAP_REL = 1e-2
FEATURE_VIEW_DOT = 1e-6
# A point of the third class is held to FEATURE_GAP_EPS float32 epsilons
# over its eigen gap, on its normal and on its covariance over max|ref|: the
# card's rounding moves the eigenvector by about eps over the gap. On the
# H100 the four such points read 8.6-12.5 epsilons over the gap (PERF.md §6,
# phase 19); above a gap of about 3.8e-2 the limit is under FEATURE_TOL.
FEATURE_GAP_EPS = 32.0
# Phases 21-22: each pose 1 (each step's delta) within GICP_BOUND_M and
# _RAD of the JAX package's for the same inputs, or within
# GICP_SHIFT_MARGIN times the shift by which the order of the points alone
# moves that init's (step's) JAX pose, where that is larger.
GICP_BOUND_M = 1e-3
GICP_BOUND_RAD = 1e-3
GICP_SHIFT_MARGIN = 2.0
# The JAX package's pose 1 of each two-scan registration on the CPU, by
# factor kind and init (top three rows, row-major;
# tests/test_torch_real_size.py --gicp-pairs 8).
GICP_PAIR_JAX_POSES = {
    "gicp": [
        [0.9980265, -0.062794104, -0.0000022906866, 1.381342, 0.062794104, 0.9980265, -0.0000058388537, 0.042989306, 0.0000026580078, 0.0000056486365, 1., -0.00016612369],
        [0.99802655, -0.062794, -0.0000023323823, 1.3813391, 0.06279403, 0.9980266, -0.000005787269, 0.042986132, 0.0000026406203, 0.0000056443178, 1., -0.00016570116],
        [0.9980265, -0.06279415, -0.0000022832046, 1.3813416, 0.06279416, 0.9980265, -0.000005820104, 0.042988867, 0.000002659837, 0.000005668251, 0.99999994, -0.00016616355],
        [0.99802655, -0.062794104, -0.0000022876866, 1.3813423, 0.06279412, 0.9980265, -0.000005819653, 0.042988006, 0.000002656123, 0.0000056706704, 1., -0.0001662301],
        [0.9980265, -0.06279408, -0.000002326352, 1.381341, 0.0627941, 0.9980265, -0.0000058307346, 0.042988665, 0.0000026577948, 0.0000056665613, 1., -0.00016614603],
        [0.9980264, -0.06279407, -0.0000022948675, 1.3813412, 0.062794074, 0.99802643, -0.000005816068, 0.042990386, 0.000002654966, 0.000005646491, 1., -0.00016621218],
        [0.99802655, -0.06279406, -0.0000022551524, 1.3813388, 0.06279404, 0.9980265, -0.000005796563, 0.042989295, 0.0000026250218, 0.000005648127, 0.99999994, -0.00016572356],
        [0.99802667, -0.06279414, -0.0000031598465, 1.3813425, 0.06279413, 0.99802643, -0.000006100934, 0.04298966, 0.0000035439516, 0.0000058732476, 1., -0.00016010704],
    ],
    "icp": [
        [0.9980296, -0.06274308, 0.000030507636, 1.3806404, 0.062743075, 0.99802965, 0.000055593293, 0.041899484, -0.000033932476, -0.000053581178, 1., 0.0005631815],
        [0.9980369, -0.06262633, 0.00003080279, 1.3778814, 0.06262629, 0.99803674, 0.000049551003, 0.04091347, -0.000033800367, -0.000047526868, 1., 0.00042338425],
        [0.9991426, -0.04139863, -0.00023659434, 0.89573646, 0.041398726, 0.99914265, 0.00037091033, 0.01241238, 0.00022109505, -0.00038038535, 0.99999994, -0.015035221],
        [0.9980296, -0.06274309, 0.000030508625, 1.3806411, 0.062743075, 0.9980297, 0.000055603472, 0.04189814, -0.00003393229, -0.000053580992, 1., 0.000563208],
        [0.9988922, -0.04705859, -0.000020756943, 1.014893, 0.047058627, 0.9988921, 0.00016119372, 0.011387563, 0.000013138171, -0.00016200817, 1., -0.012534285],
        [0.9980294, -0.062743455, 0.000031503132, 1.3806345, 0.062743425, 0.99802977, 0.00005597443, 0.041896597, -0.000034958764, -0.00005390311, 1., 0.0005448974],
        [0.9990726, -0.043052107, -0.000055392415, 0.92784786, 0.043052148, 0.9990728, 0.000043463886, 0.012268809, 0.000053417538, -0.000045822635, 1., -0.015460545],
        [0.9980297, -0.06274297, 0.000031038002, 1.3806334, 0.06274295, 0.99802965, 0.000054763736, 0.04189869, -0.000034405555, -0.00005271198, 1., 0.00053069234],
    ],
    "icp_plane": [
        [0.9980283, -0.06276511, -0.000008043881, 1.3801798, 0.06276511, 0.99802834, 0.000018610759, 0.041324638, 0.0000068687295, -0.000019097397, 0.99999994, 0.000093707],
        [0.9980282, -0.06276509, -0.000008043228, 1.3801788, 0.0627651, 0.99802816, 0.000018629526, 0.0413281, 0.0000068695845, -0.000019095503, 1., 0.00009366792],
        [0.9980282, -0.062764905, -0.000007991379, 1.3801674, 0.062764905, 0.9980284, 0.000018637184, 0.041315064, 0.000006824696, -0.000019121107, 1., 0.00009504822],
        [0.9980282, -0.06276514, -0.000008021102, 1.3801802, 0.06276509, 0.9980284, 0.000018631192, 0.041322395, 0.0000068580207, -0.000019091947, 0.9999999, 0.00009360977],
        [0.9980283, -0.06276511, -0.000008104568, 1.3801799, 0.062765114, 0.99802834, 0.000018614295, 0.04132378, 0.000006856239, -0.000019090234, 1., 0.000093644885],
        [0.9980283, -0.06276511, -0.000008032681, 1.3801805, 0.06276513, 0.9980283, 0.000018599807, 0.04132527, 0.0000068547865, -0.000019089211, 1., 0.00009361429],
        [0.99802834, -0.06276511, -0.000008021668, 1.3801798, 0.06276511, 0.99802834, 0.000018634872, 0.041325156, 0.0000068563504, -0.000019089472, 1., 0.000093631636],
        [0.99802834, -0.062765114, -0.000008029928, 1.3801806, 0.062765114, 0.9980284, 0.000018635428, 0.04132265, 0.0000068562763, -0.000019092373, 1., 0.00009370178],
    ],
}
# Each init's largest pose-1 shift when the order of both scans' points
# alone changes, JAX against JAX (the same script, --gicp-orders 6).
GICP_PAIR_ORDER_SHIFT_M = {
    "gicp": [2.281e-04, 2.328e-04, 2.297e-04, 2.302e-04, 2.247e-04, 2.311e-04, 2.326e-04, 2.304e-04],
    "icp": [3.342e-04, 5.557e-04, 2.250e-03, 3.379e-04, 2.752e-03, 3.231e-04, 2.391e-03, 3.291e-04],
    "icp_plane": [7.854e-04, 7.859e-04, 7.776e-04, 7.899e-04, 7.848e-04, 7.899e-04, 7.899e-04, 7.904e-04],
}
GICP_PAIR_ORDER_SHIFT_RAD = {
    "gicp": [6.862e-06, 6.910e-06, 6.879e-06, 6.884e-06, 6.211e-06, 6.896e-06, 6.844e-06, 6.946e-06],
    "icp": [1.182e-05, 1.491e-05, 8.287e-05, 1.183e-05, 1.389e-04, 1.232e-05, 1.047e-04, 1.105e-05],
    "icp_plane": [3.418e-05, 3.417e-05, 3.404e-05, 3.419e-05, 3.424e-05, 3.419e-05, 3.418e-05, 3.419e-05],
}
# The JAX package's frame-to-frame deltas with constant velocity, its ATE
# (mean, max) and each step's order shift (the same script, --gicp-steps 24,
# --gicp-orders 6).
GICP_STEP_JAX_DELTAS = [
[0.99802643, -0.06279411, -0.0000022991037, 1.3813412, 0.06279411, 0.99802643, -0.0000058128808, 0.042989288, 0.0000026600444, 0.0000056546482, 1., -0.0001661558],
    [0.9980276, -0.0627753, 0.0000027211588, 1.3810629, 0.0627753, 0.9980276, 0.000011963677, 0.043209236, -0.0000034663526, -0.000011771654, 1., 0.00038048875],
    [0.9980268, -0.062788956, 0.000004931343, 1.3812755, 0.062788956, 0.9980268, 0.000001067469, 0.04325809, -0.0000049881755, -0.0000007581229, 1., 0.000003899014],
    [0.9980269, -0.062786885, 0.0000007735912, 1.3813139, 0.062786885, 0.9980269, -0.000013859479, 0.043265026, 0.0000000985915, 0.0000138783125, 1., -0.00031636617],
    [0.99802667, -0.06279044, -0.0000043290543, 1.3813698, 0.06279044, 0.99802667, 0.000016750322, 0.04344318, 0.0000032692144, -0.000016991487, 1., 0.00047287325],
    [0.99802727, -0.06278116, 0.0000026215614, 1.3810718, 0.06278116, 0.99802727, -0.0000047649683, 0.043103162, -0.0000023167772, 0.00000491776, 1., -0.0001195385],
    [0.99802595, -0.06280241, -0.000008854853, 1.3817822, 0.06280241, 0.99802595, 0.000006137505, 0.043097906, 0.000008452385, -0.00000668389, 1., 0.00017016393],
    [0.99802727, -0.06278155, 0.00000013549007, 1.3810714, 0.06278155, 0.99802727, -0.0000067645697, 0.043469407, 0.00000028992832, 0.0000067573365, 1., -0.00009776392],
    [0.99802697, -0.062786214, -0.0000049607193, 1.3812073, 0.062786214, 0.99802697, 0.000004598319, 0.043029808, 0.000004662682, -0.0000049031064, 1., 0.00016833213],
    [0.9980272, -0.06278198, 0.0000050216586, 1.3810658, 0.06278198, 0.9980272, 0.000007025813, 0.043325678, -0.000005452386, -0.0000066990783, 1., 0.00008259694],
    [0.99802667, -0.06279044, -0.00000063037487, 1.3813081, 0.06279044, 0.99802667, 0.0000021890642, 0.043285422, 0.00000049213986, -0.0000022267204, 1., 0.00010463393],
    [0.99802667, -0.06279066, 0.0000033443202, 1.381382, 0.06279066, 0.99802667, 0.000007485571, 0.043451857, -0.000003807284, -0.0000072632024, 1., 0.00007236313],
    [0.99802697, -0.06278608, -0.00000008882671, 1.3812777, 0.06278608, 0.99802697, -0.0000061456553, 0.04316773, 0.00000047497429, 0.00000612556, 1., -0.000035450495],
    [0.99802625, -0.06279744, -0.0000081558055, 1.3814524, 0.06279744, 0.99802625, -0.0000100130055, 0.04337042, 0.000008768961, 0.000009478687, 1., -0.00019388282],
    [0.9980268, -0.06278873, 0.000007944267, 1.3813931, 0.06278873, 0.9980268, 0.0000048847332, 0.043199003, -0.000008234838, -0.0000043786777, 1., 0.000118912925],
    [0.9980265, -0.06279309, 0.0000040816303, 1.381243, 0.06279309, 0.9980265, -0.000003401552, 0.04334322, -0.000003859521, 0.0000036487459, 1., 0.0000035785633],
    [0.9980262, -0.062797725, -0.0000012026309, 1.3814697, 0.062797725, 0.9980262, 0.0000021892658, 0.043152686, 0.0000010632372, -0.000002262859, 1., 0.000078090445],
    [0.998027, -0.062784456, -0.000007808309, 1.3813761, 0.062784456, 0.998027, -0.000011402486, 0.043467935, 0.000008509266, 0.000010887359, 1., -0.00027760642],
    [0.99802697, -0.06278553, 0.000006230136, 1.3810897, 0.06278553, 0.99802697, 0.000015187839, 0.04294311, -0.000007170962, -0.000014769103, 1., 0.00027203653],
    [0.9980264, -0.06279531, -0.000004885497, 1.3814883, 0.06279531, 0.9980264, -0.0000025998622, 0.043303486, 0.000005039574, 0.000002285554, 1., 0.000008762614],
    [0.9980271, -0.06278438, -0.0000011851002, 1.3811717, 0.06278438, 0.9980271, -0.000007057857, 0.04308449, 0.0000016263443, 0.000006967137, 1., -0.00018456359],
    [0.9980266, -0.06279152, -0.000004259072, 1.3812255, 0.06279152, 0.9980266, -0.0000039443394, 0.043340117, 0.0000044987974, 0.0000036667323, 1., 0.000021712303],
    [0.99802697, -0.06278537, 0.000004494442, 1.3811818, 0.06278537, 0.99802697, 0.0000019448607, 0.043240543, -0.0000046072255, -0.0000016612291, 1., 0.000060534396],
    [0.998027, -0.062784195, 0.0000002891957, 1.381291, 0.062784195, 0.998027, 0.000005031868, 0.043465216, -0.0000006040894, -0.0000050061753, 1., 0.000101899015],
]
GICP_STEP_ORDER_SHIFT_M = [2.858e-04, 2.229e-04, 1.651e-04, 2.144e-04, 1.484e-04, 1.799e-04, 3.063e-04, 1.914e-04,
                           1.340e-04, 1.727e-04, 1.220e-04, 3.222e-04, 1.220e-04, 1.816e-04, 1.894e-04, 1.656e-04,
                           1.410e-04, 2.468e-04, 1.981e-04, 3.334e-04, 1.806e-04, 1.686e-04, 2.253e-04, 1.475e-04]
GICP_STEP_ORDER_SHIFT_RAD = [1.043e-05, 4.361e-06, 4.929e-06, 1.021e-05, 5.245e-06, 5.188e-06, 7.119e-06, 5.111e-06,
                             8.486e-06, 7.616e-06, 3.179e-06, 1.080e-05, 5.101e-06, 6.504e-06, 6.389e-06, 9.189e-06,
                             3.669e-06, 7.907e-06, 6.364e-06, 8.178e-06, 6.300e-06, 7.858e-06, 8.560e-06, 4.837e-06]
GICP_ATE_JAX_MEAN_M = 0.002636
GICP_ATE_JAX_MAX_M = 0.004886

# Phase 23: the multi-frame chain graph (the reference's
# demo_matching_cost_factors protocol) on the first GRAPH_POSES scans of the
# same scene, each preprocessed as the examples do: voxelgrid_sampling at
# GRAPH_LEAF into GRAPH_CAPACITY slots, then kNN normals and covariances
# (k = 10, grid leaf 1.0). A PriorFactor(T_true[0], GRAPH_PRIOR_WEIGHT) on
# pose 0 and binary edges (i, i+1) and (i, i+2): GICP at GICP_MAX_CORR, and
# VGICP at leaf GRAPH_VGICP_LEAF with GRAPH_VGICP_MIN_POINTS, as a list of
# factors and as one VGICPFactorBatch. The start: T_true[i] @
# se3_exp(uniform(-0.1, 0.1, 6)) for i >= 1, RandomState(GRAPH_SEED). Each
# run's poses within GICP_BOUND_M and _RAD of the JAX package's, or within
# GICP_SHIFT_MARGIN times the shift by which the order of the points alone
# moves that JAX pose where that is larger; against the truth (relative to
# pose 0) no further than the JAX package's run times ATE_SLACK. The demo's
# bounds, GRAPH_TRUTH_M and _RAD, are printed: on the ring neither package
# meets them in these iteration counts (the walls are rings about one axis,
# which only the pillars pin, and a chain of 16 poses slides along it).
GRAPH_POSES = 16
GRAPH_LEAF = 0.5
GRAPH_CAPACITY = 16384
GRAPH_PRIOR_WEIGHT = 1e6
GRAPH_VGICP_LEAF = 1.0
GRAPH_VGICP_MIN_POINTS = 4.0
GRAPH_SEED = 42
GRAPH_RUNS = ("gicp_lm", "vgicp_lm", "vgicp_gn", "vgicp_dogleg", "vgicp_batch_lm")
GRAPH_LM_ITERATIONS = 20
GRAPH_GN_ITERATIONS = 10
GRAPH_DOGLEG_ITERATIONS = 20
GRAPH_REPEATS = 3  # each run timed this many times; every repeat equal to the first bit for bit
GRAPH_TRUTH_M = 0.15
GRAPH_TRUTH_RAD = 0.015
GRAPH_BATCH_BOUND_M = 1e-5  # the batch run's poses against the VGICP list run's on the card
# The JAX package's poses (top three rows, row-major), final errors,
# iterations and errors against the truth (m, rad, relative to pose 0) of
# each run on the CPU (tests/test_torch_real_size.py --graph-poses 16).
GRAPH_JAX_POSES = {
    "gicp_lm": [
        [-0.00000312104, -1., -0.000000022843905, 22., 0.99999994, -0.0000031392406, 0.000000012081322, 0.00000011099675, -0.000000021798302, -0.00000001695817, 1., 0.5],
        [-0.06267258, -0.9980342, 0.0000104159635, 21.957405, 0.99803424, -0.06267257, -0.000017636476, 1.3788861, 0.000018266672, 0.000009285776, 1., 0.4998149],
        [-0.12526016, -0.99212396, -0.0000028818504, 21.827236, 0.9921241, -0.12526013, -0.0000005637367, 2.756267, 0.00000019713534, -0.000002937725, 1., 0.50007284],
        [-0.18724953, -0.9823123, 0.0000023301825, 21.611473, 0.9823123, -0.18724948, -0.0000010423779, 4.11947, 0.0000014440908, 0.0000021132732, 1.0000001, 0.49997848],
        [-0.24855086, -0.96861875, 0.0000032440703, 21.310427, 0.9686188, -0.24855086, -0.0000058603073, 5.4682264, 0.0000064683754, 0.0000016910487, 1., 0.49974638],
        [-0.30901086, -0.95105845, -0.0000060138664, 20.924398, 0.9510584, -0.30901083, -0.000006850402, 6.798398, 0.0000046394543, -0.0000078340645, 0.99999994, 0.5002019],
        [-0.3677148, -0.92993873, 0.00000510786, 20.459963, 0.9299388, -0.3677147, -0.0000038017474, 8.089677, 0.000005414655, 0.0000033583126, 1., 0.4997094],
        [-0.56105155, -0.8277807, -0.000004912983, 18.214266, 0.82778084, -0.5610516, -0.000035736728, 12.343298, 0.000026821339, -0.000024114946, 1., 0.49901214],
        [-0.4808577, -0.87679845, -0.0000008126426, 19.290773, 0.87679857, -0.48085773, -0.00007318241, 10.578739, 0.00006377685, -0.00003586782, 1., 0.49969018],
        [-0.6601739, -0.7511129, 0.00000019505387, 16.529032, 0.7511129, -0.6601741, -0.000063877946, 14.525436, 0.000048115857, -0.00004200552, 1., 0.4992079],
        [-0.58676916, -0.8097542, -0.000019638592, 17.816357, 0.80975395, -0.5867691, -0.000099707875, 12.908935, 0.000069210124, -0.00007440625, 0.99999994, 0.4998932],
        [-0.7498493, -0.6616088, -0.000027062708, 14.5601635, 0.6616089, -0.7498493, -0.00006866596, 16.498308, 0.000025162053, -0.00006937209, 1.0000001, 0.4994185],
        [-0.68304574, -0.73037577, -0.000033914876, 16.07076, 0.7303754, -0.68304574, -0.00012625652, 15.0274725, 0.00006901814, -0.00011098868, 1., 0.50021005],
        [-0.8270711, -0.56209725, -0.000043698798, 12.372233, 0.56209755, -0.8270709, -0.00010161936, 18.19709, 0.000020989828, -0.00010858863, 1., 0.49976915],
        [-0.86060876, -0.5092672, -0.00003397183, 11.210081, 0.5092673, -0.86060876, -0.00010951912, 18.93516, 0.000026541098, -0.00011157834, 1.0000001, 0.4999453],
        [-0.89088076, -0.45423752, -0.0000545644, 9.999502, 0.45423743, -0.8908806, -0.0001118393, 19.600912, 0.0000021761043, -0.00012440818, 1., 0.50034297],
    ],
    "vgicp_lm": [
        [0.0000012629855, -0.99999994, 0.000000053631403, 22., 0.99999994, 0.000001262797, 0.00000005154493, -0.000000027680244, -0.000000047827896, 0.000000047419476, 1., 0.5],
        [-0.06200696, -0.99807566, 0.000020296262, 21.957512, 0.99807566, -0.062006943, 0.0000178306, 1.3654454, -0.000016506368, 0.00002133485, 1.0000001, 0.50041366],
        [-0.12507156, -0.99214774, 0.000002077406, 21.82646, 0.9921476, -0.1250716, 0.000016564325, 2.752662, -0.000016166101, 0.000004136322, 1., 0.501211],
        [-0.16687897, -0.98597735, 0.000014580539, 21.68986, 0.9859771, -0.16687901, 0.000005509556, 3.6715207, -0.0000030086028, 0.000015312608, 0.99999994, 0.5013405],
        [-0.2505101, -0.96811414, 0.000029535686, 21.296581, 0.96811414, -0.25051013, 0.0000151081695, 5.5119176, -0.0000072368407, 0.000032387336, 1., 0.50175697],
        [-0.28495285, -0.95854163, 0.000006094293, 21.086056, 0.9585414, -0.28495297, 0.000021748454, 6.26863, -0.000019099874, 0.000012028388, 1., 0.5026522],
        [-0.33897007, -0.94079715, 0.000028394985, 20.694225, 0.94079727, -0.33897, 0.00005067341, 7.4579377, -0.000038054874, 0.00004390272, 1., 0.5021393],
        [-0.4942293, -0.86933166, 0.000026299676, 19.121342, 0.8693318, -0.49422926, 0.000042215066, 10.873351, -0.00002367916, 0.00004373784, 1., 0.5030102],
        [-0.45162767, -0.8922065, 0.00006120623, 19.623215, 0.89220655, -0.4516277, 0.000056156394, 9.936295, -0.000022469494, 0.00007997327, 1., 0.50256914],
        [-0.6034082, -0.7974323, 0.00006160849, 17.538576, 0.79743207, -0.60340846, 0.000020367057, 13.275097, 0.000020940359, 0.00006142722, 1., 0.5032765],
        [-0.54627794, -0.83760405, 0.000053122312, 18.42161, 0.83760387, -0.546278, 0.00003489867, 12.017964, -0.00000021947926, 0.00006354341, 1., 0.50417995],
        [-0.69981843, -0.71432066, 0.000029144121, 15.709065, 0.7143206, -0.69981855, 0.00004083109, 15.395384, -0.000008786061, 0.00004939648, 1., 0.5046044],
        [-0.64557946, -0.76369315, 0.000034566005, 16.795046, 0.76369315, -0.6455792, 0.000019254383, 14.201816, 0.000007587944, 0.00003884548, 1.0000001, 0.5054752],
        [-0.7824421, -0.6227233, 0.000041672738, 13.693211, 0.62272334, -0.7824423, 0.000037109683, 17.212189, 0.000009475269, 0.000054996563, 1., 0.5051962],
        [-0.819829, -0.5726084, 0.00006496687, 12.5903635, 0.5726083, -0.8198289, 0.000051650102, 18.034168, 0.000023668399, 0.00007949122, 0.9999999, 0.50523275],
        [-0.85387313, -0.5204813, 0.00006208412, 11.44367, 0.520481, -0.8538731, 0.000031224477, 18.782207, 0.000036729773, 0.00005894479, 0.99999994, 0.5066353],
    ],
    "vgicp_gn": [
        [0.000020177406, -1., 0.00000012095313, 22., 1., 0.000020177407, -0.0000000822959, -0.0000005482326, 0.00000008229177, 0.0000001209544, 1., 0.5],
        [-0.06943606, -0.9975865, 0.000032092514, 21.946024, 0.99758625, -0.06943604, -0.000008859484, 1.529391, 0.0000110810215, 0.000031370786, 1., 0.50009495],
        [-0.12703788, -0.9918978, 0.000009576955, 21.820398, 0.9918978, -0.12703785, 0.000014982836, 2.796265, -0.000013656821, 0.000011409753, 0.99999994, 0.50105333],
        [-0.14177403, -0.9898991, 0.0000023057987, 21.77619, 0.989899, -0.14177406, -0.000040625593, 3.119825, 0.000040549246, -0.000003485215, 1., 0.50103307],
        [-0.25103477, -0.9679781, 0.000022694383, 21.2933, 0.96797806, -0.25103477, 0.000010602511, 5.523536, -0.0000045796937, 0.00002459925, 0.99999994, 0.50170135],
        [-0.2580532, -0.96613085, 0.000020074418, 21.252632, 0.9661308, -0.25805327, -0.000049687347, 5.6777086, 0.000053178042, 0.000006550112, 1., 0.50181293],
        [-0.30390108, -0.9527034, 0.000061212784, 20.955927, 0.9527035, -0.30390105, -0.000016042819, 6.686911, 0.00003389363, 0.000053435822, 1.0000001, 0.5010061],
        [-0.4614404, -0.8871712, 0.000057167315, 19.513952, 0.8871714, -0.46144035, -0.000023000262, 10.152469, 0.000046789188, 0.000040113602, 0.9999999, 0.5020745],
        [-0.42082122, -0.9071436, 0.00009692436, 19.951998, 0.90714353, -0.4208213, -0.000016181622, 9.258921, 0.00005545202, 0.00008114284, 1., 0.50160766],
        [-0.57549447, -0.8178055, 0.00009640957, 17.986736, 0.81780565, -0.57549447, -0.000037482518, 12.66125, 0.000086139014, 0.000057280162, 0.99999994, 0.50237745],
        [-0.5045835, -0.86336285, 0.000060892606, 18.988571, 0.8633629, -0.5045836, -0.00005317611, 11.101005, 0.00007663434, 0.000025707206, 1., 0.5037342],
        [-0.66850555, -0.7437073, 0.000058280082, 16.355991, 0.743707, -0.6685056, -0.000027001432, 14.706537, 0.00005904304, 0.000025283476, 0.99999994, 0.50399864],
        [-0.6079663, -0.7939627, 0.000052063926, 17.46124, 0.79396284, -0.60796624, -0.00006487881, 13.374699, 0.00008314813, 0.0000019034827, 1.0000001, 0.50505215],
        [-0.7501198, -0.66130203, 0.000051089777, 14.542361, 0.661302, -0.75011975, -0.000025388374, 16.501177, 0.00005507401, 0.000014760723, 0.99999994, 0.5048576],
        [-0.7906671, -0.61224616, 0.000075995675, 13.462801, 0.6122461, -0.79066706, -0.000014517405, 17.39279, 0.000069020694, 0.00003504669, 1., 0.50501007],
        [-0.82628614, -0.5632504, 0.000069727656, 12.38488, 0.5632502, -0.82628626, -0.000036462876, 18.17542, 0.00007812816, 0.000009097388, 1., 0.5065105],
    ],
    "vgicp_dogleg": [
        [0.0000029212854, -0.99999994, 0.0000001079716, 22., 0.99999994, 0.0000029220323, -0.000000022157948, -0.00000013276808, 0.000000022462505, 0.00000010908214, 1., 0.5],
        [-0.061908267, -0.9980817, 0.000019419971, 21.957684, 0.9980817, -0.0619083, 0.000017013932, 1.3632612, -0.000015783877, 0.000020437526, 1., 0.50040704],
        [-0.12525177, -0.9921249, 0.0000035908536, 21.825846, 0.9921249, -0.12525183, 0.000018508303, 2.7567036, -0.000017947112, 0.0000058968863, 0.9999999, 0.5011858],
        [-0.17381142, -0.9847789, 0.000009659848, 21.663193, 0.9847787, -0.17381142, 0.000016967475, 3.8242114, -0.000015078842, 0.000012494469, 1., 0.50141317],
        [-0.2505839, -0.968095, 0.000028327588, 21.29602, 0.9680948, -0.25058386, 0.000023809529, 5.513744, -0.000015953898, 0.000033388314, 0.9999999, 0.5019072],
        [-0.29248568, -0.95626986, -0.0000007721287, 21.035782, 0.95627, -0.29248568, 0.000032459993, 6.4346695, -0.0000312624, 0.000008755717, 0.99999994, 0.5027773],
        [-0.34757262, -0.9376531, 0.00001225189, 20.62523, 0.93765295, -0.34757254, 0.00006259277, 7.6475844, -0.000054437955, 0.000033262073, 1., 0.5026343],
        [-0.5028513, -0.8643729, 0.000011942206, 19.012463, 0.86437297, -0.5028514, 0.000052710722, 11.063489, -0.000039550956, 0.000036839556, 1.0000001, 0.5032659],
        [-0.4602258, -0.88780177, 0.00004696698, 19.52652, 0.88780165, -0.4602258, 0.00006685366, 10.125957, -0.000037755923, 0.00007248677, 0.9999999, 0.5029148],
        [-0.6105468, -0.7919802, 0.000051394793, 17.4189, 0.79198027, -0.610547, 0.00003195611, 13.432721, 0.000006089756, 0.000060219634, 0.99999994, 0.503506],
        [-0.55723387, -0.83035535, 0.000038115646, 18.262728, 0.8303554, -0.5572339, 0.000046827026, 12.259295, -0.00001765227, 0.00005771004, 0.99999994, 0.504446],
        [-0.70696044, -0.7072531, 0.000010812768, 15.553966, 0.70725316, -0.70696056, 0.000052464537, 15.552836, -0.000029465671, 0.000044724704, 1., 0.50482774],
        [-0.65548503, -0.7552083, 0.000026915994, 16.608734, 0.75520843, -0.65548474, 0.000028986815, 14.420169, -0.0000042996344, 0.00003936049, 1., 0.5055171],
        [-0.78865355, -0.614838, 0.000017555674, 13.520175, 0.6148381, -0.7886532, 0.000060378152, 17.349012, -0.000023253973, 0.000058409838, 1., 0.50517577],
        [-0.8255205, -0.56437206, 0.000040298022, 12.409542, 0.5643722, -0.8255205, 0.00007735336, 18.159586, -0.000010393108, 0.00008658243, 0.99999994, 0.5051124],
        [-0.8590874, -0.511829, 0.000038035978, 11.253755, 0.5118292, -0.8590873, 0.000056593573, 18.897108, 0.0000036768538, 0.00006805814, 0.99999994, 0.50647247],
    ],
    "vgicp_batch_lm": [
        [0.00000027463736, -0.99999994, 0.00000003233812, 22., 0.99999994, 0.0000002744889, -0.00000003358536, -0.00000007894851, 0.00000003725432, 0.000000026483225, 1., 0.5],
        [-0.06201347, -0.99807537, 0.00002032554, 21.9575, 0.9980753, -0.062013436, 0.000017782806, 1.3655694, -0.000016473601, 0.000021367989, 1., 0.5004118],
        [-0.12507387, -0.99214745, 0.0000020005332, 21.826454, 0.99214745, -0.12507387, 0.00001641554, 2.7526906, -0.000016040605, 0.000004041211, 1., 0.50121295],
        [-0.16688757, -0.985976, 0.000014796997, 21.689825, 0.98597586, -0.16688755, 0.0000056351246, 3.671699, -0.00000307572, 0.000015525782, 1.0000001, 0.5013323],
        [-0.25051388, -0.968113, 0.000029687933, 21.296556, 0.9681129, -0.2505139, 0.000015059818, 5.5119853, -0.000007155171, 0.00003248852, 1., 0.5017525],
        [-0.28496084, -0.95853925, 0.0000062024583, 21.086002, 0.9585391, -0.2849609, 0.000021956474, 6.2687936, -0.000019273373, 0.000012189184, 0.9999999, 0.5026471],
        [-0.3389743, -0.94079554, 0.00002876231, 20.694183, 0.9407957, -0.3389742, 0.000051003197, 7.4580097, -0.000038229056, 0.000044339162, 1., 0.5021269],
        [-0.49423546, -0.8693282, 0.000026386479, 19.121258, 0.86932826, -0.49423555, 0.000042405514, 10.873484, -0.000023817287, 0.000043881733, 0.99999994, 0.50300235],
        [-0.45163542, -0.8922025, 0.00006141071, 19.623125, 0.8922026, -0.4516354, 0.00005648344, 9.936475, -0.000022646564, 0.00008030445, 1., 0.50255865],
        [-0.60341436, -0.79742765, 0.000061760154, 17.538467, 0.79742754, -0.60341454, 0.000020599706, 13.275236, 0.000020833384, 0.000061695726, 1., 0.5032669],
        [-0.54628545, -0.83759934, 0.00005329687, 18.421509, 0.83759904, -0.54628533, 0.000035230794, 12.01813, -0.00000039447232, 0.00006386594, 0.99999994, 0.50416946],
        [-0.69981974, -0.71431947, 0.000029212306, 15.709062, 0.71431935, -0.69981974, 0.00004122988, 15.395408, -0.0000090170715, 0.00004973478, 1., 0.5045941],
        [-0.6455937, -0.76368123, 0.000034770554, 16.794786, 0.7636812, -0.6455938, 0.000019465431, 14.202153, 0.000007584262, 0.000039119266, 1.0000001, 0.50546414],
        [-0.78244895, -0.62271446, 0.000041668616, 13.693041, 0.62271464, -0.7824489, 0.000037518537, 17.212355, 0.0000092293685, 0.000055304183, 1., 0.5051871],
        [-0.81983364, -0.5726018, 0.00006507466, 12.5902405, 0.5726016, -0.8198335, 0.00005204056, 18.034285, 0.000023494214, 0.00007990055, 1., 0.50522035],
        [-0.85388, -0.52046996, 0.000062091814, 11.443441, 0.52046996, -0.85388017, 0.000031537205, 18.782375, 0.00003656917, 0.00005924966, 1., 0.5066264],
    ],
}
GRAPH_JAX_ERRORS = {"gicp_lm": 164264.3125, "vgicp_lm": 42088.25, "vgicp_gn": 42159.63671875, "vgicp_dogleg": 41697.6796875, "vgicp_batch_lm": 42088.359375}
GRAPH_JAX_ITERATIONS = {"gicp_lm": 20, "vgicp_lm": 20, "vgicp_gn": 10, "vgicp_dogleg": 20, "vgicp_batch_lm": 20}
GRAPH_JAX_TRUTH = {"gicp_lm": (3.44801, 0.15706), "vgicp_lm": (1.850869, 0.083994), "vgicp_gn": (2.206244, 0.100465), "vgicp_dogleg": (2.071718, 0.094044), "vgicp_batch_lm": (1.850885, 0.083995)}
# Each run's largest pose shift when the order of every scan's points alone
# changes, JAX against JAX (the same script, --graph-poses 16
# --graph-orders 3): the VGICP LM's stopping point moves by up to 0.476 m.
# The batch run solves the list run's system summed in another order, so
# its poses are held to the larger of the two runs' shifts.
GRAPH_ORDER_SHIFT_M = {
    "gicp_lm": [4.192e-08, 4.438e-06, 1.028e-05, 1.162e-05, 1.653e-05, 1.938e-05, 3.017e-05, 2.077e-03, 1.018e-04, 2.259e-03, 3.932e-04, 2.588e-03, 1.006e-03, 2.266e-03, 2.179e-03, 2.220e-03],
    "vgicp_lm": [4.391e-08, 2.251e-02, 1.831e-03, 2.833e-01, 1.919e-03, 3.006e-01, 3.529e-01, 3.705e-01, 3.367e-01, 3.580e-01, 4.764e-01, 4.101e-01, 4.591e-01, 4.591e-01, 4.604e-01, 4.618e-01],
    "vgicp_gn": [4.913e-08, 1.239e-04, 1.015e-04, 2.358e-04, 1.569e-04, 4.325e-04, 8.745e-04, 9.832e-04, 7.669e-04, 9.426e-04, 7.947e-04, 1.074e-03, 9.592e-04, 6.666e-04, 6.701e-04, 7.296e-04],
    "vgicp_dogleg": [5.403e-08, 3.372e-04, 5.324e-04, 1.635e-03, 7.266e-04, 1.984e-03, 1.845e-03, 1.908e-03, 2.070e-03, 2.268e-03, 1.119e-03, 2.411e-03, 1.176e-03, 1.608e-03, 1.566e-03, 1.580e-03],
    "vgicp_batch_lm": [5.806e-08, 1.358e-04, 3.877e-04, 4.515e-03, 1.487e-03, 4.990e-03, 4.768e-03, 5.141e-03, 5.206e-03, 5.316e-03, 5.014e-03, 5.765e-03, 4.674e-03, 5.651e-03, 5.709e-03, 5.589e-03],
}
GRAPH_ORDER_SHIFT_RAD = {
    "gicp_lm": [1.817e-06, 1.889e-06, 1.864e-06, 1.823e-06, 1.969e-06, 1.838e-06, 2.849e-06, 9.530e-05, 3.770e-06, 1.029e-04, 1.649e-05, 1.181e-04, 4.570e-05, 1.029e-04, 9.854e-05, 1.007e-04],
    "vgicp_lm": [1.139e-06, 1.019e-03, 8.773e-05, 1.287e-02, 9.239e-05, 1.366e-02, 1.603e-02, 1.683e-02, 1.529e-02, 1.626e-02, 2.164e-02, 1.862e-02, 2.085e-02, 2.086e-02, 2.091e-02, 2.098e-02],
    "vgicp_gn": [2.290e-06, 5.413e-06, 5.313e-06, 1.249e-05, 5.790e-06, 2.287e-05, 3.927e-05, 4.937e-05, 3.847e-05, 4.645e-05, 3.900e-05, 5.103e-05, 4.656e-05, 3.302e-05, 2.954e-05, 3.554e-05],
    "vgicp_dogleg": [2.050e-06, 1.736e-05, 2.245e-05, 7.568e-05, 3.354e-05, 9.142e-05, 8.561e-05, 8.868e-05, 9.549e-05, 1.058e-04, 4.984e-05, 1.123e-04, 5.267e-05, 7.481e-05, 7.271e-05, 7.371e-05],
    "vgicp_batch_lm": [1.084e-06, 6.156e-06, 1.789e-05, 2.027e-04, 6.770e-05, 2.199e-04, 2.120e-04, 2.280e-04, 2.314e-04, 2.367e-04, 2.224e-04, 2.561e-04, 2.076e-04, 2.521e-04, 2.549e-04, 2.497e-04],
}
# Phase 24: the block-sparse pose graph: PG_POSES poses of ring_trajectory
# (PG_LAP a lap), odometry BetweenFactors (i, i+1) measured with noise
# (RandomState(PG_SEED): normal, PG_NOISE_RAD on the rotation and PG_NOISE_M
# on the translation), loop edges (i, i+PG_LAP) at the true relative pose,
# weights PG_WEIGHT, a PG_PRIOR_WEIGHT prior on pose 0; the start chains the
# noisy odometry. optimize_pose_graph(max_iterations=PG_ITERATIONS); the
# poses at every PG_SAMPLE-th key held to the JAX package's as phase 23's.
PG_POSES = 1000
PG_LAP = 100
PG_SEED = 7
PG_NOISE_M = 0.02
PG_NOISE_RAD = 0.002
PG_WEIGHT = 1e2
PG_PRIOR_WEIGHT = 1e6
PG_ITERATIONS = 30
PG_SAMPLE = 25
# The JAX package's poses at every PG_SAMPLE-th key (top three rows,
# row-major), its final error and iterations (tests/test_torch_real_size.py
# --pose-graph 1000 --graph-orders 3: the CPU port's largest gap 6.128e-5 m,
# JAX against JAX with the edges in 3 other orders at most 4.006e-5 m, so
# every pose is held to GICP_BOUND_M and _RAD).
PG_JAX_POSES = [
    [-0.000000009757114, -1., -0.0000017808187, 22., 1., -0.000000009754662, -0.0000011077412, 0.00000005948891, 0.0000011077419, -0.0000017808181, 1., 0.49999985],
    [-0.9997384, -0.0004666221, -0.022858992, -0.01845792, 0.0007336544, -0.99993145, -0.011674707, 21.896526, -0.022851959, -0.011688287, 0.99967045, 0.18690325],
    [-0.0008119784, 0.9997129, -0.023940869, -22.107138, -0.9999153, -0.0011231939, -0.01299008, -0.033012994, -0.013013196, 0.023928268, 0.99962914, -0.6080078],
    [0.99953634, -0.001957337, -0.030394629, -0.02712558, 0.0013064547, 0.9997698, -0.021426558, -21.948978, 0.030429458, 0.021376759, 0.999308, -0.48473117],
    [0.005242387, -0.9999473, -0.008844471, 22.003181, 0.9999562, 0.0053109066, -0.0077507887, 0.010318546, 0.007797212, -0.008803322, 0.9999312, 0.4994233],
    [-0.99970305, 0.005795297, -0.023677962, -0.03679981, -0.0055078343, -0.9999106, -0.012204704, 21.89028, -0.023746477, -0.0120705115, 0.99964577, 0.19243163],
    [0.0012654784, 0.99970716, -0.024157668, -22.11702, -0.9997549, 0.0007313143, -0.0221323, -0.028487494, -0.022108063, 0.024179626, 0.99946374, -0.60104746],
    [0.9994673, -0.0012852645, -0.032613587, -0.03864896, 0.0005788481, 0.9997656, -0.021686042, -21.96337, 0.032633647, 0.02165551, 0.9992332, -0.4713438],
    [0.0039625918, -0.9999121, -0.012664718, 22.003975, 0.9999716, 0.0040439507, -0.0064664036, 0.002215824, 0.0065169833, -0.012638543, 0.99989957, 0.49545112],
    [-0.99961734, 0.0010375108, -0.02764906, -0.033077374, -0.0007711855, -0.9999537, -0.009662365, 21.8976, -0.027657678, -0.009637192, 0.9995718, 0.20844747],
    [-0.0016479075, 0.9996944, -0.024649883, -22.107359, -0.99990535, -0.0019841988, -0.013640542, -0.03249236, -0.013685182, 0.024624927, 0.9996038, -0.6035501],
    [0.99964494, -0.006751036, -0.02575588, -0.03052956, 0.0061749825, 0.9997305, -0.022406956, -21.958006, 0.025900133, 0.022239862, 0.999418, -0.468391],
    [-0.0005695143, -0.99988174, -0.015341845, 22.01251, 0.9999726, -0.00045637405, -0.0074221194, -0.002589197, 0.007414091, -0.0153455185, 0.9998563, 0.49450582],
    [-0.99969554, 0.0009319295, -0.024671588, -0.036101352, -0.00068955676, -0.99995214, -0.009853538, 21.89494, -0.024679398, -0.009833271, 0.99964845, 0.21631715],
    [0.0008923951, 0.99971473, -0.023858067, -22.111692, -0.9997655, 0.00037602795, -0.021663744, -0.032739352, -0.021648534, 0.023871643, 0.999482, -0.60993946],
    [0.99964195, -0.0053105075, -0.026202986, -0.030308811, 0.0047449027, 0.9997553, -0.021635305, -21.956356, 0.026311424, 0.02150312, 0.99942404, -0.47077245],
    [-0.000089171335, -0.9998528, -0.01714089, 22.015564, 0.9999786, 0.00002376298, -0.006632423, -0.0018273222, 0.006631725, -0.017141059, 0.99983275, 0.48926505],
    [-0.99978864, -0.0009683278, -0.020495761, -0.028028082, 0.001166616, -0.9999534, -0.009711339, 21.891636, -0.020485425, -0.009733062, 0.9997445, 0.21652503],
    [0.0042903656, 0.9996975, -0.024162496, -22.115234, -0.99982667, 0.003850151, -0.018275643, -0.043859616, -0.018176863, 0.024236744, 0.9995428, -0.6095644],
    [0.9995886, 0.000073900876, -0.028648902, -0.03634122, -0.0006771694, 0.9997788, -0.021075252, -21.96094, 0.028641026, 0.021085843, 0.9993691, -0.46516508],
    [0.0041154325, -0.9998153, -0.018700575, 22.012928, 0.99997747, 0.0042173243, -0.005452078, 0.005786469, 0.0055296747, -0.018677764, 0.99981236, 0.48912767],
    [-0.9996973, -0.0031729592, -0.024335101, -0.023219982, 0.0034091892, -0.9999475, -0.009712586, 21.894163, -0.024303157, -0.009792408, 0.9996588, 0.21920998],
    [0.011374007, 0.99960005, -0.025827898, -22.101976, -0.99968046, 0.010784454, -0.02289336, -0.029186117, -0.022605458, 0.026080217, 0.9994065, -0.60125786],
    [0.99954706, 0.0010191542, -0.030020246, -0.02212585, -0.0016245251, 0.9997956, -0.020192038, -21.957144, 0.029993743, 0.02023143, 0.9993478, -0.46321213],
    [0.0017713598, -0.9998234, -0.018606028, 22.001614, 0.99995583, 0.0019423662, -0.0092371525, 0.012304718, 0.009271279, -0.018589063, 0.99978644, 0.49463058],
    [-0.9998319, -0.0010231497, -0.018202981, -0.026456434, 0.0012018947, -0.99995095, -0.0098762605, 21.890385, -0.018192153, -0.00989621, 0.9997877, 0.2186627],
    [0.007833035, 0.99962515, -0.026176317, -22.097416, -0.999862, 0.0074461317, -0.01489154, -0.023304954, -0.014690651, 0.02628957, 0.9995489, -0.61043024],
    [0.99959964, -0.0033092836, -0.028049016, -0.023323338, 0.002728584, 0.9997812, -0.020767754, -21.947956, 0.028111828, 0.020682646, 0.9993934, -0.46199325],
    [-0.00020770356, -0.99981374, -0.019217849, 21.998583, 0.9999762, -0.00007521382, -0.006965423, 0.008041522, 0.006962338, -0.019219115, 0.9997935, 0.48541895],
    [-0.9998586, -0.001071583, -0.016669545, -0.036032643, 0.0012074158, -0.9999653, -0.008251263, 21.890068, -0.0166604, -0.008269908, 0.99982965, 0.21736643],
    [0.00508002, 0.9996668, -0.025238823, -22.092285, -0.999879, 0.004708542, -0.014837425, -0.039733578, -0.014713361, 0.025311455, 0.9995741, -0.60844535],
    [0.9996215, -0.003676216, -0.027194085, -0.0065932325, 0.0031068628, 0.99977374, -0.021046825, -21.9468, 0.027265586, 0.020953983, 0.9994113, -0.4638965],
    [0.00028757346, -0.9997974, -0.02004542, 21.999065, 0.99988437, 0.00059040025, -0.015228459, -0.01397499, 0.015236789, -0.020038854, 0.9996859, 0.4933974],
    [-0.999893, -0.00088356395, -0.014473696, -0.025594983, 0.0010009661, -0.9999661, -0.008289607, 21.889269, -0.014466161, -0.008302706, 0.99986386, 0.21762931],
    [0.010613073, 0.99960554, -0.025920503, -22.095991, -0.99987656, 0.010310121, -0.011899981, -0.032474022, -0.011627579, 0.026043782, 0.9995956, -0.5988715],
    [0.99971837, -0.005079938, -0.023082038, -0.013152076, 0.004619584, 0.99978846, -0.020079842, -21.954773, 0.023179326, 0.019967202, 0.99953496, -0.45363024],
    [-0.0031701487, -0.9997964, -0.019804725, 22.003479, 0.99991643, -0.002922876, -0.012648479, -0.013739213, 0.01258771, -0.019843336, 0.9997268, 0.49501586],
    [-0.9995526, -0.0022041115, -0.029758528, -0.037016816, 0.002474144, -0.9999565, -0.009135793, 21.900425, -0.029737268, -0.009204858, 0.9995185, 0.20912217],
    [0.0021327727, 0.99964464, -0.02647321, -22.094835, -0.9999499, 0.0018719061, -0.0099676605, -0.027052391, -0.0099144, 0.026493464, 0.999603, -0.5911612],
    [0.9992682, 0.003116844, -0.038060714, -0.01540613, -0.0038899556, 0.9997869, -0.020319175, -21.95563, 0.037989594, 0.02045202, 0.999072, -0.4450311],
]
PG_JAX_ERROR = 45.1278190612793
PG_JAX_ITERATIONS = 30
SMALL_GRAPH_TOL = 1e-5  # phase 24's small graph, card against the CPU port, x max|ref| a block
PG_ERROR_TOL = 1e-4  # the final error against the JAX package's, relative

# Phases 25-27: the SLAM back end on phase 23's GRAPH_POSES preprocessed
# frames. Phase 25, loop detection: estimate_fpfh (defaults) on frames 0,
# GNC_NEAR_PAIR[1] and GRAPH_POSES - 1, estimate_pose_gnc(GNCParams())
# between frames 0 and GRAPH_POSES - 1 (the far pair) and on GNC_NEAR_PAIR
# (the near pair); the card's FPFH against the CPU port's (the neighbour tables equal, the pair bins
# equal but for flips at a bin edge, FPFH_EDGE_TOL in bin units, or at PCL's
# swap test tie, FPFH_SWAP_TIE; the rows no flip reaches within
# FPFH_HIST_TOL), feature_knn's indices on the same features (a differing
# index a tie: its exact distance within FPFH_TIE_TOL of the CPU port's
# candidate's, relative to |q|² + |t|², the scale of the rounding of
# |q|² + |t|² - 2 q·t), each pair's pose
# within GICP_BOUND_M and _RAD of the JAX package's or GICP_SHIFT_MARGIN
# times its order shift, and the IRLS alone (gnc_irls) on the CPU port's
# far-pair matches, card against the CPU port, within GICP_BOUND_M and
# _RAD. Phase 26, the incremental_isam2_slam protocol:
# ISAM2Ext(window_size=ISAM2_WINDOW, LMParams(max_iterations=
# ISAM2_ITERATIONS)), a PriorFactor(T_true[0], GRAPH_PRIOR_WEIGHT) on key 0,
# then a VGICP factor (i-1, i) (GRAPH_VGICP_LEAF, GRAPH_VGICP_MIN_POINTS) an
# update, initial value estimate(i-1) @ the true motion @
# se3_exp(uniform(-0.1, 0.1, 6)) from RandomState(ISAM2_SEED), and the late
# loop closure (0, ISAM2_POSES - 1) once key 0 froze, on the first
# ISAM2_POSES frames (cut from GRAPH_POSES: an eager window update takes
# 1.7-2.6 s on the card, PERF.md, and 10 frames put phases 25-27 at 92 s,
# past the minute they may add to the smoke). Phase 27, the same
# stream through FixedLagSmoother(lag=ISAM2_LAG) with stamps one apart (3
# poses kept), ending with add_factors([loop]); then cg_solve on phase 26's
# last window system against torch.linalg.solve within CG_TOL x max|x|.
ISAM2_POSES = 6
ISAM2_WINDOW = 3
ISAM2_ITERATIONS = 30
ISAM2_SEED = 42
ISAM2_LAG = 2.5
ISAM2_RUNS = 2  # phase 26's stream twice on the card, equal bit for bit (phase 27's once)
FPFH_REPS = 5
FPFH_EDGE_TOL = 1e-4
FPFH_SWAP_TIE = 1e-6
FPFH_HIST_TOL = 1e-3
FPFH_TIE_TOL = 1e-5
CG_TOL = 1e-4
# The JAX package's records of phases 26-27 on the CPU
# (tests/test_torch_real_size.py --isam2 6 --isam2-orders 8): per update
# the window, the frozen keys, num_compiles, compiled (None for the
# smoother's pose updates), and the poses the update moved, top three rows
# row-major (the window's; every pose at the loop closure). The CPU port's
# largest gap 7.739e-05 m (7.739e-05 for the smoother). ISAM2_ORDER_SHIFT_M
# and _RAD: per update the largest shift of those poses with the scans'
# points in 8 other orders (at most 5.160e-02 m, update 2), the same for
# phase 27.
ISAM2_JAX = {
    "window": [[0], [0, 1], [0, 1, 2], [1, 2, 3], [2, 3, 4], [3, 4, 5], [3, 4, 5]],
    "frozen": [[], [], [], [0], [0, 1], [0, 1, 2], [0, 1, 2]],
    "num_compiles": [1, 2, 3, 6, 7, 7, 10],
    "compiled": [True, True, True, True, False, False, True],
    "poses": [
        [[-0., -1., 0., 22., 1., -0., 0., 0., 0., 0., 1., 0.5]],
        [[-0.0000000034796486, -1., 0.0000000073341107, 22., 1., -0.0000000034796486, 0.0000000015869682, 0.0000000004251537, -0.0000000015869102, 0.000000007334338, 1., 0.5], [-0.062180754, -0.9980648, 0.000014220567, 21.957172, 0.99806464, -0.062180746, 0.000014333555, 1.3693608, -0.000013420924, 0.000015072572, 1., 0.500821]],
        [[-0.000000023659396, -1., -0.0000000005016728, 22., 1., -0.000000023659567, 0.000000003927088, -0.00000000012800946, -0.0000000039266754, -0.000000000501165, 1., 0.5], [-0.062180776, -0.9980648, 0.000014212706, 21.957172, 0.99806464, -0.06218077, 0.000014335905, 1.3693606, -0.000013423757, 0.000015064874, 1., 0.500821], [-0.12466075, -0.9921993, -0.00001972305, 21.826967, 0.99219906, -0.12466072, 0.00003879898, 2.7436655, -0.00004097872, -0.000014739507, 1., 0.5023898]],
        [[-0.062180713, -0.99806476, 0.000014227264, 21.957172, 0.9980646, -0.062180705, 0.000014337796, 1.3693568, -0.000013424741, 0.00001507952, 1., 0.500821], [-0.124660425, -0.99219936, -0.000019708272, 21.826965, 0.9921991, -0.124660395, 0.0000388013, 2.7436564, -0.00004097917, -0.000014724577, 1., 0.5023898], [-0.18660155, -0.9824356, -0.0000028721408, 21.611158, 0.9824352, -0.18660153, 0.000033532157, 4.1054196, -0.00003349569, 0.0000034221812, 1., 0.5029116]],
        [[-0.12466069, -0.99219924, -0.000019726134, 21.826965, 0.992199, -0.12466066, 0.000038794537, 2.7436657, -0.0000409747, -0.000014743129, 1., 0.50238985], [-0.18660282, -0.9824353, -0.0000028905056, 21.61115, 0.9824349, -0.1866028, 0.000033524822, 4.1054506, -0.000033491917, 0.0000034028162, 1., 0.5029116], [-0.24821076, -0.96870613, 0.000018361821, 21.309345, 0.96870565, -0.24821074, 0.000059454662, 5.4608974, -0.000053058164, 0.000032515592, 1., 0.5032462]],
        [[-0.18660285, -0.98243535, -0.0000028829531, 21.61115, 0.982435, -0.18660283, 0.00003352616, 4.10545, -0.000033491822, 0.0000034104867, 1., 0.5029116], [-0.24809977, -0.96873456, 0.000017004553, 21.30996, 0.9687341, -0.24809976, 0.000060110302, 5.4585347, -0.000054033775, 0.00003135734, 1., 0.5032721], [-0.30815744, -0.9513355, 0.000024431798, 20.926792, 0.9513351, -0.30815753, 0.0000546855, 6.7795343, -0.000044521796, 0.000040066607, 0.99999994, 0.504246]],
        [[0.00000010355059, -1., -0.00000004098649, 22., 1., 0.00000010355042, -0.00000007265261, -0.000000025574922, 0.00000007265302, -0.00000004098598, 1., 0.5], [-0.062239427, -0.9980611, 0.00003292803, 21.957542, 0.99806094, -0.06223942, 0.000019303861, 1.3707962, -0.000017216369, 0.000034053905, 1., 0.50017226], [-0.12477767, -0.9921845, 0.000017290078, 21.827536, 0.9921843, -0.12477764, 0.000049010323, 2.74653, -0.000046498073, 0.00002326268, 1., 0.50109625], [-0.18679905, -0.9823981, -0.000053133663, 21.612211, 0.98239774, -0.18679903, -0.0000041532585, 4.1098356, -0.0000058683936, -0.00005298739, 1., 0.50038373], [-0.24829046, -0.9686857, -0.00002669559, 21.310947, 0.9686852, -0.24829046, 0.000021415002, 5.4628105, -0.000027391354, -0.000020574438, 1., 0.50056], [-0.30842426, -0.951249, -0.000013327539, 20.927145, 0.9512486, -0.30842435, 0.000016183438, 6.7854676, -0.00001951843, -0.000007708838, 0.99999994, 0.50134593]],
    ],
}
ISAM2_ORDER_SHIFT_M = [0.000e+00, 2.757e-05, 5.160e-02, 6.678e-04, 1.222e-03, 1.225e-03, 6.664e-04]
ISAM2_ORDER_SHIFT_RAD = [0.000e+00, 1.228e-06, 2.334e-03, 2.761e-05, 5.584e-05, 5.901e-05, 3.091e-05]
# The smoother's records are the window's; only `compiled` differs.
FIXED_LAG_JAX = {**ISAM2_JAX, "compiled": [None, None, None, None, None, None, True]}
# Phase 25's JAX GNC pose (frame 0 <- frame 15, top three rows) and inlier
# rate (--gnc 16 --gnc-orders 3). On the ring GNC lands 14.74 m and 0.68 rad
# from the truth in JAX (the CPU port 15.34 m, 0.72 rad, 0.702 m from JAX):
# the walls are rings about the world's axis, so FPFH matches alias
# along the corridor; the order of the points alone moves JAX's pose by
# 2.3e-3, 0.706 and 2.064 m, so the pose's bound is twice 2.064 m.
GNC_JAX_POSE = [0.9662483, -0.25761276, 0.0001705547, 5.648526, 0.25761157, 0.9662455, 0.0023721994, 0.72655106, -0.0007759048, -0.0022481903, 0.9999969, 0.021128654]
GNC_JAX_INLIER = 0.8498718738555908
GNC_ORDER_SHIFT_M = 2.064e+00
GNC_ORDER_SHIFT_RAD = 1.009e-01
# The near pair (frame 0 <- frame 1), where GNC converges in both packages
# (JAX 0.0168 m and 5.5e-4 rad from the truth, the CPU port 3.114e-3 m from
# JAX): its JAX pose and inlier rate, the order shift 4.345e-3 m over 3
# orders (--gnc 16 --gnc-orders 3), so the bound is twice that.
GNC_NEAR_PAIR = (0, 1)
GNC_NEAR_JAX_POSE = [0.99805033, -0.062417142, -0.00009362097, 1.3664556, 0.06241707, 0.9980502, -0.000397394, 0.04306221, 0.00011824975, 0.00039080344, 1.0000005, -0.0076361895]
GNC_NEAR_JAX_INLIER = 0.996920645236969
GNC_NEAR_ORDER_SHIFT_M = 4.345e-03
GNC_NEAR_ORDER_SHIFT_RAD = 1.294e-04

# Phases 29-30's scene (scan_world): the ring world's walls and floor as
# plane points (SCAN_WORLD_N points before its round pillars are dropped)
# and SCAN_FINS flat radial fins (2 x SCAN_FIN_HALF m wide, 3 m tall), whose
# faces add plane points and whose two vertical ends carry
# SCAN_EDGE_PER_LINE edge points each with SCAN_EDGE_NOISE m of noise; a
# scan is the SCAN_PLANE_N nearest plane points and the SCAN_EDGE_N nearest
# edge points of a pose of ring_trajectory(lap=100).
SCAN_WORLD_N = 100_000
SCAN_FINS = 40
SCAN_FIN_HALF = 1.25
SCAN_EDGE_PER_LINE = 100
SCAN_EDGE_NOISE = 0.01
SCAN_PLANE_N = 20_000
SCAN_EDGE_N = 3_000
SCAN_SEED = 4
# phase 28: RANSAC (demo_global_registration: 8192 hypotheses) on phase 25's
# pairs, then the demo's GICP refine (unary GICP, max corr 2.0, 15 LM
# iterations) from a coarse pose.
RANSAC_ITERATIONS = 8192
RANSAC_TOL_M = 1e-4
RANSAC_TOL_RAD = 1e-4
REFINE_MAX_CORR = 2.0
REFINE_ITERATIONS = 15
# The references (tests/test_torch_real_size.py --ransac 16 --ransac-orders 3,
# JAX_PLATFORMS=cpu): the JAX package's RANSAC from its own threefry draws
# (printed beside the card's, not held: torch cannot draw them), the CPU
# port's RANSAC pose from the generator seeded with RANSACParams().seed on
# the CPU port's frames and FPFH (the refine's RANSAC start; the JAX GNC
# pose is its GNC start), the JAX package's refined pose from each start,
# and its largest shift (m, rad) with the scans' points in 3 other orders.
# On the CPU the port's refines lie 1.9e-6 and 2.3e-4 m (far pair) and
# 2.4e-7 and 7.5e-9 m (near pair) from JAX's.
RANSAC_JAX = {
    "near": {"pose": [0.995481, -0.09492838, -0.0025381402, 2.3104696, 0.09491669, 0.99547595, -0.0043433085, -0.08420277, 0.0029390864, 0.004082692, 0.9999875, -0.12882915], "inlier": 0.9185888767242432},
    "far": {"pose": [0.99836266, -0.056884203, 0.0059942557, 1.4413857, 0.05684121, 0.9983578, 0.007127323, 0.5232105, -0.0063898424, -0.006774919, 0.9999566, 0.22175306], "inlier": 0.7978141903877258},
}
RANSAC_START = {
    "near": [0.9955944, -0.093754694, 0.0015303455, 1.3428094, 0.09376596, 0.99553114, -0.011221409, 0.7894306, -0.0004714392, 0.011315443, 0.99993616, -0.08416349],
    "far": [0.52602196, -0.85041, 0.010199312, 18.805199, 0.85046226, 0.52603364, -0.0017296672, 9.190103, -0.0038942322, 0.009583972, 0.99994683, -0.013501227],
}
REFINE_JAX = {
    "near": {"ransac": [0.99803704, -0.06262815, -0.000020075167, 1.3780985, 0.06262811, 0.99803704, -0.0000033498097, 0.042530835, 0.000020238453, 0.0000020679995, 1.0000004, -0.00013985485],
             "gnc": [0.99803716, -0.06262814, -0.000020079106, 1.3780992, 0.062628105, 0.9980371, -0.0000033065019, 0.042531338, 0.000020239022, 0.0000020742416, 1.0000005, -0.00013995916]},
    "far": {"ransac": [0.587703, -0.80907685, 0.0000072335006, 17.800537, 0.80907685, 0.5877031, 0.000029315144, 9.066589, -0.000027971286, -0.000011380013, 1.0000004, 0.00007674098],
            "gnc": [0.9660766, -0.25825593, -0.00006046701, 5.6835976, 0.25825584, 0.9660763, 0.00011347399, 0.74386746, 0.000029111465, -0.00012523361, 0.99999976, 0.0011733789]},
}
REFINE_ORDER_SHIFT = {'near': {'ransac': [2.243e-07, 7.501e-09], 'gnc': [5.093e-07, 9.606e-09]}, 'far': {'ransac': [0.0, 1.042e-09], 'gnc': [0.0002321, 1.069e-05]}}
# phase 29, LOAM: scans 0 and 1 (tests/test_loam_newer01.py's settings):
# make_loam_factor with grid leaf 2.0 and the default max_points_per_cell
# (both packages' grids keep 16 points a cell, whatever it says), a
# PriorFactor of 1e6 on key 0, LOAM_ITERATIONS LM iterations from the
# identity, with and without scan-line validation. Both packages get the
# scans' points in the same order, so the LOAM poses are held to the floor
# (GICP_BOUND_M, _RAD) alone, not to the order shift, and the card's gap
# between its validated and plain poses to the JAX package's gap within the
# same floor: validation moves the pose by ~5e-3 m here.
LOAM_GRID_LEAF = 2.0
LOAM_MAX_CORR = 2.0
LOAM_PRIOR_WEIGHT = 1e6
LOAM_ITERATIONS = 30
# phase 29, CT-ICP (demo_continuous_time's protocol): the target is scan 0
# (planes and edges), the source the same surfaces sampled again
# (noise seed SCAN_SEED + 10) and seen while the sensor moves by
# Exp(CT_MOTION) over the sweep (0.15 m and 0.02 rad: a handheld sensor,
# as the demo's newer_06); kNN features (k = 20, leaf 0.5);
# make_ct_icp_factor(0, 1, max_corr_dist 1.0, grid_leaf CT_GRID_LEAF), a
# PriorFactor of 1e3 on key 0, CT_ITERATIONS LM iterations from the
# identity, then deskew; the GICP mode is the demo's, ICP and point to plane
# the other two. The grid leaf is 0.5, not the default 1.0: both packages'
# grids keep 16 points a cell, and a 1 m cell of this scan holds up to ~55,
# which leaves nearest neighbours a cell's width apart and moves the optimum
# 0.1-0.2 m off the truth.
CT_MOTION = (0.0, 0.0, 0.02, 0.15, 0.02, 0.0)
CT_FEATURE_K = 20
CT_FEATURE_LEAF = 0.5
CT_GRID_LEAF = 0.5
CT_MAX_CORR = 1.0
CT_PRIOR_WEIGHT = 1e3
CT_ITERATIONS = 30
CT_MODES = ("gicp", "icp", "plane")
# The JAX package's phase-29 poses (tests/test_torch_real_size.py --loam
# --ct-icp --scan-orders 3, JAX_PLATFORMS=cpu): LOAM's pose 1, CT-ICP's
# begin and end poses; and their largest shift with every cloud's points in
# 3 other orders. The CPU port's lie 1.1e-8 to 2.6e-6 m from them; JAX's
# LOAM lands 0.037 m from the truth, its CT-ICP sweeps within 1e-3 m.
SCAN_JAX_POSES = {
    "loam_plain": [0.9981271, -0.061173193, -0.00034235438, 1.3530073, 0.06117411, 0.99811804, 0.0042478647, 0.025909772, 0.00008184826, -0.0042608595, 0.99999094, 0.008569069],
    "loam_validated": [0.9981352, -0.061041776, 0.0002284242, 1.3492532, 0.06104018, 0.9981257, 0.0043801805, 0.025550894, -0.0004953835, -0.00435807, 0.99999034, 0.0050551635],
    "ct_gicp": [[1., -0.000010486266, -0.00001158305, 0.00035226985, 0.00001048925, 1., 0.00012111267, -0.00031376368, 0.000011589032, -0.0001211137, 1., -0.00068669923], [0.9997999, -0.020006683, -0.0000816164, 0.14973415, 0.02000667, 0.99979985, -0.00017858295, 0.021767769, 0.000085173815, 0.00017691804, 1., 0.00043958772]],
    "ct_icp": [[1., 0.00001094194, 0.000034129167, 0.00021203925, -0.000010941491, 0.99999994, 0.0000010783851, 0.000040244337, -0.000034110315, -0.0000010763933, 1., -0.0002967396], [0.9998004, -0.019977491, -0.00004189183, 0.14971091, 0.01997749, 0.9998004, -0.00004057438, 0.021352313, 0.00004269579, 0.000039731505, 1., 0.00015021842]],
    "ct_plane": [[1., -0.0000034332718, -0.000037028836, 0.00006953456, 0.0000034322334, 1., -0.000014731945, 0.000045114368, 0.00003702848, 0.0000147320525, 1., -0.00023246901], [0.99980015, -0.019992573, -0.000042466367, 0.14968015, 0.019992571, 0.99980015, -0.00011034614, 0.021469293, 0.000044671244, 0.0001094734, 1., 0.00024349273]],
}
SCAN_ORDER_SHIFT = {'loam_plain': [0.02314, 0.003334], 'loam_validated': [0.0163, 0.003247], 'ct_gicp': [0.0005564, 0.0001005], 'ct_icp': [0.0004678, 6.987e-05], 'ct_plane': [0.0006308, 0.0001007]}
# phase 30: demo_bundle_adjustment's protocol on BA_KEYS keyframes
BA_KEYS = 5
BA_PLANES = 12
BA_EDGES = 8
BA_MAX_POINTS = 256
BA_SIGMA = 0.03
BA_EIGEN_GAP = 10.0
BA_ITERATIONS = 25
# The JAX package's BA poses (tests/test_torch_real_size.py --ba --ba-orders 3,
# JAX_PLATFORMS=cpu; 12 plane and 8 edge features; 5 and 6 LM iterations)
# and their largest shift with each feature's points in 3 other orders. The
# CPU port's lie 2.0e-6 m (EVM) and 2.8e-6 m (LSQ) from them; against the
# truth JAX's EVM poses are 4.8e-4 m off, its LSQ poses (planes alone)
# 0.0372 m.
BA_JAX_POSES = {
    "evm": [[0.0000000012768101, -1., 0.00000000074645096, 22., 1., 0.0000000012768087, 0.00000000042569656, 0.000000000073819346, -0.00000000042569656, 0.00000000074645184, 1., 0.5], [-0.06279997, -0.99802613, -0.000009276452, 21.956587, 0.99802625, -0.06279999, -0.0000031469008, 1.3813907, 0.0000025336653, -0.000009446689, 0.99999994, 0.50000083], [-0.12534556, -0.99211305, -0.0000118994285, 21.826565, 0.9921132, -0.12534556, -0.00000550246, 2.757365, 0.000003978874, -0.000012499439, 0.9999998, 0.50017864], [-0.18739843, -0.98228383, -0.00018015655, 21.610561, 0.982284, -0.18739845, -0.000009815897, 4.1223416, -0.000024125695, -0.00017881524, 0.99999994, 0.50014055], [-0.24869452, -0.968582, 0.000032044627, 21.308668, 0.9685819, -0.24869457, 0.000008021364, 5.471106, 0.00000019008334, 0.000033019074, 0.99999994, 0.5004475]],
    "lsq": [[0.0000000021022744, -1., 0.00000000088431995, 22., 1., 0.000000002102274, 0.0000000007617533, 0.0000000000859932, -0.0000000007617533, 0.00000000088431995, 1., 0.5], [-0.06280506, -0.99802583, -0.000009825141, 21.956585, 0.99802595, -0.062805034, -0.0000016520232, 1.3813906, 0.0000010178678, -0.000009892857, 1., 0.5000008], [-0.12540078, -0.99210596, 0.0004772895, 21.825142, 0.9921062, -0.12540077, 0.000011969065, 2.7575912, 0.000047995873, 0.00047501345, 0.99999976, 0.49848267], [-0.18754409, -0.98224914, 0.0037050259, 21.599106, 0.982256, -0.1875448, 0.00015099789, 4.122401, 0.0005465285, 0.0036676032, 0.99999326, 0.4878462], [-0.24904849, -0.9684496, 0.008948303, 21.281202, 0.9684895, -0.249054, 0.00051118823, 5.4723735, 0.0017335562, 0.008793659, 0.9999599, 0.4750857]],
}
BA_ORDER_SHIFT = {'evm': [1.97e-06, 5.493e-08], 'lsq': [5.156e-06, 7.868e-07]}

# Phases 32-35: the colored factors, the IMU and Sim(3) factors, the
# occupancy and incremental covariance maps, segmentation.
# Phase 32: demo_colored_registration's own scene and protocol (a 20 m
# plane of 20000 points with a painted ring at r = 5 m; GICP slides along
# it, the photometric term locks it), and test_voxelmap's colored GICP
# against a voxel map's frame.
COLORED_N = 20_000
COLORED_SEED = 0
COLORED_XI = (0.0, 0.0, 0.05, 0.4, -0.3, 0.0)
COLORED_FEATURE_K = 10
COLORED_FEATURE_LEAF = 1.0
COLORED_MAX_CORR = 2.0
COLORED_PHOTOMETRIC_WEIGHT = 20.0
COLORED_ITERATIONS = 30
COLORED_RUNS = ("gicp", "colored_gicp", "consistency_gicp")
COLORED_LOCKED_M = 0.05  # the demo's label: below it "locked by the photometric term"
SURFACE_N = 4000
SURFACE_SEED = 3
SURFACE_XI = (0.01, -0.01, 0.02, 0.15, -0.1, 0.05)
SURFACE_LEAF = 0.5
SURFACE_MAX_CORR = 1.0
SURFACE_ITERATIONS = 20
IVOX_TOL = 1e-5  # the ivox gradients and their lookup, card against the CPU port, x max|ref|
# Phase 33: a LiDAR-inertial keyframe chain on ring_trajectory (lap 100: a
# car at 13.8 m/s turning at 0.628 rad/s, keyframes at 10 Hz), IMU at 200 Hz.
IMU_POSES = 24
IMU_RATE_HZ = 200
IMU_KEY_DT = 0.1
IMU_WEIGHT = 100.0
IMU_PRIOR_WEIGHT = 1e6
IMU_NOISE = 0.1
IMU_SEED = 42
IMU_ITERATIONS = 30
IMU_PREDICT_TOL_M = 1e-4
IMU_JAC_TOL = 1e-5  # the bias Jacobians, card against the CPU port, x max|ref|
GRAVITY_MS2 = 9.80665
# Sim(3) alignment over KITTI 00's trajectory length, the second trajectory
# the first under SIM3_XI at scale SIM3_SCALE, each pose noised.
SIM3_POSES = 4541
SIM3_SCALE = 1.3
SIM3_XI = (0.1, -0.2, 0.3, 5.0, -3.0, 1.0)
SIM3_NOISE = 0.01
SIM3_SEED = 7
SIM3_ITERATIONS = 20
SIM3_SCALE_TOL = 1e-5  # relative
SIM3_POSE_TOL = 1e-4  # m and rad
# Phase 34: phase 4's scans at their true poses.
OCC_LEAF = 0.5
ICM_CAPACITY = 262_144
ICM_K = 10
ICM_LEAF = 1.0
ICM_WARMUPS = (256, 1)
ICM_EDGE_TOL = 1e-5  # a differing validity flag must lie this close to the band's edge (or be a kNN tie)
# Phase 35: demo_segmentation's preprocessing on phase 4's scan 0, a floor seed.
SEG_LEAF = 0.3
SEG_CAPACITY = 16384
SEG_FEATURE_K = 10
SEG_FEATURE_LEAF = 1.0
SEG_SEED_POINT = (3.0, 1.0, -0.5)
SEG_REGION = {"distance_thresh": 0.6, "angle_thresh": 0.25}
# the demo's radii, and tighter ones: the scan reaches 6.3 m, so the demo's
# 12 m background radius leaves min-cut no sink edge and every point in front
SEG_MIN_CUT = {"demo": {"foreground_radius": 4.0, "background_radius": 12.0},
               "tight": {"foreground_radius": 1.0, "background_radius": 5.0}}

# The JAX package's poses 1 of phase 32's runs (tests/test_torch_real_size.py
# --colored --colored-orders 3, JAX_PLATFORMS=cpu; 30, 19, 20 and 15 LM
# iterations) and their largest shift with each cloud's points in 3 other
# orders (m, rad). The CPU port's lie within 1.5e-4 m (GICP) and 2.4e-7 m
# (the others) of them. Against the truth JAX's GICP is 0.2869 m / 0.0309
# rad off (it slides), ColoredGICP 0.0449 m / 0.0043 rad, the surface 0.0049
# m / 0.0008 rad. The order alone moves the plane's poses by 2.3-5.1 cm:
# the photometric ring is the only constraint along the plane. The card
# takes the points in JAX's order, so the shift is printed only and each
# pose is held at GICP_BOUND_M and _RAD.
COLORED_JAX_POSES = {
    "gicp": [0.9998185, -0.019039918, 0., 0.17991102, 0.01903992, 0.9998185, 0., -0.11493138, 0., 0., 1., 0.],
    "colored_gicp": [0.9989577, -0.045642063, 0., 0.44802052, 0.04564206, 0.9989577, 0., -0.27095538, 0., 0., 1., 0.],
    "consistency_gicp": [0.99895364, -0.045734346, 0., 0.44835347, 0.045734353, 0.99895364, 0., -0.2710058, 0., 0., 1., 0.],
    "surface": [0.9997667, -0.019237895, -0.009826469, 0.146091, 0.019138096, 0.9997652, -0.01015161, -0.10029538, 0.01001945, 0.009961182, 0.99990016, 0.050543617],
}
COLORED_ORDER_SHIFT = {"gicp": [0.02267, 0.001326], "colored_gicp": [0.05089, 0.007614], "consistency_gicp": [0.05131, 0.007525], "surface": [1.085e-07, 2.66e-08]}
# The JAX package's IMU chain (--imu: 4 LM iterations; the CPU port's poses
# lie 2.7e-6 m from them, both 1.4e-3 m from the truth: the samples are
# integrated by Euler steps) and its chained prediction of the last pose.
IMU_JAX_POSES = [
    [0.0000000066222943, -1., 0.0000000015123899, 22., 1., -0.000000006621009, 0.000000011871845, 0.00000000000015460319, 0.000000011870898, -0.0000000015110547, 1., 0.5],
    [-0.06279051, -0.99802667, 0.0000000147752575, 21.956587, 0.9980267, -0.06279053, 0.0000000045392983, 1.3814584, -0.000000005678732, -0.0000000066090413, 1., 0.5],
    [-0.12533323, -0.9921147, 0.000000019172344, 21.826517, 0.9921148, -0.12533326, 0.000000026615806, 2.7574651, 0.000000006180791, -0.000000008646509, 0.99999994, 0.50000006],
    [-0.18738131, -0.9822872, 0.000000023543738, 21.610302, 0.9822872, -0.18738133, 0.00000003162016, 4.122589, 0.0000000009766907, -0.0000000049139492, 1., 0.50000006],
    [-0.24868985, -0.9685831, 0.000000009123173, 21.3088, 0.96858305, -0.24868988, 0.000000030732245, 5.4714437, -0.000000008222644, 0.000000004342432, 0.99999994, 0.50000006],
    [-0.30901694, -0.95105654, 0.0000000055742717, 20.923195, 0.9510565, -0.30901703, 0.000000029440761, 6.7987046, -0.00000001624897, 0.0000000056086233, 0.99999994, 0.5000001],
    [-0.36812454, -0.92977643, 0.00000002081348, 20.455011, 0.9297765, -0.36812457, -0.000000011978798, 8.099134, -0.0000000479189, 0.00000002363257, 1., 0.5000001],
    [-0.4257793, -0.90482706, 0.000000007896597, 19.9061, 0.90482706, -0.42577928, 0.000000012536912, 9.3676, -0.000000014454244, 0.000000023151838, 1., 0.5000002],
    [-0.4817537, -0.8763067, 0.0000000102439985, 19.278622, 0.8763067, -0.48175374, 0.0000000066299775, 10.599097, -0.0000000020106412, 0.000000021070559, 1., 0.5000002],
    [-0.53582686, -0.844328, 0.00000003366198, 18.575054, 0.8443279, -0.53582686, -0.0000000033380516, 11.788764, -0.00000000018624861, 0.0000000019398556, 0.99999994, 0.50000024],
    [-0.5877853, -0.809017, 0.000000024086365, 17.798178, 0.80901694, -0.5877853, -0.000000017012152, 12.931906, 0.000000015439724, 0.000000003799302, 1.0000001, 0.50000024],
    [-0.63742405, -0.7705131, 0.000000015066425, 16.951054, 0.77051336, -0.637424, -0.000000028552748, 14.024012, 0.000000028589866, -0.0000000043324064, 1., 0.5000002],
    [-0.6845472, -0.72896856, 0.000000005168367, 16.03703, 0.7289686, -0.6845472, -0.00000004965168, 15.06077, 0.000000028284436, -0.0000000219299, 0.99999994, 0.5000002],
    [-0.72896874, -0.6845471, -0.00000002031176, 15.059709, 0.6845471, -0.7289687, -0.00000005311552, 16.038092, 0.00000003581041, -0.000000057183577, 1.0000001, 0.5000002],
    [-0.7705132, -0.63742393, -0.00000008700669, 14.02295, 0.63742393, -0.77051324, -0.0000000889706, 16.952118, -0.0000000012363586, -0.000000073637565, 1., 0.5000002],
    [-0.809017, -0.58778536, -0.00000013038425, 12.930845, 0.58778524, -0.809017, -0.00000008933589, 17.799242, -0.00000006175145, -0.00000013545944, 1., 0.5000001],
    [-0.84432787, -0.53582674, -0.00000016603528, 11.7877035, 0.5358268, -0.8443279, -0.00000008603167, 18.57612, -0.00000010767361, -0.00000015417442, 1., 0.5000001],
    [-0.87630653, -0.4817537, -0.00000019872506, 10.598038, 0.48175365, -0.8763067, -0.00000008144132, 19.279688, -0.0000001416503, -0.00000015186835, 1., 0.5000001],
    [-0.90482724, -0.42577943, -0.0000002444603, 9.366542, 0.42577934, -0.904827, -0.00000008482345, 19.907167, -0.00000019060812, -0.00000016351738, 1.0000001, 0.5000002],
    [-0.9297765, -0.3681246, -0.00000028322728, 8.098077, 0.36812463, -0.9297764, -0.00000008883368, 20.456083, -0.00000023703895, -0.00000018314911, 1.0000001, 0.50000024],
    [-0.95105654, -0.30901706, -0.00000032970507, 6.797647, 0.3090171, -0.95105654, -0.00000010274825, 20.924267, -0.000000276973, -0.00000019627417, 1., 0.5000003],
    [-0.96858317, -0.24868996, -0.00000037017773, 5.4703865, 0.24869, -0.96858317, -0.00000011539282, 21.309874, -0.00000032483675, -0.00000019959505, 1.0000001, 0.5000003],
    [-0.9822871, -0.18738142, -0.00000039064247, 4.1215324, 0.18738136, -0.98228717, -0.00000013534998, 21.61138, -0.00000038316384, -0.00000018804774, 0.99999994, 0.50000036],
    [-0.99211466, -0.12533331, -0.00000041315394, 2.7564087, 0.12533332, -0.99211466, -0.000000106086404, 21.827595, -0.00000038392108, -0.00000019467141, 0.9999999, 0.50000036],
]
IMU_JAX_PREDICT = [-0.99210775, -0.12533315, 0., 2.7564151, 0.12533137, -0.9921078, 0., 21.827595, 0., 0., 1., 0.5]
# The JAX package's Sim(3) (--sim3; the CPU port's within 8.6e-7 m and the
# same scale to the last bit).
SIM3_JAX = {'pose': [0.93575746, -0.30292752, -0.18053499, 5.2534018, 0.2831595, 0.95058197, -0.12733704, -2.2849154, 0.21018718, 0.068036415, 0.97529095, 1.3922057], 'scale': 1.300001621246338}
# The JAX package's point count and mask sizes (--segmentation; the CPU
# port's are equal).
SEG_JAX = {'points': 2488, 'region_growing': 1158, 'min_cut_demo': 2488, 'min_cut_tight': 34}

# Phase 36's scene: a suburban drive seen by a KITTI-like LiDAR (the
# distributed_mapping demo reads KITTI 07 scans, which the repository does not
# hold). The sensor is an HDL-64E mounted as KITTI's, LIDAR_HEIGHT m up: 32
# beams from +2 to -8.33 deg and 32 from -8.83 to -24.33 deg, LIDAR_AZIMUTHS
# azimuths, returns from LIDAR_MIN_M to LIDAR_MAX_M m with LIDAR_NOISE_M of
# range noise. A sweep (about 127000 returns) is thinned as a scan dump is:
# one point a STREET_DUMP_LEAF voxel, then at most STREET_SCAN_N at random.
# The road winds (STREET_ROAD_AMP m over STREET_ROAD_PERIOD m); beside it
# three rows of box houses a side, parked cars, lamp poles, trees (a trunk
# and a crown that a ray enters up to half way) and bushes, all from
# RandomState(STREET_SEED). The demo's scans 0 and 1 lie STREET_DEMO_STEP_M
# apart (a frame at 10 m/s); the map's STREET_KEYFRAMES keyframes lie
# STREET_SPACING_M apart along the road, about 920 m of it.
LIDAR_HEIGHT = 1.73
LIDAR_AZIMUTHS = 2048
LIDAR_SECTOR = 32  # azimuths a ray bundle: each meets only the objects in its sector
LIDAR_MIN_M = 3.0
LIDAR_MAX_M = 80.0
LIDAR_NOISE_M = 0.02
LIDAR_CROWN_DEPTH = 0.5  # a ray returns from up to this share of its chord through a crown
STREET_SEED = 0
STREET_SCAN_N = 25_000
STREET_DUMP_LEAF = 0.2
STREET_ROAD_AMP = 12.0
STREET_ROAD_PERIOD = 500.0
STREET_HOUSE_ROWS = ((12.0, 20.0), (40.0, 50.0), (70.0, 80.0))  # a row's near side, m from the road
STREET_HOUSE_GAP = (10.0, 30.0)
STREET_WIDTH = 95.0  # trees and bushes up to this far from the road
STREET_TREE_AREA = 150.0  # m^2 of land a tree, and a bush
STREET_DEMO_STEP_M = 1.0
STREET_KEYFRAMES = 24
STREET_SPACING_M = 40.0

# Phase 36: the distributed layer, PAR_RANKS ranks on one card over gloo.
# The distributed_mapping demo's protocol on the drive's scans 0 and 1: both
# voxelgrid-sampled at 0.5 into 16384 slots (no covariances, as the demo), an
# 8-shard map of scan 0 at leaf 1.0 with 8192 voxels a shard, a prior and the
# map-sharded VGICP factor (min 4 points a voxel) through optimize_lm (20
# iterations) from the truth times Exp(PAR_DEMO_XI); then scan 1, moved by
# the result, inserted, and its overlap.
PAR_RANKS = 8
PAR_LEAF = 1.0
PAR_SAMPLE_LEAF = 0.5
PAR_SAMPLE_CAPACITY = 16384
PAR_DEMO_SHARD_CAPACITY = 8192
PAR_DEMO_XI = (0.05, -0.03, 0.05, 0.3, -0.2, 0.1)
PAR_DEMO_MIN_POINTS = 4.0
PAR_DEMO_ITERATIONS = 20
PAR_PRIOR_WEIGHT = 1e6
PAR_REPEATS = 3  # each registration run this many times, every run equal to the first bit for bit
# The map at the size that sharding is for: the drive's STREET_KEYFRAMES
# keyframes at their true poses, 8 shards of 1.5 x 262144 / 8 voxels (rounded
# to 128); the odometry's one map holds 262144.
PAR_MAP_SHARD_CAPACITY = 49152
PAR_LINEARIZE_CALLS = 20
# The factor axis: tests/test_distributed.py's batch_problem with 25000-point
# sources, 8 unary VGICP factors split over the ranks, 10 LM iterations.
PAR_SCAN_CAPACITY = 25088  # the demo's frames
PAR_BATCH_N = 25_000
PAR_BATCH_FACTORS = 8
PAR_BATCH_MAP_CAPACITY = 2048
PAR_BATCH_MIN_POINTS = 3.0
PAR_BATCH_ITERATIONS = 10
PAR_TIMEOUT_S = 600.0  # the ranks together; a collective that waits 120 s raises
PAR_TOL = 1e-4  # a sharded linearize against the replicated map's, x max|ref|
PAR_BOUND_M = 1e-3
PAR_BOUND_RAD = 1e-3
PAR_SHIFT_MARGIN = 2.0
# The JAX package's poses (top three rows) and iterations on 8 virtual CPU
# devices, and the largest shift of each pose over 3 other point orders:
# JAX_PLATFORMS=cpu python3 tests/test_torch_real_size.py --steps 0 --inits 0
# --orders 0 --parallel --parallel-orders 3. JAX's demo pose lies 2.019e-3 m
# and 2.969e-4 rad from the truth.
PAR_DEMO_JAX_POSE = [0.99999994, 0.000003039039, -0.00027080564, 1.0096073, -0.0000030816884, 1., -0.00012129432, -0.00040820154, 0.00027083166, 0.00012127449, 0.9999999, 0.001014251]
PAR_DEMO_JAX_ITERATIONS = 7
PAR_DEMO_ORDER_SHIFT = [2.698e-04, 5.357e-06]
PAR_BATCH_JAX_POSES = [[0.99861574, -0.047775768, 0.021995278, 0.109111644, 0.04952281, 0.99495256, -0.087273695, 0.098323494, -0.017714638, 0.08824219, 0.9959415, -0.04562491], [0.99995863, 0.004987819, -0.0075973226, 0.020112453, -0.0053413017, 0.9988693, -0.04723806, 0.0055532875, 0.007353098, 0.0472767, 0.99885464, 0.07288487], [0.9997401, -0.021882853, 0.0064054835, 0.015776206, 0.022109354, 0.9990432, -0.037732106, 0.075228795, -0.005573627, 0.03786392, 0.9992673, -0.008859942], [0.99098986, 0.12669894, -0.043435343, 0.03623029, -0.12736113, 0.9917736, -0.012823161, 0.041346826, 0.041453358, 0.018239573, 0.9989739, -0.035964053], [0.9973703, -0.0063368785, -0.072195575, -0.012097702, -0.0018632215, 0.99359864, -0.112952836, 0.07247656, 0.0724492, 0.11279034, 0.990974, 0.07717798], [0.99884593, 0.04426619, 0.018635022, -0.09928086, -0.04412165, 0.9989933, -0.0080964295, -0.015163796, -0.018974664, 0.007264853, 0.99979365, 0.008805481], [0.99801934, 0.021231057, 0.059216626, -0.017721737, -0.017563283, 0.9979349, -0.06178469, -0.04989716, -0.06040611, 0.060622267, 0.9963312, -0.07191469], [0.99494904, 0.021287642, 0.09809783, -0.020564592, -0.029562004, 0.9960539, 0.08368195, -0.060560208, -0.09592934, -0.08615926, 0.99165213, 0.042467125]]
PAR_BATCH_JAX_ITERATIONS = 10
PAR_BATCH_ORDER_SHIFT_M = [5.392e-06, 8.563e-06, 4.982e-06, 3.760e-06, 6.032e-06, 7.920e-06, 5.078e-06, 2.231e-06]
PAR_BATCH_ORDER_SHIFT_RAD = [7.918e-07, 3.398e-06, 6.497e-07, 1.390e-06, 2.174e-06, 2.943e-06, 3.731e-06, 5.971e-07]

def se3_exp_np(xi):
    """se3_exp of a twist (omega, v) as a float32 numpy [4, 4] (the port's, on the CPU)."""
    import numpy as np
    import torch

    from gtsam_points_tpu_torch.utils import se3

    return se3.se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()


def box_cloud(n: int, seed: int):
    """tests/test_distributed.py's box: the six faces of a 10 m cube, n // 3
    points on each pair of opposite faces, 2 cm of noise across them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pts = []
    for ax in range(3):
        p = rng.rand(n // 3, 3) * 10 - 5
        p[:, ax] = np.sign(p[:, ax]) * 5 + rng.randn(n // 3) * 0.02
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def parallel_batch_problem(n: int = PAR_BATCH_N, factors: int = PAR_BATCH_FACTORS) -> dict:
    """tests/test_distributed.py's batch_problem at n points a cloud: one box
    target, and `factors` sources, the target moved back by T_i =
    Exp(0.05 randn(6)) (RandomState(0)). -> {"target": [M, 3], "sources":
    [[M, 3]], "T": [[4, 4]]}, float32."""
    import numpy as np

    rng = np.random.RandomState(0)
    pts = box_cloud(n, 0)
    sources, gts = [], []
    for _ in range(factors):
        T = se3_exp_np(rng.randn(6).astype(np.float32) * 0.05)
        sources.append(((pts - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        gts.append(T)
    return {"target": pts, "sources": sources, "T": gts}


def road_y(x):
    """The road's centre line: y at x, m."""
    import numpy as np

    return STREET_ROAD_AMP * np.sin(2 * np.pi * np.asarray(x) / STREET_ROAD_PERIOD)


def road_pose(x: float):
    """The LiDAR's pose at x along the road, facing along it, float32 [4, 4]."""
    import numpy as np

    yaw = np.arctan(STREET_ROAD_AMP * 2 * np.pi / STREET_ROAD_PERIOD * np.cos(2 * np.pi * x / STREET_ROAD_PERIOD))
    T = np.eye(4)
    T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    T[:3, 3] = (x, road_y(x), LIDAR_HEIGHT)
    return T.astype(np.float32)


def street_scene(length: float, seed: int = STREET_SEED) -> dict:
    """The objects beside `length` m of road, and 120 m more at each end, in
    float64: boxes [n, 6] (min xyz, max xyz: houses, parked cars),
    cylinders [n, 4] (x, y, radius, height: poles, trunks), spheres [n, 4]
    (centre, radius: crowns, bushes)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x_lo, x_hi = -120.0, length + 120.0
    boxes, cyl, sph = [], [], []
    for side in (-1, 1):
        for near, far in STREET_HOUSE_ROWS:
            x = x_lo
            while x < x_hi:
                w, d, h = rng.uniform(8, 18), rng.uniform(8, 14), rng.uniform(4, 12)
                y = road_y(x + w / 2) + side * rng.uniform(near, far)
                boxes.append((x, y if side > 0 else y - d, 0.0, x + w, y + d if side > 0 else y, h))
                x += w + rng.uniform(*STREET_HOUSE_GAP)
        x = x_lo
        while x < x_hi:
            if rng.rand() < 0.4:
                y = road_y(x + 2.2) + side * rng.uniform(4.0, 4.6)
                boxes.append((x, y - 0.9, 0.2, x + 4.4, y + 0.9, 1.5))
            x += rng.uniform(5.5, 9.0)
        for x in np.arange(x_lo, x_hi, 25.0) + rng.uniform(0, 25.0):
            cyl.append((x, road_y(x) + side * 6.5, 0.12, 7.0))
    boxes = np.asarray(boxes, np.float64)

    def clear_of_houses(x, y, margin):
        ok = np.ones(len(x), bool)
        for b in boxes:
            ok &= ~((x > b[0] - margin) & (x < b[3] + margin) & (y > b[1] - margin) & (y < b[4] + margin))
        return ok

    n = int((x_hi - x_lo) * 2 * STREET_WIDTH / STREET_TREE_AREA)
    tx = rng.uniform(x_lo, x_hi, n)
    ty = road_y(tx) + rng.uniform(-STREET_WIDTH, STREET_WIDTH, n)
    ok = (np.abs(ty - road_y(tx)) > 7.0) & clear_of_houses(tx, ty, 2.0)
    for x, y in zip(tx[ok], ty[ok]):
        h, r = rng.uniform(2.0, 4.0), rng.uniform(1.2, 3.0)
        cyl.append((x, y, rng.uniform(0.15, 0.35), h + r))
        sph.append((x, y, h + r, r))
    bx = rng.uniform(x_lo, x_hi, n)
    by = road_y(bx) + rng.uniform(-STREET_WIDTH, STREET_WIDTH, n)
    ok = (np.abs(by - road_y(bx)) > 5.5) & clear_of_houses(bx, by, 1.0)
    for x, y in zip(bx[ok], by[ok]):
        r = rng.uniform(0.5, 1.3)
        sph.append((x, y, 0.6 * r, r))
    return {"boxes": boxes, "cylinders": np.asarray(cyl, np.float64), "spheres": np.asarray(sph, np.float64)}


def lidar_sweep(scene: dict, T, rng):
    """One sweep of the LiDAR at pose T (a yaw and a position) through the
    scene: the returns [n, 3] in the sensor frame, float32. Each ray meets
    the ground (z = 0) and the objects whose bearing lies within its
    LIDAR_SECTOR-azimuth sector; its return is the nearest hit."""
    import numpy as np

    o, R = T[:3, 3].astype(np.float64), T[:3, :3].astype(np.float64)
    yaw = np.arctan2(R[1, 0], R[0, 0])
    el = np.deg2rad(np.concatenate([np.linspace(2.0, -8.33, 32), np.linspace(-8.83, -24.33, 32)]))
    az = (np.arange(LIDAR_AZIMUTHS) + rng.rand()) * (2 * np.pi / LIDAR_AZIMUTHS)
    A, E = np.meshgrid(az, el, indexing="ij")  # [azimuths, beams]
    local = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], -1)
    D = local @ R.T
    t = np.where(D[..., 2] < 0, -o[2] / np.minimum(D[..., 2], -1e-12), np.inf)
    depth = (rng.rand(*t.shape) * LIDAR_CROWN_DEPTH).reshape(LIDAR_AZIMUTHS // LIDAR_SECTOR, -1)
    B, C, S = scene["boxes"], scene["cylinders"], scene["spheres"]
    objects = {}
    for kind, P, centre, radius in (("box", B, 0.5 * (B[:, :2] + B[:, 3:5]), 0.5 * np.linalg.norm(B[:, 3:5] - B[:, :2], axis=1)),
                                    ("cylinder", C, C[:, :2], C[:, 2]), ("sphere", S, S[:, :2], S[:, 3])):
        v = centre - o[:2]
        dist = np.linalg.norm(v, axis=1)
        near = dist - radius < LIDAR_MAX_M
        bearing = np.mod(np.arctan2(v[:, 1], v[:, 0]) - yaw, 2 * np.pi)
        half = np.where(dist > radius, np.arcsin(np.minimum(1.0, radius / np.maximum(dist, 1e-9))), np.pi)
        objects[kind] = (P[near], bearing[near], half[near])
    width = 2 * np.pi * LIDAR_SECTOR / LIDAR_AZIMUTHS
    for k in range(LIDAR_AZIMUTHS // LIDAR_SECTOR):
        mid = (k + 0.5) * width
        d = D[k * LIDAR_SECTOR:(k + 1) * LIDAR_SECTOR].reshape(-1, 3)
        tt = t[k * LIDAR_SECTOR:(k + 1) * LIDAR_SECTOR].reshape(-1)
        for kind, (P, bearing, half) in objects.items():
            P = P[np.abs(np.mod(bearing - mid + np.pi, 2 * np.pi) - np.pi) < half + width / 2 + 1e-3]
            if not len(P):
                continue
            if kind == "box":  # slabs
                inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
                lo, hi = (P[None, :, :3] - o) * inv[:, None], (P[None, :, 3:] - o) * inv[:, None]
                t_in, t_out = np.max(np.minimum(lo, hi), -1), np.min(np.maximum(lo, hi), -1)
                th = np.where((t_out >= t_in) & (t_in > 0), t_in, np.inf)
            elif kind == "cylinder":  # vertical, from the ground to its height
                a = (d[:, 0] ** 2 + d[:, 1] ** 2)[:, None]
                px, py = o[0] - P[None, :, 0], o[1] - P[None, :, 1]
                bq = 2 * (d[:, None, 0] * px + d[:, None, 1] * py)
                disc = bq ** 2 - 4 * a * (px ** 2 + py ** 2 - P[None, :, 2] ** 2)
                tc = (-bq - np.sqrt(np.maximum(disc, 0))) / (2 * a + 1e-30)
                z = o[2] + tc * d[:, None, 2]
                th = np.where((disc > 0) & (tc > 0) & (z >= 0) & (z <= P[None, :, 3]), tc, np.inf)
            else:  # a sphere, entered up to `depth` of the chord
                oc = o - P[:, :3]
                bq = d @ oc.T
                disc = bq ** 2 - (np.sum(oc * oc, 1) - P[:, 3] ** 2)[None]
                root = np.sqrt(np.maximum(disc, 0))
                ts = -bq - root + depth[k][:, None] * 2 * root
                th = np.where((disc > 0) & (ts > 0), ts, np.inf)
            tt = np.minimum(tt, th.min(1))
        t[k * LIDAR_SECTOR:(k + 1) * LIDAR_SECTOR] = tt.reshape(LIDAR_SECTOR, -1)
    t, local = t.reshape(-1), local.reshape(-1, 3)
    hit = (t >= LIDAR_MIN_M) & (t <= LIDAR_MAX_M)
    r = t[hit] + rng.randn(int(hit.sum())) * LIDAR_NOISE_M
    return (local[hit] * r[:, None]).astype(np.float32)


def scan_dump(points, rng):
    """A sweep thinned as a scan dump is: the first point of each
    STREET_DUMP_LEAF voxel, then at most STREET_SCAN_N of them at random, in
    sweep order."""
    import numpy as np

    k = np.floor(points / STREET_DUMP_LEAF).astype(np.int64) + (1 << 20)
    _, first = np.unique((k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2], return_index=True)
    keep = np.sort(first)
    if len(keep) > STREET_SCAN_N:
        keep = np.sort(rng.choice(keep, STREET_SCAN_N, replace=False))
    return points[keep]


def parallel_street() -> dict:
    """Phase 36's data from the drive (float32): "demo", the demo's scan 0
    (target) and scan 1 (source) in their sensor frames, the true relative
    pose ("delta") and the start, the truth times Exp(PAR_DEMO_XI);
    "keyframes", the map's scans in the world frame; "scan_last" and
    "T_last", the last keyframe in its sensor frame and its pose."""
    import numpy as np

    scene = street_scene((STREET_KEYFRAMES - 1) * STREET_SPACING_M)
    rng = np.random.RandomState(STREET_SEED + 1)

    def scan(T):
        return scan_dump(lidar_sweep(scene, T, rng), rng)

    T0, T1 = road_pose(0.0), road_pose(STREET_DEMO_STEP_M)
    delta = (np.linalg.inv(T0.astype(np.float64)) @ T1.astype(np.float64)).astype(np.float32)
    demo = {"target": scan(T0), "source": scan(T1), "delta": delta,
            "start": (delta @ se3_exp_np(PAR_DEMO_XI)).astype(np.float32)}
    poses = [road_pose(k * STREET_SPACING_M) for k in range(STREET_KEYFRAMES)]
    local = [scan(T) for T in poses]
    return {"demo": demo, "keyframes": [((p @ T[:3, :3].T) + T[:3, 3]).astype(np.float32) for p, T in zip(local, poses)],
            "scan_last": local[-1], "T_last": poses[-1]}


def colored_scene(n: int = COLORED_N, seed: int = COLORED_SEED) -> dict:
    """demo_colored_registration's scene: n points on z = 0 over 20 m x 20 m,
    intensity 1 within 0.1 m of the r = 5 m ring plus N(0, 0.01), the source
    the same points seen from se3_exp(COLORED_XI)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2).astype(np.float32) * 20 - 10
    pts = np.concatenate([xy, np.zeros((n, 1), np.float32)], axis=1)
    d = np.abs(np.linalg.norm(xy, axis=1) - 5.0)
    intens = ((d < 0.1).astype(np.float32) * 1.0 + rng.randn(n).astype(np.float32) * 0.01).astype(np.float32)
    T = se3_exp_np(COLORED_XI)
    src = ((pts - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    return {"target": pts, "source": src, "intensities": intens, "T_true": T}


def surface_scene(n: int = SURFACE_N, seed: int = SURFACE_SEED) -> dict:
    """tests/test_voxelmap.py's colored-GICP scene: a smooth surface painted
    sin(2x) cos(2y), covariances 0.01 I, the source seen from
    se3_exp(SURFACE_XI)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    xy = (rng.rand(n, 2) * 8 - 4).astype(np.float32)
    z = (0.1 * np.sin(xy[:, 0]) + 0.05 * xy[:, 1]).astype(np.float32)
    pts = np.concatenate([xy, z[:, None]], axis=1)
    inten = (np.sin(2.0 * xy[:, 0]) * np.cos(2.0 * xy[:, 1])).astype(np.float32)
    covs = np.tile((0.01 * np.eye(3, dtype=np.float32))[None], (n, 1, 1))
    T = se3_exp_np(SURFACE_XI)
    src = ((pts - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    return {"target": pts, "source": src, "intensities": inten, "covs": covs, "T_true": T}


def imu_chain(n_poses: int = IMU_POSES) -> dict:
    """The keyframe chain: ring_trajectory's first n_poses poses, between
    each pair IMU_RATE_HZ x IMU_KEY_DT body-frame samples of the ring's
    constant yaw rate and specific force (centripetal plus gravity), zero
    bias; the world velocity at each keyframe; start poses noised by
    IMU_NOISE with RandomState(IMU_SEED)."""
    import numpy as np

    from gtsam_points_tpu_torch.utils.synthetic import ring_trajectory

    T = np.stack(ring_trajectory(n_poses, lap=100))
    omega = 2 * np.pi / (100 * IMU_KEY_DT)
    speed = 22.0 * omega
    per = int(round(IMU_RATE_HZ * IMU_KEY_DT))
    stamps = (np.arange(per + 1) / IMU_RATE_HZ).astype(np.float32)
    gyros = np.tile([0.0, 0.0, omega], (per + 1, 1)).astype(np.float32)
    accs = np.tile([0.0, omega * omega * 22.0, GRAVITY_MS2], (per + 1, 1)).astype(np.float32)
    v = (T[:, :3, :3] @ np.array([speed, 0.0, 0.0])).astype(np.float32)
    noise = np.random.RandomState(IMU_SEED).randn(n_poses, 6) * IMU_NOISE
    start = np.stack([T[i] @ se3_exp_np(noise[i]) for i in range(n_poses)]).astype(np.float32)
    return {"T": T, "stamps": stamps, "accs": accs, "gyros": gyros, "v": v, "start": start}


def sim3_trajectories(n_poses: int = SIM3_POSES) -> dict:
    """poses_a: ring_trajectory(n_poses); poses_b: scaled_transform of
    (S poses_a, SIM3_SCALE), S = se3_exp(SIM3_XI), each times
    se3_exp(SIM3_NOISE N(0, 1)) with RandomState(SIM3_SEED)."""
    import numpy as np

    from gtsam_points_tpu_torch.utils.synthetic import ring_trajectory

    A = np.stack(ring_trajectory(n_poses, lap=100)).astype(np.float64)
    B = se3_exp_np(SIM3_XI).astype(np.float64)[None] @ A
    B[:, :3, 3] *= SIM3_SCALE
    noise = np.random.RandomState(SIM3_SEED).randn(n_poses, 6) * SIM3_NOISE
    B = np.stack([B[i] @ se3_exp_np(noise[i]) for i in range(n_poses)])
    return {"a": A.astype(np.float32), "b": B.astype(np.float32)}


def segmentation_scan():
    """Phase 4's scan 0 (ring_scans of the REAL_WORLD_N-point world, seed 1)."""
    from gtsam_points_tpu_torch.utils.synthetic import ring_scans, ring_trajectory, ring_world

    return ring_scans(ring_world(0, REAL_WORLD_N), ring_trajectory(1, lap=100), scan_n=REAL_SCAN_N, seed=1)[0]

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
    """The floating-point tensors of `args` in float64, the rest (integer and
    bool tensors, Python numbers, None) as they are."""
    return tuple(a.double() if getattr(a, "is_floating_point", lambda: False)() else a for a in args)


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
    differ = _bits_differ(torch, lin, again)
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


def _strip_anonymous(text: str) -> str:
    """A mangled name, or a line of SASS, without its anonymous-namespace
    components (`<len>_GLOBAL__N__...`), which differ by tree."""
    import re

    out, pos = [], 0
    for m in re.finditer(r"(\d+)(_GLOBAL__N__|_INTERNAL_)", text):
        if m.start() < pos:
            continue
        out.append(text[pos:m.start()] + "ANON")
        pos = m.start(2) + int(m.group(1))
    return "".join(out) + text[pos:]


def _sass_functions(path: str) -> dict:
    """cuobjdump -sass of a library -> {function name without its
    anonymous-namespace prefix: its SASS lines, joined}."""
    from gtsam_points_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True, check=True).stdout
    funcs, current = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            current = _strip_anonymous(line.split("Function : ", 1)[1].strip())
            funcs[current] = []
        elif current is not None and line.strip():
            funcs[current].append(_strip_anonymous(line.strip()))
    return {k: "\n".join(v) for k, v in funcs.items()}


def sass_diff(tree: str) -> None:
    """--sass-diff: every kernel source of this checkout and of the checkout
    at `tree` (another commit unpacked into a directory that .gitignore
    lists) built with this checkout's nvcc flags into a scratch directory
    inside the build directory, and their SASS compared function by
    function; a kernel found under another name in the other tree is
    matched by its code. One line a source."""
    import tempfile
    from pathlib import Path

    from gtsam_points_tpu_torch import _build

    trees = {"here": Path(ROOT), "there": Path(tree).resolve()}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for name in _build.SOURCES:
            sass = {}
            for label, root in trees.items():
                src = root / "gtsam_points_tpu_torch" / "csrc" / f"{name}.cu"
                if not src.exists():
                    continue
                lib = os.path.join(tmp, f"{label}_{name}.so")
                subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, str(src)],
                               capture_output=True, text=True, check=True)
                sass[label] = _sass_functions(lib)
            if len(sass) < 2:
                log(f"[sass] {name}.cu: only {', '.join(sass)}")
                continue
            a, b = sass["here"], sass["there"]
            equal = [k for k in a if b.get(k) == a[k]]
            renamed = [f"{k} = {next(j for j in b if b[j] == a[k])} there" for k in a
                       if b.get(k) != a[k] and a[k] in b.values()]
            new = [k for k in a if a[k] not in b.values()]
            gone = [k for k in b if b[k] not in a.values()]
            log(f"[sass] {name}.cu vs {tree}: {len(equal)} of {len(a)} functions equal under the same name; "
                f"equal under another name: {renamed or 'none'}; code found nowhere there: {new or 'none'}; "
                f"code there found nowhere here: {gone or 'none'}")


def unary_witness(torch, tree: str) -> None:
    """--unary-witness: K1's and K5's device us per launch pair, by kernel,
    of the checkout at `tree` (this commit's, or another's unpacked into a
    directory that .gitignore lists) on phase 7's inputs: K1 at N = 1 and at
    the pyramid's four stage shapes, K5 at N = 1, 8, 3136 and 25088. Held to
    nothing, so that two commits' K1 and K5 can be timed side by side in
    one chip call. It uses only functions every commit of the port since K5
    has."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL

    _, scans, _, priors = _ring_frames(torch, 2)
    source, maps, _ = _pyramid_inputs(torch, scans, priors[0], "cuda")
    cases = dict(_k1_cases(torch, source, maps))
    runs = [("K1", FL.linearize_vgicp_unary_cuda, name, cases[name])
            for name in ("N=1", "stride 8 leaf 4", "stride 4 leaf 1", "stride 2 leaf 1", "N=25088")]
    runs += [("K5", FL.linearize_vgicp_unary_dense_cuda, name, cases[name][:7])
             for name in ("N=1", "N=8", "stride 8 leaf 4", "N=25088")]
    for kernel, fn, name, args in runs:
        split = _device_us_by_kernel(torch, lambda: fn(*args), "unary_")
        log(f"[unary-witness] {tree} {kernel} {name} (N={args[0].shape[1]}): device {_pair_text(split)}")


def _zero_counts(FL) -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    FL.launches = 0
    FL.unary_launches = 0
    FL.unary_batch_launches = 0
    FL.moments_launches = 0
    FL.dense_launches = 0


def _ring_frames(torch, n_poses: int, world_n: int = REAL_WORLD_N):
    import numpy as np

    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs_moments
    from gtsam_points_tpu_torch.types.frame import make_frame
    from gtsam_points_tpu_torch.utils.synthetic import ring_scans, ring_trajectory, ring_world

    world = ring_world(0, world_n)
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


def _run_odometry(torch, frames, priors, steps: int, eager: bool = False, start=None, clusters=None,
                  reads: Optional[list] = None):
    """`steps` odometry steps; step i gets priors[i] as its motion prior.
    Through make_odometry_stepper (one CUDA graph replay a step), or with
    `eager` through odometry_step. `start` = (state, stepper) continues a
    run instead of starting one from frames[0]; frames[0] and priors[0] are
    then the first step's. `clusters` (one a frame, aligned with `frames`)
    takes the cluster path. With `reads`, each step's host reads (the
    synchronizing calls sync debug mode "warn" reports inside the step) are
    appended to it."""
    from gtsam_points_tpu_torch.pipelines.odometry import (
        OdometryParams,
        init_odometry,
        make_odometry_stepper,
        odometry_step,
    )

    import warnings

    params = OdometryParams()
    clusters = [None] * len(frames) if clusters is None else clusters
    if start is None:
        state = init_odometry(frames[0], params, device="cuda")
        step = make_odometry_stepper(params, device="cuda")
        frames, clusters = frames[1:], clusters[1:]
    else:
        state, step = start
    if eager:
        def step(state, f, prior, cl):  # noqa: F811
            return odometry_step(state, f, params, prior, cl)
    poses = [state.T_world]
    iters, step_ms, merges = [], [], 0
    for f, prior, cl in zip(frames[:steps], priors, clusters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if reads is None:
            state, T, diag = step(state, f, prior, cl)
        else:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, T, diag = step(state, f, prior, cl)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            reads.append(sum("called a synchronizing CUDA operation" in str(w.message) for w in caught))
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
    log(f"[main] graph stepper: step ms over {len(step_ms)} steps median {statistics.median(step_ms):.3f}, "
        f"min {min(step_ms):.3f}, max {max(step_ms):.3f} (first, with the capture: {step_ms[0]:.3f}); "
        f"limit {STEP_LIMIT_MS} ms, one 10 Hz LiDAR period")
    if statistics.median(step_ms) > STEP_LIMIT_MS:
        raise AssertionError(f"the median step takes more than {STEP_LIMIT_MS} ms")
    ate_mean, ate_max = float(trans_e.mean()), float(trans_e.max())
    log(f"[main] ATE translation mean {ate_mean:.6f} m max {ate_max:.6f} m; "
        f"rotation max {float(rot_e.max()):.6f} rad (bound: the JAX package's mean "
        f"{ATE_JAX_MEAN_M} m, max {ATE_JAX_MAX_M} m, times {ATE_SLACK})")
    if not (ate_mean <= ATE_JAX_MEAN_M * ATE_SLACK and ate_max <= ATE_JAX_MAX_M * ATE_SLACK):
        raise AssertionError("the trajectory is further from the truth than the JAX package's")

    if profile:
        _profile_steps(torch, frames, priors, profile)
        _census(torch, frames, priors)

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
    r["map"] = (state.vmap, frames[-1], poses[-1])
    r["T_true"], r["world_poses"] = T_true, T0 @ poses
    return scans, frames, priors, r


def _trace(torch, label: str, run, unit: str, key: str, path: str, per_step: int = 0) -> None:
    """`run()` -> (wall ms, units of work), three times in this process:
    untraced, traced with device activity only (the busy share), and traced
    with host ops too (launch, graph-launch and host-read counts; the table
    goes to `path`). `key` names the kernels whose device time is also given
    alone. With `per_step`, counts are also given per step of that many."""
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
    key_ms = sum(e.self_device_time_total for e in kernels if _named(e.key, key)) / 1e3
    key_pairs = sum(e.count for e in kernels if _named(e.key, key)) / 2  # partial + final
    n_kernels = sum(e.count for e in kernels)
    per_pair = f"{key_ms * 1e3 / key_pairs:.3f} us" if key_pairs else "not measured"
    log(f"[profile] the same {label} traced with device activity only: wall {traced_ms:.3f} ms, "
        f"device kernel time {device_ms:.3f} ms, busy {100 * device_ms / traced_ms:.2f}% of the traced "
        f"wall; {n_kernels} kernels ({n_kernels / units:.1f} per {unit}), '{_key_text(key)}' kernels {key_ms:.3f} ms "
        f"in {key_pairs:g} launch pairs, {per_pair} per pair")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_ms, units = run()
    events = prof.key_averages()
    n_launch = sum(e.count for e in events if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    n_graph = sum(e.count for e in events if e.key.startswith(("cudaGraphLaunch", "cuGraphLaunch")))
    n_sync = sum(e.count for e in events if e.key == "cudaStreamSynchronize")  # host reads
    with open(path, "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=80))
    steps = (f"; per step: {n_kernels / per_step:.1f} kernels, {device_ms / per_step:.3f} ms of device time, "
             f"{n_launch / per_step:.1f} launches, {n_graph / per_step:.1f} graph launches, "
             f"{n_sync / per_step:.1f} host reads") if per_step else ""
    log(f"[profile] the same {label} traced with host ops: wall {host_ms:.3f} ms, {n_launch} kernel "
        f"launches ({n_launch / units:.1f} per {unit}), {n_graph} graph launches, {n_sync} host reads"
        f"{steps}; table in {path}")


def _profile_steps(torch, frames, priors, path: str, clusters=None) -> None:
    """Three odometry steps (2..4) traced (see _trace): through the graph
    stepper, captured at step 1 before the traces, and through the eager
    odometry_step. With `clusters` (one a frame), the cluster path's graph
    steps only."""
    from gtsam_points_tpu_torch.pipelines.odometry import OdometryParams, init_odometry, make_odometry_stepper

    params = OdometryParams()
    step = make_odometry_stepper(params, device="cuda")
    cl = [None] * len(frames) if clusters is None else clusters
    state, _, _ = step(init_odometry(frames[0], params, device="cuda"), frames[1], priors[0], cl[1])
    root, ext = os.path.splitext(path)
    kinds = [("graph", False, path)] + ([] if clusters else [("eager", True, f"{root}_eager{ext}")])
    for label, eager, out in kinds:
        def run():
            _, _, iters, step_ms, _ = _run_odometry(torch, frames[2:], priors[1:], 3, eager, (state, step), cl[2:])
            return sum(step_ms), sum(iters)

        _trace(torch, f"3 {'cluster ' if clusters else ''}odometry steps, {label}", run, "LM iteration",
               "unary_" if clusters else "linearize_", out, per_step=3)


def _census_piece(torch, fn, reps: int = 20) -> tuple:
    """(kernels, device us) per call of fn, from one trace of `reps` calls:
    every device activity the profiler records (kernels, copies, fills)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in rows) / reps, sum(e.self_device_time_total for e in rows) / reps


def _census(torch, frames, priors, clusters=None) -> None:
    """The census of one odometry step by source: each piece of the graph's
    registration run alone at the main path's shape (frame 4 against the map
    after three steps), its kernels and device us per call. Pieces that
    contain others are given, and what they add on their own is their total
    less the parts. Then what a step adds up to by these counts. With
    `clusters` (one a frame), the cluster path's step (K1 with weights)."""
    from gtsam_points_tpu_torch.factors.vgicp import VGICPClustersFactor, VGICPFactor
    from gtsam_points_tpu_torch.optim import lm as LM
    from gtsam_points_tpu_torch.optim.graph import FactorGraph, retract
    from gtsam_points_tpu_torch.pipelines import odometry as O
    from gtsam_points_tpu_torch.utils import se3

    params = O.OdometryParams()
    p = O._lm_params(params)
    state, _, _, _, _ = _run_odometry(torch, frames, priors, 3, eager=True, clusters=clusters)
    frame, prior = frames[4], priors[3]
    T_pred = state.T_world @ prior
    common = dict(voxelmap=state.vmap, fixed_target_pose=torch.eye(4, device="cuda"), target_key=-1,
                  source_key=0, min_voxel_points=params.min_voxel_points)
    if clusters is None:
        def new_factor():
            return VGICPFactor(source=frame, **common)

        n = frame.capacity
        views_key, views = "planar views (_source_planar, once a step)", lambda: new_factor()._source_planar
        corr_key, lin_key = "correspondences (lookup_fetch_planar, sym_rotate, sym_inv)", "linearize_corr (K3 + _unpack)"
    else:
        def new_factor():
            return VGICPClustersFactor(clusters=clusters[4], **common)

        n = clusters[4].capacity
        views_key, views = "regularized covariances (_cl_covs6, once a step)", lambda: new_factor()._cl_covs6
        corr_key, lin_key = "correspondences (probe_moments)", "linearize_corr (K1 with weights + _unpack)"

    factor = new_factor()
    graph = FactorGraph([factor], num_poses=1)
    poses = T_pred[None]
    st = LM.lm_start(graph, poses, p)
    corr = graph.correspondences(poses)  # one entry a factor
    A, b, err_lin, frozen_error = graph.linearize_frozen(poses, corr)
    c = LM.candidates(A, b, st.lam, st.ladder, poses, p)
    errs = LM.score(c, err_lin, frozen_error, p)
    res = LM.lm_result(st)

    def tail():
        T_new = torch.where(torch.all(torch.isfinite(res.poses[0])), res.poses[0], T_pred)
        return se3.se3_inverse(state.T_world) @ T_new

    measured = {
        views_key: views,
        "prediction T_world @ delta": lambda: state.T_world @ prior,
        "lm_start (state, status arrays)": lambda: LM.lm_start(graph, poses, p),
        corr_key: lambda: factor.correspondences(poses),
        lin_key: lambda: factor.linearize_corr(poses, corr[0]),
        "linearize_frozen (all)": lambda: graph.linearize_frozen(poses, corr),
        "_solve_damped (solve_small, K = 5)": lambda: LM._solve_damped(A, b, c.lams, p.diagonal_damping),
        "retract / se3_exp (K = 5)": lambda: retract(poses, c.deltas),
        "candidates (all)": lambda: LM.candidates(A, b, st.lam, st.ladder, poses, p),
        "frozen_error, candidate 0": lambda: frozen_error(c.cands[0]),
        "frozen_error, candidates 1..4": lambda: frozen_error(c.cands[1:]),
        "score (all)": lambda: LM.score(c, err_lin, frozen_error, p),
        "gate": lambda: LM.gate(c, err_lin, errs, p),
        "lm_iteration (all)": lambda: LM.lm_iteration(graph, st, p),
        "finite guard and T_delta": tail,
    }
    m = {k: _census_piece(torch, fn) for k, fn in measured.items()}

    def less(total, *parts):
        return tuple(m[total][i] - sum(m[q][i] for q in parts) for i in (0, 1))

    rows = [
        (corr_key, m[corr_key]),
        (lin_key, m[lin_key]),
        ("linearize_frozen's assembly (A, b, error)", less("linearize_frozen (all)", lin_key)),
        ("_solve_damped (solve_small, K = 5)", m["_solve_damped (solve_small, K = 5)"]),
        ("retract / se3_exp (K = 5)", m["retract / se3_exp (K = 5)"]),
        ("ladder and predicted decrease", less("candidates (all)", "_solve_damped (solve_small, K = 5)",
                                              "retract / se3_exp (K = 5)")),
        ("frozen_error, candidate 0", m["frozen_error, candidate 0"]),
        ("frozen_error, candidates 1..4", m["frozen_error, candidates 1..4"]),
        ("score's gate on candidate 0, inf mask, cat", less("score (all)", "frozen_error, candidate 0",
                                                           "frozen_error, candidates 1..4")),
        ("gate", m["gate"]),
        ("finish: pick, lambda, convergence, done masking, status",
         less("lm_iteration (all)", corr_key, "linearize_frozen (all)", "candidates (all)", "score (all)", "gate")),
    ]
    log(f"[census] one {'cluster ' if clusters else ''}LM iteration by source, at N = {n} (kernels per call, "
        "device us per call):")
    for name, (k, us) in rows:
        log(f"[census]   {name}: {k:.1f} kernels, {us:.3f} us")
    k_it, us_it = m["lm_iteration (all)"]
    log(f"[census]   sum of the rows = lm_iteration: {sum(r[1][0] for r in rows):.1f} kernels "
        f"({k_it:.1f}), {sum(r[1][1] for r in rows):.3f} us ({us_it:.3f})")
    once = [views_key, "prediction T_world @ delta", "lm_start (state, status arrays)",
            "finite guard and T_delta"]
    for name in once:
        log(f"[census]   once a step, {name}: {m[name][0]:.1f} kernels, {m[name][1]:.3f} us")
    k_step = sum(m[n][0] for n in once) + p.max_iterations * k_it
    us_step = sum(m[n][1] for n in once) + p.max_iterations * us_it
    log(f"[census] the graph's registration: {k_step:.1f} kernels, {us_step:.3f} us of device time a step "
        f"({p.max_iterations} iterations); the step's other work (static-buffer copies, clones, keyframe "
        f"gate, insert) is the traced step less this")


def phase_plain_vs_cuda(torch, frames, priors) -> None:
    """The graph stepper against the eager odometry_step on the same frames,
    bit for bit; then the CUDA path against the plain path (K3's plain
    version in K3's place) within POSE_BOUND_M."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.utils import se3

    _, poses_graph, it_graph, _, _ = _run_odometry(torch, frames, priors, REAL_STEPS)
    _, poses_eager, it_eager, eager_ms, _ = _run_odometry(torch, frames, priors, REAL_STEPS, eager=True)
    same = torch.equal(poses_graph, poses_eager) and it_graph == it_eager
    rot_d, trans_d = se3.pose_error(poses_eager, poses_graph)
    log(f"[plain] {REAL_STEPS} steps graph stepper vs eager odometry_step: poses equal bit for bit {same}, "
        f"max per-pose difference {float(trans_d.max()):.3e} m, {float(rot_d.max()):.3e} rad; LM iterations "
        f"equal {it_graph == it_eager}; eager step ms median {statistics.median(eager_ms):.3f}")
    if not same:
        raise AssertionError("the graph stepper and the eager step disagree")

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
    return _frame_to(frame, "cuda")


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


def _named(name: str, key) -> bool:
    """Whether a profiler's kernel name holds `key`, a string or a tuple of
    strings any of which will do."""
    return any(k in name for k in ((key,) if isinstance(key, str) else key))


def _key_text(key) -> str:
    return key if isinstance(key, str) else "' + '".join(key)


def _kernel_label(name: str) -> str:
    """A profiler's kernel name without its return type, namespace and
    arguments: "unary_partial<true, false>"."""
    return name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]


def _device_us_by_kernel(torch, fn, key: str, calls: int = 100) -> dict:
    """Device time per call of fn of each kernel whose name holds `key`, by
    _kernel_label, from one profiler trace of `calls` calls; empty when the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernel_type = torch.autograd.DeviceType.CUDA
    split = collections.defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == kernel_type and _named(e.key, key) and e.self_device_time_total > 0:
            split[_kernel_label(e.key)] += e.self_device_time_total / calls
    return dict(split)


def _pair_text(split: dict) -> str:
    """A _device_us_by_kernel result as text: the pair's total, then each
    kernel's share."""
    if not split:
        return "not measured"
    return (f"{sum(split.values()):.3f} us per launch pair ("
            + ", ".join(f"{k} {v:.3f} us" for k, v in sorted(split.items())) + ")")


def _device_us_per_call(torch, fn, key: str, calls: int = 100):
    """Device time of the kernels whose name holds `key`, per call of fn, from
    a profiler trace of `calls` calls; None when the trace holds no device time."""
    split = _device_us_by_kernel(torch, fn, key, calls)
    return sum(split.values()) if split else None


def _bits_differ(torch, x, y) -> int:
    """Values of two Linearized (or tuples of tensors) that differ in any bit."""
    return sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(x, y))


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
        ("N=8", stage_args(1, maps[-1], n=8)),
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
    """K1 against its plain version on the pyramid's own inputs (_k1_cases),
    each case called twice with no host read allowed, the two calls equal
    bit for bit; device us per launch pair, split between the partial and
    the final kernel from the trace, each beside its bound, at N = 1 and at
    the pyramid's four stage shapes (N = 3136, 6272, 12544, 25088); wrapper
    and plain times at the last stage's shape and at the first stage's."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.registration.pyramid import DEFAULT_STAGES

    cases = _k1_cases(torch, source, maps)
    strided = (source.points.T.contiguous()[:, :: DEFAULT_STAGES[0].stride],) + cases[-2][1][1:]
    try:
        FL.linearize_vgicp_unary_cuda(*strided)
        raise AssertionError("K1's wrapper took a non-contiguous source")
    except ValueError:
        pass
    FL.linearize_vgicp_unary_cuda(*cases[0][1])  # loads the library before the host reads are refused
    torch.cuda.synchronize()
    outputs = []
    for name, args in cases:
        torch.cuda.set_sync_debug_mode("error")  # a host read inside raises
        try:
            lin = FL.linearize_vgicp_unary_cuda(*args)
            again = FL.linearize_vgicp_unary_cuda(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref = FL.linearize_vgicp_unary_plain(*args)
        outputs.append(lin)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(torch, lin, ref)
        differ = _bits_differ(torch, lin, again)
        log(f"[k1] {name}: valid {int(ref.num_inliers)} max_abs_err={abs_err:.3e} "
            f"err/max|ref|={rel_err:.3e} (tol {K1_TOL}); two calls differ in {differ} values (must be 0)")
        if rel_err > K1_TOL or int(lin.num_inliers) != int(ref.num_inliers):
            raise AssertionError(f"K1 disagrees with its plain version ({name})")
        if differ:
            raise AssertionError(f"two K1 calls on the same input differ ({name})")

    out = {"outputs": outputs}
    by_name = dict(cases)
    timed = (("N=1", "N=1"), ("stride8", "stride 8 leaf 4"), ("stride4", "stride 4 leaf 1"),
             ("stride2", "stride 2 leaf 1"), ("main", "N=25088"))
    for key, name in timed:
        args = by_name[name]
        bound, bound_by = k1_bound_ms(args)
        split = _device_us_by_kernel(torch, lambda: FL.linearize_vgicp_unary_cuda(*args), "unary_")
        r = {
            "n": args[0].shape[1],
            "device_us": sum(split.values()) if split else None,
            "split": split,
            "bound_ms": bound,
            "bound_by": bound_by,
        }
        line = (f"[k1] {name} (N={r['n']}, {FL.unary_num_blocks(r['n'])} blocks): device {_pair_text(split)}, "
                f"bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']})")
        if key in ("main", "stride8"):
            lin = FL.linearize_vgicp_unary_cuda(*args)
            r["max_abs_err"] = _max_err(torch, lin, FL.linearize_vgicp_unary_plain(*args))[0]
            r["ms"] = _median_ms(torch, lambda: FL.linearize_vgicp_unary_cuda(*args))
            r["plain_ms"] = _median_ms(torch, lambda: FL.linearize_vgicp_unary_plain(*args))
            line += (f"; kernel {r['ms']:.4f} ms (wrapper, CUDA events), plain {r['plain_ms']:.4f} ms; "
                     "no single PyTorch call computes this function")
        log(line)
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
        again = FL.linearize_vgicp_moments_cuda(*args)
        k1 = FL.linearize_vgicp_unary_cuda(*args)  # no weights: K4's partial kernel and grid
        ref = FL.linearize_vgicp_moments_plain(*args)
        torch.cuda.synchronize()
        _check_close(torch, f"[k4] {name}", lin, ref, K4_TOL)
        differ = _bits_differ(torch, lin, again)
        differ_k1 = _bits_differ(torch, _source_block(lin), _source_block(k1))
        if differ or differ_k1:
            raise AssertionError(f"[k4] {name}: {differ} values differ between two calls, {differ_k1} of the "
                                 "source block from K1's")
    log(f"[k4] every case: two calls equal bit for bit, and the source block (H_ss, b_s, error, count) "
        f"equal to K1's without weights bit for bit ({len(cases)} cases)")

    args = k4_args(poses["twist"])
    lin = FL.linearize_vgicp_moments_cuda(*args)
    abs_err, _ = _max_err(torch, lin, FL.linearize_vgicp_moments_plain(*args))
    bound, bound_by = k4_bound_ms(args)
    r = {
        "n": n_all,
        "max_abs_err": abs_err,
        "ms": _median_ms(torch, lambda: FL.linearize_vgicp_moments_cuda(*args)),
        "plain_ms": _median_ms(torch, lambda: FL.linearize_vgicp_moments_plain(*args)),
        "device_us": _device_us_per_call(torch, lambda: FL.linearize_vgicp_moments_cuda(*args), K4_KERNELS),
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

        return {"moments_fused": (moments_fused, K4_KERNELS), "planar_fused": (planar_fused, "linearize_"),
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
            own = "" if key is None else (f", its '{_key_text(key)}' kernels {own_us:.3f} us" if own_us is not None
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

        _trace(torch, "100 single-scan linearizes", run, "call", K4_KERNELS, f"{root}_scan{ext}")
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
        us = {k: _device_us_per_call(torch, lambda x=x: FL.linearize_vgicp_unary_batch_cuda(*x), "unary_")
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
            own = "" if key is None else (f", its '{_key_text(key)}' kernels {own_us:.3f} us" if own_us is not None
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
    """K5 against its plain version at K1_TOL and against K1 without weights
    bit for bit (K5 runs K1's partial kernel on K1's grid), on scan 1
    (`source`, moved back by the true prior) against scan 0's leaf-1.0 map
    (`maps[-1]`) and on the stride-8 stage against the leaf-4 map
    (`maps[0]`): the tails of the TPU's dense view and of K1's blocks, both
    modes, both gates, half masks, at the identity, at K1_TWIST's pose and
    at `T_reg`, the card's registration of scan 1. Each case calls K5 twice
    with no host read allowed, and the two calls must agree bit for bit.
    Then times and device us per launch pair beside K1's, on bench.py's
    race case (N = 25088, covariances, min_voxel_points 1) and at N = 1, 8
    and the stride-8 stage."""
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
        differ, k1_differ = _bits_differ(torch, lin, again), _bits_differ(torch, lin, k1)
        log(f"[k5] {name}: two K5 calls differ in {differ} values, K5 and K1 without weights in {k1_differ} "
            "(both must be 0)")
        if differ:
            raise AssertionError(f"two K5 calls on the same input differ ({name})")
        if k1_differ:
            raise AssertionError(f"K5 differs from K1 without weights ({name})")

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
        log(f"[k5] {key} (N={r['n']}, {FL.unary_num_blocks(r['n'])} blocks): kernel {r['ms']:.4f} ms (wrapper, "
            f"CUDA events), device {device} per launch pair, K1 {k1_device} per launch pair on the same inputs, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}); no single "
            "PyTorch call computes this function")
        out[key] = r
    return out


def graph_edges(n_poses: int) -> list:
    """Phase 23's binary edges: (i, i+1) and (i, i+2), by i."""
    return [(i, j) for i in range(n_poses) for j in (i + 1, i + 2) if j < n_poses]


def graph_start(T_true):
    """Phase 23's start [P, 4, 4] (numpy): pose 0 true, pose i >= 1 at
    T_true[i] @ se3_exp(uniform(-0.1, 0.1, 6)), RandomState(GRAPH_SEED)."""
    import numpy as np
    import torch

    from gtsam_points_tpu_torch.utils import se3

    rng = np.random.RandomState(GRAPH_SEED)
    out = [np.asarray(T_true[0], np.float32)]
    for T in T_true[1:]:
        xi = torch.from_numpy(rng.uniform(-0.1, 0.1, 6).astype(np.float32))
        out.append(np.asarray(T, np.float32) @ se3.se3_exp(xi).numpy())
    return np.stack(out).astype(np.float32)


def pose_graph_arrays(n_poses: int = PG_POSES, lap: int = PG_LAP, seed: int = PG_SEED):
    """Phase 24's pose graph -> (true poses [P, 4, 4], the fields of a
    PoseGraphEdges as numpy arrays, the chained start [P, 4, 4])."""
    import numpy as np
    import torch

    from gtsam_points_tpu_torch.utils import se3
    from gtsam_points_tpu_torch.utils.synthetic import ring_trajectory

    T = np.stack(ring_trajectory(n_poses, lap=lap)).astype(np.float32)
    rng = np.random.RandomState(seed)
    odo = [(i, i + 1) for i in range(n_poses - 1)]
    loops = [(i, i + lap) for i in range(n_poses - lap)]
    measured = []
    for i, j in odo:
        noise = np.concatenate([rng.normal(0, PG_NOISE_RAD, 3), rng.normal(0, PG_NOISE_M, 3)]).astype(np.float32)
        measured.append(np.linalg.inv(T[i]) @ T[j] @ se3.se3_exp(torch.from_numpy(noise)).numpy())
    measured += [np.linalg.inv(T[i]) @ T[j] for i, j in loops]
    edges = odo + loops
    arrays = {
        "measured": np.stack(measured).astype(np.float32),
        "weights": np.full((len(edges), 6), PG_WEIGHT, np.float32),
        "t_idx": np.array([e[0] for e in edges], np.int32),
        "s_idx": np.array([e[1] for e in edges], np.int32),
        "prior_T": T[:1],
        "prior_w": np.full((1, 6), PG_PRIOR_WEIGHT, np.float32),
        "prior_idx": np.zeros(1, np.int32),
    }
    start = [T[0]]
    for k in range(n_poses - 1):
        start.append(start[-1] @ arrays["measured"][k])
    return T, arrays, np.stack(start).astype(np.float32)


def scan_world(plane_n: int = SCAN_WORLD_N, per_line: int = SCAN_EDGE_PER_LINE, seed: int = SCAN_SEED):
    """Phases 29-30's world (numpy). SCAN_FINS flat vertical fins, 3 m tall
    and 2 x SCAN_FIN_HALF m wide, stand radially in the ring world's
    corridor. The plane points are the ring world's walls and floor
    (`ring_world(0, plane_n)` without its round pillars) and the fins'
    faces, `per_line` x 3 points a fin with 0.01 m of noise across it: a
    fin faces along the corridor, which the walls and the floor leave free
    (a bundle adjustment of planes alone would slide each keyframe along
    it). The edge points are the fins' two vertical ends, `per_line` points
    each over z in [0, 3], with SCAN_EDGE_NOISE m of noise. Both clouds come
    shuffled. -> (planes [M, 3], edges [L, 3])."""
    import numpy as np

    from gtsam_points_tpu_torch.utils.synthetic import ring_world

    rng = np.random.RandomState(seed)
    th = rng.rand(SCAN_FINS) * 2 * np.pi
    radial = np.stack([np.cos(th), np.sin(th)], 1)
    normal = np.stack([-np.sin(th), np.cos(th)], 1)
    centre = radial * (19.5 + rng.rand(SCAN_FINS) * 5.0)[:, None]
    ends = centre[:, None] + np.array([-1.0, 1.0])[None, :, None] * SCAN_FIN_HALF * radial[:, None]
    xy = ends.reshape(-1, 2)
    z = rng.rand(len(xy), per_line) * 3.0
    edges = np.concatenate([np.repeat(xy[:, None], per_line, 1), z[..., None]], -1).reshape(-1, 3)
    edges = edges + rng.randn(*edges.shape) * SCAN_EDGE_NOISE
    per_fin = per_line * 3
    u = (rng.rand(SCAN_FINS, per_fin) * 2 - 1) * SCAN_FIN_HALF
    across = rng.randn(SCAN_FINS, per_fin) * 0.01
    fxy = centre[:, None] + u[..., None] * radial[:, None] + across[..., None] * normal[:, None]
    fins = np.concatenate([fxy, rng.rand(SCAN_FINS, per_fin, 1) * 3.0], -1).reshape(-1, 3)
    planes = np.concatenate([ring_world(0, plane_n)[: 3 * (plane_n // 4)], fins])
    # in no spatial order, as a LiDAR's points are: a grid cell keeps its first
    # 16 points, which are then a sample of every surface or edge the cell holds
    return planes[rng.permutation(len(planes))].astype(np.float32), edges[rng.permutation(len(edges))].astype(np.float32)


def scan_clouds(world, T_list, plane_n: int = SCAN_PLANE_N, edge_n: int = SCAN_EDGE_N, seed: int = SCAN_SEED):
    """Per pose (numpy): the plane_n nearest plane points and the edge_n
    nearest edge points of `world` in the pose's frame, with 0.005 m of
    noise on the plane points -> [(planes [plane_n, 3], edges [edge_n, 3])]."""
    import numpy as np

    planes, edges = world
    rng = np.random.RandomState(seed + 1)
    out = []
    for T in T_list:
        T = np.asarray(T, np.float64)
        pair = []
        for cloud, n, noise in ((planes, plane_n, 0.005), (edges, edge_n, 0.0)):
            idx = np.sort(np.argpartition(np.sum((cloud - T[:3, 3]) ** 2, axis=1), n)[:n])
            local = (cloud[idx] - T[:3, 3]) @ T[:3, :3] + rng.randn(n, 3) * noise
            pair.append(local.astype(np.float32))
        out.append(tuple(pair))
    return out


def scan_times(local):
    """Per-point times in [0, 1) from the azimuth, a spinning LiDAR's sweep
    starting behind the sensor (numpy float32)."""
    import numpy as np

    return ((np.arctan2(local[:, 1], local[:, 0]) + np.pi) / (2 * np.pi)).astype(np.float32) % np.float32(1.0)


def ct_scan(local, xi_motion):
    """The points `local` (in the scan-begin pose's frame) observed while
    the sensor moves from I to Exp(xi_motion) over the sweep: each point at
    its azimuth time t from T(t) = interpolate_poses(I, Exp(xi), t), local'
    = T(t)⁻¹ p. -> (raw points [N, 3], times [N]), numpy float32."""
    import numpy as np
    import torch

    from gtsam_points_tpu_torch.factors.ct_icp import interpolate_poses
    from gtsam_points_tpu_torch.utils import se3

    times = scan_times(local)
    T1 = se3.se3_exp(torch.from_numpy(np.asarray(xi_motion, np.float32)))
    Ts = interpolate_poses(torch.eye(4), T1, torch.from_numpy(times)).numpy()
    raw = np.einsum("nji,nj->ni", Ts[:, :3, :3], local - Ts[:, :3, 3])
    return raw.astype(np.float32), times


def loam_clouds():
    """Phase 29's LOAM pair (numpy): the true poses of scans 0 and 1 and
    their (planes, edges) clouds."""
    from gtsam_points_tpu_torch.utils.synthetic import ring_trajectory

    T = ring_trajectory(2, lap=100)
    return T, scan_clouds(scan_world(), T)


def ct_clouds():
    """Phase 29's CT-ICP scan (numpy): the target (scan 0's planes and
    edges, static), the raw source (the same surfaces sampled again, seen
    while moving by Exp(CT_MOTION)) and its times."""
    import numpy as np

    from gtsam_points_tpu_torch.utils.synthetic import ring_trajectory

    world, T = scan_world(), ring_trajectory(1, lap=100)
    target = np.concatenate(scan_clouds(world, T)[0])
    again = np.concatenate(scan_clouds(world, T, seed=SCAN_SEED + 10)[0])
    raw, times = ct_scan(again, CT_MOTION)
    return target, raw, times


def ba_features(clouds, T_gt, count: int, rng, radius: float = 1.0, min_keys: int = 3, gap: float = BA_EIGEN_GAP,
                kind: str = "plane"):
    """demo_bundle_adjustment's features (numpy): centres drawn with `rng`
    from keyframe 0's points in the world; each keyframe's points (under
    T_gt) within `radius` of the centre, at most BA_MAX_POINTS a keyframe,
    kept from keyframes with at least 10 such points and where there are
    `min_keys`. A feature whose scatter has the eigenvalue next to the kept
    ones within `gap` of them (lambda_1 < gap lambda_0 for a plane,
    lambda_2 < gap lambda_1 for an edge) is skipped: there the frozen
    eigenvectors are arbitrary. -> up to `count` {key: [n, 3] local}."""
    import numpy as np

    world = [c @ np.asarray(T[:3, :3]).T + np.asarray(T[:3, 3]) for c, T in zip(clouds, T_gt)]
    feats = []
    for _ in range(200):
        c = world[0][rng.randint(len(world[0]))]
        per_key = {}
        for k, w in enumerate(world):
            m = np.linalg.norm(w - c, axis=1) < radius
            if m.sum() >= 10:
                per_key[k] = clouds[k][m][:BA_MAX_POINTS]
        if len(per_key) < min_keys:
            continue
        pts = np.concatenate([world[k][np.linalg.norm(world[k] - c, axis=1) < radius][:BA_MAX_POINTS]
                              for k in per_key]).astype(np.float64)
        lam = np.linalg.eigvalsh(np.cov(pts.T))
        i = 0 if kind == "plane" else 1
        if lam[i + 1] < gap * lam[i]:
            continue
        feats.append(per_key)
        if len(feats) >= count:
            break
    return feats


def ba_problem(n_keys: int = BA_KEYS, plane_n: int = SCAN_PLANE_N, edge_n: int = SCAN_EDGE_N,
               world_n: int = SCAN_WORLD_N, per_line: int = SCAN_EDGE_PER_LINE, planes: int = BA_PLANES,
               edges: int = BA_EDGES):
    """Phase 30's bundle-adjustment problem (numpy): n_keys keyframes along
    the ring, `planes` plane and `edges` edge features (RandomState(0)), the
    poses noised by sigma = BA_SIGMA (RandomState(1), pose 0 exact).
    -> dict(T_gt, plane_feats, edge_feats, start)."""
    import numpy as np
    import torch

    from gtsam_points_tpu_torch.utils import se3
    from gtsam_points_tpu_torch.utils.synthetic import ring_trajectory

    T_gt = np.stack(ring_trajectory(n_keys, lap=100)).astype(np.float32)
    clouds = scan_clouds(scan_world(world_n, per_line), T_gt, plane_n, edge_n)
    rng = np.random.RandomState(0)
    plane_feats = ba_features([c[0] for c in clouds], T_gt, planes, rng, kind="plane")
    edge_feats = ba_features([c[1] for c in clouds], T_gt, edges, rng, kind="edge")
    r = np.random.RandomState(1)
    start = [T_gt[0]]
    for i in range(1, n_keys):
        xi = torch.from_numpy(r.randn(6).astype(np.float32) * BA_SIGMA)
        start.append(T_gt[i] @ se3.se3_exp(xi).numpy())
    return {"T_gt": T_gt, "plane_feats": plane_feats, "edge_feats": edge_feats,
            "start": np.stack(start).astype(np.float32)}


def ba_moments(per_key) -> dict:
    """{key: (count, mean, covariance)} of a feature's points (numpy), the
    LSQ factor's input."""
    import numpy as np

    out = {}
    for k, pts in per_key.items():
        mu = pts.mean(0)
        d = pts - mu
        out[k] = (len(pts), mu, d.T @ d / len(pts))
    return out


def _frame_to(frame, device: str):
    """The frame's tensors (aux included) copied to `device`."""
    def move(x):
        return {k: v.to(device) for k, v in x.items()} if isinstance(x, dict) else x.to(device)

    return frame.replace(**{f.name: move(getattr(frame, f.name)) for f in dataclasses.fields(frame)
                            if getattr(frame, f.name) is not None})


def _cpu_copy(frame):
    """The frame's tensors copied to the CPU."""
    return _frame_to(frame, "cpu")


def _shift_bound(torch, shift_m, shift_rad, margin=GICP_SHIFT_MARGIN, floor_m=GICP_BOUND_M,
                 floor_rad=GICP_BOUND_RAD):
    """Per pose: `margin` times its order shift, at least the floor (m, rad)."""
    bound_m = torch.clamp(margin * torch.tensor(shift_m, device="cuda"), min=floor_m)
    bound_rad = torch.clamp(margin * torch.tensor(shift_rad, device="cuda"), min=floor_rad)
    return bound_m, bound_rad


def _rows_to_poses(torch, rows):
    """Top-three-row poses, row-major, as the constants keep them -> [P, 4, 4] on the card."""
    top = torch.tensor(rows, dtype=torch.float32).reshape(-1, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(len(top), 1, 4)
    return torch.cat([top, bottom], 1).cuda()


def _cluster_scene(torch) -> dict:
    """Phases 14-17's scene, built once on the card: CLUSTER_STEPS + 1 frames
    of a CLUSTER_WORLD_N-point ring world with their covariances (as phase 4
    makes them), the true motions, and the cluster pyramid's inputs: scan 1
    moved back by the true relative pose, and scan 0's
    DEFAULT_CLUSTER_STAGES pyramid."""
    from gtsam_points_tpu_torch.registration import DEFAULT_CLUSTER_STAGES, build_pyramid
    from gtsam_points_tpu_torch.types.frame import transform_frame

    t0 = time.perf_counter()
    T_true, scans, frames, priors = _ring_frames(torch, CLUSTER_STEPS + 1, CLUSTER_WORLD_N)
    source = transform_frame(priors[0], frames[1])
    maps = build_pyramid(frames[0], DEFAULT_CLUSTER_STAGES)
    torch.cuda.synchronize()
    log(f"[clusters] {len(frames)} frames of {frames[0].capacity} slots ({REAL_SCAN_N} points) from a "
        f"{CLUSTER_WORLD_N}-point ring world and scan 0's DEFAULT_CLUSTER_STAGES pyramid "
        f"({', '.join(str(int(vm.num_voxels)) for vm in maps)} voxels), built in {time.perf_counter() - t0:.3f} s")
    return {"T_true": T_true, "scans": scans, "frames": frames, "priors": priors, "source": source, "maps": maps}


def _rel_err(torch, a, b) -> float:
    """max |a - b| over max |b|, in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _fields_differ(torch, a, b) -> int:
    """Values of two SourceClusters that differ in any bit."""
    return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum()) if x.is_floating_point()
               else int((x != y).sum()) for x, y in zip(a, b))


def phase_cluster_inputs(torch, scene) -> dict:
    """Phase 14: the cluster pyramid's source clustered twice on the card
    (every field equal bit for bit: the cells are summed in a fixed order)
    and once on the CPU from the same frame (mask and weights bit for bit,
    centroids and covariances within their tolerances); the occupied and the
    dropped cells; then every odometry frame clustered at the map's leaf,
    as phase 17 takes them."""
    from gtsam_points_tpu_torch.pipelines.odometry import OdometryParams
    from gtsam_points_tpu_torch.registration import DEFAULT_CLUSTER_CAPACITY, DEFAULT_CLUSTER_LEAF, cluster_source

    source = scene["source"]
    card = cluster_source(source, DEFAULT_CLUSTER_LEAF, DEFAULT_CLUSTER_CAPACITY)
    again = cluster_source(source, DEFAULT_CLUSTER_LEAF, DEFAULT_CLUSTER_CAPACITY)
    cpu = cluster_source(_cpu_copy(source), DEFAULT_CLUSTER_LEAF, DEFAULT_CLUSTER_CAPACITY, device="cpu")
    torch.cuda.synchronize()
    differ = _fields_differ(torch, card, again)
    log(f"[clusters] two card builds of the pyramid's source clusters: {differ} of "
        f"{sum(t.numel() for t in card)} values differ (must be 0)")
    if differ:
        raise AssertionError("two card builds of the same clusters differ")
    same = torch.equal(card.mask.cpu(), cpu.mask) and torch.equal(card.weight.cpu(), cpu.weight)
    cen, cov = _rel_err(torch, card.pts_p, cpu.pts_p), _rel_err(torch, card.covs6, cpu.covs6)
    log(f"[clusters] card vs CPU: mask and weights equal bit for bit {same}; centroids {cen:.3e} "
        f"(tol {CLUSTER_CENTROID_TOL}), covariances {cov:.3e} (tol {CLUSTER_COV_TOL}) of max|CPU|")
    if not same or cen > CLUSTER_CENTROID_TOL or cov > CLUSTER_COV_TOL:
        raise AssertionError("the card's clusters differ from the CPU's")
    occupied = int(card.mask.sum())
    cells = int(cluster_source(source, DEFAULT_CLUSTER_LEAF, source.capacity).mask.sum())
    points = int(source.mask.sum())
    log(f"[clusters] {occupied} of {DEFAULT_CLUSTER_CAPACITY} cluster slots occupied by {points} points "
        f"({points / max(occupied, 1):.2f} a cluster, {int((card.weight >= 5).sum())} clusters of 5 or more); "
        f"{max(cells - DEFAULT_CLUSTER_CAPACITY, 0)} cells dropped")

    leaf = OdometryParams().voxel_resolution
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_frame = [cluster_source(f, leaf, DEFAULT_CLUSTER_CAPACITY) for f in scene["frames"]]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(per_frame)
    counts = [int(c.mask.sum()) for c in per_frame]
    log(f"[clusters] {len(per_frame)} odometry frames clustered at leaf {leaf}: {min(counts)}-{max(counts)} "
        f"clusters a frame, {ms:.3f} ms a frame (host clock, synchronized)")
    return {"source": card, "frames": per_frame}


def _summand_scale(args):
    """Each field's summand scale for K1's inputs `args`: K1's 29 per-point
    terms in float64, summed in absolute value and unpacked as K1 unpacks
    its sums (a Linearized). The rounding of a float32 sum is bounded
    relative to the sum of its terms' magnitudes, and max|sum| is not when
    the terms cancel (b_s near the optimum)."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL

    p, momT, found, delta, min_points, eps, covs6, weights = _float64(args)
    A, rp, okf = FL._unary_weight_residual(p, momT, found, delta, min_points, eps, covs6, weights)
    return FL._unpack_unary(FL._unary_terms(p, A, rp, okf).abs().sum(1))


def _cluster_fields(lin, ref, ref64, scale) -> tuple:
    """Phase 15's check of one K1 result `lin` against the float32 plain
    version `ref` -> (texts, failed fields). A field fails when the two part
    by more than K1_TOL of the field's summand scale (`_summand_scale`,
    largest entry). For H_ss and the error that scale is max|ref|, as in
    phase 7; b_s near the optimum is a small residue of large terms. Printed
    beside it: the gap over max|ref|, and each version's gap to float64
    `ref64` over the scale."""
    texts, bad = [], []
    for f in ("H_ss", "b_s", "error"):
        k, p, e = getattr(lin, f).double(), getattr(ref, f).double(), getattr(ref64, f)
        sc = float(getattr(scale, f).abs().max()) + 1e-30
        rel = float((k - p).abs().max()) / sc
        texts.append(f"{f} {rel:.3e} (of max|ref| {float((k - p).abs().max()) / (float(p.abs().max()) + 1e-30):.3e}; "
                     f"max|ref| {float(p.abs().max()) / sc:.3e} of the scale; against float64: K1 "
                     f"{float((k - e).abs().max()) / sc:.3e}, plain {float((p - e).abs().max()) / sc:.3e})")
        if rel > K1_TOL:
            bad.append(f)
    return texts, bad


def phase_k1_clusters(torch, scene, clusters) -> dict:
    """Phase 15: K1 with weights and covariances on the cluster pyramid's
    shapes (N = 1408, 2816, 5632: strides 4, 2 and 1 of the clusters against
    the leaf-4, leaf-1 and leaf-1 maps), at the identity and at the pose
    phase 16 registers from its first init; each case held to the plain
    version by `_cluster_fields` and called twice with no host read
    allowed, the two calls equal bit for bit; at the registered pose the
    plain version with its weights or its C_s dropped must fail that check.
    Device us per launch pair beside the bound, and the plain weighted
    route's device us at N = 5632 (a witness)."""
    import numpy as np

    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.ops import planar
    from gtsam_points_tpu_torch.registration import DEFAULT_CLUSTER_STAGES, register_clusters_pyramid
    from gtsam_points_tpu_torch.utils import se3

    maps = scene["maps"]
    xi0 = np.random.RandomState(CLUSTER_SEED).uniform(-0.1, 0.1, (1, 6)).astype(np.float32)
    T_reg = register_clusters_pyramid(maps, clusters, se3.se3_exp(torch.from_numpy(xi0).cuda())[0])
    reg = clusters._replace(covs6=planar.sym_add_eye(clusters.covs6, 1e-3))  # as the pyramid weights them
    poses = {"identity": torch.eye(4, device="cuda"), "registered": T_reg.contiguous()}
    cases = []
    for vm, st in zip(maps, DEFAULT_CLUSTER_STAGES):
        cl = reg.strided(st.stride)
        for name, pose in poses.items():
            momT, found = FL.probe_moments(vm, cl.pts_p, cl.mask, pose)
            cases.append((f"N={cl.capacity} stride {st.stride} leaf {st.leaf} {name}",
                          (cl.pts_p, momT, found, pose, 1.0, 1e-3, cl.covs6, cl.weight)))
    torch.cuda.synchronize()
    for name, args in cases:
        torch.cuda.set_sync_debug_mode("error")  # a host read inside raises
        try:
            lin = FL.linearize_vgicp_unary_cuda(*args)
            again = FL.linearize_vgicp_unary_cuda(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref = FL.linearize_vgicp_unary_plain(*args)
        ref64 = FL.linearize_vgicp_unary_plain(*_float64(args))
        torch.cuda.synchronize()
        abs_err, _ = _max_err(torch, lin, ref)
        differ = _bits_differ(torch, lin, again)
        scale = _summand_scale(args)
        texts, bad = _cluster_fields(lin, ref, ref64, scale)
        log(f"[k1-clusters] {name}: weighted count {int(ref.num_inliers)} max_abs_err={abs_err:.3e}; "
            f"err over the summand scale " + ", ".join(texts) + f" (tol {K1_TOL}); two calls differ in {differ} "
            "values (must be 0)")
        if bad or int(lin.num_inliers) != int(ref.num_inliers):
            raise AssertionError(f"K1 with weights disagrees with its plain version ({name}: {bad})")
        if differ:
            raise AssertionError(f"two K1 calls on the same input differ ({name})")
        if name.endswith("registered"):
            # controls: the plain version with a fault planted must fail the
            # same check, so the summand scale cannot pass a faulty kernel
            for fault, planted in (("weights dropped", args[:7] + (None,)),
                                   ("C_s dropped", args[:6] + (None, args[7]))):
                _, caught = _cluster_fields(FL.linearize_vgicp_unary_plain(*planted), ref, ref64, scale)
                log(f"[k1-clusters] {name}: control, the plain version with {fault}: fails on {caught or 'nothing'}")
                if not caught:
                    raise AssertionError(f"the phase's check passes the plain version with {fault} ({name})")

    out = {"T_reg": T_reg}
    for name, args in cases:
        if not name.endswith("registered"):
            continue
        bound, bound_by = k1_bound_ms(args)
        split = _device_us_by_kernel(torch, lambda: FL.linearize_vgicp_unary_cuda(*args), "unary_")
        line = (f"[k1-clusters] {name} ({FL.unary_num_blocks(args[0].shape[1])} blocks): device "
                f"{_pair_text(split)}, bound {bound * 1e3:.4f} us ({bound_by})")
        if args[0].shape[1] == clusters.capacity:
            plain = _device_us_per_call(torch, lambda: FL.linearize_vgicp_unary_plain(*args), "")
            line += (f"; the plain weighted route {'not measured' if plain is None else f'{plain:.3f} us'} "
                     "of device time a call (all its kernels; a witness, it chooses nothing)")
        log(line)
        out[args[0].shape[1]] = {"device_us": sum(split.values()) if split else None, "bound_ms": bound}
    return out


def phase_cluster_pyramid(torch, scene, clusters) -> dict:
    """Phase 16: the cluster pyramid at the JAX package's headline shape:
    CLUSTER_INITS registrations of the source clusters against the
    DEFAULT_CLUSTER_STAGES pyramid through register_clusters_pyramid, each
    with no host read allowed inside it; K1 exactly 7 launches a
    registration; each pose within CLUSTER_PYRAMID_BOUND_M and _RAD of the
    JAX package's pose for the same inputs, or within CLUSTER_SHIFT_MARGIN
    times the shift by which the order of the sums moves that init's JAX
    pose (CLUSTER_ORDER_SHIFT_M and _RAD) where that is larger."""
    import numpy as np

    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.registration import register_clusters_pyramid
    from gtsam_points_tpu_torch.utils import se3

    maps = scene["maps"]
    xis = np.random.RandomState(CLUSTER_SEED).uniform(-0.1, 0.1, (CLUSTER_INITS, 6)).astype(np.float32)
    T0s = se3.se3_exp(torch.from_numpy(xis).cuda())
    torch.cuda.synchronize()
    _zero_counts(FL)
    poses, reg_ms = [], []
    for T0 in T0s:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")  # a host read inside raises
        try:
            poses.append(register_clusters_pyramid(maps, clusters, T0))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        reg_ms.append((time.perf_counter() - t0) * 1e3)
    k1_launches, k3_launches = FL.unary_launches, FL.launches
    poses = torch.stack(poses)

    if not bool(torch.all(torch.isfinite(poses))):
        raise AssertionError("a cluster pyramid pose is not finite")
    log(f"[cluster-pyramid] {CLUSTER_INITS} registrations of {int(clusters.mask.sum())} clusters "
        f"({clusters.capacity} slots) against {len(maps)} maps: K1 launches {k1_launches} "
        f"({k1_launches / CLUSTER_INITS:.3f} per registration), K3 launches {k3_launches}, host reads inside a "
        "registration: 0 (sync debug mode 'error')")
    log(f"[cluster-pyramid] ms per registration median {statistics.median(reg_ms):.3f}, min {min(reg_ms):.3f}, "
        f"max {max(reg_ms):.3f} (first {reg_ms[0]:.3f}); all {CLUSTER_INITS}: {sum(reg_ms):.3f} ms")
    if k1_launches != K1_LAUNCHES_PER_CLUSTER_REGISTRATION * CLUSTER_INITS or k3_launches:
        raise AssertionError(f"K1 launched {k1_launches} times in {CLUSTER_INITS} cluster registrations")
    rot, trans = se3.pose_error(_rows_to_poses(torch, CLUSTER_PYRAMID_JAX_POSES), poses)
    truth_rot, truth_trans = se3.pose_error(torch.eye(4, device="cuda"), poses)
    bound_m, bound_rad = _shift_bound(torch, CLUSTER_ORDER_SHIFT_M, CLUSTER_ORDER_SHIFT_RAD, CLUSTER_SHIFT_MARGIN,
                                      CLUSTER_PYRAMID_BOUND_M, CLUSTER_PYRAMID_BOUND_RAD)
    share_m, share_rad = trans / bound_m, rot / bound_rad
    own = int((bound_m == CLUSTER_PYRAMID_BOUND_M).sum())
    log(f"[cluster-pyramid] against the JAX package's poses: max per-pose gap {float(trans.max()):.3e} m "
        f"{float(rot.max()):.3e} rad; {int((trans <= CLUSTER_PYRAMID_BOUND_M).sum())} of {CLUSTER_INITS} within "
        f"{CLUSTER_PYRAMID_BOUND_M} m; the largest gap over its init's bound {float(share_m.max()):.3f} (init "
        f"{int(share_m.argmax())}) in m, {float(share_rad.max()):.3f} (init {int(share_rad.argmax())}) in rad "
        f"(bounds: {CLUSTER_PYRAMID_BOUND_M} m, {CLUSTER_PYRAMID_BOUND_RAD} rad, or {CLUSTER_SHIFT_MARGIN} x the "
        f"init's order shift; {own} inits at {CLUSTER_PYRAMID_BOUND_M} m); the five largest gaps (init, m, bound "
        "m): " + ", ".join(f"({int(i)}, {float(trans[i]):.3e}, {float(bound_m[i]):.3e})"
                            for i in torch.argsort(-trans)[:5])
        + f"; error against the truth max {float(truth_trans.max()):.6f} m {float(truth_rot.max()):.6f} rad")
    if not (bool(torch.all(share_m <= 1)) and bool(torch.all(share_rad <= 1))):
        raise AssertionError("cluster pyramid: a pose is further from the JAX package's than its init's bound")
    return {"launches": k1_launches, "median_ms": statistics.median(reg_ms), "poses": poses}


def phase_cluster_odometry(torch, scene, clusters, profile: Optional[str]) -> dict:
    """Phase 17: cluster odometry at the real size: CLUSTER_STEPS steps with
    `OdometryParams()` and each frame's clusters, each step with the true
    motion as its prior, through make_odometry_stepper (one CUDA graph
    replay a step, K1 10 launches a replay) and through the eager
    odometry_step, equal bit for bit; the step median held to
    STEP_LIMIT_MS; host reads a step; ATE held to the JAX package's cluster
    ATE on the same run times ATE_SLACK. With `profile`, three graph steps
    traced as phase 4 traces them."""
    import numpy as np

    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.pipelines.odometry import OdometryParams
    from gtsam_points_tpu_torch.utils import se3

    frames, priors, T_true = scene["frames"], scene["priors"], scene["T_true"]
    iterations = OdometryParams().max_iterations
    reads = []
    _zero_counts(FL)
    state, poses, iters, step_ms, merges = _run_odometry(torch, frames, priors, CLUSTER_STEPS, clusters=clusters,
                                                         reads=reads)
    k1_launches, k3_launches = FL.unary_launches, FL.launches
    if not bool(torch.all(torch.isfinite(poses))):
        raise AssertionError("a cluster odometry pose is not finite")
    log(f"[cluster-odometry] {CLUSTER_STEPS} steps, map capacity {state.vmap.capacity}, "
        f"{int(state.vmap.num_voxels)} voxels, {merges} structural merges; LM iterations per step {iters} "
        f"(total {sum(iters)}); K1 launches {k1_launches} ({iterations} in the capture's warm-up, then "
        f"{(k1_launches - iterations) / CLUSTER_STEPS:.3f} a replay), K3 launches {k3_launches}; host reads a "
        f"step {reads[1:]} (the first step, with the capture: {reads[0]})")
    if k1_launches != iterations * (CLUSTER_STEPS + 1) or k3_launches:
        raise AssertionError(f"K1 launched {k1_launches} times in {CLUSTER_STEPS} cluster steps")
    log(f"[cluster-odometry] graph stepper: step ms over {len(step_ms)} steps median "
        f"{statistics.median(step_ms):.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f} (first, with the "
        f"capture: {step_ms[0]:.3f}); limit {STEP_LIMIT_MS} ms, one 10 Hz LiDAR period")
    if statistics.median(step_ms) > STEP_LIMIT_MS:
        raise AssertionError(f"the median cluster step takes more than {STEP_LIMIT_MS} ms")

    _, poses_eager, it_eager, eager_ms, _ = _run_odometry(torch, frames, priors, CLUSTER_STEPS, eager=True,
                                                          clusters=clusters)
    same = torch.equal(poses, poses_eager) and iters == it_eager
    log(f"[cluster-odometry] {CLUSTER_STEPS} steps graph stepper vs eager odometry_step: poses and iterations "
        f"equal bit for bit {same}; eager step ms median {statistics.median(eager_ms):.3f}")
    if not same:
        raise AssertionError("the cluster graph stepper and the eager step disagree")

    T0 = torch.from_numpy(T_true[0]).cuda()
    T_ref = torch.from_numpy(np.stack(T_true[: len(poses)])).cuda()
    rot_e, trans_e = se3.pose_error(T_ref, T0 @ poses)
    ate_mean, ate_max = float(trans_e.mean()), float(trans_e.max())
    log(f"[cluster-odometry] ATE translation mean {ate_mean:.6f} m max {ate_max:.6f} m; rotation max "
        f"{float(rot_e.max()):.6f} rad (bound: the JAX package's mean {CLUSTER_ATE_JAX_MEAN_M} m, max "
        f"{CLUSTER_ATE_JAX_MAX_M} m, times {ATE_SLACK})")
    if not (ate_mean <= CLUSTER_ATE_JAX_MEAN_M * ATE_SLACK and ate_max <= CLUSTER_ATE_JAX_MAX_M * ATE_SLACK):
        raise AssertionError("the cluster trajectory is further from the truth than the JAX package's")
    if profile:
        root, ext = os.path.splitext(profile)
        _profile_steps(torch, frames, priors, f"{root}_clusters{ext}", clusters)
        _census(torch, frames, priors, clusters)
    return {"launches": k1_launches, "median_ms": statistics.median(step_ms)}


def _grid_fields_differ(torch, a, b) -> int:
    """Values of two HashGrids (and their coarse levels) that differ in any bit."""
    differ = 0
    for x, y in zip(a[:-1], b[:-1]):
        x, y = x.cpu(), y.cpu()
        differ += int((x.view(torch.int32) != y.view(torch.int32)).sum()) if x.is_floating_point() \
            else int((x != y).sum())
    if (a.coarse is None) != (b.coarse is None):
        return differ + 1
    return differ + (_grid_fields_differ(torch, a.coarse, b.coarse) if a.coarse is not None else 0)


def _knn_ties(torch, card, cpu, points, queries) -> tuple:
    """Card kNN against the CPU port's -> (masks differ, distances that differ
    in any bit, index differences that are ties, index differences that are
    not). A tie: the two candidates' float64 distances to the query within
    1 ulp of the float32 distance."""
    import numpy as np

    ci, cs, cv = (x.cpu() for x in card)
    pi, ps, pv = cpu
    masks = int((cv != pv).sum())
    dist = int((cs.view(torch.int32) != ps.view(torch.int32)).sum())
    rows, cols = torch.nonzero(ci != pi, as_tuple=True)
    if not len(rows):
        return masks, dist, 0, 0
    p64, q64 = points.double(), queries.double()
    d_card = ((p64[ci[rows, cols].clamp(min=0).long()] - q64[rows]) ** 2).sum(-1)
    d_cpu = ((p64[pi[rows, cols].clamp(min=0).long()] - q64[rows]) ** 2).sum(-1)
    ulp = torch.from_numpy(np.spacing(ps[rows, cols].numpy())).double()
    tie = (torch.abs(d_card - d_cpu) <= ulp) & (ci[rows, cols] >= 0) & (pi[rows, cols] >= 0)
    return masks, dist, int(tie.sum()), int((~tie).sum())


def phase_hash_grid(torch, scene) -> None:
    """Phase 18: the hash grid and kNN on the cluster scene. build_hash_grid
    on scan 0 at leaf 1.0, plain and with coarse_factor 4: two card builds
    equal bit for bit, and every field equal to the CPU port's build bit for
    bit; the overflow case (a cell capacity below the occupied cells); scan
    1 moved by the true relative pose as the queries: 1-NN and 10-NN on the
    card against the CPU port (indices equal or ties within 1 ulp of the
    distance, counted); the card's grid kNN against its brute_force_knn for
    every neighbour closer than one leaf; device ms of the build and of a
    1-NN and a 10-NN search."""
    from gtsam_points_tpu_torch.ops import voxel_keys as vk
    from gtsam_points_tpu_torch.ops.hash_grid import brute_force_knn, build_hash_grid, knn_search, lookup_cells
    from gtsam_points_tpu_torch.types.frame import make_frame
    from gtsam_points_tpu_torch.utils import se3

    scans = scene["scans"]
    card = make_frame(scans[0], device="cuda")
    cpu = _cpu_copy(card)
    queries = se3.transform_points(scene["priors"][0], make_frame(scans[1], device="cuda").points)
    qmask = make_frame(scans[1], device="cuda").mask
    grids = {}
    for name, kw in (("plain", {}), ("coarse", {"coarse_factor": GRID_COARSE_FACTOR}),
                     ("overflow", {"cell_capacity": GRID_OVERFLOW_CELLS})):
        g = build_hash_grid(card.points, card.mask, 1.0, **kw)
        again = build_hash_grid(card.points, card.mask, 1.0, **kw)
        ref = build_hash_grid(cpu.points, cpu.mask, 1.0, **kw)
        torch.cuda.synchronize()
        twice, vs_cpu = _grid_fields_differ(torch, g, again), _grid_fields_differ(torch, g, ref)
        log(f"[grid] {name}: {int(g.num_cells)} cells of capacity {g.cell_capacity}, at most "
            f"{int(g.cell_count.max())} points a cell ({int((g.cell_count > g.points_per_cell).sum())} cells over "
            f"the {g.points_per_cell} kept), overflowed {bool(g.overflowed)}; two card builds differ in {twice} "
            f"values, card vs CPU port in {vs_cpu} (both must be 0)")
        if twice or vs_cpu or bool(g.overflowed) != (name == "overflow"):
            raise AssertionError(f"hash grid ({name}): the card's build is not the CPU's, or overflow is wrong")
        grids[name] = (g, ref)

    q_cpu, qm_cpu = queries.cpu(), qmask.cpu()
    for name in ("plain", "coarse"):
        g, ref = grids[name]
        for k in (1, 10):
            got = knn_search(g, queries, qmask, k, max_sq_dist=GICP_MAX_CORR**2)
            want = knn_search(ref, q_cpu, qm_cpu, k, max_sq_dist=GICP_MAX_CORR**2)
            masks, dist, ties, other = _knn_ties(torch, got, want, cpu.points, q_cpu)
            log(f"[grid] {name} {k}-NN of {int(qmask.sum())} queries: {int(got[2].sum())} neighbours found; card "
                f"vs CPU port: masks differ {masks}, distances differ in {dist} values, index ties within 1 ulp "
                f"{ties}, other index differences {other} (masks and other must be 0)")
            if masks or other:
                raise AssertionError(f"{name} {k}-NN on the card differs from the CPU port's")

    # the oracle check on a grid that keeps every point of a cell (scan 0's
    # fullest cell holds 35): the default keeps 16, a bounded budget as in
    # the reference, so dense cells lose in-leaf neighbours by design
    g = build_hash_grid(card.points, card.mask, 1.0, max_points_per_cell=64)
    if int(g.cell_count.max()) > g.points_per_cell:
        raise AssertionError("the oracle grid truncates a cell")
    _, gs, _ = knn_search(g, card.points, card.mask, 4)
    bi, bs, bv = brute_force_knn(card.points, card.mask, card.points, card.mask, 4)
    # a cell that lost its slot in both hash tables is dropped, as in the
    # reference: its points are no one's candidates
    indexed = lookup_cells(g, vk.point_keys(card.points, card.mask, 1.0))[1]
    within = (bs < 1.0) & bv
    seen = torch.all(indexed[bi.clamp(min=0).long()] | ~within, dim=-1)
    within &= seen[:, None]
    scale = 8 * float(torch.finfo(torch.float32).eps) * 2 * float((card.points ** 2).sum(-1).max())
    gap = float((gs[within] - bs[within]).abs().max())
    log(f"[grid] 4-NN of scan 0's own points, grid against brute_force_knn on the card for the "
        f"{int(within.sum())} neighbours closer than one leaf: max distance gap {gap:.3e} (bound {scale:.3e}, the "
        f"brute force's |a|^2 + |b|^2 - 2 a.b cancellation); {int(g.num_cells) - int((g.hash_index[..., 0] >= 0).sum())}"
        f" cells lost their slot in both hash tables, as the reference drops them ({int((~seen).sum())} queries "
        "with a neighbour there left out)")
    if gap > scale:
        raise AssertionError("the card's grid kNN misses a neighbour its brute force finds within one leaf")

    g = grids["plain"][0]
    build_ms = _median_ms(torch, lambda: build_hash_grid(card.points, card.mask, 1.0), reps=20, warmup=3)
    one_ms = _median_ms(torch, lambda: knn_search(g, queries, qmask, 1, max_sq_dist=GICP_MAX_CORR**2), reps=50,
                        warmup=5)
    ten_ms = _median_ms(torch, lambda: knn_search(g, card.points, card.mask, 10), reps=50, warmup=5)
    log(f"[grid] ms on the card (CUDA events, median): build_hash_grid {build_ms:.4f}, 1-NN of 25000 queries "
        f"{one_ms:.4f}, 10-NN of the scan's own points {ten_ms:.4f}")


def _eigen_gap(torch, points, normals, raw_cov) -> tuple:
    """Per point: (the gap between the two smallest eigenvalues over the
    largest, |n·v| for the unit view direction v), from the CPU port's raw
    neighbour covariances."""
    from gtsam_points_tpu_torch.ops.eigh3 import eigvals3

    w = eigvals3(raw_cov)
    gap = (w[:, 1] - w[:, 0]) / torch.clamp(w[:, 2], min=1e-30)
    dot = torch.abs(torch.sum(normals * points, -1)) / torch.clamp(torch.linalg.norm(points, dim=-1), min=1e-30)
    return gap, dot


def _past_gap_limit(normal_gap: float, cov_gap: float, eigen_gap: float) -> bool:
    """Phase 19's limit on a point whose normal is determined (eigen gap at
    least FEATURE_GAP_REL): its normal gap and its covariance gap over
    max|ref| within FEATURE_GAP_EPS float32 epsilons over the eigen gap."""
    return max(normal_gap, cov_gap) * eigen_gap > FEATURE_GAP_EPS * 1.1920928955078125e-07


def phase_knn_features(torch, scene) -> list:
    """Phase 19: estimate_normals_covs(k=10, grid_leaf=1.0) on the scene's
    frames on the card, against the CPU port on the same points: normals
    within FEATURE_TOL and covariances within FEATURE_TOL x max|ref| for at
    least FEATURE_SHARE of the points. Each other point is printed with
    its cause: a repeated smallest eigenvalue (eigen gap under
    FEATURE_GAP_REL of the largest), a normal square to the view direction
    (|n·v| < FEATURE_VIEW_DOT), or else its eigen gap, where the card's
    float32 rounding (its own cos and acos in eigh3, its own order of the
    neighbour sums) moves the eigenvector by about eps over the gap; such a
    point fails the phase past FEATURE_GAP_EPS x eps over its gap. ms a
    frame. -> the card's frames."""
    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs, neighbor_covariances
    from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid, knn_search
    from gtsam_points_tpu_torch.types.frame import make_frame

    raw = [make_frame(s, device="cuda") for s in scene["scans"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [estimate_normals_covs(f, k=10, grid_leaf=1.0) for f in raw]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    total = differ = repeated = view = 0
    worst_n = worst_c = 0.0
    others = []
    t0 = time.perf_counter()
    for fi, (f, card) in enumerate(zip(raw, frames)):
        cpu = _cpu_copy(f)
        ref = estimate_normals_covs(cpu, k=10, grid_leaf=1.0)
        n = int(cpu.mask.sum())
        dn = (card.normals.cpu() - ref.normals).abs().amax(-1)[:n]
        dc = (card.covs.cpu() - ref.covs).abs().amax((-2, -1))[:n]
        scale = float(ref.covs.abs().max())
        bad = (dn >= FEATURE_TOL) | (dc >= FEATURE_TOL * scale)
        worst_n = max(worst_n, float(dn[~bad].max()))
        worst_c = max(worst_c, float(dc[~bad].max()) / scale)
        if bool(bad.any()):
            g = build_hash_grid(cpu.points, cpu.mask, 1.0)
            idx, _, valid = knn_search(g, cpu.points, cpu.mask, 10)
            cov, _ = neighbor_covariances(cpu.points, idx, valid)
            gap, dot = _eigen_gap(torch, cpu.points[:n], ref.normals[:n], cov[:n])
            rep, sq = gap < FEATURE_GAP_REL, dot < FEATURE_VIEW_DOT
            repeated += int((bad & rep).sum())
            view += int((bad & sq & ~rep).sum())
            for i in torch.nonzero(bad & ~rep & ~sq)[:, 0].tolist():
                others.append((fi, i, float(dn[i]), float(dc[i]) / scale, float(gap[i])))
        total += n
        differ += int(bad.sum())
    cpu_s = time.perf_counter() - t0
    share = 1.0 - differ / total
    log(f"[features] estimate_normals_covs(k=10, grid_leaf=1.0) on {len(frames)} frames of {REAL_SCAN_N} points: "
        f"{ms:.3f} ms a frame on the card (host clock, synchronized); against the CPU port ({cpu_s:.1f} s): "
        f"{total - differ} of {total} points ({share:.6f}, bound {FEATURE_SHARE}) with normals within "
        f"{FEATURE_TOL} (max gap {worst_n:.3e}) and covariances within {FEATURE_TOL} x max|ref| (max "
        f"{worst_c:.3e}); the other {differ}: {repeated} with a repeated smallest eigenvalue, {view} with a "
        f"normal square to the view direction, {len(others)} by their eigen gap (frame, point, normal gap, "
        f"covariance gap over max|ref|, eigen gap, the larger gap x eigen gap in float32 eps, limit "
        f"{FEATURE_GAP_EPS}): "
        + (", ".join(f"({a}, {b}, {c:.3e}, {d:.3e}, {e:.3e}, {max(c, d) * e / torch.finfo(torch.float32).eps:.2f})"
                     for a, b, c, d, e in others[:20]) or "none"))
    if share < FEATURE_SHARE:
        raise AssertionError("kNN features on the card differ from the CPU port's at too many points")
    if any(_past_gap_limit(c, d, gap) for _, _, c, d, gap in others):
        raise AssertionError("kNN features: a point with a determined normal differs past FEATURE_GAP_EPS x eps "
                             "over its eigen gap")
    return frames


def _pair_factor(kind: str, target, source, target_key: int = 0):
    from gtsam_points_tpu_torch.factors import make_gicp_factor, make_icp_factor

    if kind == "gicp":
        return make_gicp_factor(target_key, 1, target, source, max_corr_dist=GICP_MAX_CORR)
    return make_icp_factor(target_key, 1, target, source, point_to_plane=kind == "icp_plane",
                           max_corr_dist=GICP_MAX_CORR)


def _pair_graph(torch, factor):
    from gtsam_points_tpu_torch.factors import PriorFactor
    from gtsam_points_tpu_torch.optim import FactorGraph

    graph = FactorGraph(num_poses=2)
    eye = torch.eye(4, device="cuda")
    graph.add(PriorFactor(prior=eye, weights=torch.full((6,), GICP_PRIOR_WEIGHT, device="cuda"), key=0))
    return graph.add(factor)


def _k3_summand_scale(torch, args):
    """Each field's summand scale for K3's inputs `args`: the per-point terms
    of H = JᵀWJ, b = -JᵀWr and rᵀWr in float64, summed in absolute value,
    as a Linearized. At the optimum b is a residue of large terms that
    cancel, and the float32 rounding of a sum is bounded relative to the
    sum of its terms' magnitudes, not to |sum|."""
    from gtsam_points_tpu_torch.factors.linearized import Linearized
    from gtsam_points_tpu_torch.utils import se3

    p, mu, W6, mask, delta = _float64(args)
    R, t = delta[:3, :3], delta[:3, 3]
    pm = (R @ p + t[:, None]).T  # [N, 3]
    r = pm - mu.T
    w = W6.T * mask.to(p.dtype)[:, None]
    W = torch.stack([w[:, [0, 1, 2]], w[:, [1, 3, 4]], w[:, [2, 4, 5]]], dim=1)  # [N, 3, 3]
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(len(pm), 3, 3)
    J = torch.cat([se3.skew(pm), -eye, -(R @ se3.skew(p.T)), R.expand(len(pm), 3, 3)], dim=-1)  # [N, 3, 12]
    WJ = W @ J
    H = (J.transpose(1, 2) @ WJ).abs().sum(0)
    b = (WJ.transpose(1, 2) @ r[..., None])[..., 0].abs().sum(0)
    err = (r[:, None, :] @ W @ r[..., None]).abs().sum()
    return Linearized(H[:6, :6], H[6:, 6:], H[:6, 6:], b[:6], b[6:], err, mask.sum())


def _k3_field_errors(torch, lin, ref, scale) -> dict:
    """Field -> (error over max|ref|, error over the field's summand scale)."""
    out = {}
    for name in ("H_tt", "H_ts", "H_ss", "b_t", "b_s", "error"):
        a, b = getattr(lin, name).double(), getattr(ref, name).double()
        err = float((a - b).abs().max())
        out[name] = (err / max(float(b.abs().max()), 1e-30), err / max(float(getattr(scale, name).max()), 1e-30))
    return out


def hold_k3(torch, tag: str, label: str, args) -> None:
    """K3 against its plain version (and the plain version of its own
    arithmetic) on K3's inputs `args`: every block (H_tt, H_ts, H_ss, b_t,
    b_s, the error) within 1e-4 of its summand scale (`_k3_summand_scale`;
    for H and the error that is max|ref|, and the error over max|ref| is
    printed beside it), two calls equal bit for bit, inlier counts equal. A
    planted fault, the plain version with the weights of one K3 thread
    block's worth of inliers (the first FL._THREADS) zeroed, must fail the
    same check."""
    from gtsam_points_tpu_torch.ops import fused_linearize as FL

    lin, again = FL.linearize_fused_cuda(*args), FL.linearize_fused_cuda(*args)
    ref, mirror = FL.linearize_fused_plain(*args), FL.linearize_fused_source_plain(*args)
    ref64, scale = FL.linearize_fused_plain(*_float64(args)), _k3_summand_scale(torch, args)
    faulty = list(args)
    faulty[2] = args[2].clone()
    faulty[2][:, torch.nonzero(args[3]).flatten()[:FL._THREADS]] = 0.0
    fault = FL.linearize_fused_plain(*faulty)
    errs = _k3_field_errors(torch, lin, ref, scale)
    own = _k3_field_errors(torch, mirror, ref, scale)
    f64 = {name: _k3_field_errors(torch, x, ref64, scale) for name, x in (("K3", lin), ("plain", ref))}
    fault_err = max(v[1] for v in _k3_field_errors(torch, lin, fault, scale).values())
    differ = _bits_differ(torch, lin, again)
    same_count = int(lin.num_inliers) == int(ref.num_inliers)
    worst, worst_own = max(v[1] for v in errs.values()), max(v[1] for v in own.values())
    log(f"[{tag}] {label}, N={args[0].shape[1]} valid={int(ref.num_inliers)}: K3 vs plain "
        "per field err/max|ref| and err/summand scale: "
        + ", ".join(f"{k} {a:.3e} {b:.3e}" for k, (a, b) in errs.items())
        + f"; worst {worst:.3e} (tol 1e-4 of the summand scale), its own arithmetic's plain version "
        f"{worst_own:.3e}; against float64 b_s err/max|ref| K3 {f64['K3']['b_s'][0]:.3e} plain "
        f"{f64['plain']['b_s'][0]:.3e}, err/summand K3 {max(v[1] for v in f64['K3'].values()):.3e} plain "
        f"{max(v[1] for v in f64['plain'].values()):.3e} (recorded); two calls differ in {differ} values; "
        f"inlier counts equal {same_count}; the planted fault (the weights of the first {FL._THREADS} inliers "
        f"zeroed) reads {fault_err:.3e} (must be over 1e-4)")
    if worst > 1e-4 or worst_own > 1e-4 or differ or not same_count:
        raise AssertionError(f"K3 disagrees with its plain version ({tag}: {label})")
    if fault_err <= 1e-4:
        raise AssertionError(f"the K3 check passes a plain version with points dropped ({tag}: {label})")


def phase_k3_payloads(torch, frames, T_rel) -> None:
    """Phase 20: K3 against its plain version (and the plain version of its
    own arithmetic) at N = 25088 on the two-scan payloads: GICP's W from
    inv3x3, ICP point to point (W = I), ICP point to plane (W = nnᵀ), each
    with the binary factor's delta at the identity and at the registered
    pose (one GICP registration of the pair from the true relative pose),
    each held by `hold_k3`."""
    from gtsam_points_tpu_torch.optim import optimize_lm

    target, source = frames[0], frames[1]
    eye = torch.eye(4, device="cuda")
    reg = optimize_lm(_pair_graph(torch, _pair_factor("gicp", target, source)), torch.stack([eye, T_rel]))
    poses = {"identity": torch.stack([eye, eye]), "registered": reg.poses}
    for kind in GICP_KINDS:
        factor = _pair_factor(kind, target, source)
        for at, P in poses.items():
            hold_k3(torch, "k3-pairs", f"{kind} at the {at} pose", factor.k3_inputs(P, factor.correspondences(P)))


def phase_gicp_pairs(torch, frames, T_rel) -> dict:
    """Phase 21: the two-scan registration (basic_scan_matching) on the card
    for GICP, ICP point to point and ICP point to plane, from GICP_INITS
    starts each, through optimize_lm on a FactorGraph of a PriorFactor and
    the binary factor; K3's launches a registration equal to its LM
    iterations (its linearizations), and no call of K3's plain version;
    pose 1 within GICP_BOUND_M and _RAD of the JAX package's, or within
    GICP_SHIFT_MARGIN times its init's order shift where that is larger.
    -> K3's launches by factor kind."""
    import numpy as np

    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.optim import optimize_lm
    from gtsam_points_tpu_torch.utils import se3

    xis = np.random.RandomState(GICP_SEED).uniform(-0.1, 0.1, (GICP_INITS, 6)).astype(np.float32)
    starts = T_rel @ se3.se3_exp(torch.from_numpy(xis).cuda())
    eye = torch.eye(4, device="cuda")
    launches = {}
    for kind in GICP_KINDS:
        graph = _pair_graph(torch, _pair_factor(kind, frames[0], frames[1]))
        poses, ms, iters, per_reg = [], [], [], []
        _zero_counts(FL)
        with mock.patch.object(FL, "linearize_fused_plain", side_effect=AssertionError("K3's plain version ran")):
            for T0 in starts:
                before = FL.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = optimize_lm(graph, torch.stack([eye, T0]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                poses.append(res.poses[1])
                iters.append(int(res.status.num_iterations))
                per_reg.append(FL.launches - before)
        launches[kind] = FL.launches
        poses = torch.stack(poses)
        rot, trans = se3.pose_error(_rows_to_poses(torch, GICP_PAIR_JAX_POSES[kind]), poses)
        truth_rot, truth_trans = se3.pose_error(T_rel.expand(GICP_INITS, 4, 4), poses)
        bound_m, bound_rad = _shift_bound(torch, GICP_PAIR_ORDER_SHIFT_M[kind], GICP_PAIR_ORDER_SHIFT_RAD[kind])
        shifted = int(((trans > GICP_BOUND_M) | (rot > GICP_BOUND_RAD)).sum())
        log(f"[pairs] {kind}: {GICP_INITS} registrations, ms each median {statistics.median(ms):.3f}, min "
            f"{min(ms):.3f}, max {max(ms):.3f} (host clock, synchronized); LM iterations {iters}; K3 launches "
            f"{per_reg} (must equal the iterations), K3's plain version not called; against the JAX package's "
            f"pose 1: max gap {float(trans.max()):.3e} m {float(rot.max()):.3e} rad, {shifted} inits past "
            f"{GICP_BOUND_M} m / {GICP_BOUND_RAD} rad held to {GICP_SHIFT_MARGIN} x their order shift, the largest "
            f"gap over its bound {float((trans / bound_m).max()):.3f} in m, {float((rot / bound_rad).max()):.3f} in rad; "
            f"against the truth max {float(truth_trans.max()):.6f} m {float(truth_rot.max()):.6f} rad")
        if per_reg != iters or not all(iters):
            raise AssertionError(f"{kind}: K3 launches a registration differ from its LM iterations")
        if not (bool(torch.all(trans <= bound_m)) and bool(torch.all(rot <= bound_rad))):
            raise AssertionError(f"{kind}: a pose is further from the JAX package's than its init's bound")
    return launches


def phase_frame_to_frame(torch, scene) -> dict:
    """Phase 22: GICP_STEPS steps of frame_to_frame_step on the scene with
    constant velocity (each step predicted by the previous step's delta,
    from rest; the JAX package's ATE on the CPU is the same with the true
    motion as prediction, tests/test_torch_real_size.py --gicp-steps); a
    step's preprocessing is
    estimate_normals_covs on the new frame and build_hash_grid on the
    previous one. Each step's delta within the pair bound of the JAX
    package's (GICP_STEP_JAX_DELTAS, GICP_STEP_ORDER_SHIFT_M and _RAD); the
    ATE within the JAX package's times ATE_SLACK; K3's launches equal to
    the LM iterations and K3's plain version not called; step and
    preprocessing ms and host reads a step. -> K3's launches."""
    import warnings

    import numpy as np

    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs
    from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid
    from gtsam_points_tpu_torch.pipelines import odometry
    from gtsam_points_tpu_torch.types.frame import make_frame
    from gtsam_points_tpu_torch.utils import se3

    raw = [make_frame(s, device="cuda") for s in scene["scans"][: GICP_STEPS + 1]]
    iters = []
    lm = odometry.optimize_lm

    def counted(*a, **kw):
        res = lm(*a, **kw)
        iters.append(res.status.num_iterations)
        return res

    prev = estimate_normals_covs(raw[0], k=10, grid_leaf=1.0)
    T_world = delta = torch.eye(4, device="cuda")
    world, deltas, pre_ms, step_ms, reads = [T_world], [], [], [], []
    _zero_counts(FL)
    with mock.patch.object(FL, "linearize_fused_plain", side_effect=AssertionError("K3's plain version ran")), \
            mock.patch.object(odometry, "optimize_lm", counted):
        for f in raw[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = estimate_normals_covs(f, k=10, grid_leaf=1.0)
            grid = build_hash_grid(prev.points, prev.mask, 1.0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    T_world, delta, _ = odometry.frame_to_frame_step(prev, grid, T_world, delta,
                                                                     GICP_STEP_ITERATIONS, frame)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            reads.append(sum("called a synchronizing CUDA operation" in str(w.message) for w in caught))
            pre_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t1) * 1e3)
            world.append(T_world)
            deltas.append(delta)
            prev = frame
    k3 = FL.launches
    iters = [int(i) for i in iters]
    deltas = torch.stack(deltas)
    rot, trans = se3.pose_error(_rows_to_poses(torch, GICP_STEP_JAX_DELTAS), deltas)
    bound_m, bound_rad = _shift_bound(torch, GICP_STEP_ORDER_SHIFT_M, GICP_STEP_ORDER_SHIFT_RAD)
    T_true = scene["T_true"]
    T0 = torch.from_numpy(T_true[0]).cuda()
    T_ref = torch.from_numpy(np.stack(T_true[: len(world)])).cuda()
    _, ate = se3.pose_error(T_ref, T0 @ torch.stack(world))
    ate_mean, ate_max = float(ate.mean()), float(ate.max())
    per_scan = [a + b for a, b in zip(pre_ms, step_ms)]
    log(f"[frame-to-frame] {GICP_STEPS} steps with constant velocity: step ms median "
        f"{statistics.median(step_ms):.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}; preprocessing ms "
        f"median {statistics.median(pre_ms):.3f} (estimate_normals_covs of the new frame and build_hash_grid of "
        f"the previous one); per scan median {statistics.median(per_scan):.3f} ms (target {STEP_LIMIT_MS} ms, "
        f"one 10 Hz LiDAR period, not gated); host reads a step {reads}; LM iterations {iters}; K3 launches {k3} "
        f"(must equal {sum(iters)}), K3's plain version not called")
    log(f"[frame-to-frame] against the JAX package's deltas: max gap {float(trans.max()):.3e} m "
        f"{float(rot.max()):.3e} rad, {int(((trans > GICP_BOUND_M) | (rot > GICP_BOUND_RAD)).sum())} steps held to "
        f"{GICP_SHIFT_MARGIN} x their order shift, the largest gap over its bound {float((trans / bound_m).max()):.3f}"
        f" in m, {float((rot / bound_rad).max()):.3f} in rad; ATE mean {ate_mean:.6f} m max {ate_max:.6f} m (bound: the "
        f"JAX package's mean {GICP_ATE_JAX_MEAN_M} m, max {GICP_ATE_JAX_MAX_M} m, times {ATE_SLACK})")
    if k3 != sum(iters) or not all(iters):
        raise AssertionError("frame-to-frame: K3 launches differ from the LM iterations")
    if not (bool(torch.all(trans <= bound_m)) and bool(torch.all(rot <= bound_rad))):
        raise AssertionError("frame-to-frame: a step's delta is further from the JAX package's than its bound")
    if not (ate_mean <= GICP_ATE_JAX_MEAN_M * ATE_SLACK and ate_max <= GICP_ATE_JAX_MAX_M * ATE_SLACK):
        raise AssertionError("frame-to-frame: the trajectory is further from the truth than the JAX package's")
    return {"launches": k3, "median_ms": statistics.median(per_scan)}


def _frame_bits_differ(torch, a, b) -> int:
    """Values of two Frames that differ in any bit (aux included); -1 where
    one has an attribute the other lacks."""
    def differ(x, y) -> int:
        x, y = x.cpu(), y.cpu()
        return int((x.view(torch.int32) != y.view(torch.int32)).sum()) if x.is_floating_point() else int((x != y).sum())

    out = 0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None) or (isinstance(x, dict) and sorted(x) != sorted(y)):
            return -1
        if isinstance(x, dict):
            out += sum(differ(x[k], y[k]) for k in x)
        elif x is not None:
            out += differ(x, y)
    return out


def _graph_factor_lists(frames) -> dict:
    """Phase 23's binary factors by kind: GICP, VGICP, and the same VGICP
    factors as one VGICPFactorBatch on the same voxel maps."""
    from gtsam_points_tpu_torch.factors import make_gicp_factor, make_vgicp_factor, make_vgicp_factor_batch

    edges = graph_edges(len(frames))
    vgicp = [make_vgicp_factor(i, j, frames[i], frames[j], voxel_resolution=GRAPH_VGICP_LEAF,
                               min_voxel_points=GRAPH_VGICP_MIN_POINTS) for i, j in edges]
    return {
        "gicp": [make_gicp_factor(i, j, frames[i], frames[j], max_corr_dist=GICP_MAX_CORR) for i, j in edges],
        "vgicp": vgicp,
        "vgicp_batch": [make_vgicp_factor_batch([f.voxelmap for f in vgicp], [frames[j] for _, j in edges],
                                                [i for i, _ in edges], [j for _, j in edges],
                                                min_voxel_points=GRAPH_VGICP_MIN_POINTS)],
    }


def _graph_optimize(torch, run: str, graph, start):
    """One of phase 23's runs -> (poses, error, iterations)."""
    from gtsam_points_tpu_torch.optim import DoglegParams, LMParams, optimize_dogleg, optimize_gn, optimize_lm

    opt = run.rsplit("_", 1)[1]
    if opt == "lm":
        res = optimize_lm(graph, start, LMParams(max_iterations=GRAPH_LM_ITERATIONS))
        return res.poses, res.error, int(res.status.num_iterations)
    if opt == "gn":
        res = optimize_gn(graph, start, iterations=GRAPH_GN_ITERATIONS)
        return res.poses, res.error, GRAPH_GN_ITERATIONS
    res = optimize_dogleg(graph, start, DoglegParams(max_iterations=GRAPH_DOGLEG_ITERATIONS))
    return res.poses, res.error, int(res.num_iterations)


def _relative_truth_error(torch, T_true, poses) -> tuple:
    """The demo's error: each pose relative to pose 0 against the truth's
    -> (max m, max rad)."""
    import numpy as np

    from gtsam_points_tpu_torch.utils import se3

    ref = torch.from_numpy((np.linalg.inv(T_true[0]) @ np.stack(T_true)).astype(np.float32)).cuda()
    rot, trans = se3.pose_error(ref, torch.linalg.inv(poses[0]) @ poses)
    return float(trans.max()), float(rot.max())


def phase_chain_graph(torch, scene) -> dict:
    """Phase 23: the multi-frame chain graph (the reference's
    demo_matching_cost_factors protocol) over the scene's first GRAPH_POSES
    scans. voxelgrid_sampling on the card against the CPU port bit for bit,
    the kept counts; then GRAPH_RUNS, each GRAPH_REPEATS times, every repeat
    equal to the first bit for bit; K3's launches equal to the iterations x
    F (the binary factors: one launch a factor a linearization, the batch's
    too) and K3's plain version not called; the poses against the JAX
    package's (GRAPH_JAX_POSES) within GICP_BOUND_M and _RAD or
    GICP_SHIFT_MARGIN x their order shift (GRAPH_ORDER_SHIFT_M, _RAD) where
    larger; the error against the JAX package's; against the truth no
    further than the JAX package's run times ATE_SLACK (the demo's bounds
    printed); the batch run within GRAPH_BATCH_BOUND_M of the VGICP list
    run; K3 held against its plain version (`hold_k3`) on the last edge's
    GICP, VGICP and batch payloads at the start and the final poses; the
    VGICP LM once more with K3's plain version, its stop recorded. -> (K3's
    launches by path, the preprocessed frames, phases 25-27's input)."""
    import numpy as np

    from gtsam_points_tpu_torch.factors import PriorFactor
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.ops.downsample import voxelgrid_sampling
    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs
    from gtsam_points_tpu_torch.optim import FactorGraph
    from gtsam_points_tpu_torch.types.frame import make_frame
    from gtsam_points_tpu_torch.utils import se3

    T_true = scene["T_true"][:GRAPH_POSES]
    raw = [make_frame(s, device="cuda") for s in scene["scans"][:GRAPH_POSES]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampled = [voxelgrid_sampling(f, GRAPH_LEAF, capacity=GRAPH_CAPACITY) for f in raw]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    frames = [estimate_normals_covs(f, k=10, grid_leaf=1.0) for f in sampled]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    differ = [_frame_bits_differ(torch, f, voxelgrid_sampling(_cpu_copy(r), GRAPH_LEAF, capacity=GRAPH_CAPACITY))
              for f, r in zip(sampled, raw)]
    kept = [int(f.mask.sum()) for f in sampled]
    log(f"[graph] voxelgrid_sampling of {GRAPH_POSES} scans ({REAL_SCAN_N} points) at leaf {GRAPH_LEAF} into "
        f"{GRAPH_CAPACITY} slots: {(t1 - t0) * 1e3 / GRAPH_POSES:.3f} ms a scan, kNN features "
        f"{(t2 - t1) * 1e3 / GRAPH_POSES:.3f} ms a scan (host clock, synchronized); kept points {kept}; values "
        f"differing from the CPU port's in any bit {differ} (must be 0)")
    if any(differ):
        raise AssertionError("graph: voxelgrid_sampling on the card differs from the CPU port")

    start = torch.from_numpy(graph_start(T_true)).cuda()
    prior = PriorFactor(prior=torch.from_numpy(np.asarray(T_true[0])).cuda(),
                        weights=torch.full((6,), GRAPH_PRIOR_WEIGHT, device="cuda"), key=0)
    factors = _graph_factor_lists(frames)
    F = len(factors["gicp"])
    launches, results = {}, {}
    for run in GRAPH_RUNS:
        graph = FactorGraph([prior] + factors[run.rsplit("_", 1)[0]], num_poses=GRAPH_POSES)
        ms, reps = [], []
        _zero_counts(FL)
        with mock.patch.object(FL, "linearize_fused_plain", side_effect=AssertionError("K3's plain version ran")):
            for _ in range(GRAPH_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                reps.append(_graph_optimize(torch, run, graph, start))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        launches[run] = FL.launches
        poses, err, iters = reps[0]
        same = all(_bits_differ(torch, (p, e), (poses, err)) == 0 and i == iters for p, e, i in reps[1:])
        results[run] = poses
        rot, trans = se3.pose_error(_rows_to_poses(torch, GRAPH_JAX_POSES[run]), poses)
        shifts = [run, "vgicp_lm"] if run == "vgicp_batch_lm" else [run]
        bound_m, bound_rad = _shift_bound(torch, [max(x) for x in zip(*(GRAPH_ORDER_SHIFT_M[r] for r in shifts))],
                                          [max(x) for x in zip(*(GRAPH_ORDER_SHIFT_RAD[r] for r in shifts))])
        truth_m, truth_rad = _relative_truth_error(torch, T_true, poses)
        jax_m, jax_rad = GRAPH_JAX_TRUTH[run]
        log(f"[graph] {run}: {F} binary factors + a prior, {GRAPH_POSES} poses ({6 * GRAPH_POSES}x{6 * GRAPH_POSES} "
            f"system); ms median {statistics.median(ms):.3f} of {GRAPH_REPEATS} (host clock, synchronized; "
            f"{', '.join(f'{x:.3f}' for x in ms)}); iterations {iters} (JAX {GRAPH_JAX_ITERATIONS[run]}); K3 launches "
            f"{launches[run]} (must equal {GRAPH_REPEATS} x {iters} x {F}), K3's plain version not called; repeats "
            f"equal bit for bit {same}; error {float(err):.6f} (JAX {GRAPH_JAX_ERRORS[run]:.6f}); against the JAX "
            f"package's poses max gap {float(trans.max()):.3e} m {float(rot.max()):.3e} rad, the largest over its "
            f"bound {float((trans / bound_m).max()):.3f} in m {float((rot / bound_rad).max()):.3f} in rad; against the "
            f"truth relative to pose 0 {truth_m:.6f} m {truth_rad:.6f} rad (the JAX package's {jax_m} m {jax_rad} rad "
            f"times {ATE_SLACK}; the demo's bounds {GRAPH_TRUTH_M} m, {GRAPH_TRUTH_RAD} rad, met "
            f"{truth_m < GRAPH_TRUTH_M and truth_rad < GRAPH_TRUTH_RAD})")
        if launches[run] != GRAPH_REPEATS * iters * F or not iters:
            raise AssertionError(f"graph {run}: K3 launches differ from the iterations x the factors")
        if not same:
            raise AssertionError(f"graph {run}: two card runs differ")
        if not (bool(torch.all(trans <= bound_m)) and bool(torch.all(rot <= bound_rad))):
            raise AssertionError(f"graph {run}: a pose is further from the JAX package's than its bound")
        if not (truth_m <= jax_m * ATE_SLACK and truth_rad <= jax_rad * ATE_SLACK):
            raise AssertionError(f"graph {run}: further from the truth than the JAX package's")
    rot, trans = se3.pose_error(results["vgicp_lm"], results["vgicp_batch_lm"])
    log(f"[graph] the VGICPFactorBatch run against the VGICP list run: max gap {float(trans.max()):.3e} m "
        f"{float(rot.max()):.3e} rad (bound {GRAPH_BATCH_BOUND_M} m)")
    if float(trans.max()) > GRAPH_BATCH_BOUND_M:
        raise AssertionError("graph: the batch run's poses differ from the list run's")
    # K3 on the graph's own payloads (GICP from downsampled frames at
    # N = GRAPH_CAPACITY, binary VGICP from voxel maps, the batch's member):
    # the last edge's factor at the start and at its run's final poses
    for run, factor in (("gicp_lm", factors["gicp"][-1]), ("vgicp_lm", factors["vgicp"][-1]),
                        ("vgicp_batch_lm", factors["vgicp_batch"][0]._factors[-1])):
        for at, P in (("start", start), ("final", results[run])):
            hold_k3(torch, "graph-k3", f"{run} edge {factor.keys} at the {at} poses",
                    factor.k3_inputs(P, factor.correspondences(P)))
    # a second witness of where the VGICP LM stops on the card: the same run
    # with K3's plain version in place of the kernel
    graph = FactorGraph([prior] + factors["vgicp"], num_poses=GRAPH_POSES)
    with mock.patch.object(FL, "linearize_fused", FL.linearize_fused_plain):
        poses, err, iters = _graph_optimize(torch, "vgicp_lm", graph, start)
    rot, trans = se3.pose_error(_rows_to_poses(torch, GRAPH_JAX_POSES["vgicp_lm"]), poses)
    rot_k, trans_k = se3.pose_error(results["vgicp_lm"], poses)
    log(f"[graph] witness: vgicp_lm with K3's plain version on the card: iterations {iters}, error {float(err):.6f}; "
        f"against the JAX package's poses max gap {float(trans.max()):.3e} m {float(rot.max()):.3e} rad; against the "
        f"K3 run's {float(trans_k.max()):.3e} m {float(rot_k.max()):.3e} rad (recorded)")
    return {"graph_gicp": launches["gicp_lm"],
            "graph_vgicp": launches["vgicp_lm"] + launches["vgicp_gn"] + launches["vgicp_dogleg"],
            "graph_batch": launches["vgicp_batch_lm"]}, frames


def _small_graph(torch, device: str):
    """Phase 24's small graph of the pose and multi-key factors over five
    seeded poses on `device`, and the poses."""
    import numpy as np

    from gtsam_points_tpu_torch.factors import (
        BetweenFactor,
        LinearDampingFactor,
        Pose3CalibFactor,
        Pose3InterpolationFactor,
        RotateVector3Factor,
    )
    from gtsam_points_tpu_torch.optim import FactorGraph
    from gtsam_points_tpu_torch.utils import se3

    rng = np.random.RandomState(PG_SEED)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    poses = se3.se3_exp(t(rng.uniform(-0.5, 0.5, (5, 6))))
    w = t(rng.uniform(0.5, 2.0, 6))
    graph = FactorGraph([
        LinearDampingFactor(weights=w, key=2),
        BetweenFactor(measured=se3.se3_exp(t(rng.uniform(-0.5, 0.5, 6))), weights=w, target_key=1, source_key=3),
        Pose3CalibFactor(weights=w, pose_keys=(0, 2, 4)),
        Pose3InterpolationFactor(t=t(0.3), weights=w, pose_keys=(1, 2, 3)),
        RotateVector3Factor(local=t([0.0, 0.0, 1.0]), world=t([0.1, -0.05, 0.99]), weights=w[:3], pose_keys=(2,)),
    ], num_poses=5)
    return graph, poses


def phase_pose_graph(torch) -> None:
    """Phase 24: the block-sparse pose graph (PG_POSES poses, ten laps)
    through optimize_pose_graph twice, equal bit for bit; host reads and ms;
    every PG_SAMPLE-th pose within GICP_BOUND_M and _RAD of the JAX
    package's (PG_JAX_POSES), the error within PG_ERROR_TOL of the JAX
    package's; then the small graph of
    the pose and multi-key factors, linearize_frozen on the card against the
    CPU port within SMALL_GRAPH_TOL x max|ref| on every block."""
    import warnings

    from gtsam_points_tpu_torch import interop
    from gtsam_points_tpu_torch.optim import optimize_pose_graph
    from gtsam_points_tpu_torch.utils import se3

    _, arrays, start = pose_graph_arrays()
    pg = interop.pose_graph_from_numpy(arrays, device="cuda")
    start = torch.from_numpy(start).cuda()
    runs, ms = [], []
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if rep == 0:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                runs.append(optimize_pose_graph(pg, start, max_iterations=PG_ITERATIONS))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if rep == 0:
            reads = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    res = runs[0]
    same = all(_bits_differ(torch, (r.poses, r.error), (res.poses, res.error)) == 0 for r in runs[1:])
    sampled = res.poses[::PG_SAMPLE]
    rot, trans = se3.pose_error(_rows_to_poses(torch, PG_JAX_POSES), sampled)
    err_rel = abs(float(res.error) - PG_JAX_ERROR) / PG_JAX_ERROR
    log(f"[pose-graph] {PG_POSES} poses, {len(arrays['t_idx'])} BetweenFactor edges and a prior: ms {ms[0]:.3f} with "
        f"host reads counted ({reads} host reads), then {ms[1]:.3f}, {ms[2]:.3f} (host clock, synchronized); iterations "
        f"{int(res.iterations)} (JAX {PG_JAX_ITERATIONS}); runs equal bit for bit {same}; error {float(res.error):.6f} "
        f"(JAX {PG_JAX_ERROR:.6f}, relative gap {err_rel:.3e}); every {PG_SAMPLE}th pose against the JAX package's: "
        f"max gap {float(trans.max()):.3e} m {float(rot.max()):.3e} rad (bounds {GICP_BOUND_M} m, {GICP_BOUND_RAD} rad)")
    if not same:
        raise AssertionError("pose graph: two card runs differ")
    if not (float(trans.max()) <= GICP_BOUND_M and float(rot.max()) <= GICP_BOUND_RAD):
        raise AssertionError("pose graph: a pose is further from the JAX package's than its bound")
    if err_rel > PG_ERROR_TOL:
        raise AssertionError("pose graph: the error differs from the JAX package's")

    card, card_poses = _small_graph(torch, "cuda")
    cpu, cpu_poses = _small_graph(torch, "cpu")
    A, b, err, efn = card.linearize_frozen(card_poses)
    rA, rb, rerr, refn = cpu.linearize_frozen(cpu_poses)
    batch = torch.stack([cpu_poses, cpu_poses.flip(0)])
    worst = max(
        [_rel_err(torch, A.reshape(5, 6, 5, 6)[i, :, j], rA.reshape(5, 6, 5, 6)[i, :, j]) for i in range(5) for j in range(5)
         if rA.reshape(5, 6, 5, 6)[i, :, j].any()]
        + [_rel_err(torch, b.reshape(5, 6)[i], rb.reshape(5, 6)[i]) for i in range(5) if rb.reshape(5, 6)[i].any()]
        + [_rel_err(torch, err, rerr), _rel_err(torch, efn(batch.cuda()), refn(batch))])
    zeros_kept = bool(torch.equal((A == 0).cpu(), rA == 0))
    log(f"[pose-graph] small graph (LinearDampingFactor, BetweenFactor, Pose3CalibFactor, Pose3InterpolationFactor, "
        f"RotateVector3Factor over 5 poses): linearize_frozen on the card against the CPU port, largest block gap "
        f"{worst:.3e} x max|ref| (bound {SMALL_GRAPH_TOL}), the same zero blocks {zeros_kept}")
    if worst > SMALL_GRAPH_TOL or not zeros_kept:
        raise AssertionError("pose graph: the small graph on the card differs from the CPU port")



def isam2_noise(n_poses: int):
    """Phases 26-27's init noise [P, 4, 4] (numpy): identity for pose 0,
    se3_exp(uniform(-0.1, 0.1, 6)) from RandomState(ISAM2_SEED) for i >= 1."""
    import numpy as np
    import torch

    from gtsam_points_tpu_torch.utils import se3

    rng = np.random.RandomState(ISAM2_SEED)
    out = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n_poses):
        out.append(se3.se3_exp(torch.from_numpy(rng.uniform(-0.1, 0.1, 6).astype(np.float32))).numpy())
    return np.stack(out).astype(np.float32)


def isam2_stream(api: dict, frames, T_true, smoother: bool = False, on_update=None):
    """Phases 26-27's protocol on one package: `api` holds its ISAM2Ext,
    FixedLagSmoother, LMParams, PriorFactor and make_vgicp_factor, `arr`
    (numpy -> the package's array on its device) and `kw` (the optimizer's
    device keyword). `on_update(i)`, if given, is a context manager entered
    around each update. -> (records, the ISAM2Ext, the loop factor): a
    record an update (the last the loop closure) with its window, frozen
    keys, num_compiles, compiled (None for the smoother's pose updates),
    iterations, every estimate [P, 4, 4] and its host-clock ms."""
    import contextlib

    import numpy as np

    noise = isam2_noise(len(frames))
    arr = api["arr"]
    lm = api["LMParams"](max_iterations=ISAM2_ITERATIONS)
    kw = dict(voxel_resolution=GRAPH_VGICP_LEAF, min_voxel_points=GRAPH_VGICP_MIN_POINTS)
    if smoother:
        opt = api["FixedLagSmoother"](lag=ISAM2_LAG, lm_params=lm, **api["kw"])
        isam = opt._isam
    else:
        opt = isam = api["ISAM2Ext"](window_size=ISAM2_WINDOW, lm_params=lm, **api["kw"])
    around = on_update or (lambda i: contextlib.nullcontext())
    records = []

    def run(i, call):
        with around(i):
            t0 = time.perf_counter()
            res = call()
            ms = (time.perf_counter() - t0) * 1e3
        full = hasattr(res, "compiled")
        records.append({"window": list(isam.window), "frozen": sorted(isam.frozen),
                        "num_compiles": isam.num_compiles, "compiled": bool(res.compiled) if full else None,
                        "iterations": int(res.num_iterations) if full else None,
                        "estimates": isam.calculate_estimate().copy(), "ms": ms})

    n = len(frames)
    for i in range(n):
        if i == 0:
            factors = [api["PriorFactor"](prior=arr(T_true[0]), weights=arr(np.full(6, GRAPH_PRIOR_WEIGHT)), key=0)]
            init = np.asarray(T_true[0], np.float32)
        else:
            factors = [api["make_vgicp_factor"](i - 1, i, frames[i - 1], frames[i], **kw)]
            init = isam.calculate_estimate_pose(i - 1) @ np.linalg.inv(T_true[i - 1]) @ T_true[i] @ noise[i]
        if smoother:
            run(i, lambda: opt.update(i, float(i), arr(init), factors))
        else:
            run(i, lambda: opt.update(factors, {i: arr(init)}))
    loop = api["make_vgicp_factor"](0, n - 1, frames[0], frames[n - 1], **kw)
    run(n, lambda: opt.add_factors([loop]) if smoother else opt.update([loop]))
    return records, isam, loop


def _stream_rows(records) -> list:
    """Per update the poses it moved, top three rows row-major: the window's,
    and every pose at the loop closure (the frozen ones keep earlier rows)."""
    out = []
    for r in records:
        keys = range(len(r["estimates"])) if r is records[-1] else r["window"]
        out.append([r["estimates"][k][:3].reshape(12).tolist() for k in keys])
    return out


def _card_api(torch) -> dict:
    import numpy as np

    from gtsam_points_tpu_torch.factors import PriorFactor, make_vgicp_factor
    from gtsam_points_tpu_torch.optim import FixedLagSmoother, ISAM2Ext, LMParams

    return {"ISAM2Ext": ISAM2Ext, "FixedLagSmoother": FixedLagSmoother, "LMParams": LMParams,
            "PriorFactor": PriorFactor, "make_vgicp_factor": make_vgicp_factor,
            "arr": lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).cuda(), "kw": {"device": "cuda"}}


def _fpfh_flips(torch, frame, frame_cpu) -> tuple:
    """The card's FPFH pair bins of `frame` against the CPU port's on its
    copy -> (neighbour tables equal, flips, pairs, flips not at a bin edge
    or a swap tie, the rows a flip reaches as a bool [N])."""
    import numpy as np

    from gtsam_points_tpu_torch.registration import fpfh

    c_idx, _, c_val = fpfh.fpfh_neighbors(frame, device="cuda")
    h_idx, _, h_val = fpfh.fpfh_neighbors(frame_cpu, device="cpu")
    same_nn = torch.equal(c_idx.cpu(), h_idx) and torch.equal(c_val.cpu(), h_val)
    c_bins = [b.cpu().numpy() for b in fpfh.spfh_bins(frame, c_idx)]
    h_bins = [b.numpy() for b in fpfh.spfh_bins(frame_cpu, h_idx)]
    i = np.maximum(h_idx.numpy(), 0)
    valid = h_val.numpy()
    P = frame_cpu.points.numpy().astype(np.float64)
    N = frame_cpu.normals.numpy().astype(np.float64)
    du = P[i] - P[:, None]
    du = du / np.maximum(np.linalg.norm(du, axis=-1, keepdims=True), 1e-12)
    tie = np.abs(np.abs(np.sum(N[:, None] * du, -1)) - np.abs(np.sum(N[i] * du, -1))) < FPFH_SWAP_TIE
    feats = [x.numpy().astype(np.float64) for x in fpfh.compute_pair_features(
        frame_cpu.points[:, None], frame_cpu.normals[:, None], frame_cpu.points[i], frame_cpu.normals[i])[:3]]
    flip = np.zeros_like(valid)
    unexplained = 0
    for x, a, b, (lo, hi) in zip(feats, c_bins, h_bins, ((-1.0, 1.0), (-1.0, 1.0), (-np.pi, np.pi))):
        d = (a != b) & valid
        scaled = (x - lo) / (hi - lo) * fpfh.FPFH_BINS
        edge = np.abs(scaled - np.round(scaled)) < FPFH_EDGE_TOL
        unexplained += int((d & ~edge & ~tie).sum())
        flip |= d
    touched = flip.any(1)
    return same_nn, int(flip.sum()), int(valid.sum()), unexplained, touched | (touched[i] & valid).any(1)


def _syncs(torch, fn):
    """fn() with the card's synchronizing calls counted -> (its result, the count)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def _host_median_ms(torch, fn, reps=FPFH_REPS):
    """fn()'s median ms over `reps` calls (host clock, synchronized) -> (the last result, ms)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def phase_loop_detection(torch, frames, T_true) -> dict:
    """Phase 25: FPFH of frames 0, GNC_NEAR_PAIR[1] and GRAPH_POSES - 1 on
    the card against the CPU port (neighbour tables equal, bin flips counted
    and each explained, unreached rows within FPFH_HIST_TOL); feature_knn's
    indices on the far pair's CPU features against the CPU port (ties
    counted, each within FPFH_TIE_TOL); estimate_pose_gnc on the card on the
    near pair (GNC_NEAR_PAIR, where GNC converges) against the JAX package's
    pose within GICP_BOUND_M and _RAD or GICP_SHIFT_MARGIN x its order shift,
    and on the far pair (0, GRAPH_POSES - 1, where both packages alias) the
    same way against GNC_JAX_POSE; the IRLS (gnc_irls) on the CPU port's
    matches of the far pair, card against the CPU port, within GICP_BOUND_M
    and _RAD; and, recorded, the whole GNC from the CPU port's features,
    whose card matches differ from the CPU port's at the feature_knn ties.
    Errors against the truth, inlier rates, FPFH and GNC medians over
    FPFH_REPS calls, the synchronizing calls of one GNC."""
    import numpy as np

    from gtsam_points_tpu_torch.registration import GNCParams, align_points_se3, estimate_fpfh, estimate_pose_gnc
    from gtsam_points_tpu_torch.registration import feature_knn
    from gtsam_points_tpu_torch.registration.gnc import gnc_irls, reciprocal_matches
    from gtsam_points_tpu_torch.utils import se3

    far = (0, len(frames) - 1)
    card = {k: frames[k] for k in sorted({*far, *GNC_NEAR_PAIR})}
    cpu = {k: _cpu_copy(f) for k, f in card.items()}
    feats, cpu_feats = {}, {}
    for k, f in card.items():
        feats[k], ms = _host_median_ms(torch, lambda: estimate_fpfh(f, device="cuda"))
        cpu_feats[k] = estimate_fpfh(cpu[k], device="cpu")
        same_nn, flips, pairs, unexplained, reached = _fpfh_flips(torch, f, cpu[k])
        gap = (feats[k].cpu() - cpu_feats[k]).abs().max(dim=1).values.numpy()
        far_gap = float(gap[~reached].max()) if (~reached).any() else 0.0
        log(f"[loop] FPFH of frame {k} ({int(f.mask.sum())} points in {f.capacity} slots) card vs CPU port: "
            f"neighbour tables equal {same_nn}; pair bins differing {flips} of {pairs} ({unexplained} not at a bin edge "
            f"within {FPFH_EDGE_TOL} or a swap tie within {FPFH_SWAP_TIE}, must be 0); rows a flip reaches "
            f"{int(reached.sum())}, the others' largest gap {far_gap:.3e} (bound {FPFH_HIST_TOL}); median ms "
            f"{ms:.3f} over {FPFH_REPS} calls (host clock, synchronized)")
        if not same_nn or unexplained or far_gap > FPFH_HIST_TOL:
            raise AssertionError(f"loop detection: FPFH of frame {k} on the card differs from the CPU port's")
    t, s = far
    # feature_knn on the same (CPU port's) features
    c_idx, c_sq, c_val = feature_knn(cpu_feats[t].cuda(), card[t].mask, cpu_feats[s].cuda(), card[s].mask)
    h_idx, h_sq, h_val = feature_knn(cpu_feats[t], cpu[t].mask, cpu_feats[s], cpu[s].mask)
    differ = ((c_idx.cpu() != h_idx) & h_val).numpy()[:, 0]
    tgt, src = cpu_feats[t].double().numpy(), cpu_feats[s].double().numpy()
    worst_tie = 0.0
    for q in np.nonzero(differ)[0]:
        tc, th = tgt[int(c_idx[q, 0])], tgt[int(h_idx[q, 0])]
        scale = np.sum(src[q] ** 2) + max(np.sum(tc**2), np.sum(th**2))
        worst_tie = max(worst_tie, abs(np.sum((src[q] - tc) ** 2) - np.sum((src[q] - th) ** 2)) / scale)
    log(f"[loop] feature_knn on the same features, card vs CPU port: valid equal "
        f"{torch.equal(c_val.cpu(), h_val)}, indices differing {int(differ.sum())} of {int(h_val.sum())}, each a tie "
        f"(largest gap of the two candidates' exact distances {worst_tie:.3e} of |q|² + |t|², bound {FPFH_TIE_TOL})")
    if not torch.equal(c_val.cpu(), h_val) or worst_tie > FPFH_TIE_TOL:
        raise AssertionError("loop detection: feature_knn on the card differs from the CPU port's beyond ties")

    def truth(pair):
        return torch.from_numpy((np.linalg.inv(T_true[pair[0]]) @ T_true[pair[1]]).astype(np.float32)).cuda()

    for name, pair, jax_pose, jax_inlier, shift_m, shift_rad in (
            ("near", GNC_NEAR_PAIR, GNC_NEAR_JAX_POSE, GNC_NEAR_JAX_INLIER, GNC_NEAR_ORDER_SHIFT_M,
             GNC_NEAR_ORDER_SHIFT_RAD),
            ("far", far, GNC_JAX_POSE, GNC_JAX_INLIER, GNC_ORDER_SHIFT_M, GNC_ORDER_SHIFT_RAD)):
        a, b = pair

        def gnc():
            return estimate_pose_gnc(card[a], card[b], feats[a], feats[b], GNCParams(), device="cuda")

        res, syncs = _syncs(torch, gnc)
        again, ms = _host_median_ms(torch, gnc)
        same = _bits_differ(torch, (again.T_target_source,), (res.T_target_source,)) == 0
        rot_t, trans_t = se3.pose_error(truth(pair), res.T_target_source)
        rot, trans = se3.pose_error(_rows_to_poses(torch, [jax_pose])[0], res.T_target_source)
        bound_m, bound_rad = _shift_bound(torch, [shift_m], [shift_rad])
        log(f"[loop] estimate_pose_gnc {name} pair, frame {a} <- frame {b}: against the truth {float(trans_t):.6f} m "
            f"{float(rot_t):.6f} rad, inlier rate {float(res.inlier_rate):.6f} (JAX {jax_inlier:.6f}); against the JAX "
            f"package's pose {float(trans):.3e} m {float(rot):.3e} rad (bounds {float(bound_m[0]):.3e} m "
            f"{float(bound_rad[0]):.3e} rad); median ms {ms:.3f} over {FPFH_REPS} calls (host clock, synchronized), "
            f"repeats equal bit for bit {same}; synchronizing calls in one call {syncs}")
        if not (float(trans) <= float(bound_m[0]) and float(rot) <= float(bound_rad[0])):
            raise AssertionError(f"loop detection: the {name} GNC pose is further from the JAX package's than its bound")
        if not same or not bool(torch.all(torch.isfinite(res.T_target_source))):
            raise AssertionError(f"loop detection: the {name} GNC on the card is not repeatable or not finite")

    # the IRLS alone on the far pair: the CPU port's matches, card against the CPU port
    h_match, h_valid = reciprocal_matches(cpu[t], cpu[s], cpu_feats[t], cpu_feats[s])
    c_match, c_valid = reciprocal_matches(card[t], card[s], cpu_feats[t].cuda(), cpu_feats[s].cuda())
    moved = int(((c_match.cpu() != h_match) & (h_valid | c_valid.cpu())).sum() + (c_valid.cpu() != h_valid).sum())
    match, valid = h_match.cuda(), h_valid.cuda()
    T_irls, irls_syncs = _syncs(torch, lambda: gnc_irls(card[t], card[s], match, valid))
    T_ref = gnc_irls(cpu[t], cpu[s], h_match, h_valid)
    rot, trans = se3.pose_error(T_ref, T_irls.cpu())
    tgt_points, weights = card[t].points[match], valid.float()
    _, align_syncs = _syncs(torch, lambda: align_points_se3(card[s].points, tgt_points, weights))
    log(f"[loop] the IRLS on the CPU port's far-pair matches ({int(h_valid.sum())} valid), card against the CPU port: "
        f"{float(trans):.3e} m {float(rot):.3e} rad (bounds {GICP_BOUND_M} m {GICP_BOUND_RAD} rad); synchronizing calls "
        f"in the IRLS {irls_syncs}, in one align_points_se3 {align_syncs}")
    if not (float(trans) <= GICP_BOUND_M and float(rot) <= GICP_BOUND_RAD):
        raise AssertionError("loop detection: the IRLS on the card differs from the CPU port's on the same matches")
    # GNC's pose from the CPU port's features: the IRLS on each side's own matches (T_ref is the CPU port's)
    T_wit = gnc_irls(card[t], card[s], c_match, c_valid)
    rot, trans = se3.pose_error(T_ref, T_wit.cpu())
    log(f"[loop] witness: the far pair's GNC from the CPU port's features, card against the CPU port: {float(trans):.3e} m "
        f"{float(rot):.3e} rad; the card's reciprocal matches differ from the CPU port's in {moved} source points, "
        f"from the feature_knn ties (recorded)")
    return {"card": card, "cpu": cpu, "feats": feats, "cpu_feats": cpu_feats, "far": far}


class _LMRecorder:
    """Stands in for optim/isam2.optimize_lm: each call's K3 launches, its
    graph's VGICP factors and its iterations (a tensor, read later)."""

    def __init__(self, FL, real):
        self.FL, self.real, self.calls = FL, real, []

    def __call__(self, graph, poses, params=None):
        from gtsam_points_tpu_torch.factors import VGICPFactor

        before = self.FL.launches
        res = self.real(graph, poses, params)
        n_k3 = sum(isinstance(f, VGICPFactor) for f in graph.factors)
        self.calls.append((self.FL.launches - before, n_k3, res.status.num_iterations))
        return res


def _held_stream(torch, tag: str, frames, T_true, jax_ref: dict, shift_m, shift_rad, smoother: bool, runs: int,
                 count_syncs: bool) -> dict:
    """Phases 26-27's stream `runs` times on the card with K3's plain version
    barred. Run 1 records each LM call's K3 launches (they must equal its
    iterations x its VGICP factors; the rest, two a retired VGICP factor and
    one a realized loop edge) and, with count_syncs, the synchronizing
    calls an update (the times are then taken from run 2); every run equal
    to run 1 bit for bit; every update's poses held to the JAX package's
    (jax_ref["poses"]) within GICP_BOUND_M and _RAD or GICP_SHIFT_MARGIN x
    the update's order shift; windows, frozen keys, num_compiles and
    compiled equal to the JAX package's. -> run 1's records, its optimizer,
    the loop factor and the K3 launches over the runs."""
    import contextlib
    import warnings

    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.optim import isam2 as isam2_mod
    from gtsam_points_tpu_torch.utils import se3

    api = _card_api(torch)
    recorder = _LMRecorder(FL, isam2_mod.optimize_lm)
    per_update = []

    @contextlib.contextmanager
    def around(i):
        calls, launches = len(recorder.calls), FL.launches
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if count_syncs:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
        per_update.append((FL.launches - launches, recorder.calls[calls:], syncs))

    _zero_counts(FL)
    all_runs = []
    with mock.patch.object(FL, "linearize_fused_plain", side_effect=AssertionError("K3's plain version ran")):
        with mock.patch.object(isam2_mod, "optimize_lm", recorder):
            records, isam, loop = isam2_stream(api, frames, T_true, smoother, on_update=around)
        all_runs.append(records)
        for _ in range(runs - 1):
            all_runs.append(isam2_stream(api, frames, T_true, smoother)[0])
    launches = FL.launches
    lm_ok, lm_launches, total_run1, n_calls = True, 0, 0, 0
    for total, calls, _ in per_update:
        total_run1 += total
        n_calls += len(calls)
        for got, n_k3, iters in calls:
            lm_launches += got
            lm_ok &= got == int(iters) * n_k3 and int(iters) > 0
    extra = total_run1 - lm_launches
    extra_expected = 2 * len(isam.history_edges) + len(isam.loop_edges)
    same = all(len(r) == len(records) and all(
        (a["estimates"].view("int32") == b["estimates"].view("int32")).all() for a, b in zip(r, records))
        for r in all_runs[1:])
    gaps = []
    for u, rows in enumerate(_stream_rows(records)):
        rot, trans = se3.pose_error(_rows_to_poses(torch, jax_ref["poses"][u]), _rows_to_poses(torch, rows))
        bound_m, bound_rad = _shift_bound(torch, [shift_m[u]], [shift_rad[u]])
        gaps.append((float(trans.max()), float(rot.max()), float((trans / bound_m[0]).max()),
                     float((rot / bound_rad[0]).max())))
    keys_same = len(records) == len(jax_ref["poses"]) and all(
        r[k] == jax_ref[k][u] for u, r in enumerate(records) for k in ("window", "frozen", "num_compiles", "compiled"))
    timed = all_runs[-1] if count_syncs and runs > 1 else records
    # the steady state: the updates before the loop that marginalize a pose out of a full window; the
    # port runs eagerly, so an update that meets a structure new to the JAX package builds nothing here
    steady = [r["ms"] for r, r1, r0 in zip(timed[1:-1], records[1:], records)
              if len(r1["window"]) == ISAM2_WINDOW and len(r1["frozen"]) > len(r0["frozen"])]
    all_ms = ", ".join(f"{r['ms']:.1f}" for r in timed)
    moved = max(float(abs(records[-1]["estimates"][k][:3, 3] - records[-2]["estimates"][k][:3, 3]).max())
                for k in records[-2]["frozen"])
    syncs = f"synchronizing calls an update {[s for _, _, s in per_update]}; " if count_syncs else ""
    log(f"[{tag}] {len(records) - 1} updates and the loop closure (0, {len(frames) - 1}), {runs} run(s): runs equal bit "
        f"for bit {same}; K3 launches {launches} over the runs, run 1's {total_run1}: LM calls {n_calls}, each at its "
        f"iterations x its VGICP factors {lm_ok} ({lm_launches}), the rest {extra} (2 a retired VGICP factor + 1 a "
        f"realized loop edge = {extra_expected}), K3's plain version not called; windows, frozen keys, num_compiles and "
        f"compiled equal to the JAX package's {keys_same} (num_compiles {records[-1]['num_compiles']}); against the JAX "
        f"package's poses max gap {max(g[0] for g in gaps):.3e} m {max(g[1] for g in gaps):.3e} rad, the largest over "
        f"its bound {max(g[2] for g in gaps):.3f} in m {max(g[3] for g in gaps):.3f} in rad; ms an update (host clock, "
        f"run {len(all_runs) if timed is not records else 1}): steady-state (a pose marginalized out of a full "
        f"window, before the loop) median "
        f"{statistics.median(steady) if steady else float('nan'):.3f} over {len(steady)} updates, the loop update "
        f"{timed[-1]['ms']:.3f}, all {all_ms}; {syncs}iterations {[r['iterations'] for r in records]}; the relax moved "
        f"the frozen poses by up to {moved:.6f} m")
    if not same:
        raise AssertionError(f"{tag}: two card runs differ")
    if not lm_ok or extra != extra_expected or not lm_launches:
        raise AssertionError(f"{tag}: K3 launches differ from the LM iterations x the factors")
    if not keys_same:
        raise AssertionError(f"{tag}: windows, frozen keys or compiles differ from the JAX package's")
    if max(max(g[2], g[3]) for g in gaps) > 1.0:
        raise AssertionError(f"{tag}: an estimate is further from the JAX package's than its bound")
    return {"records": records, "isam": isam, "loop": loop, "launches": launches}


def phase_isam2(torch, frames, T_true) -> dict:
    """Phase 26: the incremental_isam2_slam protocol through ISAM2Ext on the
    card (`_held_stream`), then K3 held to its plain version (`hold_k3`) on
    the loop factor's payload at the relaxed poses. -> K3's launches, the
    optimizer."""
    out = _held_stream(torch, "isam2", frames, T_true, ISAM2_JAX, ISAM2_ORDER_SHIFT_M, ISAM2_ORDER_SHIFT_RAD, False,
                       ISAM2_RUNS, True)
    P = _rows_to_poses(torch, [T[:3].reshape(12).tolist() for T in out["records"][-1]["estimates"]])
    loop = out["loop"]
    hold_k3(torch, "isam2-k3", f"loop factor {loop.keys} at the relaxed poses", loop.k3_inputs(P, loop.correspondences(P)))
    return out


def phase_fixed_lag(torch, frames, T_true, isam) -> dict:
    """Phase 27: the same stream through FixedLagSmoother (`_held_stream`,
    one run), then cg_solve on phase 26's last window system against
    torch.linalg.solve within CG_TOL x max|x|, its iterations."""
    import numpy as np

    from gtsam_points_tpu_torch.factors.base import remap_keys
    from gtsam_points_tpu_torch.optim import FactorGraph
    from gtsam_points_tpu_torch.optim.solvers import cg_solve

    out = _held_stream(torch, "fixed-lag", frames, T_true, FIXED_LAG_JAX, ISAM2_ORDER_SHIFT_M,
                       ISAM2_ORDER_SHIFT_RAD, True, 1, False)
    mapping = {k: i for i, k in enumerate(isam.window)}
    graph = FactorGraph([remap_keys(f, mapping) for f in isam.factors], num_poses=len(isam.window))
    poses = torch.from_numpy(np.stack([isam.estimates[k] for k in isam.window])).cuda()
    A, b, _ = graph.linearize_full(poses)
    x_ref = torch.linalg.solve(A, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, iters = cg_solve(A, b, return_iterations=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = float((x - x_ref).abs().max() / x_ref.abs().max().clamp(min=1e-30))
    log(f"[cg] phase 26's last window system ({A.shape[0]}x{A.shape[1]}, window {isam.window}): cg_solve against "
        f"torch.linalg.solve {err:.3e} x max|x| (bound {CG_TOL}), iterations {int(iters)}, ms {ms:.3f} (host clock)")
    if err > CG_TOL:
        raise AssertionError("cg_solve differs from the dense solve")
    return out


def _held_to_jax(torch, label: str, poses, jax_rows, shift, use_shift: bool = True) -> str:
    """poses [P, 4, 4] on the card against the JAX package's (top-three-row
    constants) within GICP_BOUND_M and _RAD, or GICP_SHIFT_MARGIN x the JAX
    package's own order shift (m, rad) where that is larger and `use_shift`
    holds (else the shift is printed only); raises past it. -> the line's
    text."""
    from gtsam_points_tpu_torch.utils import se3

    rot, trans = se3.pose_error(_rows_to_poses(torch, jax_rows), poses.reshape(-1, 4, 4))
    margin = GICP_SHIFT_MARGIN if use_shift else 0.0
    bound_m, bound_rad = max(GICP_BOUND_M, margin * shift[0]), max(GICP_BOUND_RAD, margin * shift[1])
    text = (f"against the JAX package's {float(trans.max()):.3e} m {float(rot.max()):.3e} rad (bounds {bound_m:.3e} m "
            f"{bound_rad:.3e} rad; JAX's order shift {shift[0]:.3e} m {shift[1]:.3e} rad"
            f"{'' if use_shift else ', printed only: the same point order'})")
    if not (float(trans.max()) <= bound_m and float(rot.max()) <= bound_rad):
        raise AssertionError(f"{label}: {text}")
    return text


def _refine_on_card(torch, target, source, T0):
    """demo_global_registration's refine on the card: the source moved by
    the coarse pose T0, a unary GICP factor, REFINE_ITERATIONS LM
    iterations from I. -> (T_fine, the LM's result, the factor, ms)."""
    from gtsam_points_tpu_torch.factors import make_gicp_factor
    from gtsam_points_tpu_torch.optim import FactorGraph, LMParams, optimize_lm
    from gtsam_points_tpu_torch.types.frame import transform_frame

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factor = make_gicp_factor(-1, 0, target, transform_frame(T0, source), max_corr_dist=REFINE_MAX_CORR)
    graph = FactorGraph(num_poses=1).add(factor)
    res = optimize_lm(graph, torch.eye(4, device="cuda")[None], LMParams(max_iterations=REFINE_ITERATIONS))
    T_fine = res.poses[0] @ T0
    torch.cuda.synchronize()
    return T_fine, res, factor, (time.perf_counter() - t0) * 1e3


def phase_global_registration(torch, loop: dict, T_true) -> dict:
    """Phase 28: demo_global_registration on phase 25's frames and FPFH, the
    near pair GNC_NEAR_PAIR and the far pair (0, GRAPH_POSES - 1):
    estimate_pose_ransac (RANSAC_ITERATIONS hypotheses) on the card's
    features, the main path, timed (median of FPFH_REPS calls, host clock)
    with its synchronizing calls counted; then on the CPU port's features
    and the same generator draws, card against the CPU port, the pose within
    RANSAC_TOL_M and _RAD or, where another hypothesis won, an equal score
    (a tie); then the GICP refine from the coarse pose the JAX package's
    refine started from (the CPU port's RANSAC pose, RANSAC_*_START, and
    the JAX GNC pose), on K3 with its plain version barred, its launches
    equal to the LM iterations, held to the JAX package's refined pose by
    `_held_to_jax`; the demo's chain, the refine from the card's own RANSAC
    pose, held to the refine from RANSAC_START within GICP_BOUND_M and _RAD;
    K3 held to its plain version on each refine's final payload
    (`hold_k3`); voxelmap_overlap and overlap_auto of each refined
    pair, card against the CPU port, equal. -> K3's launches and the times."""
    import numpy as np

    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.ops.voxelmap import build_voxelmap, voxelmap_overlap
    from gtsam_points_tpu_torch.registration import (
        RANSACParams,
        estimate_pose_ransac,
        estimate_pose_ransac_from_draws,
        ransac_draws,
    )
    from gtsam_points_tpu_torch.types.frame_funcs import overlap_auto
    from gtsam_points_tpu_torch.utils import se3

    card, cpu, feats, cpu_feats = loop["card"], loop["cpu"], loop["feats"], loop["cpu_feats"]
    params = RANSACParams(max_iterations=RANSAC_ITERATIONS)
    out = {"launches": 0, "ransac_ms": {}, "refine_ms": {}, "syncs": {}}
    for name, pair in (("near", GNC_NEAR_PAIR), ("far", loop["far"])):
        a, b = pair
        truth = torch.from_numpy((np.linalg.inv(T_true[a]) @ T_true[b]).astype(np.float32)).cuda()

        def ransac():
            return estimate_pose_ransac(card[a], card[b], feats[a], feats[b], params, device="cuda")

        res, syncs = _syncs(torch, ransac)
        again, ms = _host_median_ms(torch, ransac)
        same = _bits_differ(torch, (again.T_target_source,), (res.T_target_source,)) == 0
        rot_t, trans_t = se3.pose_error(truth, res.T_target_source)
        jax_rot, jax_trans = se3.pose_error(_rows_to_poses(torch, [RANSAC_JAX[name]["pose"]])[0], res.T_target_source)
        out["ransac_ms"][name], out["syncs"][name] = ms, syncs
        log(f"[global] RANSAC {name} pair, frame {a} <- frame {b}, {RANSAC_ITERATIONS} hypotheses on the card's "
            f"FPFH: against the truth {float(trans_t):.6f} m {float(rot_t):.6f} rad, inlier rate "
            f"{float(res.inlier_rate):.6f}; median ms {ms:.3f} over {FPFH_REPS} calls (host clock, synchronized), "
            f"repeats equal bit for bit {same}; synchronizing calls in one call {syncs}; the JAX package's pose from "
            f"its own threefry draws (recorded, not held: torch cannot make those draws) lies {float(jax_trans):.3e} m "
            f"{float(jax_rot):.3e} rad from it, inlier rate {RANSAC_JAX[name]['inlier']:.6f}")
        if not same or not bool(torch.all(torch.isfinite(res.T_target_source))):
            raise AssertionError(f"global registration: the {name} RANSAC on the card is not repeatable or not finite")

        # the same draws and the CPU port's features: card against the CPU port
        cand, score_idx = ransac_draws(params, card[b].capacity)
        ref = estimate_pose_ransac_from_draws(cpu[a], cpu[b], cpu_feats[a], cpu_feats[b], params, cand, score_idx)
        got = estimate_pose_ransac_from_draws(card[a], card[b], cpu_feats[a].cuda(), cpu_feats[b].cuda(), params,
                                              cand.cuda(), score_idx.cuda())
        rot, trans = se3.pose_error(ref.T_target_source, got.T_target_source.cpu())
        close = float(trans) <= RANSAC_TOL_M and float(rot) <= RANSAC_TOL_RAD
        tie = float(got.inlier_rate) == float(ref.inlier_rate)
        start_rot, start_trans = se3.pose_error(_rows_to_poses(torch, [RANSAC_START[name]])[0].cpu(),
                                                ref.T_target_source)
        log(f"[global] RANSAC {name} pair on the CPU port's features and the same draws, card against the CPU port: "
            f"{float(trans):.3e} m {float(rot):.3e} rad (bounds {RANSAC_TOL_M} m {RANSAC_TOL_RAD} rad), inlier rates "
            f"{float(got.inlier_rate):.6f} and {float(ref.inlier_rate):.6f}"
            + ("" if close else " (another hypothesis won: the scores must tie)")
            + f"; the CPU port's pose here lies {float(start_trans):.3e} m {float(start_rot):.3e} rad from the refine's "
            f"start RANSAC_START (the CPU port's pose on its own frames)")
        if not (close or tie):
            raise AssertionError(f"global registration: the {name} RANSAC on the card differs from the CPU port's")

        # the refines, each from the coarse pose the JAX package's refine started from
        target_map, target_map_cpu = build_voxelmap(card[a], 1.0), build_voxelmap(cpu[a], 1.0)
        source_map, source_map_cpu = build_voxelmap(card[b], 1.0), build_voxelmap(cpu[b], 1.0)
        fine = {}
        for start, rows in (("ransac", RANSAC_START[name]), ("gnc", GNC_NEAR_JAX_POSE if name == "near"
                                                                  else GNC_JAX_POSE), ("card", None)):
            # "card": the demo's chain, the refine from the card's own RANSAC pose, held to the refine from
            # RANSAC_START within GICP_BOUND_M and _RAD
            T0 = res.T_target_source if rows is None else _rows_to_poses(torch, [rows])[0]
            _zero_counts(FL)
            with mock.patch.object(FL, "linearize_fused_plain", side_effect=AssertionError("K3's plain version ran")):
                T_fine, lm, factor, ms = _refine_on_card(torch, card[a], card[b], T0)
            iters, launches = int(lm.status.num_iterations), FL.launches
            out["launches"] += launches
            fine[start], out["refine_ms"][f"{name}_{start}"] = T_fine, ms
            rot_t, trans_t = se3.pose_error(truth, T_fine)
            if rows is None:
                rot, trans = se3.pose_error(fine["ransac"], T_fine)
                held = (f"against the refine from RANSAC_START {float(trans):.3e} m {float(rot):.3e} rad (bounds "
                        f"{GICP_BOUND_M} m {GICP_BOUND_RAD} rad)")
                if float(trans) > GICP_BOUND_M or float(rot) > GICP_BOUND_RAD:
                    raise AssertionError(f"global registration: the {name} refine from the card's RANSAC pose: {held}")
            else:
                held = _held_to_jax(torch, f"global registration: the {name} refine from {start}", T_fine,
                                    [REFINE_JAX[name][start]], REFINE_ORDER_SHIFT[name][start])
            log(f"[global] GICP refine of the {name} pair from the {start} pose: {iters} LM iterations, K3 launches "
                f"{launches} (must equal them), K3's plain version not called, ms {ms:.3f} (host clock, "
                f"synchronized); against the truth {float(trans_t):.6f} m {float(rot_t):.6f} rad; {held}")
            if launches != iters or iters == 0:
                raise AssertionError(f"global registration: K3 launched {launches} times in {iters} LM iterations")
            hold_k3(torch, "global", f"the {name} refine from {start} at its final pose",
                    factor.k3_inputs(lm.poses, factor.correspondences(lm.poses)))
            # the refined pair's overlap, card against the CPU port
            ov = (float(voxelmap_overlap(target_map, card[b], T_fine)),
                  float(voxelmap_overlap(target_map_cpu, cpu[b], T_fine.cpu())))
            eye = torch.eye(4, device="cuda")
            auto = (float(overlap_auto([target_map, source_map], card[b], [T_fine, eye])),
                    float(overlap_auto([target_map_cpu, source_map_cpu], cpu[b], [T_fine.cpu(), eye.cpu()])))
            log(f"[global] overlap of the {name} pair at the refined {start} pose: voxelmap_overlap card {ov[0]:.6f} "
                f"CPU port {ov[1]:.6f}; overlap_auto (target's map at the pose, source's at the identity) card "
                f"{auto[0]:.6f} CPU port {auto[1]:.6f} (each pair must be equal)")
            if ov[0] != ov[1] or auto[0] != auto[1]:
                raise AssertionError("global registration: an overlap on the card differs from the CPU port's")
    return out


def phase_scan_factors(torch) -> dict:
    """Phase 29: LOAM and CT-ICP on the scan scene (scan_world). LOAM: scans
    0 and 1 (loam_clouds) through make_loam_factor with and without
    scan-line validation, a prior, LOAM_ITERATIONS LM iterations from the
    identity; CT-ICP: ct_clouds' target and motion-distorted source with
    kNN features, make_ct_icp_factor in CT_MODES, a prior, CT_ITERATIONS LM
    iterations from the identity, then deskew, with the RMSE of the source
    against the target before and after (brute_force_knn). Every pose held
    to the JAX package's by `_held_to_jax` (LOAM's to the floor alone), and
    the gap between the validated and plain LOAM poses to the JAX package's
    gap; ms a registration (host clock, synchronized). -> the times."""
    import numpy as np

    from gtsam_points_tpu_torch.factors import PriorFactor, deskew, make_ct_icp_factor, make_loam_factor
    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs
    from gtsam_points_tpu_torch.ops.hash_grid import brute_force_knn
    from gtsam_points_tpu_torch.optim import FactorGraph, LMParams, optimize_lm
    from gtsam_points_tpu_torch.types.frame import make_frame
    from gtsam_points_tpu_torch.utils import se3

    t0 = time.perf_counter()
    T, clouds = loam_clouds()
    target, raw, times = ct_clouds()
    log(f"[scan] the scan scene: {len(clouds[0][0])} plane and {len(clouds[0][1])} edge points a scan, made in "
        f"{time.perf_counter() - t0:.3f} s (numpy, host)")
    eye = torch.eye(4, device="cuda")

    def run(factor, weight: float, iterations: int):
        graph = FactorGraph(num_poses=2)
        graph.add(PriorFactor(prior=eye, weights=torch.full((6,), weight, device="cuda"), key=0))
        graph.add(factor)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = optimize_lm(graph, torch.stack([eye, eye]), LMParams(max_iterations=iterations))
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    out, loam = {}, {}
    frames = [[make_frame(c, device="cuda") for c in pair] for pair in clouds]
    truth = torch.from_numpy((np.linalg.inv(T[0]) @ T[1]).astype(np.float32)).cuda()
    for validate in (False, True):
        key = "loam_validated" if validate else "loam_plain"
        (tp, te), (sp, se) = frames
        factor = make_loam_factor(0, 1, te, tp, se, sp, max_corr_dist=LOAM_MAX_CORR, grid_leaf=LOAM_GRID_LEAF,
                                  enable_correspondence_validation=validate)
        res, ms = run(factor, LOAM_PRIOR_WEIGHT, LOAM_ITERATIONS)
        out[key], loam[key] = ms, res.poses[1]
        rot_t, trans_t = se3.pose_error(truth, res.poses[1])
        held = _held_to_jax(torch, f"scan factors: {key}", res.poses[1], [SCAN_JAX_POSES[key]], SCAN_ORDER_SHIFT[key],
                            use_shift=False)
        log(f"[scan] LOAM pair, validation {validate}: {int(res.status.num_iterations)} LM iterations, ms {ms:.3f}; "
            f"against the truth {float(trans_t):.6f} m {float(rot_t):.6f} rad; {held}")
    jax_loam = _rows_to_poses(torch, [SCAN_JAX_POSES["loam_plain"], SCAN_JAX_POSES["loam_validated"]])
    gap_rot, gap_m = (float(x) for x in se3.pose_error(loam["loam_plain"], loam["loam_validated"]))
    jax_rot, jax_m = (float(x) for x in se3.pose_error(jax_loam[0], jax_loam[1]))
    log(f"[scan] LOAM, validated against plain pose: card {gap_m:.6e} m {gap_rot:.6e} rad, the JAX package's "
        f"{jax_m:.6e} m {jax_rot:.6e} rad (must agree within {GICP_BOUND_M} m {GICP_BOUND_RAD} rad)")
    if abs(gap_m - jax_m) > GICP_BOUND_M or abs(gap_rot - jax_rot) > GICP_BOUND_RAD:
        raise AssertionError("scan factors: scan-line validation moves the card's LOAM pose unlike the JAX package's")

    def rmse(points, mask, tgt) -> float:
        _, sq, valid = brute_force_knn(tgt.points, tgt.mask, points, mask, k=1)
        ok = valid[:, 0] & mask
        return float(torch.sqrt(torch.sum(torch.where(ok, sq[:, 0], 0.0)) / torch.clamp(ok.sum(), min=1)))

    prep = lambda f: estimate_normals_covs(f, k=CT_FEATURE_K, grid_leaf=CT_FEATURE_LEAF)  # noqa: E731
    tgt = prep(make_frame(target, device="cuda"))
    src = prep(make_frame(raw, times=times, device="cuda"))
    motion = se3.se3_exp(torch.tensor(CT_MOTION, device="cuda"))
    for mode in CT_MODES:
        key = f"ct_{mode}"
        factor = make_ct_icp_factor(0, 1, tgt, src, gicp=mode == "gicp", point_to_plane=mode == "plane",
                                    max_corr_dist=CT_MAX_CORR, grid_leaf=CT_GRID_LEAF)
        res, ms = run(factor, CT_PRIOR_WEIGHT, CT_ITERATIONS)
        out[key] = ms
        held = _held_to_jax(torch, f"scan factors: {key}", res.poses, SCAN_JAX_POSES[key], SCAN_ORDER_SHIFT[key])
        desk = deskew(res.poses[0], res.poses[1], factor.source)
        rot_m, trans_m = se3.pose_error(motion, se3.se3_inverse(res.poses[0]) @ res.poses[1])
        log(f"[scan] CT-ICP {mode}: {int(res.status.num_iterations)} LM iterations, ms {ms:.3f}; the sweep's motion "
            f"against the truth {float(trans_m):.6f} m {float(rot_m):.6f} rad; deskew RMSE against the target before "
            f"{rmse(src.points, src.mask, tgt):.6f} m after {rmse(desk.points, desk.mask, tgt):.6f} m; {held}")
    return out


def phase_bundle_adjustment(torch) -> dict:
    """Phase 30: demo_bundle_adjustment on the scan scene (ba_problem:
    BA_KEYS keyframes, BA_PLANES plane and BA_EDGES edge features), priors
    of 1e6 on key 0 and 1e2 on key 1, BA_ITERATIONS LM iterations from the
    noised poses, in EVM mode (make_evm_factor, plane and edge) and LSQ mode
    (make_lsq_ba_factor, planes); the poses held to the JAX package's by
    `_held_to_jax`; the demo's report (the largest rotation and translation
    error of each pose relative to pose 0 against the truth), ms a run."""
    from gtsam_points_tpu_torch.factors import PriorFactor, make_evm_factor, make_lsq_ba_factor
    from gtsam_points_tpu_torch.optim import FactorGraph, LMParams, optimize_lm
    from gtsam_points_tpu_torch.utils import se3

    t0 = time.perf_counter()
    problem = ba_problem()
    log(f"[ba] {BA_KEYS} keyframes, {len(problem['plane_feats'])} plane and {len(problem['edge_feats'])} edge features, "
        f"made in {time.perf_counter() - t0:.3f} s (numpy, host)")
    T_gt = torch.from_numpy(problem["T_gt"]).cuda()
    out = {}
    for mode in ("evm", "lsq"):
        graph = FactorGraph(num_poses=BA_KEYS)
        graph.add(PriorFactor(prior=T_gt[0], weights=torch.full((6,), 1e6, device="cuda"), key=0))
        graph.add(PriorFactor(prior=T_gt[1], weights=torch.full((6,), 1e2, device="cuda"), key=1))
        if mode == "evm":
            for kind in ("plane", "edge"):
                for f in problem[f"{kind}_feats"]:
                    graph.add(make_evm_factor(kind, f, device="cuda"))
        else:
            for f in problem["plane_feats"]:
                graph.add(make_lsq_ba_factor(ba_moments(f), device="cuda"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = optimize_lm(graph, torch.from_numpy(problem["start"]).cuda(), LMParams(max_iterations=BA_ITERATIONS))
        torch.cuda.synchronize()
        out[mode] = ms = (time.perf_counter() - t) * 1e3
        held = _held_to_jax(torch, f"bundle adjustment: {mode}", res.poses, BA_JAX_POSES[mode], BA_ORDER_SHIFT[mode])
        rel_est = se3.se3_inverse(res.poses[0])[None] @ res.poses
        rel_gt = se3.se3_inverse(T_gt[0])[None] @ T_gt
        rot, trans = se3.pose_error(rel_gt, rel_est)
        log(f"[ba] {mode.upper()}: {len(graph)} factors, {int(res.status.num_iterations)} LM iterations, ms {ms:.3f}; "
            f"max rot err {float(rot.max()):.4f} rad, max trans err {float(trans.max()):.4f} m (the demo's report); "
            f"{held}")
    return out


def phase_data_model(torch, main_map) -> None:
    """Phase 31: the data model on the card against the CPU port, bit for
    bit: merge_frames (with aux, pad to a capacity), pad_frame (pad and
    truncate), sort_by_voxel_key and sample on phase 4's scans with times
    and aux attributes; insert_frame_fast of phase 4's last scan (at its
    odometry pose) into phase 4's final map, every field and the miss
    fraction; a save_voxelmap / load_voxelmap round trip of that map through
    build/ (the file removed after)."""
    import numpy as np

    from gtsam_points_tpu_torch.ops.voxelmap import GaussianVoxelMap, insert_frame_fast, load_voxelmap, save_voxelmap
    from gtsam_points_tpu_torch.types.frame import make_frame, merge_frames, pad_frame, transform_frame
    from gtsam_points_tpu_torch.types.frame_funcs import sample, sort_by_voxel_key

    vmap, last, pose = main_map
    rng = np.random.RandomState(31)
    pts = [last.points[: 20000 - 1000 * i].cpu().numpy() for i in range(3)]
    attrs = [dict(times=rng.rand(len(p)).astype(np.float32), aux={"ring": rng.randint(0, 64, len(p)).astype(np.float32),
                                                                  "w": rng.rand(len(p), 2)}) for p in pts]
    card = [make_frame(p, device="cuda", **a) for p, a in zip(pts, attrs)]
    cpu = [make_frame(p, device="cpu", **a) for p, a in zip(pts, attrs)]
    idx = rng.permutation(len(pts[0]))[:9000]
    checks = {
        "merge_frames": (merge_frames(card, capacity=60000), merge_frames(cpu, capacity=60000)),
        "pad_frame (pad)": (pad_frame(card[0], 24576), pad_frame(cpu[0], 24576)),
        "pad_frame (truncate)": (pad_frame(card[1], 12000), pad_frame(cpu[1], 12000)),
        "sort_by_voxel_key (leaf 1.0)": (sort_by_voxel_key(card[0], 1.0), sort_by_voxel_key(cpu[0], 1.0)),
        "sort_by_voxel_key (leaf 4.0)": (sort_by_voxel_key(card[2], 4.0), sort_by_voxel_key(cpu[2], 4.0)),
        "sample": (sample(card[0], torch.from_numpy(idx).cuda()), sample(cpu[0], torch.from_numpy(idx))),
    }
    texts = []
    for name, (c, h) in checks.items():
        differ = _frame_bits_differ(torch, c, h)
        texts.append(f"{name} {differ}")
        if differ:
            raise AssertionError(f"data model: {name} on the card differs from the CPU port's in {differ} values")
    log("[data] card against the CPU port, values differing in any bit (-1: an attribute missing): "
        + ", ".join(texts))

    moved = transform_frame(pose, last)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, miss = insert_frame_fast(vmap, moved)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    cpu_map = GaussianVoxelMap(*(x.cpu() for x in vmap))
    ref, ref_miss = insert_frame_fast(cpu_map, _cpu_copy(moved))
    differ = {k: _bits_differ(torch, (getattr(new, k).cpu(),), (getattr(ref, k),)) for k in vmap._fields}
    log(f"[data] insert_frame_fast of phase 4's last scan into its {vmap.capacity}-voxel map: miss fraction card "
        f"{float(miss):.6f} CPU port {float(ref_miss):.6f}; fields differing in any bit {differ}; ms {ms:.3f} "
        f"(host clock, synchronized, first call)")
    if any(differ.values()) or float(miss) != float(ref_miss):
        raise AssertionError("data model: insert_frame_fast on the card differs from the CPU port's")

    path = os.path.join(ROOT, "build", "phase31_map.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        save_voxelmap(path, new)
        loaded = load_voxelmap(path, device="cuda")
    finally:
        if os.path.exists(path):
            os.remove(path)
    differ = {k: _bits_differ(torch, (getattr(loaded, k),), (getattr(new, k),)) for k in new._fields}
    log(f"[data] save_voxelmap / load_voxelmap round trip on the card: fields differing in any bit {differ}")
    if any(differ.values()):
        raise AssertionError("data model: the voxel map changed through save_voxelmap / load_voxelmap")


def _colored_frames(torch, scene: dict, device: str):
    """Phase 32's plane on `device`: target and source with intensities and
    kNN features (COLORED_FEATURE_K, _LEAF)."""
    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs
    from gtsam_points_tpu_torch.types.frame import make_frame

    return [estimate_normals_covs(make_frame(scene[k], intensities=scene["intensities"], device=device),
                                  k=COLORED_FEATURE_K, grid_leaf=COLORED_FEATURE_LEAF) for k in ("target", "source")]


def _lm_two(torch, factors, iterations: int):
    """`_pair_graph`'s prior and `factors`, optimize_lm from the identity on
    the card -> (the result, ms, host clock, synchronized)."""
    from gtsam_points_tpu_torch.optim import LMParams, optimize_lm

    graph = _pair_graph(torch, factors[0])
    for f in factors[1:]:
        graph.add(f)
    eye = torch.eye(4, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = optimize_lm(graph, torch.stack([eye, eye]), LMParams(max_iterations=iterations))
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def phase_colored(torch) -> dict:
    """Phase 32: demo_colored_registration at the demo's size (colored_scene:
    20000 points, kNN features k = 10 at leaf 1.0 on the card), a prior and
    COLORED_ITERATIONS LM iterations from the identity: GICP (K3, its plain
    version barred, launches = LM iterations, K3 held to its plain version
    on the final payload by `hold_k3`), ColoredGICP (photometric weight
    COLORED_PHOTOMETRIC_WEIGHT), and the color consistency factor beside
    the GICP factor (K3 launches = LM iterations); each pose held to the
    JAX package's by `_held_to_jax` on the same point order (the order
    shift printed only), the ColoredGICP-GICP gap held to the JAX
    package's, the demo's report (errors against the truth) printed; then
    test_voxelmap's colored GICP against a voxel map's frame
    (surface_scene, leaf SURFACE_LEAF, with normals), held the same way; estimate_intensity_gradients_ivox and its lookup on that map, card
    against the CPU port within IVOX_TOL x max|ref|; ms a registration and
    a gradient estimate. -> K3's launches by run and the times."""
    from gtsam_points_tpu_torch.factors import (
        estimate_intensity_gradients,
        estimate_intensity_gradients_ivox,
        lookup_intensity_gradients_ivox,
        make_color_consistency_factor,
        make_colored_gicp_factor,
        make_gicp_factor,
    )
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.ops.voxelmap import GaussianVoxelMap, build_voxelmap
    from gtsam_points_tpu_torch.types.frame import make_frame
    from gtsam_points_tpu_torch.utils import se3

    scene = colored_scene()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    target, source = _colored_frames(torch, scene, "cuda")
    torch.cuda.synchronize()
    out = {"launches": {}, "ms": {}, "features_ms": (time.perf_counter() - t0) * 1e3}
    truth = torch.from_numpy(scene["T_true"]).cuda()
    kw = dict(max_corr_dist=COLORED_MAX_CORR, photometric_weight=COLORED_PHOTOMETRIC_WEIGHT)
    makers = {
        "gicp": lambda: [make_gicp_factor(0, 1, target, source, max_corr_dist=COLORED_MAX_CORR)],
        "colored_gicp": lambda: [make_colored_gicp_factor(0, 1, target, source, **kw)],
        "consistency_gicp": lambda: [make_gicp_factor(0, 1, target, source, max_corr_dist=COLORED_MAX_CORR),
                                     make_color_consistency_factor(0, 1, target, source, **kw)],
    }
    poses = {}
    for run in COLORED_RUNS:
        factors = makers[run]()
        _zero_counts(FL)
        with mock.patch.object(FL, "linearize_fused_plain", side_effect=AssertionError("K3's plain version ran")):
            res, ms = _lm_two(torch, factors, COLORED_ITERATIONS)
        iters, launches = int(res.status.num_iterations), FL.launches
        out["launches"][run], out["ms"][run] = launches, ms
        rot_t, trans_t = se3.pose_error(truth, res.poses[1])
        poses[run] = res.poses[1]
        held = _held_to_jax(torch, f"colored: {run}", res.poses[1], [COLORED_JAX_POSES[run]], COLORED_ORDER_SHIFT[run],
                            use_shift=False)
        label = "slides along the plane" if float(trans_t) > COLORED_LOCKED_M else "locked by the photometric term"
        log(f"[colored] {run}: {iters} LM iterations, K3 launches {launches}, ms {ms:.3f} (host clock, synchronized); "
            f"rot err {float(rot_t):.4f} rad, trans err {float(trans_t):.4f} m ({label}, the demo's report); {held}")
        expect = iters if run != "colored_gicp" else 0
        if launches != expect or iters == 0:
            raise AssertionError(f"colored: {run} launched K3 {launches} times in {iters} LM iterations")
        if run == "gicp":
            hold_k3(torch, "colored", "the demo's GICP at its final pose",
                    factors[0].k3_inputs(res.poses, factors[0].correspondences(res.poses)))
    jax_colored = _rows_to_poses(torch, [COLORED_JAX_POSES["gicp"], COLORED_JAX_POSES["colored_gicp"]])
    gap_rot, gap_m = (float(x) for x in se3.pose_error(poses["gicp"], poses["colored_gicp"]))
    jax_rot, jax_m = (float(x) for x in se3.pose_error(jax_colored[0], jax_colored[1]))
    log(f"[colored] ColoredGICP against GICP pose: card {gap_m:.6e} m {gap_rot:.6e} rad, the JAX package's "
        f"{jax_m:.6e} m {jax_rot:.6e} rad (must agree within {GICP_BOUND_M} m {GICP_BOUND_RAD} rad)")
    if abs(gap_m - jax_m) > GICP_BOUND_M or abs(gap_rot - jax_rot) > GICP_BOUND_RAD:
        raise AssertionError("colored: the photometric term moves the card's pose unlike the JAX package's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads = estimate_intensity_gradients(target, grid_leaf=COLORED_FEATURE_LEAF)
    torch.cuda.synchronize()
    out["gradients_ms"] = (time.perf_counter() - t0) * 1e3

    surf = surface_scene()
    vmap = build_voxelmap(make_frame(surf["target"], covs=surf["covs"], intensities=surf["intensities"],
                                     capacity=4096, device="cuda"), SURFACE_LEAF)
    src = make_frame(surf["source"], covs=surf["covs"], intensities=surf["intensities"], capacity=4096, device="cuda")
    factor = make_colored_gicp_factor(0, 1, vmap.as_frame(with_normals=True), src, max_corr_dist=SURFACE_MAX_CORR,
                                      grid_leaf=SURFACE_LEAF)
    res, ms = _lm_two(torch, [factor], SURFACE_ITERATIONS)
    out["ms"]["surface"] = ms
    rot_t, trans_t = se3.pose_error(torch.from_numpy(surf["T_true"]).cuda(), res.poses[1])
    held = _held_to_jax(torch, "colored: surface", res.poses[1], [COLORED_JAX_POSES["surface"]],
                        COLORED_ORDER_SHIFT["surface"], use_shift=False)
    log(f"[colored] colored GICP against a leaf-{SURFACE_LEAF} voxel map's frame ({int(vmap.num_voxels)} voxels, "
        f"{SURFACE_N} source points): {int(res.status.num_iterations)} LM iterations, ms {ms:.3f}; rot err "
        f"{float(rot_t):.4f} rad, trans err {float(trans_t):.4f} m; {held}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vg = estimate_intensity_gradients_ivox(vmap)
    torch.cuda.synchronize()
    out["ivox_ms"] = (time.perf_counter() - t0) * 1e3
    got, found = lookup_intensity_gradients_ivox(vmap, vg, src.points, src.mask)
    cpu_map = GaussianVoxelMap(*(x.cpu() for x in vmap))
    ref = estimate_intensity_gradients_ivox(cpu_map)
    ref_got, ref_found = lookup_intensity_gradients_ivox(cpu_map, ref, src.points.cpu(), src.mask.cpu())
    err, err_lookup = _rel_err(torch, vg, ref), _rel_err(torch, got, ref_got)
    same_found = bool(torch.equal(found.cpu(), ref_found))
    log(f"[colored] intensity gradients: per point (k = 10) on the {COLORED_N}-point target {out['gradients_ms']:.3f} "
        f"ms (finite {bool(torch.isfinite(grads).all())}); per voxel (ivox) on the surface map "
        f"{out['ivox_ms']:.3f} ms, card against the CPU port {err:.3e} x max|ref|, lookup {err_lookup:.3e} (tol "
        f"{IVOX_TOL}), found flags equal {same_found} ({int(found.sum())} found)")
    if max(err, err_lookup) > IVOX_TOL or not same_found:
        raise AssertionError("colored: the ivox gradients on the card differ from the CPU port's")
    return out


def phase_imu_sim3(torch) -> dict:
    """Phase 33: the IMU keyframe chain (imu_chain: IMU_POSES poses, a prior
    of IMU_PRIOR_WEIGHT on pose 0, a ReintegratedImuFactor of weight
    IMU_WEIGHT between neighbours with v_i from the truth, IMU_ITERATIONS LM
    iterations from the noised start): poses held to the JAX package's
    within GICP_BOUND_M and _RAD, the chained `predict` within
    IMU_PREDICT_TOL_M of JAX's, `jacfwd` of `reintegrate` in both biases
    card against the CPU port within IMU_JAC_TOL x max|ref|, ms an LM
    iteration and ms a factor's linearization (its re-integration
    included); then align_trajectories_sim3 over SIM3_POSES poses
    (sim3_trajectories), the scale within SIM3_SCALE_TOL (relative) and the
    pose within SIM3_POSE_TOL of JAX's and of the CPU port's; ms an
    alignment and its synchronizing calls."""
    import numpy as np

    from gtsam_points_tpu_torch.factors import (
        PriorFactor,
        ReintegratedImuFactor,
        align_trajectories_sim3,
        make_imu_measurements,
        reintegrate,
    )
    from gtsam_points_tpu_torch.optim import FactorGraph, LMParams, optimize_lm
    from gtsam_points_tpu_torch.utils import se3

    chain = imu_chain()
    P = len(chain["T"])

    def factors(device):
        m = make_imu_measurements(chain["stamps"], chain["accs"], chain["gyros"], device=device)
        z = torch.zeros(3, device=device)
        w = torch.full((6,), IMU_WEIGHT, device=device)
        v = torch.from_numpy(chain["v"]).to(device)
        return m, [ReintegratedImuFactor(measurements=m, v_i=v[i], bias_acc=z, bias_gyro=z, weights=w,
                                         pose_keys=(i, i + 1)) for i in range(P - 1)]

    m, fs = factors("cuda")
    T = torch.from_numpy(chain["T"]).cuda()
    graph = FactorGraph(num_poses=P)
    graph.add(PriorFactor(prior=T[0], weights=torch.full((6,), IMU_PRIOR_WEIGHT, device="cuda"), key=0))
    for f in fs:
        graph.add(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = optimize_lm(graph, torch.from_numpy(chain["start"]).cuda(), LMParams(max_iterations=IMU_ITERATIONS))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    iters = int(res.status.num_iterations)
    held = _held_to_jax(torch, "imu: the chain", res.poses, IMU_JAX_POSES, (0.0, 0.0))
    rot_t, trans_t = se3.pose_error(T, res.poses)
    Tp = T[0]
    for f in fs:
        Tp, _ = f.predict(Tp)
    pred_gap = float((Tp[:3, 3] - _rows_to_poses(torch, [IMU_JAX_PREDICT])[0, :3, 3]).abs().max())
    lin_ms = _median_ms(torch, lambda: fs[0].multi_linearize(res.poses), reps=20, warmup=2)
    ba, bg = torch.tensor([0.02, -0.01, 0.03]), torch.tensor([0.001, 0.002, -0.003])
    m_cpu, _ = factors("cpu")

    def jac(meas, a, g):
        return torch.func.jacfwd(lambda x, y: reintegrate(meas, x, y)[:3], argnums=(0, 1))(a, g)

    J, J_ref = jac(m, ba.cuda(), bg.cuda()), jac(m_cpu, ba, bg)
    jac_err = max(_rel_err(torch, a, b) for out_a, out_b in zip(J, J_ref) for a, b in zip(out_a, out_b))
    log(f"[imu] {P} keyframes, {P - 1} ReintegratedImuFactors of {len(chain['stamps'])} samples: {iters} LM iterations, "
        f"{ms:.3f} ms ({ms / max(iters, 1):.3f} ms an iteration, host clock, synchronized); a factor's "
        f"multi_linearize (its re-integration included) {lin_ms:.3f} ms; against the truth max "
        f"{float(trans_t.max()):.6f} m {float(rot_t.max()):.6f} rad; {held}; the chained predict against the JAX "
        f"package's {pred_gap:.3e} m (tol {IMU_PREDICT_TOL_M}); bias Jacobians card against the CPU port "
        f"{jac_err:.3e} x max|ref| (tol {IMU_JAC_TOL})")
    if pred_gap > IMU_PREDICT_TOL_M or jac_err > IMU_JAC_TOL:
        raise AssertionError("imu: the chained prediction or the bias Jacobians differ")

    traj = sim3_trajectories()
    a, b = torch.from_numpy(traj["a"]).cuda(), torch.from_numpy(traj["b"]).cuda()
    s, syncs = _syncs(torch, lambda: align_trajectories_sim3(a, b, iterations=SIM3_ITERATIONS))
    again, sim3_ms = _host_median_ms(torch, lambda: align_trajectories_sim3(a, b, iterations=SIM3_ITERATIONS), reps=3)
    ref = align_trajectories_sim3(a.cpu(), b.cpu(), iterations=SIM3_ITERATIONS)
    jax_pose = _rows_to_poses(torch, [SIM3_JAX["pose"]])[0]
    texts = []
    for name, (pose, scale) in (("JAX", (jax_pose, SIM3_JAX["scale"])), ("the CPU port", (ref.pose.cuda(),
                                                                                         float(ref.scale)))):
        rot, trans = se3.pose_error(pose, s.pose)
        dscale = abs(float(s.scale) - scale) / scale
        texts.append(f"against {name} scale {dscale:.3e} (relative, tol {SIM3_SCALE_TOL}), pose {float(trans):.3e} m "
                     f"{float(rot):.3e} rad (tol {SIM3_POSE_TOL})")
        if dscale > SIM3_SCALE_TOL or float(trans) > SIM3_POSE_TOL or float(rot) > SIM3_POSE_TOL:
            raise AssertionError(f"sim3: the alignment on the card differs from {name}'s")
    log(f"[sim3] align_trajectories_sim3 over {SIM3_POSES} poses, {SIM3_ITERATIONS} iterations: scale "
        f"{float(s.scale):.7f} (true {SIM3_SCALE}); median ms {sim3_ms:.3f} over 3 calls (host clock, "
        f"synchronized); synchronizing calls in one call {syncs}; repeats equal bit for bit "
        f"{_bits_differ(torch, (again.pose, again.scale), (s.pose, s.scale)) == 0}; " + "; ".join(texts))
    return {"imu_ms": ms, "imu_iterations": iters, "imu_linearize_ms": lin_ms, "sim3_ms": sim3_ms, "sim3_syncs": syncs}


def _icm_cpu(cmap):
    """An IncrementalCovarianceMap's tensors copied to the CPU."""
    return cmap._replace(**{k: v.cpu() for k, v in cmap._asdict().items() if k != "eig_stats"},
                         eig_stats=type(cmap.eig_stats)(*(x.cpu() for x in cmap.eig_stats)))


def _icm_flips(torch, card, cpu, prior_stats, ratio_sigma: float = 3.0) -> tuple:
    """Validity flags that differ between two maps after one insert from the
    same state -> (count, explained by a ratio within ICM_EDGE_TOL of the
    band's edge, explained by a kNN tie: a covariance apart by FEATURE_TOL
    x max|ref|, unexplained)."""
    from gtsam_points_tpu_torch.ops.eigh3 import eigh3

    d = card.valid.cpu() != cpu.valid
    if not bool(d.any()):
        return 0, 0, 0, 0
    idx = torch.nonzero(d)[:, 0]
    w, _ = eigh3(cpu.covs[idx])
    e = torch.clamp(w, min=1e-12)
    ratios = torch.stack([torch.log10(e[:, 1] / e[:, 0]), torch.log10(e[:, 2] / e[:, 1])], -1)
    mean, std = prior_stats.mean().cpu(), torch.clamp(prior_stats.std().cpu(), min=1e-3)
    edge = (torch.abs(ratios - mean) - ratio_sigma * std).abs().amin(-1) <= ICM_EDGE_TOL * torch.clamp(
        ratio_sigma * std.amax(), min=1.0)
    scale = float(cpu.covs.abs().max())
    tie = (card.covs.cpu()[idx] - cpu.covs[idx]).abs().amax((-2, -1)) >= FEATURE_TOL * scale
    return len(idx), int((edge & ~tie).sum()), int(tie.sum()), int((~edge & ~tie).sum())


def phase_maps(torch, scans, T_true, odo_poses) -> dict:
    """Phase 34 on phase 4's scans at their true poses. The occupancy grid:
    build_occupancy_grid of all REAL_STEPS scans merged at OCC_LEAF with the
    default block capacity, calc_overlap of each scan at its odometry pose;
    card against the CPU port, block keys, the bit words as uint32, the hash
    index and every overlap bit for bit. The incremental covariance map:
    `insert` of the scans one at a time into ICM_CAPACITY points (the ring
    wraps at the eleventh), k = ICM_K at ICM_LEAF, once for each warm-up of
    ICM_WARMUPS (with 1 the eigenvalue band gates); the CPU port replays
    one insert of each run from the card's state before it (the first with
    the default warm-up; the first that wraps, where the band gates, with
    warm-up 1; each takes ~11 s on the CPU, the whole buffer searched):
    points, mask, birth, cursor and epoch bit for bit; normals within
    FEATURE_TOL (up to sign: the map's normals are not oriented) for
    FEATURE_SHARE of the points whose smallest eigenvalue is not repeated
    (after 11 overlapping scans a point's 10 nearest neighbours are mostly
    its own noisy copies, an isotropic cloud), every other differing
    normal explained as in phase 19; covariances within FEATURE_TOL x
    max|ref| for FEATURE_SHARE of the points; the differing validity flags
    counted and each explained (`_icm_flips`);
    knn_search_valid and knn_search_force of the last scan on the final map
    against the CPU port (ties counted). ms a build, an overlap, an insert."""
    import numpy as np

    from gtsam_points_tpu_torch import interop
    from gtsam_points_tpu_torch.ops.eigh3 import eigvals3
    from gtsam_points_tpu_torch.ops.incremental_covariance import (
        empty_incremental_covariance_map,
        insert,
        knn_search_force,
        knn_search_valid,
    )
    from gtsam_points_tpu_torch.ops.occupancy import build_occupancy_grid, calc_overlap
    from gtsam_points_tpu_torch.types.frame import make_frame

    n = REAL_STEPS
    world = np.concatenate([s @ T[:3, :3].T + T[:3, 3] for s, T in zip(scans[:n], T_true[:n])]).astype(np.float32)
    pts, mask = torch.from_numpy(world).cuda(), torch.ones(len(world), dtype=torch.bool, device="cuda")
    grid, build_ms = _host_median_ms(torch, lambda: build_occupancy_grid(pts, mask, OCC_LEAF), reps=3)
    ref = build_occupancy_grid(pts.cpu(), mask.cpu(), OCC_LEAF)
    a, b = interop.occupancy_grid_to_numpy(grid), interop.occupancy_grid_to_numpy(ref)
    differ = {k: int((a[k] != b[k]).sum()) for k in a}
    frames = [make_frame(sc, device="cuda") for sc in scans[:n]]
    poses = odo_poses[:n]
    overlaps = [calc_overlap(grid, f.points, f.mask, T) for f, T in zip(frames, poses)]
    _, ov_ms = _host_median_ms(torch, lambda: calc_overlap(grid, frames[-1].points, frames[-1].mask, poses[-1]))
    ov_ref = [calc_overlap(ref, f.points.cpu(), f.mask.cpu(), T.cpu()) for f, T in zip(frames, poses)]
    ov_differ = sum(float(x) != float(y) for x, y in zip(overlaps, ov_ref))
    log(f"[occupancy] build_occupancy_grid of {len(world)} points at leaf {OCC_LEAF}: {int((grid.block_keys != 0x7FFFFFFF).sum())} "
        f"blocks of {grid.capacity}, {build_ms:.3f} ms (median of 3, host clock, synchronized); card against the "
        f"CPU port, values differing {differ}; calc_overlap of each scan at its odometry pose {ov_ms:.3f} ms, min "
        f"{min(float(x) for x in overlaps):.6f}, overlaps differing from the CPU port's {ov_differ}")
    if any(differ.values()) or ov_differ:
        raise AssertionError("occupancy: the grid or an overlap on the card differs from the CPU port's")

    out = {"occ_build_ms": build_ms, "occ_overlap_ms": ov_ms, "insert_ms": {}}
    cap_frames = [make_frame(sc @ T[:3, :3].T + T[:3, 3], device="cuda") for sc, T in zip(scans[:n], T_true[:n])]
    wrap = ICM_CAPACITY // REAL_SCAN_N  # the first insert whose ring write wraps
    final = None
    for warmup in ICM_WARMUPS:
        cmap = empty_incremental_covariance_map(ICM_CAPACITY, device="cuda")
        times = []
        replay = {0} if warmup != 1 else {wrap}
        for i, f in enumerate(cap_frames):
            before = cmap
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cmap = insert(before, f, k=ICM_K, grid_leaf=ICM_LEAF, warmup=warmup)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i not in replay:
                continue
            cpu_before = _icm_cpu(before)
            t1 = time.perf_counter()
            ref = insert(cpu_before, _cpu_copy(f), k=ICM_K, grid_leaf=ICM_LEAF, warmup=warmup)
            cpu_s = time.perf_counter() - t1
            exact = {k: int((getattr(cmap, k).cpu() != getattr(ref, k)).sum()) for k in ("points", "mask", "birth",
                                                                                           "epoch", "cursor")}
            m = ref.mask
            dn = (cmap.normals.cpu() - ref.normals).abs().amax(-1)[m]
            dn = torch.minimum(dn, (cmap.normals.cpu() + ref.normals).abs().amax(-1)[m])
            scale = float(ref.covs.abs().max())
            dcs = (cmap.covs.cpu() - ref.covs).abs().amax((-2, -1))[m] / scale
            # as phase 19: a normal past FEATURE_TOL is explained by a repeated smallest eigenvalue
            # (eigen gap under FEATURE_GAP_REL) or lies within FEATURE_GAP_EPS eps over its gap
            w = eigvals3(ref.covs[m])
            gap = (w[:, 1] - w[:, 0]) / torch.clamp(w[:, 2], min=1e-30)
            rep = gap < FEATURE_GAP_REL
            bad = dn >= FEATURE_TOL
            past = sum(_past_gap_limit(float(a), float(b), float(g)) for a, b, g in
                       zip(dn[bad & ~rep], dcs[bad & ~rep], gap[bad & ~rep]))
            share, share_det = float((~bad).float().mean()), float((~bad[~rep]).float().mean())
            covs_share = float((dcs < FEATURE_TOL).float().mean())
            flips = _icm_flips(torch, cmap, ref, before.eig_stats)
            log(f"[icm] warm-up {warmup}, insert {i}, replayed on the CPU port ({cpu_s:.1f} s) from the card's state: "
                f"values differing {exact}; normals within {FEATURE_TOL} (up to sign) for {share:.6f} of the "
                f"resident points, {share_det:.6f} of those whose smallest eigenvalue is not repeated (bound "
                f"{FEATURE_SHARE}; {int(rep.sum())} repeated, {int((bad & rep).sum())} of them differ; past the "
                f"eigen-gap limit {past}); covariances within {FEATURE_TOL} x max|ref| for {covs_share:.6f} "
                f"(largest {float(dcs.max()):.3e}); validity flags differing {flips[0]} (at the band's edge "
                f"{flips[1]}, kNN ties {flips[2]}, unexplained {flips[3]}); valid {int(cmap.valid.sum())} of "
                f"{int(cmap.mask.sum())}")
            if any(exact.values()) or share_det < FEATURE_SHARE or past or covs_share < FEATURE_SHARE or flips[3]:
                raise AssertionError(f"incremental covariance: insert {i} (warm-up {warmup}) on the card differs "
                                     f"from the CPU port's")
        out["insert_ms"][warmup] = statistics.median(times)
        log(f"[icm] {n} inserts of {REAL_SCAN_N}-point scans into {ICM_CAPACITY} points (k = {ICM_K}, leaf {ICM_LEAF}, "
            f"warm-up {warmup}): ms an insert median {statistics.median(times):.3f}, first {times[0]:.3f}, last "
            f"{times[-1]:.3f} (host clock, synchronized); cursor {int(cmap.cursor)}, epoch {int(cmap.epoch)}, "
            f"{int(cmap.mask.sum())} resident, {int(cmap.valid.sum())} valid")
        final = cmap
    q = cap_frames[-1]
    cpu_map = _icm_cpu(final)
    texts = []
    for name, fn in (("valid", knn_search_valid), ("force", knn_search_force)):
        card = fn(final, q.points, q.mask, 5)
        ref = fn(cpu_map, q.points.cpu(), q.mask.cpu(), 5)
        masks, dist, ties, other = _knn_ties(torch, card, ref, cpu_map.points, q.points.cpu())
        texts.append(f"knn_search_{name} (k = 5): valid {int(card[2].sum())}, masks differing {masks}, distances "
                     f"{dist}, indices differing by a tie {ties}, otherwise {other}")
        if masks or other:
            raise AssertionError(f"incremental covariance: knn_search_{name} on the card differs from the CPU port's")
    log("[icm] the final map (warm-up 1), the last scan as queries: " + "; ".join(texts))
    return out


def phase_segmentation(torch, scan) -> dict:
    """Phase 35: demo_segmentation's preprocessing of phase 4's scan 0
    (voxelgrid_sampling at SEG_LEAF into SEG_CAPACITY, then kNN features)
    on the card and on the CPU port; region_growing (SEG_REGION) and min_cut
    (each of SEG_MIN_CUT) from the point nearest SEG_SEED_POINT, a floor
    point. On the CPU port's frame and kNN tables copied to the card, the
    table-taking helpers give the CPU port's masks bit for bit; the public
    entry points' mask sizes against the JAX package's (SEG_JAX) and the
    CPU port's, a difference only where the card's kNN table differs from
    the CPU port's by a tie. ms each, region growing's synchronizing calls."""
    import numpy as np

    from gtsam_points_tpu_torch.ops.downsample import voxelgrid_sampling
    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs
    from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid, knn_search
    from gtsam_points_tpu_torch.segmentation import MinCutParams, RegionGrowingParams, min_cut, region_growing
    from gtsam_points_tpu_torch.segmentation.min_cut import _min_cut_from_knn
    from gtsam_points_tpu_torch.segmentation.region_growing import _region_growing_from_knn
    from gtsam_points_tpu_torch.types.frame import make_frame

    def prep(device):
        f = voxelgrid_sampling(make_frame(scan, device=device), SEG_LEAF, capacity=SEG_CAPACITY)
        return estimate_normals_covs(f, k=SEG_FEATURE_K, grid_leaf=SEG_FEATURE_LEAF)

    card, cpu = prep("cuda"), prep("cpu")
    on_card = _frame_to(cpu, "cuda")
    seed = torch.tensor(SEG_SEED_POINT, device="cuda")
    n_pts = int(card.mask.sum())
    if n_pts != int(cpu.mask.sum()) or _frame_bits_differ(torch, _frame_to(card, "cpu").replace(
            normals=None, covs=None), cpu.replace(normals=None, covs=None)):
        raise AssertionError("segmentation: voxelgrid_sampling on the card differs from the CPU port's")

    def table(frame, leaf, k, **kw):
        return knn_search(build_hash_grid(frame.points, frame.mask, leaf), frame.points, frame.mask, k, **kw)

    out, texts = {}, []
    runs = [("region_growing", RegionGrowingParams(**SEG_REGION))]
    runs += [(f"min_cut_{name}", MinCutParams(**kw)) for name, kw in SEG_MIN_CUT.items()]
    for name, p in runs:
        rg = name == "region_growing"
        kw = {"max_sq_dist": p.distance_thresh**2} if rg else {}

        def run(frame, seed_point):
            return (region_growing if rg else min_cut)(frame, seed_point, p)

        got, syncs = _syncs(torch, lambda: run(card, seed))
        _, ms = _host_median_ms(torch, lambda: run(card, seed))
        ref = run(cpu, seed.cpu())
        size, ref_size = int(got.sum()), int(ref.sum())
        # the helpers on the CPU port's frame and kNN table, copied to the card
        tbl = table(cpu, p.grid_leaf, p.k, **kw)
        if rg:
            given = _region_growing_from_knn(on_card, seed, p, tbl[0].cuda(), tbl[2].cuda()).cpu().numpy()
        else:
            given = _min_cut_from_knn(on_card, seed, p, *(x.cuda() for x in tbl))
        same = bool(np.array_equal(given, ref.cpu().numpy() if rg else ref))
        ties = _knn_ties(torch, table(card, p.grid_leaf, p.k, **kw), tbl, cpu.points, cpu.points)
        out[name] = {"ms": ms, "syncs": syncs, "size": size}
        texts.append(f"{name} {size} points (JAX {SEG_JAX[name]}, CPU port {ref_size}), {ms:.3f} ms (median of "
                     f"{FPFH_REPS}, host clock, synchronized), synchronizing calls {syncs}; on the CPU port's kNN "
                     f"table the card's mask equals the CPU port's {same}; the card's own table against the CPU "
                     f"port's: masks differing {ties[0]}, distances {ties[1]}, indices by a tie {ties[2]}, "
                     f"otherwise {ties[3]}")
        if not same:
            raise AssertionError(f"segmentation: {name} on the CPU port's table differs from the CPU port's")
        if ties[0] or ties[3] or (size != ref_size and not ties[2]):
            raise AssertionError(f"segmentation: {name} on the card differs from the CPU port's without a kNN tie")
    log(f"[segmentation] phase 4's scan 0 at leaf {SEG_LEAF}: {n_pts} points (JAX {SEG_JAX['points']}), seed near "
        f"{SEG_SEED_POINT}; " + "; ".join(texts))
    return out


# ---------------------------------------------------------------------------
# Phase 36: the distributed layer, PAR_RANKS ranks on the card over gloo
# ---------------------------------------------------------------------------


def _lin_arrays(lin) -> dict:
    """A Linearized as numpy (the inlier count as an int)."""
    out = {k: getattr(lin, k).detach().cpu().numpy() for k in ("H_tt", "H_ss", "H_ts", "b_t", "b_s", "error")}
    out["num_inliers"] = int(lin.num_inliers)
    return out


def _parallel_rank_body(rank: int, world: int, store: str, data: dict) -> dict:
    """Phase 36 on one rank: the demo registration on the sharded map, the
    map of every scan and its linearize, the factor axis. K3's plain version
    raises if anything calls it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gtsam_points_tpu_torch.factors import PriorFactor, make_vgicp_factor_batch
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.ops.downsample import voxelgrid_sampling
    from gtsam_points_tpu_torch.ops.voxelmap import build_voxelmap
    from gtsam_points_tpu_torch.optim import FactorGraph, LMParams, optimize_lm
    from gtsam_points_tpu_torch.parallel import (
        build_sharded_voxelmap,
        init_distributed,
        linearize_vgicp_sharded,
        make_mesh,
        make_vgicp_sharded_factor,
        place_sharded,
        sharded_insert_frame,
        sharded_num_voxels,
        sharded_overlap,
    )
    from gtsam_points_tpu_torch.parallel import sharding
    from gtsam_points_tpu_torch.parallel.distributed import optimize_lm_sharded, shard_factor_batch
    from gtsam_points_tpu_torch.parallel.sharded_voxelmap import _linearize_local, _source_planar
    from gtsam_points_tpu_torch.types.frame import make_frame, transform_frame

    torch.set_num_threads(1)  # eight ranks share the host's cores
    t_start = time.perf_counter()
    dev = init_distributed(rank, world, f"file://{store}", "gloo", device="cuda:0")
    out = {}

    def stage(name: str) -> None:
        if rank == 0:
            log(f"[parallel] rank 0: {name} at {time.perf_counter() - t_start:.1f} s")

    stage("joined the group")

    def counted(fn):
        """fn() timed, between barriers, with every kernel count at 0 before
        it -> (result, ms, K3 launches, other kernels' launches, collectives,
        bytes reduced)."""
        dist.barrier()
        _zero_counts(FL)
        c0, b0 = sharding.collectives, sharding.bytes_reduced
        res, ms = _host_median_ms(torch, fn, reps=1)
        others = FL.unary_launches + FL.unary_batch_launches + FL.moments_launches + FL.dense_launches
        return res, ms, FL.launches, others, sharding.collectives - c0, sharding.bytes_reduced - b0

    try:
        with mock.patch.object(FL, "linearize_fused_plain", side_effect=AssertionError("K3's plain version called")):
            eye = torch.eye(4, device=dev)
            # the distributed_mapping demo
            demo = data["demo"]
            target, source = (voxelgrid_sampling(make_frame(demo[k], capacity=PAR_SCAN_CAPACITY, device=dev),
                                                 PAR_SAMPLE_LEAF, capacity=PAR_SAMPLE_CAPACITY)
                              for k in ("target", "source"))
            mesh, mesh_ms = _host_median_ms(torch, lambda: make_mesh(axis="shard", device=dev), reps=1)
            out["setup"] = {"mesh_ms": mesh_ms, **{
                f"first_all_reduce_{where}_ms": _host_median_ms(torch, lambda: sharding.all_reduce_sum(
                    torch.zeros(122, device=where), mesh.group("shard")), reps=1)[1] for where in ("cpu", "cuda")}}
            stage("the shard mesh made and its first all-reduces done")
            svmap = place_sharded(build_sharded_voxelmap(target, PAR_LEAF, world, PAR_DEMO_SHARD_CAPACITY,
                                                         device=dev), mesh)
            graph = FactorGraph(num_poses=2)
            graph.add(PriorFactor(prior=eye, weights=torch.full((6,), PAR_PRIOR_WEIGHT, device=dev), key=0))
            graph.add(make_vgicp_sharded_factor(0, 1, svmap, source, mesh, min_voxel_points=PAR_DEMO_MIN_POINTS))
            start = torch.from_numpy(np.stack([np.eye(4, dtype=np.float32), demo["start"]])).to(dev)
            runs = []
            for _ in range(PAR_REPEATS):
                res, ms, k3, others, coll, nbytes = counted(
                    lambda: optimize_lm(graph, start, LMParams(max_iterations=PAR_DEMO_ITERATIONS)))
                runs.append({"poses": res.poses.cpu().numpy(), "iters": int(res.status.num_iterations), "ms": ms,
                             "k3": k3, "others": others, "collectives": coll, "bytes": nbytes})
            out["demo_runs"] = runs
            stage("demo registrations done")
            pose = torch.from_numpy(runs[0]["poses"][1]).to(dev)
            for name, delta in (("start", start[1]), ("final", pose)):
                out[f"demo_lin_{name}"] = _lin_arrays(linearize_vgicp_sharded(
                    svmap, source, delta, mesh, min_voxel_points=PAR_DEMO_MIN_POINTS))
            lin_ms = [counted(lambda: linearize_vgicp_sharded(svmap, source, pose, mesh,
                                                              min_voxel_points=PAR_DEMO_MIN_POINTS))[1:4]
                      for _ in range(PAR_LINEARIZE_CALLS)]
            # where a linearize's time goes: the rank's probe and K3 alone, and
            # one all-reduce of the payload's size on a CUDA and on a host tensor
            pts_p, covs6 = _source_planar(source)
            out["census"] = {
                "local_ms": [counted(lambda: _linearize_local(svmap.local, pts_p, covs6, source.mask, pose,
                                                              PAR_DEMO_MIN_POINTS))[1]
                             for _ in range(PAR_LINEARIZE_CALLS)],
                **{f"all_reduce_{where}_ms": [counted(lambda: sharding.all_reduce_sum(
                    torch.zeros(122, device=where), mesh.group("shard")))[1] for _ in range(PAR_LINEARIZE_CALLS)]
                   for where in ("cuda", "cpu")}}
            moved = transform_frame(pose, source)
            inserted, overflow = sharded_insert_frame(svmap, moved)
            out["demo_map"] = {
                "voxels_before": int(svmap.local.num_voxels), "voxels_after": int(inserted.local.num_voxels),
                "total_after": int(sharded_num_voxels(inserted)), "overflow": int(overflow),
                "overlap": float(sharded_overlap(inserted, source, pose)),
                "overlap_moved": float(sharded_overlap(inserted, moved, eye)),
                "linearize_ms": [x[0] for x in lin_ms], "linearize_k3": [x[1] for x in lin_ms],
                "linearize_others": [x[2] for x in lin_ms]}
            if rank == 0:
                out["demo_frames"] = {k: {"points": f.points.cpu().numpy(), "mask": f.mask.cpu().numpy()}
                                      for k, f in (("target", target), ("source", source), ("moved", moved))}

            stage("demo linearizes and insert done")
            # every scan at its true pose, 8 shards of PAR_MAP_SHARD_CAPACITY voxels
            scans = data["keyframes"]
            svm = place_sharded(build_sharded_voxelmap(make_frame(scans[0], device=dev), PAR_LEAF, world,
                                                       PAR_MAP_SHARD_CAPACITY, device=dev), mesh)
            overflow, insert_ms = 0, []
            for s in scans[1:]:
                frame = make_frame(s, device=dev)
                (svm, ov), ms = _host_median_ms(torch, lambda: sharded_insert_frame(svm, frame), reps=1)
                overflow += int(ov)
                insert_ms.append(ms)
            src = make_frame(data["scan_last"], device=dev)
            T_last = torch.from_numpy(data["T_last"]).to(dev)
            lin, ms, k3, others, coll, nbytes = counted(lambda: linearize_vgicp_sharded(svm, src, T_last, mesh))
            lin_ms = [counted(lambda: linearize_vgicp_sharded(svm, src, T_last, mesh))[1:4]
                      for _ in range(PAR_LINEARIZE_CALLS)]
            out["map"] = {"voxels": int(svm.local.num_voxels), "total": int(sharded_num_voxels(svm)),
                          "overflow": overflow, "insert_ms": insert_ms, "lin": _lin_arrays(lin),
                          "k3": k3 + sum(x[1] for x in lin_ms), "others": others + sum(x[2] for x in lin_ms),
                          "calls": 1 + len(lin_ms), "collectives": coll, "bytes": nbytes,
                          "linearize_ms": [x[0] for x in lin_ms]}

            stage("the map done")
            # the factor axis
            prob = data["batch"]
            vmap = build_voxelmap(make_frame(prob["target"], device=dev), PAR_LEAF, capacity=PAR_BATCH_MAP_CAPACITY)
            f = len(prob["sources"])
            batch = make_vgicp_factor_batch([vmap] * f, [make_frame(s, device=dev) for s in prob["sources"]],
                                            [-1] * f, list(range(f)), min_voxel_points=PAR_BATCH_MIN_POINTS)
            mesh_f = make_mesh(axis="factor", device=dev)
            graph = FactorGraph(num_poses=f)
            graph.add(shard_factor_batch(batch, mesh_f, "factor"))
            poses0 = torch.eye(4, device=dev).expand(f, 4, 4).contiguous()
            res, ms, k3, others, coll, nbytes = counted(lambda: optimize_lm_sharded(
                graph, poses0, mesh_f, LMParams(max_iterations=PAR_BATCH_ITERATIONS)))
            out["batch"] = {"poses": res.poses.cpu().numpy(), "iters": int(res.status.num_iterations), "ms": ms,
                            "k3": k3, "others": others, "collectives": coll, "bytes": nbytes,
                            "local_factors": graph.factors[0].local.num_factors()}
            stage("the factor axis done")
    finally:
        dist.destroy_process_group()
    return out


def _parallel_rank(rank: int, world: int, store: str, data: dict, queue) -> None:
    """A spawned rank: its results, or its traceback, go to `queue`; a
    failure also ends the process with a nonzero code."""
    import traceback

    try:
        result = _parallel_rank_body(rank, world, store, data)
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise
    queue.put((rank, "ok", result))


def _run_ranks(data: dict) -> list:
    """PAR_RANKS spawned ranks of `_parallel_rank` on the card -> their
    results by rank. Any rank that fails, dies or outlasts PAR_TIMEOUT_S
    fails the phase; every process is stopped before this returns."""
    import multiprocessing
    import queue as queue_mod
    import tempfile

    from gtsam_points_tpu_torch import _build

    ctx = multiprocessing.get_context("spawn")  # never fork a process that initialized CUDA
    q = ctx.Queue()
    results = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        procs = [ctx.Process(target=_parallel_rank, args=(r, PAR_RANKS, os.path.join(tmp, "store"), data, q))
                 for r in range(PAR_RANKS)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + PAR_TIMEOUT_S
            while len(results) < PAR_RANKS:
                try:
                    rank, status, payload = q.get(timeout=5.0)
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs) if r not in results and p.exitcode]
                    if dead:
                        raise RuntimeError(f"[parallel] ranks died without a result: {dead}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"[parallel] ranks still running after {PAR_TIMEOUT_S} s")
                    continue
                if status != "ok":
                    raise RuntimeError(f"[parallel] rank {rank} failed:\n{payload}")
                results[rank] = payload
            for p in procs:
                p.join(timeout=60)
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"[parallel] ranks exited with {bad}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return [results[r] for r in range(PAR_RANKS)]


def _check_parallel_system(torch, label: str, lins: list, args, near_optimum: bool) -> tuple:
    """Every rank's reduced system equal bit for bit to rank 0's, and rank
    0's against the replicated map's K3 on K3's inputs `args`: H_tt, H_ss,
    H_ts and the error within PAR_TOL x max|ref|; b_t and b_s too, or, at a
    pose near the optimum, within PAR_TOL of their summand scale (there b
    is a residue of large terms that cancel, and a float32 sum in another
    order is bounded relative to its terms, not to |b|); the inlier counts
    equal. -> (the largest error over max|ref|, over the summand scale)."""
    from gtsam_points_tpu_torch.factors.linearized import Linearized
    from gtsam_points_tpu_torch.ops import fused_linearize as FL

    fields = ("H_tt", "H_ss", "H_ts", "b_t", "b_s", "error")
    for r, lin in enumerate(lins[1:], 1):
        if any(lin[k].tobytes() != lins[0][k].tobytes() for k in fields) or lin["num_inliers"] != lins[0]["num_inliers"]:
            raise AssertionError(f"[parallel] {label}: rank {r}'s reduced system differs from rank 0's")
    ref = FL.linearize_fused(*args)
    got = Linearized(**{k: torch.from_numpy(lins[0][k]).to(ref.H_tt.device) for k in fields},
                     num_inliers=torch.tensor(lins[0]["num_inliers"]))
    errs = _k3_field_errors(torch, got, ref, _k3_summand_scale(torch, args))
    held = {k: e[1] if near_optimum and k in ("b_t", "b_s") else e[0] for k, e in errs.items()}
    if max(held.values()) > PAR_TOL:
        raise AssertionError(f"[parallel] {label}: against the replicated map's K3 " + ", ".join(
            f"{k} {e[0]:.3e} x max|ref|, {e[1]:.3e} of its summand scale" for k, e in errs.items()))
    if lins[0]["num_inliers"] != int(ref.num_inliers):
        raise AssertionError(f"[parallel] {label}: {lins[0]['num_inliers']} inliers, the replicated map "
                             f"{int(ref.num_inliers)}")
    return max(e[0] for e in errs.values()), max(e[1] for e in errs.values())


def phase_parallel(torch) -> dict:
    """Phase 36 (see the module docstring)."""
    import numpy as np

    from gtsam_points_tpu_torch import interop
    from gtsam_points_tpu_torch.ops import fused_linearize as FL
    from gtsam_points_tpu_torch.ops.voxelmap import build_voxelmap, insert_frame
    from gtsam_points_tpu_torch.parallel.sharded_voxelmap import _local_corr, _source_planar
    from gtsam_points_tpu_torch.parallel import build_sharded_voxelmap, sharded_insert_frame, sharded_overlap
    from gtsam_points_tpu_torch.types.frame import make_frame
    from gtsam_points_tpu_torch.utils import se3

    t0 = time.perf_counter()
    data = {**parallel_street(), "batch": parallel_batch_problem()}
    t_data = time.perf_counter() - t0
    world_scans = data["keyframes"]
    n_map = len(world_scans)
    res = _run_ranks(data)
    t_ranks = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    # every rank's poses, payloads and counts equal bit for bit to rank 0's
    for r, x in enumerate(res):
        for i, run in enumerate(x["demo_runs"]):
            if run["poses"].tobytes() != res[0]["demo_runs"][0]["poses"].tobytes():
                raise AssertionError(f"[parallel] rank {r} run {i}: demo poses differ from rank 0's first run")
        if x["batch"]["poses"].tobytes() != res[0]["batch"]["poses"].tobytes():
            raise AssertionError(f"[parallel] rank {r}: factor-axis poses differ from rank 0's")
        for k in ("total_after", "overflow", "overlap", "overlap_moved"):
            if x["demo_map"][k] != res[0]["demo_map"][k]:
                raise AssertionError(f"[parallel] rank {r}: demo map {k} differs from rank 0's")
        if (x["map"]["total"], x["map"]["overflow"]) != (res[0]["map"]["total"], res[0]["map"]["overflow"]):
            raise AssertionError(f"[parallel] rank {r}: the map's total or overflow differs from rank 0's")

    # K3 launched once a linearization on every rank, nothing else launched
    for r, x in enumerate(res):
        for run in x["demo_runs"]:
            if run["k3"] != run["iters"] or run["others"]:
                raise AssertionError(f"[parallel] rank {r}: demo K3 {run['k3']} for {run['iters']} LM iterations, "
                                     f"other kernels {run['others']}")
        b = x["batch"]
        if b["k3"] != b["iters"] * b["local_factors"] or b["others"]:
            raise AssertionError(f"[parallel] rank {r}: factor axis K3 {b['k3']} for {b['iters']} iterations x "
                                 f"{b['local_factors']} factors")
        m = x["map"]
        if m["k3"] != m["calls"] or m["others"] or x["demo_map"]["linearize_k3"] != [1] * PAR_LINEARIZE_CALLS:
            raise AssertionError(f"[parallel] rank {r}: a sharded linearize launched K3 other than once")

    # each sharded linearize against the replicated map's K3 on the card
    frames = res[0]["demo_frames"]
    target = interop.frame_from_numpy(frames["target"], device="cuda")
    source = interop.frame_from_numpy(frames["source"], device="cuda")
    pts_p, _ = _source_planar(source)

    def k3_args(vmap, src_p, mask, delta, mvp):
        """The replicated map's K3 inputs for the same source and pose."""
        found, mu, W6, _ = _local_corr(vmap, src_p, None, mask, delta, mvp)
        return src_p, mu.contiguous(), W6.contiguous(), found, delta.contiguous()

    rep = build_voxelmap(target, PAR_LEAF, capacity=PAR_RANKS * PAR_DEMO_SHARD_CAPACITY)
    start = torch.from_numpy(data["demo"]["start"]).cuda()
    pose = torch.from_numpy(res[0]["demo_runs"][0]["poses"][1]).cuda()
    errs = {name: _check_parallel_system(torch, f"demo linearize at the {name} pose",
                                         [x[f"demo_lin_{name}"] for x in res],
                                         k3_args(rep, pts_p, source.mask, delta, PAR_DEMO_MIN_POINTS), near)
            for name, delta, near in (("start", start, False), ("final", pose, True))}
    rep = build_voxelmap(make_frame(world_scans[0], device="cuda"), PAR_LEAF,
                         capacity=PAR_RANKS * PAR_MAP_SHARD_CAPACITY)
    for s in world_scans[1:]:
        rep = insert_frame(rep, make_frame(s, device="cuda"))
    last = make_frame(data["scan_last"], device="cuda")
    errs["map"] = _check_parallel_system(
        torch, "the map's linearize at the true pose", [x["map"]["lin"] for x in res],
        k3_args(rep, last.points.T.contiguous(), last.mask, torch.from_numpy(data["T_last"]).cuda(), 5.0), False)
    if int(rep.num_voxels) != res[0]["map"]["total"]:
        raise AssertionError(f"[parallel] the sharded map holds {res[0]['map']['total']} voxels, the replicated "
                             f"{int(rep.num_voxels)}")

    # overflow and voxel counts against the CPU port's stacked map, from the same points
    cpu_target = interop.frame_from_numpy(frames["target"], device="cpu")
    cpu_moved = interop.frame_from_numpy(frames["moved"], device="cpu")
    st = build_sharded_voxelmap(cpu_target, PAR_LEAF, PAR_RANKS, PAR_DEMO_SHARD_CAPACITY, device="cpu")
    before = st.num_voxels.tolist()
    st, ov = sharded_insert_frame(st, cpu_moved)
    demo_cpu = {"before": before, "after": st.num_voxels.tolist(), "overflow": int(ov),
                "overlap": float(sharded_overlap(st, cpu_moved, torch.eye(4)))}
    got = {"before": [x["demo_map"]["voxels_before"] for x in res], "after": [x["demo_map"]["voxels_after"] for x in res],
           "overflow": res[0]["demo_map"]["overflow"], "overlap": res[0]["demo_map"]["overlap_moved"]}
    if got != demo_cpu:
        raise AssertionError(f"[parallel] the demo map on the ranks {got}, the CPU port's {demo_cpu}")
    st = build_sharded_voxelmap(make_frame(world_scans[0], device="cpu"), PAR_LEAF, PAR_RANKS,
                                PAR_MAP_SHARD_CAPACITY, device="cpu")
    overflow = 0
    for s in world_scans[1:]:
        st, ov = sharded_insert_frame(st, make_frame(s, device="cpu"))
        overflow += int(ov)
    map_cpu = {"voxels": st.num_voxels.tolist(), "overflow": overflow}
    got = {"voxels": [x["map"]["voxels"] for x in res], "overflow": res[0]["map"]["overflow"]}
    if got != map_cpu:
        raise AssertionError(f"[parallel] the map on the ranks {got}, the CPU port's {map_cpu}")

    # the poses against the JAX package's
    demo_pose = res[0]["demo_runs"][0]["poses"][1]
    bound_m = max(PAR_BOUND_M, PAR_SHIFT_MARGIN * PAR_DEMO_ORDER_SHIFT[0])
    bound_rad = max(PAR_BOUND_RAD, PAR_SHIFT_MARGIN * PAR_DEMO_ORDER_SHIFT[1])
    rot, trans = se3.pose_error(_rows_to_poses(torch, [PAR_DEMO_JAX_POSE])[0].cpu(), torch.from_numpy(demo_pose))
    truth_rot, truth_trans = se3.pose_error(torch.from_numpy(data["demo"]["delta"]), torch.from_numpy(demo_pose))
    if float(trans) > bound_m or float(rot) > bound_rad:
        raise AssertionError(f"[parallel] demo pose {float(trans):.3e} m {float(rot):.3e} rad from JAX's "
                             f"(bound {bound_m:.3e} m {bound_rad:.3e} rad)")
    b_poses = torch.from_numpy(res[0]["batch"]["poses"])
    b_rot, b_trans = se3.pose_error(_rows_to_poses(torch, PAR_BATCH_JAX_POSES).cpu(), b_poses)
    b_bound_m = np.maximum(PAR_BOUND_M, PAR_SHIFT_MARGIN * np.asarray(PAR_BATCH_ORDER_SHIFT_M))
    b_bound_rad = np.maximum(PAR_BOUND_RAD, PAR_SHIFT_MARGIN * np.asarray(PAR_BATCH_ORDER_SHIFT_RAD))
    if np.any(b_trans.numpy() > b_bound_m) or np.any(b_rot.numpy() > b_bound_rad):
        raise AssertionError(f"[parallel] factor-axis poses {b_trans.tolist()} m {b_rot.tolist()} rad from JAX's")
    b_truth = se3.pose_error(torch.from_numpy(np.stack(data["batch"]["T"])), b_poses)

    # what the phase prints
    reg_ms = [run["ms"] for x in res for run in x["demo_runs"][1:]]
    run0 = res[0]["demo_runs"][0]
    batch0 = res[0]["batch"]
    log(f"[parallel] {card}: {PAR_RANKS} ranks on cuda:0 over gloo, spawned and run in {t_ranks:.1f} s")
    log(f"[parallel] the drive's scans made on the host in {t_data:.1f} s")
    log(f"[parallel] demo (distributed_mapping on the drive's scans 0 and 1, {len(data['demo']['target'])} and "
        f"{len(data['demo']['source'])} points, {int(target.num_valid())} and "
        f"{int(source.num_valid())} points after voxelgrid {PAR_SAMPLE_LEAF}): {run0['iters']} LM iterations "
        f"(JAX {PAR_DEMO_JAX_ITERATIONS}), pose 1 {float(trans):.3e} m {float(rot):.3e} rad from JAX's (bound "
        f"{bound_m:.3e} m {bound_rad:.3e} rad), {float(truth_trans):.4f} m {float(truth_rot):.5f} rad from the "
        f"truth; every rank and repeat equal bit for bit")
    first_ms = [x["demo_runs"][0]["ms"] for x in res]
    log(f"[parallel] demo registration ms (host clock, synchronized, {PAR_RANKS} ranks x {PAR_REPEATS - 1} runs after "
        f"the first): median {statistics.median(reg_ms):.3f}, min {min(reg_ms):.3f}, max {max(reg_ms):.3f}; the "
        f"first run of each rank {min(first_ms):.3f}-{max(first_ms):.3f}; "
        f"{run0['iters'] and run0['collectives'] / run0['iters']:.3f} collectives and "
        f"{run0['iters'] and run0['bytes'] / run0['iters']:.1f} bytes reduced an LM iteration "
        f"(collective_bytes_per_linearize 488); K3 {run0['k3']} launches a rank a run")
    setup = {k: (min(x["setup"][k] for x in res), max(x["setup"][k] for x in res)) for k in res[0]["setup"]}
    log("[parallel] set-up ms over the ranks (min-max): making the shard mesh (its process groups) "
        f"{setup['mesh_ms'][0]:.1f}-{setup['mesh_ms'][1]:.1f}; the group's first all-reduce on a host tensor "
        f"{setup['first_all_reduce_cpu_ms'][0]:.1f}-{setup['first_all_reduce_cpu_ms'][1]:.1f}, then its first on a "
        f"CUDA tensor {setup['first_all_reduce_cuda_ms'][0]:.1f}-{setup['first_all_reduce_cuda_ms'][1]:.1f}")
    census = {k: statistics.median([v for x in res for v in x["census"][k]]) for k in res[0]["census"]}
    log(f"[parallel] where a demo linearize goes (median ms, {PAR_RANKS} x {PAR_LINEARIZE_CALLS} calls, host clock, "
        f"synchronized): the rank's probe + K3 alone {census['local_ms']:.3f}; one all-reduce of 122 floats (488 "
        f"bytes) over gloo on a CUDA tensor {census['all_reduce_cuda_ms']:.3f}, on a host tensor "
        f"{census['all_reduce_cpu_ms']:.3f}")
    dm = res[0]["demo_map"]
    lin_ms = [v for x in res for v in x["demo_map"]["linearize_ms"]]
    log(f"[parallel] demo linearize ms (sharded probe + K3 + one all-reduce, {PAR_RANKS} x {PAR_LINEARIZE_CALLS} "
        f"calls): median {statistics.median(lin_ms):.3f}, min {min(lin_ms):.3f}, max {max(lin_ms):.3f}; against "
        f"the replicated map's K3 at the start {errs['start'][0]:.3e} x max|ref| ({errs['start'][1]:.3e} of the "
        f"summand scale), at the final pose {errs['final'][0]:.3e} x max|ref| ({errs['final'][1]:.3e})")
    log(f"[parallel] demo map: voxels a rank {[x['demo_map']['voxels_before'] for x in res]} -> after inserting "
        f"scan 1 {[x['demo_map']['voxels_after'] for x in res]} (total {dm['total_after']}, overflow {dm['overflow']}; the CPU port's "
        f"equal); overlap of scan 1 {dm['overlap']:.6f}")
    m0 = res[0]["map"]
    ins_ms = [v for x in res for v in x["map"]["insert_ms"]]
    lin_ms = [v for x in res for v in x["map"]["linearize_ms"]]
    log(f"[parallel] map of the drive's {n_map} keyframes {STREET_SPACING_M} m apart "
        f"({sum(len(w) for w in world_scans)} points) in {PAR_RANKS} shards of {PAR_MAP_SHARD_CAPACITY}: voxels a "
        f"rank {[x['map']['voxels'] for x in res]}, filled {min(x['map']['voxels'] for x in res) / PAR_MAP_SHARD_CAPACITY:.3f}"
        f"-{max(x['map']['voxels'] for x in res) / PAR_MAP_SHARD_CAPACITY:.3f} (total {m0['total']}, the "
        f"replicated map {int(rep.num_voxels)}, overflow {m0['overflow']}; the CPU port's equal); insert ms median "
        f"{statistics.median(ins_ms):.3f}; linearize of keyframe {n_map - 1} at its true pose ms median "
        f"{statistics.median(lin_ms):.3f} (min {min(lin_ms):.3f}, max {max(lin_ms):.3f}), "
        f"{errs['map'][0]:.3e} x max|ref| ({errs['map'][1]:.3e} of the summand scale) from the replicated map's, "
        f"{m0['collectives']} collective of "
        f"{m0['bytes']} bytes")
    b_ms = [x["batch"]["ms"] for x in res]
    log(f"[parallel] factor axis ({PAR_BATCH_FACTORS} VGICP factors of {PAR_BATCH_N} points, "
        f"{batch0['local_factors']} a rank): {batch0['iters']} LM iterations (JAX {PAR_BATCH_JAX_ITERATIONS}), "
        f"poses at most {float(b_trans.max()):.3e} m {float(b_rot.max()):.3e} rad from JAX's, "
        f"{float(b_truth[1].max()):.4f} m {float(b_truth[0].max()):.5f} rad from the truth; ms median "
        f"{statistics.median(b_ms):.3f} (max {max(b_ms):.3f}); {batch0['collectives'] / batch0['iters']:.3f} "
        f"collectives and {batch0['bytes'] / batch0['iters']:.1f} bytes reduced an LM iteration; K3 "
        f"{batch0['k3']} launches a rank; every rank equal bit for bit")
    log(f"[parallel] phase 36: {time.perf_counter() - t0:.1f} s")
    return {"parallel_demo": sum(x["demo_runs"][0]["k3"] for x in res),
            "parallel_demo_linearize": sum(sum(x["demo_map"]["linearize_k3"]) for x in res),
            "parallel_map_linearize": sum(x["map"]["k3"] for x in res),
            "parallel_factor_axis": sum(x["batch"]["k3"] for x in res)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="profile three steps, the pyramid, the single-scan linearize on K4 and on K5, "
                             "the batched linearize and three cluster steps, tables to PATH, PATH_pyramid, "
                             "PATH_scan, PATH_dense, PATH_batch and PATH_clusters")
    parser.add_argument("--k3-witness", metavar="TREE",
                        help="only read the K3 of the checkout at TREE on phase 3's payloads against float64, "
                             "then exit")
    parser.add_argument("--unary-witness", metavar="TREE",
                        help="only time the K1 and K5 of the checkout at TREE on phase 7's inputs, then exit")
    parser.add_argument("--sass-diff", metavar="TREE",
                        help="only build every kernel source of this checkout and of the checkout at TREE and "
                             "compare their SASS function by function, then exit")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    witness = args.k3_witness or args.unary_witness
    tree = os.path.abspath(witness) if witness else ROOT
    sys.path.insert(0, tree)
    import gtsam_points_tpu_torch  # noqa: F401  (fails outside a checkout)

    if witness:
        if not gtsam_points_tpu_torch.__file__.startswith(tree + os.sep):
            raise RuntimeError(f"gtsam_points_tpu_torch came from {gtsam_points_tpu_torch.__file__}, not {tree}")
        phase_environment(torch)
        (k3_witness if args.k3_witness else unary_witness)(torch, witness)
        return 0
    if args.sass_diff:
        phase_environment(torch)
        sass_diff(args.sass_diff)
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
    scene = _cluster_scene(torch)
    clusters = phase_cluster_inputs(torch, scene)
    phase_k1_clusters(torch, scene, clusters["source"])
    cluster_pyramid = phase_cluster_pyramid(torch, scene, clusters["source"])
    cluster_odometry = phase_cluster_odometry(torch, scene, clusters["frames"], args.profile)
    phase_hash_grid(torch, scene)
    gicp_frames = phase_knn_features(torch, scene)
    phase_k3_payloads(torch, gicp_frames, scene["priors"][0])
    pairs = phase_gicp_pairs(torch, gicp_frames, scene["priors"][0])
    frame_to_frame = phase_frame_to_frame(torch, scene)
    graph, graph_frames = phase_chain_graph(torch, scene)
    phase_pose_graph(torch)
    T_graph = scene["T_true"][:GRAPH_POSES]
    t_back = time.perf_counter()
    loop = phase_loop_detection(torch, graph_frames, T_graph)
    stream = (graph_frames[:ISAM2_POSES], T_graph[:ISAM2_POSES])
    isam2 = phase_isam2(torch, *stream)
    fixed_lag = phase_fixed_lag(torch, *stream, isam2["isam"])
    log(f"[back-end] phases 25-27: {time.perf_counter() - t_back:.1f} s")
    t_slice = time.perf_counter()
    global_reg = phase_global_registration(torch, loop, T_graph)
    phase_scan_factors(torch)
    phase_bundle_adjustment(torch)
    phase_data_model(torch, k3.pop("map"))
    log(f"[slice 13] phases 28-31: {time.perf_counter() - t_slice:.1f} s")
    t_slice = time.perf_counter()
    colored = phase_colored(torch)
    phase_imu_sim3(torch)
    T_true = k3.pop("T_true")
    phase_maps(torch, scans, T_true, k3.pop("world_poses"))
    phase_segmentation(torch, scans[0])
    log(f"[slice 14] phases 32-35: {time.perf_counter() - t_slice:.1f} s")
    parallel = phase_parallel(torch)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "linearize_fused",
        "route": "cuda",
        "source": "gtsam_points_tpu_torch/csrc/linearize_fused.cu",
        "replaces": "gtsam_points_tpu/ops/pallas_linearize.py:107",
        "launches": k3["launches"],
        "launches_by_path": {"odometry": k3["launches"], "gicp_pair": pairs["gicp"], "icp_pair": pairs["icp"],
                             "icp_plane_pair": pairs["icp_plane"], "frame_to_frame": frame_to_frame["launches"],
                             **graph, "isam2": isam2["launches"], "fixed_lag": fixed_lag["launches"],
                             "global_refine": global_reg["launches"],
                             "colored_demo_gicp": colored["launches"]["gicp"],
                             "colored_demo_consistency_gicp": colored["launches"]["consistency_gicp"],
                             **parallel},
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
        "launches_by_path": {"pyramid": pyramid["launches"], "cluster_pyramid": cluster_pyramid["launches"],
                             "cluster_odometry": cluster_odometry["launches"]},
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
