"""PyTorch port vs the JAX package: the batched VGICP factor set.

- `lookup_fetch` and `lookup_voxels` on the JAX package's voxel map carried
  across by interop: found, count, mean and the map rows bit for bit, the
  covariance within one rounding of |mean|² (XLA fuses s - mu muᵀ into
  FMAs on the CPU);
- `VGICPFactorBatch.add_to_system` at F = 4 (a unary factor, two binary
  factors on the same keys, one more binary factor) onto a nonzero system
  of three poses:
  every block of A and b within 1e-4 x max|ref|, the error, the frozen error
  of a batch of candidate pose sets, and `error`;
- a graph of a prior and the set against the graph of the prior and the
  same four factors as `VGICPFactor`s: A and b equal bit for bit (the set
  sums its blocks in the order the factors would add them), and the LM's
  poses within 1e-5 m of each other and within 1e-3 m and 1e-3 rad of the
  JAX batch graph's.

The port runs K3's plain version (CPU tensors) on the inputs JAX's
`linearize_point_system` gets: the same stacked maps and frames
(`interop.vgicp_batch_from_numpy`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors import PriorFactor as JPrior
from gtsam_points_tpu.factors import make_vgicp_factor_batch as jbatch
from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs
from gtsam_points_tpu.ops.voxelmap import build_voxelmap as jbuild
from gtsam_points_tpu.ops.voxelmap import lookup_fetch as jfetch
from gtsam_points_tpu.ops.voxelmap import lookup_voxels as jvoxels
from gtsam_points_tpu.optim import FactorGraph as JGraph
from gtsam_points_tpu.optim import optimize_lm as jlm
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import PriorFactor, VGICPFactor, make_vgicp_factor_batch
from gtsam_points_tpu_torch.ops.voxelmap import lookup_fetch, lookup_voxels
from gtsam_points_tpu_torch.optim import FactorGraph, optimize_lm
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
SYSTEM_TOL = 1e-4
TOL_M = 1e-3
TOL_RAD = 1e-3
BATCH_TOL_M = 1e-5
P = 3
LEAF = 1.0
CAPACITY = 4096
MIN_POINTS = 4.0
# pose k is scan k in scan 0's frame: a unary factor on pose 1 (scan 0's map
# as the fixed identity target), (0, 1) twice (duplicate keys accumulate),
# and (1, 2)
TARGET_KEYS = [-1, 0, 0, 1]
SOURCE_KEYS = [1, 1, 1, 2]
TARGET_SCANS = [0, 0, 0, 1]  # the scan each factor's map is built from
SOURCE_SCANS = [1, 1, 1, 2]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()} if hasattr(tree, "_asdict") else {
        k: None if getattr(tree, k) is None else np.asarray(getattr(tree, k))
        for k in ("points", "mask", "normals", "covs", "intensities", "times")}


@pytest.fixture(scope="module")
def scene():
    T_true = ring_trajectory(3, lap=100)
    scans = ring_scans(ring_world(0, 24000), T_true, scan_n=2048, seed=1)
    frames = [jax.jit(jcovs)(jmake(s)) for s in scans]
    maps = [jbuild(f, LEAF, capacity=CAPACITY) for f in frames]
    jb = jbatch([maps[i] for i in TARGET_SCANS], [frames[i] for i in SOURCE_SCANS], TARGET_KEYS, SOURCE_KEYS,
                min_voxel_points=MIN_POINTS)
    arrays = {"voxelmaps": _np(jb.voxelmaps), "sources": _np(jb.sources), "target_keys": np.asarray(jb.target_keys),
              "source_keys": np.asarray(jb.source_keys), "min_voxel_points": MIN_POINTS}
    tb = interop.vgicp_batch_from_numpy(arrays, device="cpu")
    rng = np.random.RandomState(5)
    rel = [(np.linalg.inv(T_true[0]) @ T_true[i]).astype(np.float32) for i in range(3)]
    poses = np.stack([r @ np.asarray(jse3.se3_exp(jnp.asarray(rng.uniform(-0.05, 0.05, 6).astype(np.float32))))
                      for r in rel])
    return {"jb": jb, "tb": tb, "maps": maps, "frames": frames, "poses": poses.astype(np.float32), "rel": rel}


def test_lookup_fetch_and_lookup_voxels_bit_for_bit(scene):
    jmap = scene["maps"][0]
    tmap = interop.voxelmap_from_numpy(_np(jmap), device="cpu")
    f = scene["frames"][1]
    moved = np.array(jse3.transform_points(jnp.asarray(scene["rel"][1]), f.points))
    mask = np.asarray(f.mask).copy()
    mask[::7] = False
    jout = jax.jit(jfetch)(jmap, moved, mask)
    tout = lookup_fetch(tmap, torch.from_numpy(moved), torch.from_numpy(mask))
    for t, j in zip(tout[:3], jout[:3]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # cov = s - mu muᵀ: XLA's CPU code fuses each entry into one FMA, the
    # port rounds mu_i mu_j first; the gap is one rounding of |mu|²
    mu2 = np.max(np.asarray(jout[2], np.float32) ** 2, axis=-1)
    gap = np.abs(tout[3].numpy() - np.asarray(jout[3])).max(axis=(-2, -1))
    assert np.all(gap <= np.spacing(mu2)), float((gap / np.spacing(mu2)).max())
    assert int(tout[0].sum()) > 1000
    jrow, jfound = jax.jit(jvoxels)(jmap, moved, mask)
    trow, tfound = lookup_voxels(tmap, torch.from_numpy(moved), torch.from_numpy(mask))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))


def test_add_to_system_matches_jax(scene):
    rng = np.random.RandomState(9)
    A0 = rng.randn(P, P, 6, 6).astype(np.float32)
    b0 = rng.randn(P, 6).astype(np.float32)
    poses = scene["poses"]
    cands = np.stack([poses, np.stack(scene["rel"])])

    def jax_side(A, b, p, x):
        A, b, err, efn = scene["jb"].add_to_system(A, b, p)
        return A, b, err, jnp.stack([efn(c) for c in x])

    A, b, err, errs = jax.jit(jax_side)(A0, b0, poses, cands)
    tA, tb, terr, tefn = scene["tb"].add_to_system(torch.from_numpy(A0), torch.from_numpy(b0), torch.from_numpy(poses))
    for i in range(P):
        assert _rel(tb[i], b[i]) < SYSTEM_TOL, i
        for j in range(P):
            assert _rel(tA[i, j], A[i, j]) < SYSTEM_TOL, (i, j)
    assert _rel(terr, err) < SYSTEM_TOL
    assert _rel(tefn(torch.from_numpy(cands)), errs) < SYSTEM_TOL
    assert _rel(scene["tb"].error(torch.from_numpy(poses)), jax.jit(scene["jb"].error)(poses)) < SYSTEM_TOL


def _list_factors(tb):
    """The set's four factors as VGICPFactors, on the set's own tensors."""
    out = []
    for f, (t, s) in enumerate(zip(TARGET_KEYS, SOURCE_KEYS)):
        vmap = type(tb.voxelmaps)(*(x[f] for x in tb.voxelmaps))
        src = tb.sources.replace(**{k: getattr(tb.sources, k)[f] for k in ("points", "mask", "covs")})
        out.append(VGICPFactor(voxelmap=vmap, source=src, fixed_target_pose=torch.eye(4), target_key=t, source_key=s,
                               min_voxel_points=MIN_POINTS))
    return out


def test_batch_graph_matches_list_graph_and_jax(scene):
    tb = scene["tb"]
    prior = dict(prior=torch.eye(4), weights=torch.full((6,), 1e6), key=0)
    batch_graph = FactorGraph([PriorFactor(**prior), tb], num_poses=P)
    list_graph = FactorGraph([PriorFactor(**prior)] + _list_factors(tb), num_poses=P)
    start = torch.from_numpy(scene["poses"])
    start[0] = torch.eye(4)
    Ab, bb, _, _ = batch_graph.linearize_frozen(start)
    Al, bl, _, _ = list_graph.linearize_frozen(start)
    assert torch.equal(Ab, Al) and torch.equal(bb, bl)

    rb = optimize_lm(batch_graph, start)
    rl = optimize_lm(list_graph, start)
    rot, trans = tse3.pose_error(rb.poses, rl.poses)
    assert float(trans.max()) < BATCH_TOL_M and float(rot.max()) < BATCH_TOL_M

    jg = JGraph(num_poses=P)
    jg.add(JPrior(prior=jnp.eye(4), weights=jnp.full((6,), 1e6), key=0))
    jg.add(scene["jb"])
    jr = jax.jit(lambda p: jlm(jg, p))(start.numpy())
    rot, trans = tse3.pose_error(torch.from_numpy(np.asarray(jr.poses)), rb.poses)
    assert float(trans.max()) < TOL_M and float(rot.max()) < TOL_RAD


def test_make_vgicp_factor_batch_stacks_the_port_maps(scene):
    """The port's own stacking of per-factor maps and frames gives the set
    that interop builds from the JAX set's stacked arrays."""
    tb = scene["tb"]
    maps = [interop.voxelmap_from_numpy(_np(m), device="cpu") for m in scene["maps"]]
    frames = [interop.frame_from_numpy(_np(f), device="cpu") for f in scene["frames"]]
    made = make_vgicp_factor_batch([maps[i] for i in TARGET_SCANS], [frames[i] for i in SOURCE_SCANS], TARGET_KEYS,
                                   SOURCE_KEYS, min_voxel_points=MIN_POINTS)
    for a, b in zip(made.voxelmaps, tb.voxelmaps):  # bits: the table's invalid keys are NaN as floats
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(made.sources.points, tb.sources.points) and torch.equal(made.sources.covs, tb.sources.covs)
    assert torch.equal(made.target_keys, tb.target_keys) and made.num_factors() == 4 and made.keys == ()
