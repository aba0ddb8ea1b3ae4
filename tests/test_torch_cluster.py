"""PyTorch port vs the JAX package: the source-cluster path.

The scene is a small ring world (2200 points) whose 2048-point scans see
nearly all of it, as chip_smoke.py's cluster phases see a 26k-point world
with 25k-point scans. Each test feeds the same seeded numpy input to both
packages: `cluster_source` (integers bit for bit, centroids within 1e-5 and
covariances within 2e-3 x max|ref|, the raw-moment cancellation of
ROADMAP's tolerances), `insert_clusters_incremental` (keys, voxel count,
overflow and probe-table keys bit for bit, moments within 1e-5 x max|ref|),
`VGICPClustersFactor` (H, b and error within 1e-4 x max|ref|),
`register_clusters_pyramid` (poses within 1e-3 m and 1e-3 rad) and the
cluster odometry step (the same per-pose bound over 6 steps). The port runs
K1's plain version, as CPU tensors do; the JAX package runs its XLA twin,
which its cluster path calls on every backend.

The JAX pyramid is called one stage at a time (stages pass nothing but the
pose between them), so each stage shape compiles once, as in
tests/test_torch_pyramid.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors.vgicp import VGICPClustersFactor as JClustersFactor
from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs
from gtsam_points_tpu.ops.voxelmap import build_voxelmap as jbuild
from gtsam_points_tpu.ops.voxelmap import empty_voxelmap as jempty
from gtsam_points_tpu.ops.voxelmap import insert_frame as jinsert_frame
from gtsam_points_tpu.pipelines import odometry as jodo
from gtsam_points_tpu.registration import cluster as jcl
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.types.frame import transform_frame as jtransform
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors.vgicp import VGICPClustersFactor, make_vgicp_clusters_factor
from gtsam_points_tpu_torch.ops import fused_linearize as FL
from gtsam_points_tpu_torch.ops import planar
from gtsam_points_tpu_torch.ops.voxelmap import empty_voxelmap, insert_frame
from gtsam_points_tpu_torch.pipelines import odometry as todo
from gtsam_points_tpu_torch.registration import cluster as tcl
from gtsam_points_tpu_torch.registration.pyramid import build_pyramid
from gtsam_points_tpu_torch.types.frame import make_frame as tmake
from gtsam_points_tpu_torch.types.frame import transform_frame as ttransform
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
WORLD_N = 2200
SCAN_N = 2048
N_SCANS = 7  # 6 odometry steps
CAPACITY = 2048  # clusters; the scans occupy about 1400 leaf-1.0 cells
DROP_CAPACITY = 512  # drops the cells of the highest keys
MAP_CAPACITY = 16384
N_INITS = 3
TOL_M = 1e-3
TOL_RAD = 1e-3
MOMENT_TOL = 1e-5
COV_TOL = 2e-3
SYSTEM_TOL = 1e-4


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def scene():
    world = ring_world(0, WORLD_N)
    T_true = ring_trajectory(N_SCANS, lap=100)
    scans = ring_scans(world, T_true, scan_n=SCAN_N, seed=1)
    covs = [np.asarray(jax.jit(jcovs)(jmake(s)).covs)[:SCAN_N] for s in scans]
    T_rel = (np.linalg.inv(T_true[0]) @ T_true[1]).astype(np.float32)
    return {"T_true": T_true, "scans": scans, "covs": covs, "T_rel": T_rel}


def _jax_clusters(points, covs, leaf, capacity):
    return jax.jit(jcl.cluster_source, static_argnums=(1, 2))(jmake(points, covs=covs), leaf, capacity)


def _jax_numpy(clusters) -> dict:
    return {k: np.asarray(getattr(clusters, k)) for k in ("pts_p", "covs6", "weight", "mask")}


@pytest.mark.parametrize("capacity", [CAPACITY, DROP_CAPACITY], ids=["all-cells", "drops-cells"])
def test_cluster_source_matches_jax(scene, capacity):
    pts, covs = scene["scans"][1], scene["covs"][1]
    j = _jax_numpy(_jax_clusters(pts, covs, 1.0, capacity))
    t = interop.clusters_to_numpy(tcl.cluster_source(tmake(pts, covs=covs, device="cpu"), 1.0, capacity, device="cpu"))
    n_cells = int(j["mask"].sum())
    assert (n_cells == capacity) == (capacity == DROP_CAPACITY), n_cells  # the small capacity drops cells
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_array_equal(t["weight"], j["weight"])  # the same cells, the same counts
    assert _rel(t["pts_p"], j["pts_p"]) < MOMENT_TOL
    assert _rel(t["covs6"], j["covs6"]) < COV_TOL
    assert all(a.flags.c_contiguous for a in t.values())
    if capacity == CAPACITY:
        assert float(t["weight"].sum()) == SCAN_N  # every point lands in a cluster


def _blob_cloud(rng, n_blobs=60, pts_per=40, leaf=1.0):
    """The JAX test's blobs: tight around distinct voxel centres, so every
    cluster lies wholly inside one voxel (tests/test_cluster_registration.py)."""
    centers = np.unique((rng.randint(-8, 8, (n_blobs, 3)) + 0.5) * leaf, axis=0)
    pts = centers[:, None, :] + rng.randn(centers.shape[0], pts_per, 3) * (0.05 * leaf)
    return pts.reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("case", ["ring", "blobs"])
def test_insert_clusters_incremental_matches_jax(scene, case):
    """Ring: scan 1's clusters into the map of scan 0 under the true relative
    pose. Blobs: the JAX test's invariant, the cluster insert under an
    integer-leaf translation equal to the per-point structural insert voxel
    by voxel, on the port as in the reference. Both packages start from the
    same map and clusters (carried across by interop)."""
    if case == "ring":
        pts, covs = scene["scans"][1], scene["covs"][1]
        T = scene["T_rel"]
        jvm0 = jax.jit(jinsert_frame)(jempty(1.0, MAP_CAPACITY), jmake(scene["scans"][0], covs=scene["covs"][0]))
    else:
        pts, covs = _blob_cloud(np.random.RandomState(1)), None
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [2.0, -3.0, 1.0]
        jvm0 = jempty(1.0, 8192)
    jc = _jax_clusters(pts, covs, 1.0, CAPACITY)
    jvm, jov = jax.jit(jcl.insert_clusters_incremental)(jvm0, jc, jnp.asarray(T))
    vm0 = interop.voxelmap_from_numpy({k: np.asarray(v) for k, v in jvm0._asdict().items()}, device="cpu")
    clusters = interop.clusters_from_numpy(_jax_numpy(jc), device="cpu")
    vm, ov = tcl.insert_clusters_incremental(vm0, clusters, torch.from_numpy(T))

    assert bool(ov) == bool(jov) is False
    np.testing.assert_array_equal(vm.keys.numpy(), np.asarray(jvm.keys))
    assert int(vm.num_voxels) == int(jvm.num_voxels) > int(vm0.num_voxels)
    np.testing.assert_array_equal(vm.table[:, ::16].view(torch.int32).numpy(),
                                  np.asarray(jvm.table[:, ::16]).view(np.int32))
    assert _rel(vm.moments.numpy(), np.asarray(jvm.moments)) < MOMENT_TOL

    if case == "blobs":
        world = ttransform(torch.from_numpy(T), tmake(pts, device="cpu"))
        vp = insert_frame(empty_voxelmap(1.0, 8192, device="cpu"), world)
        mc = {int(k): m for k, m in zip(vm.keys.tolist(), vm.moments[:, :10].numpy()) if k != 0x7FFFFFFF}
        mp = {int(k): m for k, m in zip(vp.keys.tolist(), vp.moments[:, :10].numpy()) if k != 0x7FFFFFFF}
        assert set(mc) == set(mp)
        for k, m in mp.items():
            np.testing.assert_allclose(mc[k], m, rtol=2e-4, atol=2e-3)


def test_clusters_factor_matches_jax(scene):
    """linearize_corr at a pose off the truth against the reference's (K1's
    plain version with weights and covariances against its XLA twin); its
    err_fn on the LM's [K-1, 1, 4, 4] candidate batch equal to one call a
    candidate, and both against the reference's."""
    jvm = jax.jit(jbuild)(jmake(scene["scans"][0], covs=scene["covs"][0]), 1.0)
    jc = _jax_clusters(scene["scans"][1], scene["covs"][1], 1.0, CAPACITY)
    pose = (scene["T_rel"] @ np.asarray(jse3.se3_exp(jnp.asarray([0.01, -0.02, 0.015, 0.1, -0.05, 0.08])))
            ).astype(np.float32)[None]
    jf = JClustersFactor(voxelmap=jvm, clusters=jc, fixed_target_pose=jnp.eye(4), target_key=-1, source_key=0,
                         min_voxel_points=1.0)
    jpose = jnp.asarray(pose)
    jcorr = jax.jit(jf.correspondences)(jpose)
    jlin = jax.jit(lambda p, c: jf.linearize_corr(p, c)[0])(jpose, jcorr)

    vm = interop.voxelmap_from_numpy({k: np.asarray(v) for k, v in jvm._asdict().items()}, device="cpu")
    tf = make_vgicp_clusters_factor(-1, 0, vm, interop.clusters_from_numpy(_jax_numpy(jc), device="cpu"),
                                    min_voxel_points=1.0)
    assert isinstance(tf, VGICPClustersFactor)
    tpose = torch.from_numpy(pose)
    corr = tf.correspondences(tpose)
    np.testing.assert_array_equal(corr[1].numpy(), np.asarray(jcorr[1]))
    np.testing.assert_array_equal(corr[0].numpy(), np.asarray(jcorr[0]))
    FL.unary_launches = 0
    lin, err_fn = tf.linearize_corr(tpose, corr)
    assert FL.unary_launches == 0  # CPU tensors take the plain version
    assert _rel(lin.H_ss, jlin.H_ss) < SYSTEM_TOL
    assert _rel(lin.b_s, jlin.b_s) < SYSTEM_TOL
    assert _rel(lin.error, jlin.error) < SYSTEM_TOL
    assert int(lin.num_inliers) == int(jlin.num_inliers) > 0
    assert not lin.H_tt.any() and not lin.H_ts.any() and not lin.b_t.any()
    assert _rel(tf.error(tpose), jax.jit(jf.error)(jpose)) < SYSTEM_TOL

    xis = np.random.RandomState(4).uniform(-0.02, 0.02, (4, 6)).astype(np.float32)
    cands = tpose[None] @ tse3.se3_exp(torch.from_numpy(xis))[:, None]  # [K-1, 1, 4, 4]
    batched = err_fn(cands)
    assert batched.shape == (4,)
    one_by_one = torch.stack([err_fn(c) for c in cands])
    np.testing.assert_array_equal(batched.numpy(), one_by_one.numpy())
    ref = jax.jit(jax.vmap(lambda c: jf.linearize_corr(jpose, jcorr)[1](c)))(jnp.asarray(cands.numpy()))
    assert _rel(batched, ref) < SYSTEM_TOL


@functools.lru_cache(maxsize=None)
def _jax_stage(iters, stride):
    """JAX's register_clusters_pyramid over one stage of this shape, jitted."""
    stage = (jcl.PyramidStage(0.0, iters, stride),)  # the leaf lives in the map
    return jax.jit(lambda vm, cl, T: jcl.register_clusters_pyramid((vm,), cl, T, stage))


def test_register_clusters_pyramid_matches_jax(scene):
    """Scan 1, moved back by the true relative pose, against scan 0's
    DEFAULT_CLUSTER_STAGES pyramid from three perturbed inits; each package
    clusters the source and builds the pyramid itself."""
    tgt, tcov = scene["scans"][0], scene["covs"][0]
    src = jtransform(jnp.asarray(scene["T_rel"]), jmake(scene["scans"][1], covs=scene["covs"][1]))
    src_pts = np.asarray(src.points)[:SCAN_N]
    src_covs = np.asarray(src.covs)[:SCAN_N]
    xis = np.random.RandomState(3).uniform(-0.1, 0.1, (N_INITS, 6)).astype(np.float32)
    T0s = np.array(jax.vmap(jse3.se3_exp)(jnp.asarray(xis)))

    stages = jcl.DEFAULT_CLUSTER_STAGES
    build = jax.jit(jbuild)
    jmaps = [build(jmake(tgt, covs=tcov), jnp.float32(st.leaf)) for st in stages]
    jc = _jax_clusters(src_pts, src_covs, jcl.DEFAULT_CLUSTER_LEAF, CAPACITY)
    jposes = []
    for T0 in T0s:
        T = jnp.asarray(T0)
        for vm, st in zip(jmaps, stages):
            T = jax.block_until_ready(_jax_stage(st.iters, st.stride)(vm, jc, T))
        jposes.append(np.asarray(T))

    maps = build_pyramid(tmake(tgt, covs=tcov, device="cpu"), tcl.DEFAULT_CLUSTER_STAGES, device="cpu")
    clusters = tcl.cluster_source(tmake(src_pts, covs=src_covs, device="cpu"), tcl.DEFAULT_CLUSTER_LEAF, CAPACITY,
                                  device="cpu")
    FL.unary_launches = 0
    tposes = [tcl.register_clusters_pyramid(maps, clusters, torch.from_numpy(T0), device="cpu") for T0 in T0s]
    assert FL.unary_launches == 0
    rot, trans = tse3.pose_error(torch.from_numpy(np.stack(jposes)), torch.stack(tposes))
    print(f"cluster pyramid, max per-pose gap {float(trans.max()):.3e} m {float(rot.max()):.3e} rad")
    assert float(trans.max()) < TOL_M, trans
    assert float(rot.max()) < TOL_RAD, rot
    rot, trans = tse3.pose_error(torch.eye(4), torch.stack(tposes))  # identity is the truth
    print("error against the truth (m)", trans.tolist())  # one init leaves the basin, in both packages


@pytest.mark.parametrize("case", ["another order", "weights dropped", "C_s dropped"])
def test_phase15_check_holds_order_and_catches_faults(scene, case):
    """chip_smoke.py's check of K1 with weights (phase 15) at a registered
    pose, where b_s is a small residue of large terms (there the gap of two
    float32 orders over max|b_s| can pass K1_TOL): K1's plain version summed
    in another point order passes it; the plain version with the weights or
    the source covariances dropped fails it."""
    import chip_smoke

    tgt, tcov = scene["scans"][0], scene["covs"][0]
    src = ttransform(torch.from_numpy(scene["T_rel"]), tmake(scene["scans"][1], covs=scene["covs"][1], device="cpu"))
    maps = build_pyramid(tmake(tgt, covs=tcov, device="cpu"), tcl.DEFAULT_CLUSTER_STAGES, device="cpu")
    clusters = tcl.cluster_source(src, tcl.DEFAULT_CLUSTER_LEAF, CAPACITY, device="cpu")
    T0 = tse3.se3_exp(torch.from_numpy(np.random.RandomState(3).uniform(-0.1, 0.1, 6).astype(np.float32)))
    pose = tcl.register_clusters_pyramid(maps, clusters, T0, device="cpu")
    covs6 = planar.sym_add_eye(clusters.covs6, 1e-3)
    momT, found = FL.probe_moments(maps[-1], clusters.pts_p, clusters.mask, pose)
    args = (clusters.pts_p, momT, found, pose, 1.0, 1e-3, covs6, clusters.weight)
    ref = FL.linearize_vgicp_unary_plain(*args)
    ref64 = FL.linearize_vgicp_unary_plain(*chip_smoke._float64(args))
    if case == "another order":
        perm = torch.from_numpy(np.random.RandomState(5).permutation(clusters.capacity))
        lin = FL.linearize_vgicp_unary_plain(clusters.pts_p[:, perm], momT[:, perm], found[perm], pose, 1.0, 1e-3,
                                             covs6[:, perm], clusters.weight[perm])
    elif case == "weights dropped":
        lin = FL.linearize_vgicp_unary_plain(*args[:7], None)
    else:
        lin = FL.linearize_vgicp_unary_plain(*args[:6], None, args[7])
    texts, bad = chip_smoke._cluster_fields(lin, ref, ref64, chip_smoke._summand_scale(args))
    print(case, texts, bad)
    assert (bad == []) == (case == "another order"), (texts, bad)


def test_cluster_odometry_matches_jax(scene):
    """Six cluster odometry steps: each package preprocesses the same scans,
    clusters them at the map's leaf and steps from its own init_odometry.
    The CPU stepper is `odometry_step`, bit for bit."""
    scans, covs = scene["scans"], scene["covs"]
    jp = jodo.OdometryParams(map_capacity=MAP_CAPACITY)
    step_j = jax.jit(jodo.odometry_step, static_argnums=2)
    jframes = [jmake(s, covs=c) for s, c in zip(scans, covs)]
    jstate = jodo.init_odometry(jframes[0], jp)
    jposes = [np.eye(4, dtype=np.float32)]
    for f, s, c in zip(jframes[1:], scans[1:], covs[1:]):
        jstate, T, diag = step_j(jstate, f, jp, None, _jax_clusters(s, c, jp.voxel_resolution, CAPACITY))
        jposes.append(np.asarray(T))

    tp = todo.OdometryParams(map_capacity=MAP_CAPACITY)
    tframes = [tmake(s, covs=c, device="cpu") for s, c in zip(scans, covs)]
    clusters = [tcl.cluster_source(f, tp.voxel_resolution, CAPACITY, device="cpu") for f in tframes]
    runs = []
    for stepper in (todo.make_odometry_stepper(tp, device="cpu"), None):
        state = todo.init_odometry(tframes[0], tp, device="cpu")
        poses, out = [torch.eye(4)], []
        for f, cl in zip(tframes[1:], clusters[1:]):
            if stepper is None:
                state, T, diag = todo.odometry_step(state, f, tp, clusters=cl)
            else:
                state, T, diag = stepper(state, f, clusters=cl)
            poses.append(T)
            out += [T, diag["error"], diag["iterations"]]
            assert diag["inserted"] and not diag["full_merge"]
        runs.append((poses, out, state))
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)

    poses, _, state = runs[0]
    rot, trans = tse3.pose_error(torch.from_numpy(np.stack(jposes)), torch.stack(poses))
    print(f"cluster odometry, per-pose gap (m) {trans.tolist()}, max {float(rot.max()):.3e} rad")
    assert float(trans.max()) < TOL_M, trans
    assert float(rot.max()) < TOL_RAD, rot
    # a centroid within the pose gap of a voxel face can land on its other
    # side (2 of 3349 keys measured): the maps agree but for such voxels
    tk, jk = set(state.vmap.keys.tolist()), set(np.asarray(jstate.vmap.keys).tolist())
    n_vox = int(jstate.vmap.num_voxels)
    print(f"voxels {int(state.vmap.num_voxels)} / {n_vox}, keys in one map only {len(tk ^ jk)}")
    assert len(tk ^ jk) <= 0.005 * n_vox
    assert abs(int(state.vmap.num_voxels) - n_vox) <= 0.005 * n_vox


def test_clusters_interop_round_trip_and_device_rule(scene, monkeypatch):
    """The four fields carried across bit for bit (NaN payloads included);
    the cluster entry points mean cuda without device= and raise when it is
    absent."""
    j = _jax_numpy(_jax_clusters(scene["scans"][1], scene["covs"][1], 1.0, CAPACITY))
    j["covs6"] = j["covs6"].copy()
    j["covs6"][0, -1] = np.frombuffer(np.int32(0x7FC00001).tobytes(), np.float32)[0]  # a NaN payload
    back = interop.clusters_to_numpy(interop.clusters_from_numpy(j, device="cpu"))
    for k, a in j.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape
        np.testing.assert_array_equal(back[k].view(np.uint8), a.view(np.uint8))

    frame = tmake(scene["scans"][1], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcl.cluster_source(frame, 1.0, CAPACITY)
    clusters = tcl.cluster_source(frame, 1.0, CAPACITY, device="cpu")
    maps = build_pyramid(frame, tcl.DEFAULT_CLUSTER_STAGES, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcl.register_clusters_pyramid(maps, clusters, torch.eye(4))


def test_graph_key_tells_points_from_clusters(scene):
    """The card's stepper captures its graph again when clusters come or go
    or their capacity changes, and not when only their values change."""
    tp = todo.OdometryParams(map_capacity=MAP_CAPACITY)
    frames = [tmake(s, covs=c, device="cpu") for s, c in zip(scene["scans"][:2], scene["covs"][:2])]
    state = todo.init_odometry(frames[0], tp, device="cpu")
    key = todo._GraphedRegister.key_of
    small, other = (tcl.cluster_source(f, 1.0, CAPACITY, device="cpu") for f in frames)
    large = tcl.cluster_source(frames[1], 1.0, 2 * CAPACITY, device="cpu")
    assert key(state, frames[1]) != key(state, small)
    assert key(state, small) == key(state, other)
    assert key(state, small) != key(state, large)
    assert key(state, frames[1]) != key(state, frames[1].replace(covs=None))
