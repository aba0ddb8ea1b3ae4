"""PyTorch port vs the JAX package: the distributed layer (parallel/).

In this process, against the JAX functions on tests/conftest.py's 8 virtual
CPU devices, on tests/test_sharded_voxelmap.py's scene (6144 points on three
pairs of walls):
- `shard_of_keys` on 100000 random int32 keys, bit for bit;
- `build_sharded_voxelmap` with S = 8: keys, num_voxels, last_seen and the
  probe table's key and row lanes bit for bit; moments and the table's
  moment lanes within 1e-5 x max|ref| (test_torch_voxelmap.py's rule);
  `interop.sharded_voxelmap_{from,to}_numpy` carry JAX's stacked map across;
- `partition_frame_by_shard`: mask, overflow and every field bit for bit,
  with the default slice and with one that overflows;
- `sharded_insert_frame`, `sharded_num_voxels` and `sharded_overlap` equal.

Across 4 ranks: this file is its own worker. A module fixture runs it as 4
processes (gloo on the CPU, a file:// store in tmp_path, a 120 s timeout on
every collective), each writing its results to a file, while this process
computes JAX's references:
- `linearize_vgicp_sharded` on a 4-rank mesh against JAX's on
  Mesh(devs[:4]), and on a 2 x 2 (host, chip) mesh over both axes against
  JAX's `make_mesh_2d(2, 2)` layout: every block within 1e-4 x max|ref|;
- the sharded factor's LM (a prior and the factor, 15 iterations) and the
  mixed graph with an EVM plane factor (tests/test_sharded_voxelmap.py:113
  and :153), and `optimize_lm_sharded` on tests/test_distributed.py's
  batch_problem, 2 factors a rank (:81): poses within 1e-3 m and 1e-3 rad;
- every rank's payloads and poses equal bit for bit; the collectives of an
  LM iteration; the placed map's insert, voxels and overlap against the
  stacked map's; `replicate`; the ValueErrors of a shard count that is not
  the mesh size and of counts that do not divide, and the TypeError of a
  linearize on a stacked map (one not placed on the mesh).
"""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a worker: python tests/test_torch_parallel.py RANK WORLD STORE OUT
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the numpy scenes shared with phase 36)
from gtsam_points_tpu_torch import interop  # noqa: E402
from gtsam_points_tpu_torch.factors import PriorFactor, make_evm_factor, make_vgicp_factor_batch  # noqa: E402
from gtsam_points_tpu_torch.ops.voxelmap import build_voxelmap  # noqa: E402
from gtsam_points_tpu_torch.optim import FactorGraph, LMParams, optimize_lm  # noqa: E402
from gtsam_points_tpu_torch.parallel import (  # noqa: E402
    build_sharded_voxelmap,
    init_distributed,
    linearize_vgicp_sharded,
    make_mesh,
    make_mesh_2d,
    make_vgicp_sharded_factor,
    place_sharded,
    replicate,
    shard_frame,
    sharded_insert_frame,
    sharded_num_voxels,
    sharded_overlap,
)
from gtsam_points_tpu_torch.parallel import sharding  # noqa: E402
from gtsam_points_tpu_torch.parallel.distributed import optimize_lm_sharded, shard_factor_batch  # noqa: E402
from gtsam_points_tpu_torch.types.frame import make_frame  # noqa: E402

torch.set_num_threads(1)
WORLD = 4
LEAF = 1.0
MIN_POINTS = 4.0
SYSTEM_TOL = 1e-4
MOMENT_TOL = 1e-5
TOL_M = 1e-3
TOL_RAD = 1e-3
XI = (0.02, -0.01, 0.03, 0.2, -0.1, 0.15)  # tests/test_sharded_voxelmap.py's source offset
XI_EVM = (0.01, -0.02, 0.02, 0.15, -0.1, 0.1)  # its mixed graph's
LM_ITERATIONS = 15
BATCH_N = 1536
BATCH_ITERATIONS = 10
WORKER_TIMEOUT_S = 120
_LIN = ("H_tt", "H_ss", "H_ts", "b_t", "b_s", "error")


def scene(n: int = 6144, seed: int = 0):
    """tests/test_sharded_voxelmap.py's `_scene`: n // 3 points on each pair
    of walls x, y, z = +-10, 5 cm of noise across them, covs 0.01 I."""
    rng = np.random.RandomState(seed)
    pts = []
    for ax in range(3):
        p = rng.rand(n // 3, 3).astype(np.float32) * 20 - 10
        p[:, ax] = np.sign(p[:, ax]) * 10 + rng.randn(n // 3).astype(np.float32) * 0.05
        pts.append(p)
    pts = np.concatenate(pts)
    return pts, np.tile((0.01 * np.eye(3, dtype=np.float32))[None], (n, 1, 1))


def moved_back(pts, xi):
    """The points seen from Exp(xi): T⁻¹ p, and T."""
    T = chip_smoke.se3_exp_np(xi)
    return ((pts - T[:3, 3]) @ T[:3, :3]).astype(np.float32), T


def evm_planes(T1):
    """The mixed graph's plane feature: 64 points on z = 10 (RandomState(7)),
    in the world and seen from T1."""
    rng = np.random.RandomState(7)
    plane_w = np.concatenate([rng.rand(64, 2).astype(np.float32) * 4 - 2, np.full((64, 1), 10.0, np.float32)], 1)
    return plane_w, ((plane_w - T1[:3, 3]) @ T1[:3, :3]).astype(np.float32)


def _lin_np(lin) -> dict:
    return {k: np.asarray(getattr(lin, k), np.float32) for k in _LIN} | {"num_inliers": int(lin.num_inliers)}


# ---------------------------------------------------------------------------
# the worker: one rank of WORLD, the port alone (no JAX in these processes)
# ---------------------------------------------------------------------------


def _raises(fn, error=ValueError) -> bool:
    try:
        fn()
    except error:
        return True
    return False


def _counted(fn):
    """fn() -> (result, collectives, bytes reduced) during the call."""
    c0, b0 = sharding.collectives, sharding.bytes_reduced
    out = fn()
    return out, sharding.collectives - c0, sharding.bytes_reduced - b0


def worker(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist

    init_distributed(rank, world, f"file://{store}", "gloo", device="cpu")
    res = {}
    try:
        eye2 = torch.eye(4).expand(2, 4, 4).contiguous()
        pts, covs = scene()
        frame = make_frame(pts, covs=covs, capacity=len(pts), device="cpu")
        src_pts, _ = moved_back(pts, XI)
        src = make_frame(src_pts, covs=covs, capacity=len(pts), device="cpu")
        stacked = build_sharded_voxelmap(frame, LEAF, world, capacity_per_shard=frame.capacity // 4, device="cpu")

        mesh = make_mesh(axis="shard", device="cpu")
        svmap = place_sharded(stacked, mesh)
        lin, n_coll, n_bytes = _counted(lambda: linearize_vgicp_sharded(svmap, src, torch.eye(4), mesh,
                                                                        min_voxel_points=MIN_POINTS))
        res["lin_1d"] = _lin_np(lin)
        res["lin_collectives"] = (n_coll, n_bytes)
        mesh2 = make_mesh_2d(2, 2, device="cpu")
        axes = ("host", "chip")
        res["lin_2d"] = _lin_np(linearize_vgicp_sharded(place_sharded(stacked, mesh2, axis=axes), src, torch.eye(4),
                                                        mesh2, axis=axes, min_voxel_points=MIN_POINTS))

        prior = PriorFactor(prior=torch.eye(4), weights=torch.full((6,), 1e6), key=0)
        graph = FactorGraph(num_poses=2)
        graph.add(prior)
        graph.add(make_vgicp_sharded_factor(0, 1, svmap, src, mesh, min_voxel_points=MIN_POINTS))
        res["lm_error"] = float(graph.error(eye2))
        r, n_coll, n_bytes = _counted(lambda: optimize_lm(graph, eye2, LMParams(max_iterations=LM_ITERATIONS)))
        res["lm"] = r.poses.numpy()
        res["lm_collectives"] = (int(r.status.num_iterations), n_coll, n_bytes)

        pts2, covs2 = scene(seed=2)
        frame2 = make_frame(pts2, covs=covs2, capacity=len(pts2), device="cpu")
        src1_pts, T1 = moved_back(pts2, XI_EVM)
        src1 = make_frame(src1_pts, covs=covs2, capacity=len(pts2), device="cpu")
        svmap2 = place_sharded(build_sharded_voxelmap(frame2, LEAF, world, frame2.capacity // 4, device="cpu"), mesh)
        plane_w, plane_1 = evm_planes(T1)
        graph = FactorGraph(num_poses=2)
        graph.add(prior)
        graph.add(make_vgicp_sharded_factor(0, 1, svmap2, src1, mesh, min_voxel_points=MIN_POINTS))
        graph.add(make_evm_factor("plane", {0: plane_w, 1: plane_1}, device="cpu"))
        res["evm"] = optimize_lm(graph, eye2, LMParams(max_iterations=LM_ITERATIONS)).poses.numpy()

        prob = chip_smoke.parallel_batch_problem(BATCH_N)
        target = make_frame(prob["target"], capacity=BATCH_N, device="cpu")
        vmap = build_voxelmap(target, LEAF, capacity=2048)
        batch = make_vgicp_factor_batch([vmap] * len(prob["sources"]),
                                        [make_frame(s, capacity=BATCH_N, device="cpu") for s in prob["sources"]],
                                        [-1] * len(prob["sources"]), list(range(len(prob["sources"]))),
                                        min_voxel_points=3.0)
        mesh_f = make_mesh(axis="factor", device="cpu")
        graph = FactorGraph(num_poses=len(prob["sources"]))
        graph.add(shard_factor_batch(batch, mesh_f, "factor"))
        poses0 = torch.eye(4).expand(len(prob["sources"]), 4, 4).contiguous()
        r, n_coll, n_bytes = _counted(lambda: optimize_lm_sharded(graph, poses0, mesh_f,
                                                                  LMParams(max_iterations=BATCH_ITERATIONS)))
        res["batch"] = r.poses.numpy()
        res["batch_error"] = float(graph.error(poses0))
        res["batch_collectives"] = (int(r.status.num_iterations), n_coll, n_bytes)

        # the placed map against the stacked map on this rank alone
        frame1 = make_frame(scene(seed=0)[0], covs=covs, capacity=len(pts), device="cpu")
        frame3 = make_frame(scene(seed=1)[0], covs=covs, capacity=len(pts), device="cpu")
        st = build_sharded_voxelmap(frame1, LEAF, world, frame1.capacity // 2, device="cpu")
        placed = place_sharded(st, mesh)
        st, ov_st = sharded_insert_frame(st, frame3)
        placed, ov_pl = sharded_insert_frame(placed, frame3)
        res["placed"] = {
            "overflow": (int(ov_st), int(ov_pl)),
            "num_voxels": (int(sharded_num_voxels(st)), int(sharded_num_voxels(placed))),
            "overlap": (float(sharded_overlap(st, frame3, torch.eye(4))),
                        float(sharded_overlap(placed, frame3, torch.eye(4)))),
            "own_shard_equal": all(a[rank].numpy().tobytes() == b.numpy().tobytes() for a, b in zip(st, placed.local)),
        }

        # replicate: rank 0's values on every rank; shard_frame: slice `rank`
        mine = make_frame(scene(seed=10 + rank)[0], covs=covs, capacity=len(pts), device="cpu")
        rep = replicate(mine, mesh)
        ref0 = scene(seed=10)[0]
        res["replicate"] = bool(np.array_equal(rep.points[: len(ref0)].numpy(), ref0)) and bool(rep.mask.all())
        part = shard_frame(frame, mesh, axis="shard")
        k = frame.capacity // world
        res["shard_frame"] = torch.equal(part.points, frame.points[rank * k:(rank + 1) * k]) and torch.equal(
            part.covs, frame.covs[rank * k:(rank + 1) * k])

        # refusals: a shard count that is not the mesh size, a map not placed, counts that do not divide
        odd = make_frame(pts[:-1], capacity=len(pts) - 1, device="cpu")
        res["refusals"] = {
            "shards_not_mesh_size": _raises(lambda: place_sharded(
                build_sharded_voxelmap(frame, LEAF, 2 * world, frame.capacity // 8, device="cpu"), mesh)),
            "linearize_shards_not_mesh_size": _raises(lambda: linearize_vgicp_sharded(
                svmap, src, torch.eye(4), mesh2, axis="host")),
            "linearize_refuses_stacked_map": _raises(lambda: linearize_vgicp_sharded(
                stacked, src, torch.eye(4), mesh), TypeError),
            "capacity_not_divisible": _raises(lambda: shard_frame(odd, mesh, axis="shard")),
            "factors_not_divisible": _raises(lambda: shard_factor_batch(make_vgicp_factor_batch(
                [vmap] * 3, [target] * 3, [-1] * 3, [0, 1, 2]), mesh_f)),
        }
    finally:
        dist.destroy_process_group()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), np.asarray(res, dtype=object), allow_pickle=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)

# ---------------------------------------------------------------------------
# the tests (JAX is imported here, never in a worker)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from gtsam_points_tpu import parallel as jpar  # noqa: E402
from gtsam_points_tpu.factors import PriorFactor as JPrior  # noqa: E402
from gtsam_points_tpu.factors.balm import make_evm_factor as jevm  # noqa: E402
from gtsam_points_tpu.factors.batch import make_vgicp_factor_batch as jbatch  # noqa: E402
from gtsam_points_tpu.ops.voxelmap import build_voxelmap as jbuild  # noqa: E402
from gtsam_points_tpu.optim import FactorGraph as JGraph  # noqa: E402
from gtsam_points_tpu.optim import optimize_lm as jlm  # noqa: E402
from gtsam_points_tpu.optim.lm import LMParams as JLMParams  # noqa: E402
from gtsam_points_tpu.parallel.distributed import optimize_lm_sharded as jlm_sharded  # noqa: E402
from gtsam_points_tpu.parallel.distributed import shard_factor_batch as jshard_batch  # noqa: E402
from gtsam_points_tpu.parallel.sharded_voxelmap import partition_frame_by_shard as jpartition  # noqa: E402
from gtsam_points_tpu.types.frame import make_frame as jmake  # noqa: E402
from gtsam_points_tpu_torch.parallel.sharded_voxelmap import partition_frame_by_shard, shard_of_keys  # noqa: E402
from gtsam_points_tpu_torch.utils import se3 as tse3  # noqa: E402

_FRAME_FIELDS = ("points", "mask", "normals", "covs", "intensities", "times")


def _jframe(pts, covs=None, **kw):
    return jmake(pts, covs=covs, capacity=len(pts), **kw)


def _tframe(jf):
    return interop.frame_from_numpy(interop.frame_to_numpy(jf), device="cpu")


def _assert_stacked_maps_match(jmap, tmap):
    j, t = interop.sharded_voxelmap_to_numpy(jmap), interop.sharded_voxelmap_to_numpy(tmap)
    for k in ("keys", "last_seen", "epoch", "num_voxels", "leaf"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    rj, rt = j["table"].reshape(-1, 16), t["table"].reshape(-1, 16)
    np.testing.assert_array_equal(rt[:, 0].view(np.int32), rj[:, 0].view(np.int32), err_msg="table keys")
    np.testing.assert_array_equal(rt[:, 1], rj[:, 1], err_msg="table rows")
    for name, a, b in (("moments", t["moments"], j["moments"]), ("table moments", rt[:, 2:], rj[:, 2:])):
        np.testing.assert_allclose(a, b, rtol=0, atol=MOMENT_TOL * np.max(np.abs(b)), err_msg=name)


def _assert_system_close(lin: dict, ref, label: str):
    for k in _LIN:
        r = np.asarray(getattr(ref, k), np.float64)
        np.testing.assert_allclose(lin[k], r, rtol=0, atol=SYSTEM_TOL * max(np.abs(r).max(), 1e-30),
                                   err_msg=f"{label} {k}")
    assert lin["num_inliers"] == int(ref.num_inliers), label


def _assert_poses_close(poses, ref, label: str):
    rot, trans = tse3.pose_error(torch.from_numpy(np.array(ref, np.float32)), torch.from_numpy(poses))
    assert float(trans.max()) < TOL_M and float(rot.max()) < TOL_RAD, (label, trans, rot)


def test_public_names_match_jax():
    """parallel/'s names are the JAX package's, plus init_distributed and Mesh."""
    import gtsam_points_tpu_torch.parallel as tpar

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_") and not isinstance(getattr(mod, n), type(sys))}

    assert public(tpar) == public(jpar) | {"init_distributed", "Mesh"}


def test_shard_of_keys_matches_jax():
    keys = np.random.RandomState(0).randint(-2**31, 2**31, size=100_000, dtype=np.int64).astype(np.int32)
    keys[:4] = [0, 1, -1, 0x7FFFFFFF]
    for s in (3, 8):
        j = np.asarray(jpar.shard_of_keys(jnp.asarray(keys), s))
        t = shard_of_keys(torch.from_numpy(keys), s).numpy()
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, j)


def test_build_sharded_voxelmap_matches_jax():
    pts, covs = scene()
    jf = _jframe(pts, covs)
    jmap = jax.jit(lambda f: jpar.build_sharded_voxelmap(f, LEAF, num_shards=8, capacity_per_shard=len(pts) // 4))(jf)
    tmap = build_sharded_voxelmap(_tframe(jf), LEAF, 8, capacity_per_shard=len(pts) // 4, device="cpu")
    assert tmap.keys.shape == (8, len(pts) // 4)
    _assert_stacked_maps_match(jmap, tmap)
    assert int(sharded_num_voxels(tmap)) == int(jpar.sharded_num_voxels(jmap)) > 0
    # JAX's stacked map carried across is JAX's to the last bit, and a map without [S] is refused
    carried = interop.sharded_voxelmap_from_numpy(interop.sharded_voxelmap_to_numpy(jmap), device="cpu")
    for k, v in interop.sharded_voxelmap_to_numpy(carried).items():
        assert np.asarray(getattr(jmap, k)).tobytes() == v.tobytes(), k
    one = interop.voxelmap_to_numpy(jbuild(jf, LEAF))
    with pytest.raises(ValueError):
        interop.sharded_voxelmap_from_numpy(one, device="cpu")


@pytest.mark.parametrize("capacity_per_shard", [None, 8])
def test_partition_frame_by_shard_matches_jax(capacity_per_shard):
    pts, covs = scene(seed=3)
    n = len(pts)
    inten = np.random.RandomState(4).rand(n).astype(np.float32)
    jf = jmake(pts, covs=covs, intensities=inten, capacity=n + 256, aux={"ring": np.arange(n, dtype=np.float32)})
    jparts, jov = jax.jit(lambda f: jpartition(f, jnp.float32(LEAF), 8, capacity_per_shard))(jf)
    tparts, tov = partition_frame_by_shard(_tframe(jf), torch.tensor(LEAF), 8, capacity_per_shard)
    assert int(tov) == int(jov)
    assert (int(tov) > 0) == (capacity_per_shard == 8)
    for k in _FRAME_FIELDS:
        a, b = getattr(tparts, k), getattr(jparts, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    np.testing.assert_array_equal(tparts.aux["ring"].numpy(), np.asarray(jparts.aux["ring"]))


def test_sharded_insert_num_voxels_overlap_match_jax():
    pts1, covs = scene(seed=0)
    pts2, _ = scene(seed=1)
    jf1, jf2 = _jframe(pts1, covs), _jframe(pts2, covs)
    cap = len(pts1) // 2
    jmap = jax.jit(lambda f: jpar.build_sharded_voxelmap(f, LEAF, num_shards=8, capacity_per_shard=cap))(jf1)
    jmap, jov = jax.jit(jpar.sharded_insert_frame)(jmap, jf2)
    tf1, tf2 = _tframe(jf1), _tframe(jf2)
    tmap, tov = sharded_insert_frame(build_sharded_voxelmap(tf1, LEAF, 8, cap, device="cpu"), tf2)
    assert int(tov) == int(jov) == 0
    _assert_stacked_maps_match(jmap, tmap)
    assert int(sharded_num_voxels(tmap)) == int(jpar.sharded_num_voxels(jmap))
    for xi in ((0.0,) * 6, XI):
        T = chip_smoke.se3_exp_np(xi)
        assert float(sharded_overlap(tmap, tf2, torch.from_numpy(T))) == float(
            jpar.sharded_overlap(jmap, jf2, jnp.asarray(T)))


def _jax_references() -> dict:
    """JAX's side of every multi-rank check, on its 8 virtual devices."""
    devs = jax.devices()
    ref = {}
    pts, covs = scene()
    jf = _jframe(pts, covs)
    src = _jframe(moved_back(pts, XI)[0], covs)
    cap = len(pts) // 4
    stacked = jpar.build_sharded_voxelmap(jf, LEAF, num_shards=WORLD, capacity_per_shard=cap)
    mesh = JMesh(np.asarray(devs[:WORLD]), ("shard",))
    svmap = jpar.place_sharded(stacked, mesh)
    ref["lin_1d"] = jax.jit(lambda sv, s: jpar.linearize_vgicp_sharded(sv, s, jnp.eye(4), mesh,
                                                                       min_voxel_points=MIN_POINTS))(svmap, src)
    mesh2 = jpar.make_mesh_2d(n_hosts=2, chips_per_host=2)
    axes = ("host", "chip")
    svmap2 = jpar.place_sharded(stacked, mesh2, axis=axes)
    ref["lin_2d"] = jax.jit(lambda sv, s: jpar.linearize_vgicp_sharded(sv, s, jnp.eye(4), mesh2, axis=axes,
                                                                       min_voxel_points=MIN_POINTS))(svmap2, src)
    eye2 = jnp.stack([jnp.eye(4), jnp.eye(4)])
    prior = JPrior(prior=jnp.eye(4), weights=jnp.full((6,), 1e6), key=0)
    graph = JGraph(num_poses=2)
    graph.add(prior)
    graph.add(jpar.make_vgicp_sharded_factor(0, 1, svmap, src, mesh, min_voxel_points=MIN_POINTS))
    ref["lm"] = jax.jit(lambda p: jlm(graph, p, JLMParams(max_iterations=LM_ITERATIONS)))(eye2).poses
    ref["lm_error"] = float(jax.jit(graph.error)(eye2))

    pts2, covs2 = scene(seed=2)
    jf2 = _jframe(pts2, covs2)
    src1_pts, T1 = moved_back(pts2, XI_EVM)
    src1 = _jframe(src1_pts, covs2)
    svmap2 = jpar.place_sharded(jpar.build_sharded_voxelmap(jf2, LEAF, num_shards=WORLD, capacity_per_shard=cap),
                                mesh)
    plane_w, plane_1 = evm_planes(T1)
    graph = JGraph(num_poses=2)
    graph.add(prior)
    graph.add(jpar.make_vgicp_sharded_factor(0, 1, svmap2, src1, mesh, min_voxel_points=MIN_POINTS))
    graph.add(jevm("plane", {0: plane_w, 1: plane_1}))
    ref["evm"] = jax.jit(lambda p: jlm(graph, p, JLMParams(max_iterations=LM_ITERATIONS)))(eye2).poses

    prob = chip_smoke.parallel_batch_problem(BATCH_N)
    vmap = jbuild(jmake(prob["target"], capacity=BATCH_N), leaf=LEAF, capacity=2048)
    f = len(prob["sources"])
    batch = jbatch([vmap] * f, [jmake(s, capacity=BATCH_N) for s in prob["sources"]], [-1] * f, list(range(f)),
                   min_voxel_points=3.0)
    mesh_f = jpar.make_mesh(WORLD, axis="factor")
    graph = JGraph(num_poses=f)
    graph.add(jshard_batch(batch, mesh_f, "factor"))
    poses0 = jnp.tile(jnp.eye(4)[None], (f, 1, 1))
    ref["batch"] = jlm_sharded(graph, poses0, mesh_f, JLMParams(max_iterations=BATCH_ITERATIONS)).poses
    ref["batch_error"] = float(jax.jit(graph.error)(poses0))
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """WORLD ranks of this file as workers, run while JAX's references are
    computed here -> (per-rank results, JAX's references)."""
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(WORLD), str(tmp / "store"),
                               str(tmp)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    try:
        ref = _jax_references()
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited with {p.returncode}:\n{log}"
    results = [np.load(tmp / f"rank{r}.npy", allow_pickle=True).item() for r in range(WORLD)]
    return results, ref


def test_sharded_linearize_matches_jax(ranks):
    results, ref = ranks
    _assert_system_close(results[0]["lin_1d"], ref["lin_1d"], "1-D mesh")
    _assert_system_close(results[0]["lin_2d"], ref["lin_2d"], "2 x 2 mesh")
    # one all-reduce of the 488-byte payload
    assert results[0]["lin_collectives"] == (1, jpar.collective_bytes_per_linearize()) == (1, 488)


def test_sharded_factor_lm_matches_jax(ranks):
    results, ref = ranks
    _assert_poses_close(results[0]["lm"], ref["lm"], "prior + sharded VGICP")
    np.testing.assert_allclose(results[0]["lm_error"], ref["lm_error"], rtol=SYSTEM_TOL)
    _assert_poses_close(results[0]["evm"], ref["evm"], "prior + sharded VGICP + EVM plane")
    # an iteration: the linearize's payload, then the two frozen-error calls
    # of the lambda ladder (candidate 0 alone, then the other nine)
    iters, n_coll, n_bytes = results[0]["lm_collectives"]
    assert n_coll == 3 * iters and n_bytes == (488 + 4 + 4 * 9) * iters, results[0]["lm_collectives"]


def test_optimize_lm_sharded_matches_jax(ranks):
    results, ref = ranks
    _assert_poses_close(results[0]["batch"], ref["batch"], "factor-axis batch")
    np.testing.assert_allclose(results[0]["batch_error"], ref["batch_error"], rtol=SYSTEM_TOL)
    iters, n_coll, n_bytes = results[0]["batch_collectives"]
    f = chip_smoke.PAR_BATCH_FACTORS
    assert n_coll == 3 * iters and n_bytes == ((36 * f * f + 6 * f + 1) * 4 + 4 + 4 * 9) * iters


def test_ranks_agree_bit_for_bit(ranks):
    results, _ = ranks
    for r in results[1:]:
        for k in ("lin_1d", "lin_2d"):
            for name in _LIN:
                assert r[k][name].tobytes() == results[0][k][name].tobytes(), (k, name)
            assert r[k]["num_inliers"] == results[0][k]["num_inliers"]
        for k in ("lm", "evm", "batch"):
            assert r[k].tobytes() == results[0][k].tobytes(), k
        for k in ("lm_collectives", "batch_collectives", "placed", "lm_error", "batch_error"):
            assert r[k] == results[0][k], k


def test_placed_map_and_helpers(ranks):
    results, _ = ranks
    for rank, r in enumerate(results):
        p = r["placed"]
        assert p["overflow"][0] == p["overflow"][1] == 0
        assert p["num_voxels"][0] == p["num_voxels"][1] > 0
        assert p["overlap"][0] == p["overlap"][1] > 0.9
        assert p["own_shard_equal"], rank
        assert r["replicate"] and r["shard_frame"], rank


def test_refusals(ranks):
    results, _ = ranks
    for r in results:
        assert all(r["refusals"].values()), r["refusals"]
