"""PyTorch port vs the JAX package: the rest of the data model.

- `Frame`'s `aux`, `num_valid`, the `has_*` accessors and `aux_attribute`;
  the package root's exports;
- `merge_frames` (attributes and aux kept only where every frame has them),
  `pad_frame` (pad and truncate) and `masked_points`: equal to JAX's;
- `types/frame_funcs`: `sample`, `sort_by_time`, `sort_by_voxel_key`
  (stable, ties kept in order), `point_distances`, `minmax_distance`,
  `median_distance` (an even and an odd count of valid samples: the mean
  of the two middle values, where `torch.nanmedian` would take the lower),
  `overlap` and `overlap_auto`: equal to JAX's;
- `ops/voxelmap`: `insert_frame_fast` (moments and probe records summed in
  the reference's order: equal to JAX's bit for bit; last_seen, epoch and
  the miss fraction equal) and `voxelmap_overlap`; `save_voxelmap` and
  `load_voxelmap` across the packages, a legacy file without `table`
  included: the maps equal and probe the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_points_tpu_torch
from gtsam_points_tpu.ops import voxelmap as jvm
from gtsam_points_tpu.types import frame as jframe
from gtsam_points_tpu.types import frame_funcs as jff
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.ops import voxelmap as tvm
from gtsam_points_tpu_torch.types import frame as tframe
from gtsam_points_tpu_torch.types import frame_funcs as tff
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
WORLD_N = 6000
SCAN_N = 1500
MAP_LEAF = 1.0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_frames_equal(t, j):
    """Every attribute of the port's frame equal to the JAX frame's, bit for
    bit (aux included, by name)."""
    jt = interop.frame_to_numpy(j)
    tt = interop.frame_to_numpy(t)
    assert sorted(tt) == sorted(jt)
    for k, v in jt.items():
        if k == "aux":
            assert sorted(tt["aux"]) == sorted(v)
            for name, a in v.items():
                assert np.array_equal(tt["aux"][name], a), name
        else:
            assert tt[k].dtype == v.dtype and np.array_equal(tt[k], v), k


@pytest.fixture(scope="module")
def scans():
    """Three ring scans with per-point times, intensities and two aux
    attributes; the third without normals."""
    T = ring_trajectory(3, lap=100)
    raw = ring_scans(ring_world(0, WORLD_N), T, scan_n=SCAN_N, seed=1)
    rng = np.random.RandomState(4)
    out = []
    for i, pts in enumerate(raw):
        attrs = dict(times=rng.rand(len(pts)).astype(np.float32), intensities=rng.rand(len(pts)).astype(np.float32),
                     normals=None if i == 2 else rng.randn(len(pts), 3).astype(np.float32),
                     aux={"ring": rng.randint(0, 32, len(pts)).astype(np.float32), "w": rng.rand(len(pts), 2)})
        if i == 1:
            del attrs["aux"]["w"]
        out.append((pts, attrs))
    return out


def _pair(pts, attrs, **kw):
    return jframe.make_frame(pts, **attrs, **kw), tframe.make_frame(pts, **attrs, device="cpu", **kw)


def test_frame_accessors_and_root_exports(scans):
    pts, attrs = scans[0]
    j, t = _pair(pts, attrs)
    _assert_frames_equal(t, j)
    assert int(t.num_valid()) == int(j.num_valid()) == len(pts)
    for name in ("has_normals", "has_covs", "has_intensities", "has_times"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert torch.equal(t.aux_attribute("ring"), torch.from_numpy(np.asarray(j.aux_attribute("ring"))))
    with pytest.raises(KeyError):
        t.aux_attribute("missing")
    for name in ("Frame", "make_frame", "transform_frame", "merge_frames", "se3"):
        assert hasattr(gtsam_points_tpu_torch, name), name
    assert gtsam_points_tpu_torch.merge_frames is tframe.merge_frames


def test_merge_pad_masked_match_jax(scans):
    frames = [_pair(p, a, capacity=1600 + 256 * i) for i, (p, a) in enumerate(scans)]
    j, t = zip(*frames)
    # normals dropped (the third has none), aux keeps only "ring" (the second has no "w")
    for cap in (None, 6000, 3000):
        jm, tm = jframe.merge_frames(list(j), capacity=cap), tframe.merge_frames(list(t), capacity=cap)
        _assert_frames_equal(tm, jm)
    assert tframe.merge_frames(list(t)).normals is None
    assert sorted(tframe.merge_frames(list(t)).aux) == ["ring"]
    assert sorted(tframe.merge_frames(list(t[:1])).aux) == ["ring", "w"]
    for cap in (1600, 2048, 1000):
        _assert_frames_equal(tframe.pad_frame(t[0], cap), jframe.pad_frame(j[0], cap))
    for fill in (float("inf"), 0.0):
        assert np.array_equal(tframe.masked_points(t[1], fill).numpy(), np.asarray(jframe.masked_points(j[1], fill)))


def test_frame_funcs_match_jax(scans):
    pts, attrs = scans[0]
    j, t = _pair(pts, attrs, capacity=1792)
    idx = np.random.RandomState(5).permutation(len(pts))[:700]
    _assert_frames_equal(tff.sample(t, torch.from_numpy(idx)), jff.sample(j, jnp.asarray(idx)))
    _assert_frames_equal(tff.sort_by_time(t), jax.jit(jff.sort_by_time)(j))
    # coarse voxels: many points share a key, so stability decides the order
    for leaf in (0.5, 4.0):
        _assert_frames_equal(tff.sort_by_voxel_key(t, leaf), jff.sort_by_voxel_key(j, leaf))
    assert np.array_equal(tff.point_distances(t).numpy(), np.asarray(jff.point_distances(j)))
    for a, b in zip(tff.minmax_distance(t), jff.minmax_distance(j)):
        assert float(a) == float(b)
    # 1792 slots, 1500 valid: stride 7 -> 256 samples, 215 valid (odd); stride 3 -> 598, 500 valid (even)
    for num in (256, 597):
        stride = max(1792 // num, 1)
        n = int(np.asarray(j.mask)[::stride].sum())
        tm, jm = tff.median_distance(t, num), jff.median_distance(j, num)
        assert float(tm) == float(jm), (num, n)
    assert int(np.asarray(j.mask)[::3].sum()) % 2 == 0 and int(np.asarray(j.mask)[::7].sum()) % 2 == 1
    empty_j, empty_t = _pair(pts[:1], {}, capacity=256)
    empty_t = empty_t.replace(mask=torch.zeros_like(empty_t.mask))
    assert bool(torch.isnan(tff.median_distance(empty_t)))


@pytest.fixture(scope="module")
def maps(scans):
    """Scan 0's leaf-1.0 map (capacity 4096) in both packages, scan 1 with
    its poses and intensities as the insert."""
    T = ring_trajectory(3, lap=100)
    rel = (np.linalg.inv(T[0]) @ T[1]).astype(np.float32)
    (p0, a0), (p1, a1) = scans[0], scans[1]
    j0, t0 = _pair(p0, {"intensities": a0["intensities"]})
    j1, t1 = _pair(p1, {"intensities": a1["intensities"]})
    jmap = jax.jit(lambda f: jvm.build_voxelmap(f, MAP_LEAF, 4096))(j0)
    tmap = tvm.build_voxelmap(t0, MAP_LEAF, 4096)
    return {"jax": (jmap, j1), "torch": (tmap, t1), "rel": rel}


def _assert_maps_equal(t, j):
    tj = interop.voxelmap_to_numpy(t)
    for k, v in {k: np.asarray(getattr(j, k)) for k in tj}.items():
        if v.dtype == np.float32:  # keys bitcast into the table: compare bits
            assert np.array_equal(tj[k].view(np.int32), v.view(np.int32)), k
        else:
            assert np.array_equal(tj[k], v), k


def test_insert_frame_fast_and_overlap_match_jax(maps):
    (jmap, j1), (tmap, t1) = maps["jax"], maps["torch"]
    _assert_maps_equal(tmap, jmap)
    rel = maps["rel"]
    moved_j = jframe.transform_frame(jnp.asarray(rel), j1)
    moved_t = tframe.transform_frame(torch.from_numpy(rel), t1)
    jnew, jmiss = jax.jit(jvm.insert_frame_fast)(jmap, moved_j)
    tnew, tmiss = tvm.insert_frame_fast(tmap, moved_t)
    _assert_maps_equal(tnew, jnew)
    assert float(tmiss) == float(jmiss) and 0.0 < float(tmiss) < 0.5
    # a second insert on top of the first
    jnew2, jmiss2 = jax.jit(jvm.insert_frame_fast)(jnew, moved_j)
    tnew2, tmiss2 = tvm.insert_frame_fast(tnew, moved_t)
    _assert_maps_equal(tnew2, jnew2)
    for T in (np.eye(4, dtype=np.float32), rel):
        a = tvm.voxelmap_overlap(tnew, t1, torch.from_numpy(T))
        b = jax.jit(jvm.voxelmap_overlap)(jnew, j1, jnp.asarray(T))
        assert float(a) == float(b)
        assert float(tff.overlap(tnew, t1, torch.from_numpy(T))) == float(b)
    # overlap_auto: the union over the map at the relative pose and the map at the identity
    Ts = [rel, np.eye(4, dtype=np.float32)]
    a = tff.overlap_auto([tnew, tmap], t1, [torch.from_numpy(T) for T in Ts])
    b = jff.overlap_auto([jnew, jmap], j1, [jnp.asarray(T) for T in Ts])
    assert float(a) == float(b) and float(a) >= float(tvm.voxelmap_overlap(tnew, t1, torch.from_numpy(rel)))


def test_save_load_across_packages(maps, tmp_path):
    (jmap, j1), (tmap, t1) = maps["jax"], maps["torch"]
    jvm.save_voxelmap(str(tmp_path / "jax.npz"), jmap)
    tvm.save_voxelmap(str(tmp_path / "torch.npz"), tmap)
    loaded = tvm.load_voxelmap(str(tmp_path / "jax.npz"), device="cpu")
    _assert_maps_equal(loaded, jmap)
    _assert_maps_equal(jvm.load_voxelmap(str(tmp_path / "torch.npz")), tmap)
    # a legacy file: no probe table (and a double-hash index, ignored)
    fields = {k: np.asarray(v) for k, v in jmap._asdict().items() if k != "table"}
    np.savez_compressed(str(tmp_path / "legacy.npz"), hash_index=np.zeros(8, np.int32), **fields)
    legacy_t = tvm.load_voxelmap(str(tmp_path / "legacy.npz"), device="cpu")
    legacy_j = jvm.load_voxelmap(str(tmp_path / "legacy.npz"))
    _assert_maps_equal(legacy_t, legacy_j)
    pts = tse3.transform_points(torch.from_numpy(maps["rel"]), t1.points)
    for m in (loaded, legacy_t):
        assert torch.equal(tvm.lookup_voxels(m, pts, t1.mask)[1], tvm.lookup_voxels(tmap, pts, t1.mask)[1])
