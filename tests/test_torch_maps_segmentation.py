"""PyTorch port vs the JAX package: the occupancy grid, the incremental
covariance map, the small stateful utilities and segmentation.

- `build_occupancy_grid` bit for bit (block keys, the bit words compared as
  uint32, the hash index), on points with negative coordinates and with a
  block capacity that drops blocks; `occupied` and `calc_overlap` equal;
- `insert` into an `IncrementalCovarianceMap` over three batches, the third
  wrapping the ring, with the default warm-up and with `warmup=1` (the
  eigenvalue band gates only after `warmup` inserts): mask, birth, epoch,
  cursor and the validity flags equal, points bit for bit, normals and
  covariances within 1e-5, the running statistics within 1e-4 x max|ref|
  (a batch mean of log10 eigenvalue ratios whose smallest eigenvalue, 1e-3
  of the next on these planes, carries each package's float32 rounding of
  eigh3: about 1e-5 of it); `knn_search_valid` and `knn_search_force`
  indices equal;
- `RunningStatistics` and `IndexedSlidingWindow` as
  tests/test_misc_components.py::test_stats_utils, the statistics against
  JAX's within 1e-6;
- `region_growing` and `min_cut` on the scenes of
  tests/test_segmentation_raycast.py (two planes; a cluster beside another):
  masks equal to JAX's through the public entry points, and through the
  port's table-taking helpers given JAX's own kNN table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.ops import incremental_covariance as jicm
from gtsam_points_tpu.ops import occupancy as jocc
from gtsam_points_tpu.ops.features import estimate_normals_covs as jfeatures
from gtsam_points_tpu.ops.hash_grid import build_hash_grid as jgrid
from gtsam_points_tpu.ops.hash_grid import knn_search as jknn
from gtsam_points_tpu.segmentation import MinCutParams as JMinCutParams
from gtsam_points_tpu.segmentation import RegionGrowingParams as JRegionGrowingParams
from gtsam_points_tpu.segmentation import min_cut as jmin_cut
from gtsam_points_tpu.segmentation import region_growing as jregion_growing
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import stats as jstats
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.ops.incremental_covariance import (
    empty_incremental_covariance_map,
    insert,
    knn_search_force,
    knn_search_valid,
)
from gtsam_points_tpu_torch.ops.occupancy import build_occupancy_grid, calc_overlap, occupied
from gtsam_points_tpu_torch.segmentation import MinCutParams, RegionGrowingParams, min_cut, region_growing
from gtsam_points_tpu_torch.segmentation.min_cut import _min_cut_from_knn
from gtsam_points_tpu_torch.segmentation.region_growing import _region_growing_from_knn
from gtsam_points_tpu_torch.types.frame import make_frame
from gtsam_points_tpu_torch.utils import se3 as tse3
from gtsam_points_tpu_torch.utils.stats import IndexedSlidingWindow, RunningStatistics

torch.set_num_threads(1)
MAP_TOL = 1e-5
RATIO_STATS_TOL = 1e-4
STATS_TOL = 1e-6


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _port(frame):
    return interop.frame_from_numpy(interop.frame_to_numpy(frame), device="cpu")


def _assert_grid_equal(t, j):
    ta, ja = interop.occupancy_grid_to_numpy(t), interop.occupancy_grid_to_numpy(j)
    assert ta["bits"].dtype == np.uint32 and ja["bits"].dtype == np.uint32
    for name in ("leaf", "block_keys", "bits", "hash_index"):
        np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)


@pytest.mark.parametrize("block_capacity", [None, 64])
def test_occupancy_grid_matches_jax(block_capacity):
    rng = np.random.RandomState(0)
    pts = (rng.rand(3000, 3) * 20 - 10).astype(np.float32)
    f = jmake(pts, capacity=3072)
    j = jax.jit(lambda p, m: jocc.build_occupancy_grid(p, m, 0.5, block_capacity))(f.points, f.mask)
    tf = _port(f)
    t = build_occupancy_grid(tf.points, tf.mask, 0.5, block_capacity)
    _assert_grid_equal(t, j)
    assert t.bits.dtype == torch.int64 and int(t.bits.max()) >= 2**31  # the top bit of a word is in use
    back = interop.occupancy_grid_from_numpy(interop.occupancy_grid_to_numpy(t), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, t))
    queries = np.concatenate([pts[:1500], pts[:1500] + rng.randn(1500, 3).astype(np.float32) * 0.4])
    qmask = rng.rand(len(queries)) < 0.9
    np.testing.assert_array_equal(occupied(t, _t(queries), torch.from_numpy(qmask)).numpy(),
                                  np.asarray(jocc.occupied(j, jnp.asarray(queries), jnp.asarray(qmask))))
    T = np.asarray(tse3.se3_exp(_t([0.02, -0.01, 0.03, 0.3, -0.2, 0.1])))
    for pose in (None, T):
        tov = calc_overlap(t, _t(queries), torch.from_numpy(qmask), None if pose is None else _t(pose))
        jov = jocc.calc_overlap(j, jnp.asarray(queries), jnp.asarray(qmask), None if pose is None else jnp.asarray(pose))
        assert float(tov) == float(jov)
    if block_capacity is None:
        assert float(calc_overlap(t, tf.points, tf.mask)) == 1.0
        assert float(calc_overlap(t, tf.points + 100.0, tf.mask)) == 0.0


def _plane_batches(seed=1):
    """tests/test_misc_components.py::test_incremental_covariance_map's
    plane (noise 0.01 m on z), 900 points in three batches of 300, and a
    wall of 300 points at x = 10 (the same noise) in the second batch. A
    noise-free surface would make the smallest eigenvalue, and with it the
    log ratio, rounding noise."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(900, 2).astype(np.float32) * 10
    pts = np.concatenate([xy, rng.randn(900, 1).astype(np.float32) * 0.01], axis=1)
    wall = np.stack([10.0 + rng.randn(300) * 0.01, rng.rand(300) * 10, rng.rand(300) * 3], 1).astype(np.float32)
    return [pts[:300], np.concatenate([pts[300:600], wall]), pts[600:]]


def _assert_map_close(t, j):
    ta, ja = interop.incremental_covariance_map_to_numpy(t), interop.incremental_covariance_map_to_numpy(j)
    for name in ("points", "mask", "valid", "birth", "epoch", "cursor"):
        np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)
    for name in ("normals", "covs"):
        assert np.abs(ta[name] - ja[name]).max() <= MAP_TOL, name
    assert ta["eig_stats"]["count"] == ja["eig_stats"]["count"]
    for name in ("total", "sq_total"):
        a, b = ta["eig_stats"][name], ja["eig_stats"][name]
        assert np.abs(a - b).max() <= RATIO_STATS_TOL * np.abs(b).max(), name


@pytest.mark.parametrize("warmup", [256, 1])
def test_incremental_covariance_insert_matches_jax(warmup):
    batches = _plane_batches()
    jins = jax.jit(lambda c, f: jicm.insert(c, f, k=10, grid_leaf=1.0, warmup=warmup))
    jc = jicm.empty_incremental_covariance_map(1536)
    tc = empty_incremental_covariance_map(1536, device="cpu")
    for b in batches:
        jf = jmake(b, capacity=768)
        jc = jins(jc, jf)
        tc = insert(tc, _port(jf), k=10, grid_leaf=1.0, warmup=warmup)
        _assert_map_close(tc, jc)
    assert int(tc.cursor) == 1200 % 1536 and int(tc.epoch) == 3
    assert int(tc.mask.sum()) == 1200
    frac = float(tc.valid.sum()) / float(tc.mask.sum())
    if warmup == 1:
        assert 0.01 < frac < 0.5, frac  # the band gates
    else:
        assert frac > 0.99, frac
    back = interop.incremental_covariance_map_from_numpy(interop.incremental_covariance_map_to_numpy(tc), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back[:-2], tc[:-2])) and torch.equal(back.cursor, tc.cursor)
    frame = tc.as_frame()
    assert torch.equal(frame.mask, tc.mask & tc.valid) and frame.normals is tc.normals
    q = np.random.RandomState(4).rand(200, 3).astype(np.float32) * 10
    qm = np.ones(200, bool)
    for tfn, jfn in ((knn_search_valid, jicm.knn_search_valid), (knn_search_force, jicm.knn_search_force)):
        ti, _, tv = tfn(tc, _t(q), torch.from_numpy(qm), 5)
        ji, _, jv = jfn(jc, jnp.asarray(q), jnp.asarray(qm), 5)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_incremental_covariance_ring_wraps_and_refuses_oversize():
    """Four 768-slot frames of 300 points into a 1024-point ring: the cursor
    advances by the valid points and wraps; a frame larger than the map is
    refused (its ring write would repeat slots)."""
    batches = _plane_batches() + [_plane_batches(2)[0]]
    jins = jax.jit(lambda c, f: jicm.insert(c, f, k=10, grid_leaf=1.0, warmup=1))
    jc = jicm.empty_incremental_covariance_map(1024)
    tc = empty_incremental_covariance_map(1024, device="cpu")
    for b in batches:
        jf = jmake(b, capacity=768)
        jc = jins(jc, jf)
        tc = insert(tc, _port(jf), k=10, grid_leaf=1.0, warmup=1)
    _assert_map_close(tc, jc)
    assert int(tc.cursor) == (300 + 600 + 300 + 300) % 1024
    with pytest.raises(ValueError, match="does not fit"):
        insert(empty_incremental_covariance_map(512, device="cpu"), make_frame(batches[1], device="cpu"))


def test_stats_utils_match_jax():
    """tests/test_misc_components.py::test_stats_utils."""
    rs = RunningStatistics.empty((2,), device="cpu")
    js = jstats.RunningStatistics.empty((2,))
    data = np.random.RandomState(4).randn(50, 2).astype(np.float32)
    for row in data:
        rs, js = rs.add(_t(row)), js.add(jnp.asarray(row))
    for name in ("mean", "var", "std"):
        np.testing.assert_allclose(getattr(rs, name)().numpy(), np.asarray(getattr(js, name)()), atol=STATS_TOL)
    np.testing.assert_allclose(rs.mean().numpy(), data.mean(0), atol=1e-4)
    np.testing.assert_allclose(rs.std().numpy(), data.std(0), atol=1e-3)
    assert float(rs.count) == 50.0 and rs.count.dtype == torch.float32

    win, jwin = IndexedSlidingWindow(max_size=3), jstats.IndexedSlidingWindow(max_size=3)
    for i in range(5):
        assert win.push(f"item{i}") == jwin.push(f"item{i}") == i
    assert (win.first_index, win.last_index, len(win)) == (jwin.first_index, jwin.last_index, len(jwin)) == (2, 4, 3)
    assert win[3] == "item3" and 1 not in win and 4 in win
    with pytest.raises(IndexError):
        win[0]


def _two_planes(n=1024, gap=3.0, seed=0):
    """tests/test_segmentation_raycast.py's two parallel planes."""
    rng = np.random.RandomState(seed)
    a = np.zeros((n, 3), np.float32)
    a[:, :2] = rng.rand(n, 2) * 4 - 2
    b = a.copy()
    b[:, 2] = gap
    a[:, 2] += rng.randn(n).astype(np.float32) * 0.01
    b[:, 2] += rng.randn(n).astype(np.float32) * 0.01
    return np.concatenate([a, b])


def test_region_growing_matches_jax():
    jf = jax.jit(lambda f: jfeatures(f, k=10, grid_leaf=0.5))(jmake(_two_planes(), capacity=2048))
    tf = _port(jf)
    for params in ({"distance_thresh": 0.5}, {"distance_thresh": 0.3, "angle_thresh": 0.1, "max_steps": 3},
                   {"distance_thresh": 0.5, "max_steps": 40, "dilation_steps": 2}):
        seed = np.zeros(3, np.float32)
        j = np.asarray(jregion_growing(jf, jnp.asarray(seed), JRegionGrowingParams(**params)))
        t = region_growing(tf, _t(seed), RegionGrowingParams(**params))
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(params))
        p = RegionGrowingParams(**params)
        ji, _, jv = jknn(jgrid(jf.points, jf.mask, p.grid_leaf), jf.points, jf.mask, p.k,
                         max_sq_dist=p.distance_thresh**2)
        given = _region_growing_from_knn(tf, seed, p, torch.from_numpy(np.asarray(ji)), torch.from_numpy(np.asarray(jv)))
        np.testing.assert_array_equal(given.numpy(), j)
    assert j[:1024].mean() > 0.95 and j[1024:].mean() < 0.05


def test_min_cut_matches_jax():
    rng = np.random.RandomState(1)
    fg = rng.randn(400, 3).astype(np.float32) * 0.3
    bg = rng.randn(400, 3).astype(np.float32) * 0.3 + np.array([6.0, 0, 0], np.float32)
    jf = jmake(np.concatenate([fg, bg]), capacity=1024)
    tf = _port(jf)
    seed = np.zeros(3, np.float32)
    for params in ({"foreground_radius": 1.0, "background_radius": 3.5, "grid_leaf": 0.4},
                   {"foreground_radius": 0.3, "background_radius": 1.0, "grid_leaf": 0.4}):
        j = jmin_cut(jf, seed, JMinCutParams(**params))
        t = min_cut(tf, _t(seed), MinCutParams(**params))
        assert isinstance(t, np.ndarray) and t.dtype == bool
        np.testing.assert_array_equal(t, j, err_msg=str(params))
        p = MinCutParams(**params)
        table = jknn(jgrid(jf.points, jf.mask, p.grid_leaf), jf.points, jf.mask, p.k)
        given = _min_cut_from_knn(tf, seed, p, *(torch.from_numpy(np.asarray(x)) for x in table))
        np.testing.assert_array_equal(given, j)
    j = jmin_cut(jf, seed, JMinCutParams(foreground_radius=1.0, background_radius=3.5, grid_leaf=0.4))
    assert j[:400].mean() > 0.9 and j[400:800].mean() < 0.1
