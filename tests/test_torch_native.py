"""PyTorch port vs the JAX package: the host library (native/).

The port builds its own copy of host_ops.cpp with g++ at first use; the JAX
package loads the library committed beside it. On the same arrays the two
agree bit for bit:
- `voxelgrid_downsample`: the voxel count, their first-seen order and the
  means, on random points, with a capacity cut, and on points that lie on
  voxel boundaries;
- `HostKdTree.knn`: indices and squared distances;
- `read_floats`, a file with a trailing partial float included.
Each plain numpy version of the port is held to the port's library: the
voxelgrid and `read_floats` bit for bit, the brute-force kNN on its
distances bit for bit and on its indices except at ties.
"""

import numpy as np
import pytest
import torch

import gtsam_points_tpu.native as jnative
from gtsam_points_tpu_torch import native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    assert native.available()
    if not jnative.available():
        pytest.fail("the JAX package's committed host library did not load")


def _cloud(case: str) -> tuple:
    """-> (points [N, 3] float32, leaf, capacity)."""
    rng = np.random.RandomState(3)
    if case == "boundaries":
        # every coordinate a multiple of the leaf (and its float32 neighbours)
        base = rng.randint(-40, 40, (6000, 3)).astype(np.float32) * np.float32(0.3)
        nudge = rng.choice([-1, 0, 1], size=base.shape)
        return np.nextafter(base, base + nudge.astype(np.float32)).astype(np.float32), 0.3, None
    pts = (rng.randn(40000, 3) * np.float32(15.0)).astype(np.float32)
    return pts, 0.3, (2000 if case == "capacity" else None)


@pytest.mark.parametrize("case", ["random", "capacity", "boundaries"])
def test_voxelgrid_matches_jax_library(case):
    pts, leaf, cap = _cloud(case)
    got = native.voxelgrid_downsample(pts, leaf, cap)
    ref = jnative.voxelgrid_downsample(pts, leaf, cap)
    plain = native.voxelgrid_downsample_plain(pts, leaf, cap)
    assert got.shape == ref.shape == plain.shape
    assert got.tobytes() == ref.tobytes()
    assert got.tobytes() == plain.tobytes()
    if cap is not None:
        assert len(got) == cap
    # the first-seen order: voxel 0 is the first point's
    first = np.floor(pts[0] * (np.float32(1.0) / np.float32(leaf)))
    assert np.array_equal(np.floor(got[0] * (np.float32(1.0) / np.float32(leaf))), first)


def test_voxelgrid_differs_from_the_jax_fallback():
    """The JAX module's NumPy fallback is another function: keys from
    p / leaf, voxels sorted by key. The port's plain version follows the
    library instead."""
    pts = (np.random.RandomState(0).randn(20000, 3) * 20).astype(np.float32)
    got = native.voxelgrid_downsample(pts, 0.3)
    coords = np.floor(pts / 0.3).astype(np.int64)
    keys = np.unique(coords, axis=0)
    assert not np.array_equal(np.floor(got / 0.3).astype(np.int64), keys)


def test_knn_matches_jax_library():
    rng = np.random.RandomState(4)
    pts = (rng.rand(6000, 3) * 20).astype(np.float32)
    queries = np.concatenate([pts[:1500], (rng.rand(500, 3) * 20).astype(np.float32)])
    idx, sq = native.HostKdTree(pts).knn(queries, 10)
    j_idx, j_sq = jnative.HostKdTree(pts).knn(queries, 10)
    assert idx.dtype == np.int32 and sq.dtype == np.float32
    assert idx.tobytes() == j_idx.tobytes() and sq.tobytes() == j_sq.tobytes()
    p_idx, p_sq = native.knn_plain(pts, queries, 10)
    assert sq.tobytes() == p_sq.tobytes()
    # a differing index is a tie: the same distance, so the rows' sets of distances agree
    diff = idx != p_idx
    assert diff.sum() <= 2, diff.sum()
    assert np.array_equal(idx[:1500, 0], np.arange(1500))  # each point is its own nearest


def test_knn_ties_and_short_trees():
    """Points on a lattice tie everywhere: distances bit for bit, indices
    equal where the distance is not shared; fewer points than k give -1 at
    1e30, as in the JAX package's library."""
    g = np.stack(np.meshgrid(*[np.arange(8, dtype=np.float32)] * 3, indexing="ij"), -1).reshape(-1, 3)
    idx, sq = native.HostKdTree(g).knn(g, 7)
    j_idx, j_sq = jnative.HostKdTree(g).knn(g, 7)
    assert idx.tobytes() == j_idx.tobytes() and sq.tobytes() == j_sq.tobytes()
    p_idx, p_sq = native.knn_plain(g, g, 7)
    assert sq.tobytes() == p_sq.tobytes()
    assert np.array_equal(idx[:, 0], np.arange(len(g)))
    for q in np.nonzero((idx != p_idx).any(1))[0]:
        d = ((g[p_idx[q]] - g[q]) ** 2).sum(1)
        e = ((g[idx[q]] - g[q]) ** 2).sum(1)
        assert np.array_equal(np.sort(d), np.sort(e))
    few = g[:3]
    idx, sq = native.HostKdTree(few).knn(few, 5)
    j_idx, j_sq = jnative.HostKdTree(few).knn(few, 5)
    assert idx.tobytes() == j_idx.tobytes() and sq.tobytes() == j_sq.tobytes()
    assert (idx[:, 3:] == -1).all() and (sq[:, 3:] == np.float32(1e30)).all()
    assert np.array_equal(native.knn_plain(few, few, 5)[0], idx)


def test_read_floats_matches_jax_library(tmp_path):
    data = np.random.RandomState(5).randn(3001).astype(np.float32)
    path = tmp_path / "floats.bin"
    data.tofile(path)
    got = native.read_floats(str(path))
    assert got.tobytes() == jnative.read_floats(str(path)).tobytes() == data.tobytes()
    assert got.tobytes() == native.read_floats_plain(str(path)).tobytes()
    with open(path, "ab") as f:
        f.write(b"\x01\x02")  # a trailing partial float is dropped by both
    assert native.read_floats(str(path)).tobytes() == jnative.read_floats(str(path)).tobytes() == data.tobytes()
    with pytest.raises(FileNotFoundError):
        native.read_floats(str(tmp_path / "missing.bin"))


def test_library_name_carries_the_source_digest(monkeypatch, tmp_path):
    path = native.library_path()
    assert path.parent == native._build.BUILD_DIR.parent / "native"
    assert path.name.startswith("libgtsam_points_host-") and path.suffix == ".so" and path.exists()
    src = tmp_path / "host_ops.cpp"
    src.write_text(native.SOURCE.read_text() + "// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != path
