"""PyTorch port vs the JAX package: downsampling and outlier removal.

- `voxelgrid_sampling` on a 2048-point ring scan with normals, covariances,
  intensities and times, at leaf 0.5 with room for every voxel and at a
  capacity that drops voxels: every output bit for bit (both sum each
  voxel's points in sorted order from its first to its last), except the
  renormalized normals, within one float32 ulp: inside the jitted function
  XLA fuses |n| its own way (standalone, `jnp.linalg.norm` and
  `torch.linalg.norm` agree bit for bit; no order of the three squares, with
  or without FMA, reproduces the fused one);
- `random_sampling` and `randomgrid_sampling` given the JAX package's own
  draws (`jax.random.uniform` scores, `jax.random.permutation`) through
  the port's `*_from_scores` and `*_from_permutation`: the selection bit for
  bit; the public functions draw from a `torch.Generator` and are
  reproducible from its seed;
- `remove_outliers` on a scan with planted far points: the mask equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.ops import downsample as jds
from gtsam_points_tpu.ops.features import estimate_normals_covs as jfeatures
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.ops import downsample as tds

torch.set_num_threads(1)
FIELDS = ("points", "mask", "normals", "covs", "intensities", "times")


def _np(frame) -> dict:
    return {k: None if getattr(frame, k) is None else np.asarray(getattr(frame, k)) for k in FIELDS}


def _assert_frames_equal(t, j, normals_ulp: int = 0):
    for k in FIELDS:
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is None:
            continue
        if k == "normals" and normals_ulp:
            b = np.asarray(b)
            np.testing.assert_array_max_ulp(a.numpy(), b, maxulp=normals_ulp)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


@pytest.fixture(scope="module")
def frames():
    scan = ring_scans(ring_world(0, 24000), ring_trajectory(1, lap=100), scan_n=2048, seed=1)[0]
    rng = np.random.RandomState(4)
    j = jax.jit(lambda f: jfeatures(f, k=10, grid_leaf=1.0))(
        jmake(scan, intensities=rng.rand(len(scan)).astype(np.float32), times=rng.rand(len(scan)).astype(np.float32)))
    return j, interop.frame_from_numpy(_np(j), device="cpu")


@pytest.mark.parametrize("capacity", [2048, 512])
def test_voxelgrid_sampling_bit_for_bit(frames, capacity):
    j, t = frames
    jo = jax.jit(lambda f: jds.voxelgrid_sampling(f, 0.5, capacity=capacity))(j)
    to = tds.voxelgrid_sampling(t, 0.5, capacity=capacity)
    _assert_frames_equal(to, jo, normals_ulp=1)
    kept = int(to.mask.sum())
    assert (kept == capacity) == (capacity == 512) and kept > 256


def test_random_sampling_given_jax_draws(frames):
    j, t = frames
    key = jax.random.PRNGKey(3)
    jo = jax.jit(lambda f: jds.random_sampling(f, 700, key))(j)
    scores = np.asarray(jax.random.uniform(key, (j.capacity,)))
    _assert_frames_equal(tds.random_sampling_from_scores(t, 700, torch.from_numpy(scores)), jo)
    a = tds.random_sampling(t, 700, torch.Generator().manual_seed(5))
    b = tds.random_sampling(t, 700, torch.Generator().manual_seed(5))
    assert torch.equal(a.points, b.points) and bool(a.mask.all())


@pytest.mark.parametrize("rate", [0.3, 0.8])
def test_randomgrid_sampling_given_jax_draws(frames, rate):
    j, t = frames
    key = jax.random.PRNGKey(8)
    jo = jax.jit(lambda f: jds.randomgrid_sampling(f, 1.0, rate, key, capacity=1536))(j)
    perm = np.asarray(jax.random.permutation(key, j.capacity))
    to = tds.randomgrid_sampling_from_permutation(t, 1.0, rate, torch.from_numpy(perm).long(), capacity=1536)
    _assert_frames_equal(to, jo)
    assert 0 < int(to.mask.sum()) <= 1536
    a = tds.randomgrid_sampling(t, 1.0, rate, torch.Generator().manual_seed(5), capacity=1536)
    b = tds.randomgrid_sampling(t, 1.0, rate, torch.Generator().manual_seed(5), capacity=1536)
    assert torch.equal(a.points, b.points) and torch.equal(a.mask, b.mask)


@pytest.mark.parametrize("grid_leaf", [1.0, None], ids=["leaf", "heuristic"])
def test_remove_outliers_mask(frames, grid_leaf):
    j, t = frames
    pts = np.asarray(j.points).copy()
    pts[::97] += np.float32(3.0)  # planted outliers, off the walls
    j = j.replace(points=jnp.asarray(pts))
    t = t.replace(points=torch.from_numpy(pts))
    jo = jds.remove_outliers(j, k=10, grid_leaf=grid_leaf)
    to = tds.remove_outliers(t, k=10, grid_leaf=grid_leaf)
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
    assert not bool(to.mask[::97].any()) and int(to.mask.sum()) > 1800
