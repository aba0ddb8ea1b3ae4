"""PyTorch port vs the JAX package: the DDA voxel raycaster (utils/raycast).

The same float32 numpy rays go to both packages' `raycast_voxels`, the
port's on the CPU, and every output is held bit for bit: `coords` at every
step (the invalid steps, where both repeat the ray's current voxel,
included) and `valid`. The cases:
- tests/test_segmentation_raycast.py's three (a straight ray along x,
  a diagonal and a negative one, a ray inside one voxel);
- chip_smoke.lattice_rays(): rays between voxel centres along the
  lattice's diagonals, where two or three axes tie at every step, so the
  traversal follows the rule for ties alone (the first axis);
- a seeded batch whose origins lie on voxel faces in one, two or three
  axes (as a sensor at x = y = 0 does), with rays that stay in one voxel,
  rays parallel to one or two axes and rays of zero length among them,
  in a leading batch shape of two axes.
The whole sweep of chip_smoke's phase 40 runs in
tests/test_torch_real_size.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsam_points_tpu.utils.raycast import raycast_voxels as jray
from gtsam_points_tpu_torch.utils.raycast import raycast_voxels as tray

torch.set_num_threads(1)


def _face_batch(n: int = 3000, leaf: float = 0.5, seed: int = 5) -> dict:
    """n rays, [2, n // 2, 3]: origins on voxel faces in a random set of
    axes, targets up to 12 m away; every 10th ray parallel to one axis or
    two, every 50th inside the origin's voxel, every 100th of zero length."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-20, 20, (n, 3))
    on_face = rng.rand(n, 3) < 0.5
    o = np.where(on_face, np.round(o / leaf) * leaf, o)
    t = o + rng.uniform(-12, 12, (n, 3))
    flat = np.arange(n) % 10 == 0
    t[flat] = np.where(rng.rand(int(flat.sum()), 3) < 0.5, o[flat], t[flat])
    t[::50] = (np.floor(o[::50] / leaf) + 0.5) * leaf
    t[::100] = o[::100]
    o, t = o.astype(np.float32), t.astype(np.float32)
    return {"origins": o.reshape(2, n // 2, 3), "targets": t.reshape(2, n // 2, 3)}


CASES = {
    "straight_axis": ({"origins": [[0.05, 0.05, 0.05]], "targets": [[0.45, 0.05, 0.05]]}, 0.1, 8),
    "diagonal_and_negative": ({"origins": [[0.95, 0.95, 0.95], [-0.05, -0.05, -0.05]],
                               "targets": [[-0.95, -0.95, -0.95], [-0.05, -0.05, -0.95]]}, 0.5, 32),
    "same_voxel": ({"origins": [[0.2, 0.2, 0.2]], "targets": [[0.3, 0.3, 0.3]]}, 1.0, 4),
    "lattice_ties": (chip_smoke.lattice_rays(), chip_smoke.RAYCAST_LEAF, chip_smoke.LATTICE_STEPS),
    "face_origins": (_face_batch(), 0.5, 80),  # at most 36 m of |d|_1 a ray: 72 voxels
}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_raycast_matches_jax_bit_for_bit(case):
    rays, leaf, steps = CASES[case]
    o, t = (np.asarray(rays[k], np.float32) for k in ("origins", "targets"))
    jc, jv = (np.asarray(a) for a in jray(jnp.asarray(o), jnp.asarray(t), leaf, steps))
    tc, tv = tray(o, t, leaf, steps, device="cpu")
    assert tc.dtype == torch.int32 and tv.dtype == torch.bool
    assert tc.shape == jc.shape == (*o.shape[:-1], steps, 3) and tv.shape == jv.shape
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert not jv[..., -1].any()  # every ray ends within its steps
    if case == "face_origins":
        assert jv.sum() > 10 * jv.shape[1]
        assert not jv[0, ::50].any() and not jv[0, ::100].any()


def test_torch_raycast_lattice_follows_the_first_axis():
    """On the (1, 1, 1) diagonal every step ties all three axes: the ray
    takes x, then y, then z, a staircase of 3 k voxels before the target's."""
    leaf, k = 0.5, 3
    c, v = tray([[0.25, 0.25, 0.25]], [[0.25 + k * leaf] * 3], leaf, 12, device="cpu")
    visited = c[0][v[0]].tolist()
    expected = [[0, 0, 0]]
    for _ in range(k):
        for axis in range(3):
            nxt = list(expected[-1])
            nxt[axis] += 1
            expected.append(nxt)
    assert visited == expected[:-1]
    assert c[0, len(visited):].tolist() == [expected[-1]] * (12 - len(visited))


def test_torch_raycast_refuses_unlike_shapes():
    with pytest.raises(ValueError):
        tray(np.zeros((4, 3), np.float32), np.zeros((3, 3), np.float32), 0.5, 8, device="cpu")
    with pytest.raises(ValueError):
        tray(np.zeros((4, 2), np.float32), np.zeros((4, 2), np.float32), 0.5, 8, device="cpu")
