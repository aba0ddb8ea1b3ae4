"""PyTorch port vs the JAX package: voxel keys, bucket hash, voxel-map inserts
and the moments-based covariance preprocessing.

Integer outputs (keys, bucket ids, table keys via their int32 view, row ids,
last_seen, num_voxels) must match bit for bit: bucket priority and slots
depend on them. Float moments must match to 1e-5 x max|ref|: the port sums
the same rows in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.ops import hash_index as jh
from gtsam_points_tpu.ops import voxel_keys as jvk
from gtsam_points_tpu.ops import voxelmap as jvm
from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch.interop import frame_from_numpy, voxelmap_from_numpy, voxelmap_to_numpy
from gtsam_points_tpu_torch.ops import hash_index as th
from gtsam_points_tpu_torch.ops import voxel_keys as tvk
from gtsam_points_tpu_torch.ops import voxelmap as tvm
from gtsam_points_tpu_torch.ops.features import estimate_normals_covs_moments as tcovs

torch.set_num_threads(1)
MOMENT_TOL = 1e-5
_FIELDS = ("leaf", "keys", "moments", "last_seen", "epoch", "num_voxels", "table")

_j_insert = jax.jit(jvm.insert_frame)
_j_incremental = jax.jit(jvm.insert_frame_incremental, static_argnums=2)


def _np_map(vmap):
    return {k: np.asarray(getattr(vmap, k)) for k in _FIELDS}


def assert_maps_match(jmap, tmap):
    j, t = _np_map(jmap), voxelmap_to_numpy(tmap)
    for k in ("keys", "last_seen", "epoch", "num_voxels", "leaf"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    rj, rt = j["table"].reshape(-1, 16), t["table"].reshape(-1, 16)
    np.testing.assert_array_equal(rt[:, 0].view(np.int32), rj[:, 0].view(np.int32), err_msg="table keys")
    np.testing.assert_array_equal(rt[:, 1], rj[:, 1], err_msg="table rows")
    for name, a, b in (("moments", t["moments"], j["moments"]), ("table moments", rt[:, 2:], rj[:, 2:])):
        np.testing.assert_allclose(a, b, rtol=0, atol=MOMENT_TOL * np.max(np.abs(b)), err_msg=name)


@pytest.fixture(scope="module")
def world_scans():
    """Three ring scans in world coordinates (2048 points each) + SPD covs."""
    world = ring_world(0, 24000)
    T = ring_trajectory(6, lap=25)[::2]
    scans = ring_scans(world, T, scan_n=2048, seed=1)
    rng = np.random.RandomState(7)
    out = []
    for Ti, s in zip(T, scans):
        pts = (s @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        A = rng.randn(len(pts), 3, 3).astype(np.float32) * 0.05
        covs = np.einsum("nij,nkj->nik", A, A).astype(np.float32)
        out.append((pts, covs))
    return out


def _frames(pts, covs, with_covs):
    jf = jmake(pts, covs=covs if with_covs else None)
    arrays = {"points": np.asarray(jf.points), "mask": np.asarray(jf.mask)}
    if with_covs:
        arrays["covs"] = np.asarray(jf.covs)
    return jf, frame_from_numpy(arrays, device="cpu")


@pytest.mark.parametrize("leaf", [1.0, 0.37])
def test_point_keys_and_hash_bit_exact(leaf):
    rng = np.random.RandomState(11)
    pts = (rng.randn(5000, 3) * 300).astype(np.float32)
    mask = rng.rand(5000) > 0.1
    leaf_j = jnp.float32(leaf)
    k_j = np.asarray(jvk.point_keys(jnp.asarray(pts), jnp.asarray(mask), leaf_j))
    leaf_t = torch.tensor(leaf, dtype=torch.float32)
    k_t = tvk.point_keys(torch.from_numpy(pts), torch.from_numpy(mask), leaf_t).numpy()
    np.testing.assert_array_equal(k_t, k_j)
    kp_t = tvk.point_keys_planar(torch.from_numpy(pts.T.copy()), torch.from_numpy(mask), leaf_t).numpy()
    np.testing.assert_array_equal(kp_t, k_j)
    np.testing.assert_array_equal(tvk.unpack_key(torch.from_numpy(k_j[mask])).numpy(),
                                  np.asarray(jvk.unpack_key(jnp.asarray(k_j[mask]))))
    for which in (0, 1):
        for size in (512, 1 << 16, 1 << 20):
            np.testing.assert_array_equal(
                th.hash_key(torch.from_numpy(k_j), which, size).numpy(),
                np.asarray(jh.hash_key(jnp.asarray(k_j), which, size)),
            )


@pytest.mark.parametrize("with_covs", [False, True])
def test_insert_frame_matches_jax(world_scans, with_covs):
    jf, tf = _frames(*world_scans[0], with_covs)
    jmap = _j_insert(jvm.empty_voxelmap(1.0, 4096), jf)
    tmap = tvm.insert_frame(tvm.empty_voxelmap(1.0, 4096, device="cpu"), tf)
    assert int(tmap.num_voxels) > 100
    assert_maps_match(jmap, tmap)


def test_insert_frame_incremental_matches_jax(world_scans):
    """Both packages start from the same JAX-built map, carried across."""
    jf0, _ = _frames(*world_scans[0], True)
    jmap0 = _j_insert(jvm.empty_voxelmap(1.0, 4096), jf0)
    tmap0 = voxelmap_from_numpy(_np_map(jmap0), device="cpu")
    assert_maps_match(jmap0, tmap0)
    jf1, tf1 = _frames(*world_scans[1], True)
    jmap1, j_over = _j_incremental(jmap0, jf1, 2048)
    tmap1, t_over = tvm.insert_frame_incremental(tmap0, tf1, 2048)
    assert bool(t_over) == bool(j_over) is False
    assert int(tmap1.num_voxels) > int(tmap0.num_voxels)
    assert_maps_match(jmap1, tmap1)


def test_lru_overflow_matches_jax(world_scans):
    """A map too small for two scans: the incremental insert reports the
    overflow and the structural insert evicts the least recently seen voxels."""
    frames = [_frames(*s, False) for s in world_scans]
    cap = 600
    jmap = _j_insert(jvm.empty_voxelmap(1.0, cap), frames[0][0])
    tmap = tvm.insert_frame(tvm.empty_voxelmap(1.0, cap, device="cpu"), frames[0][1])
    assert_maps_match(jmap, tmap)
    for jf, tf in frames[1:]:
        _, j_over = _j_incremental(jmap, jf, 2048)
        _, t_over = tvm.insert_frame_incremental(tmap, tf, 2048)
        assert bool(t_over) and bool(j_over)
        jmap, tmap = _j_insert(jmap, jf), tvm.insert_frame(tmap, tf)
        assert int(tmap.num_voxels) == cap
        assert_maps_match(jmap, tmap)


def test_lookup_fetch_planar_matches_jax(world_scans):
    jf, tf = _frames(*world_scans[0], True)
    jmap = _j_insert(jvm.empty_voxelmap(1.0, 4096), jf)
    tmap = voxelmap_from_numpy(_np_map(jmap), device="cpu")
    q = (world_scans[1][0] + 0.1).astype(np.float32)
    mask = np.ones(len(q), bool)
    mask[::7] = False
    out_j = jvm.lookup_fetch_planar(jmap, jnp.asarray(q.T), jnp.asarray(mask))
    out_t = tvm.lookup_fetch_planar(tmap, torch.from_numpy(q.T.copy()), torch.from_numpy(mask))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    assert out_t[0].any()
    for a, b in zip(out_t[1:], out_j[1:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.max(np.abs(b)))


def test_eigh3_matches_jax():
    from gtsam_points_tpu.ops.eigh3 import eigh3 as jeigh
    from gtsam_points_tpu_torch.ops.eigh3 import eigh3 as teigh

    rng = np.random.RandomState(12)
    Q, _ = np.linalg.qr(rng.randn(256, 3, 3))
    lam = np.sort(rng.rand(256, 3) * 2 + np.asarray([0.0, 0.5, 1.5]), axis=1)  # separated
    A = np.einsum("nij,nj,nkj->nik", Q, lam, Q).astype(np.float32)
    wj, vj = (np.asarray(x) for x in jeigh(jnp.asarray(A)))
    wt, vt = (x.numpy() for x in teigh(torch.from_numpy(A)))
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-5 * np.max(np.abs(wj)))
    dots = np.abs(np.einsum("nij,nij->nj", vt, vj))  # eigenvectors up to sign
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def test_estimate_normals_covs_moments_matches_jax(world_scans):
    """The regularised covariance is I - 0.999 n nᵀ for the cell normal n, and
    the closed-form f32 eigendecomposition (arccos of a cubic's discriminant,
    then cross products of A - lam I) moves n by about 1e3 eps / (eigenvalue
    gap). So the typical point agrees to 2e-4 (measured: median 6e-5), and
    cells whose smallest eigenvalues nearly coincide, which have no well-posed
    normal, stay under 1% of points beyond 2e-3."""
    jf, tf = _frames(world_scans[2][0], None, False)
    cj = np.asarray(jax.jit(jcovs)(jf).covs)
    out_t = tcovs(tf)
    diff = np.max(np.abs(out_t.covs.numpy() - cj), axis=(1, 2))
    assert np.median(diff) < 2e-4
    assert np.mean(diff > 2e-3) < 0.01
    assert out_t.normals.shape == (tf.capacity, 3)
