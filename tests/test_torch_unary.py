"""PyTorch port vs the JAX package: the unary VGICP linearize (K1) and the
moment probe that feeds it.

On the CPU the port's `linearize_vgicp_unary` takes its plain version. It is
held to the JAX K1 kernel running in interpret mode (as
tests/test_pallas_linearize.py runs it) and to the JAX XLA twin
`linearize_vgicp_unary_xla`, at 2e-3 x max|ref| per field: the voxel
covariances come from raw moments (sum ppᵀ/n - mu muᵀ), whose f32
cancellation turns rounding-order differences into ~2e-4 relative (the JAX
repo's own kernel-vs-XLA tolerance, tests/test_pallas_linearize.py:113-120).
The weighted inlier count is held exactly. The CUDA kernel itself runs only
on a card (chip_smoke.py holds it to the plain version there); here the
wrapper's output layout and its refusal of CPU tensors are checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_points_tpu.ops.pallas_linearize as PL
from gtsam_points_tpu.ops.voxelmap import build_voxelmap as jbuild
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.interop import voxelmap_from_numpy
from gtsam_points_tpu_torch.ops import fused_linearize as FL

torch.set_num_threads(1)
TOL = 2e-3
# one compile per shape, instead of one per operation when run eagerly
jprobe = jax.jit(PL.probe_moments)
jxla = jax.jit(PL.linearize_vgicp_unary_xla, static_argnums=(4, 5))


def _scene(n, extent, seed, grid=False):
    """A voxel map over `n` random points in a cube of side `extent` (leaf
    1.0, so a wide cube holds mostly one-point voxels), a source displaced by
    a small pose, source covariances, and the pose. `grid` snaps the target
    points to multiples of 1/8, whose squares f32 holds exactly."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3).astype(np.float32) - 0.5) * extent
    if grid:
        pts = np.round(pts * 8.0) / 8.0
    jmap = jax.jit(jbuild, static_argnums=(1, 2))(jmake(pts, capacity=n), 1.0, n)
    delta = np.array(jse3.se3_exp(jnp.asarray([0.01, -0.02, 0.015, 0.1, -0.05, 0.08])))
    src = (pts - delta[:3, 3]) @ delta[:3, :3]  # delta^-1 applied to the target points
    src = src + rng.randn(n, 3).astype(np.float32) * 0.02
    g = rng.randn(n, 3, 3).astype(np.float32) * 0.05
    covs = np.einsum("nij,nkj->nik", g, g) + np.eye(3, dtype=np.float32) * 0.01
    covs6 = np.stack([covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2], covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]])
    return jmap, np.ascontiguousarray(src.T.astype(np.float32)), covs6.astype(np.float32), delta, rng


@pytest.fixture(scope="module")
def box():
    return _scene(3000, 8.0, 11)


@pytest.fixture(scope="module")
def sparse():
    """One-point voxels: C_t is zero, so the eps mode's F is eps I. Off the
    grid, C_t of a one-point voxel 30 m out is f32 rounding noise of p²
    (~1e-5, against eps = 1e-3), and the JAX kernel and its XLA twin then
    differ by 1.5e-2 x max|b_s| from each other: the grid keeps that noise
    exactly zero in every implementation."""
    return _scene(3000, 60.0, 12, grid=True)


def _tmap(jmap):
    return voxelmap_from_numpy({k: np.asarray(v) for k, v in jmap._asdict().items()}, device="cpu")


def _probe(jmap, p, delta):
    mask = np.ones(p.shape[1], bool)
    momT, found = jprobe(jmap, jnp.asarray(p), jnp.asarray(mask), jnp.asarray(delta))
    return np.array(momT), np.array(found)


def _jax_kernel(monkeypatch, args):
    """The JAX K1 in interpret mode, as one jitted call. Run eagerly, the
    unpacking's dispatch on the main thread can deadlock against the
    interpreter's callback thread, which dispatches operations too."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(PL, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(jax.jit(PL.linearize_vgicp_unary, static_argnums=(4, 5))(*args))
    monkeypatch.setattr(PL, "_on_tpu", lambda: False)
    return out


def assert_linearized_close(lin, ref, tol=TOL):
    for f in Linearized._fields:
        if f == "num_inliers":
            assert int(getattr(lin, f)) == int(getattr(ref, f))
            continue
        a, b = np.asarray(getattr(lin, f)), np.asarray(getattr(ref, f))
        scale = np.max(np.abs(b)) + 1e-9
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=f)


CASES = {
    # name: (scene, min_voxel_points, half-False mask, weights); each scene
    # has 3000 points, not a multiple of the kernel's 2048-lane tile
    "full": ("box", 4.0, False, False),
    "weights": ("box", 4.0, False, True),
    "half_mask": ("box", 4.0, True, False),
    "one_point_voxels": ("sparse", 1.0, False, False),
}


@pytest.mark.parametrize("with_covs", [True, False], ids=["covs", "eps"])
@pytest.mark.parametrize("case", list(CASES))
def test_unary_matches_jax_kernel_and_xla(monkeypatch, request, case, with_covs):
    scene, mvp, half_mask, use_weights = CASES[case]
    jmap, p, covs6, delta, _ = request.getfixturevalue(scene)
    n = p.shape[1]
    momT, found = _probe(jmap, p, delta)
    rng = np.random.RandomState(n + 7)
    if half_mask:
        found = found & (rng.rand(n) > 0.5)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32) if use_weights else None
    sc = covs6 if with_covs else None
    if case == "one_point_voxels":
        assert np.mean(momT[0][found] == 1.0) > 0.8  # mostly one-point voxels
    assert found.sum() > 0.3 * n

    jargs = [jnp.asarray(a) for a in (p, momT, found, delta)] + [mvp, 1e-3]
    jargs += [None if sc is None else jnp.asarray(sc), None if weights is None else jnp.asarray(weights)]
    targs = [torch.from_numpy(a) for a in (p, momT, found, delta)] + [mvp, 1e-3]
    targs += [None if sc is None else torch.from_numpy(sc), None if weights is None else torch.from_numpy(weights)]

    lin = FL.linearize_vgicp_unary(*targs)
    assert_linearized_close(lin, _jax_kernel(monkeypatch, jargs))
    assert_linearized_close(lin, jxla(*jargs))
    gated = found & (momT[0] >= mvp)
    expect = gated.sum() if weights is None else np.sum(weights[gated], dtype=np.float64)
    assert abs(float(lin.num_inliers) - expect) <= 1.0
    assert float(torch.linalg.eigvalsh(lin.H_ss.double())[0]) > 0  # a usable GN system


def test_probe_moments_matches_jax(box):
    """found equal, and the moment rows equal bit for bit: both pick the
    one matching record, the reference through 0/1 matmuls."""
    jmap, p, _, delta, rng = box
    mask = rng.rand(p.shape[1]) > 0.1
    jm, jf = jprobe(jmap, jnp.asarray(p), jnp.asarray(mask), jnp.asarray(delta))
    tm, tf = FL.probe_moments(_tmap(jmap), torch.from_numpy(p), torch.from_numpy(mask), torch.from_numpy(delta))
    assert tm.shape == (10, p.shape[1]) and tm.is_contiguous()  # what the CUDA wrapper requires
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert 0.5 * p.shape[1] < tf.sum() < mask.sum()
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert not tm.numpy()[:, ~tf.numpy()].any()  # rows of points not found are zero


def test_unary_wrapper_layout_and_device_rule(box):
    """The kernel's 29 sums unpack to the plain version's Linearized (H_ss
    symmetric, b_s = -[p x u; u]); CPU tensors never reach the launcher."""
    jmap, p, covs6, delta, _ = box
    momT, found = _probe(jmap, p, delta)
    args = [torch.from_numpy(a) for a in (p, momT, found, delta)] + [4.0, 1e-3, torch.from_numpy(covs6)]
    plain = FL.linearize_vgicp_unary_plain(*args)
    H = plain.H_ss
    torch.testing.assert_close(H, H.T, rtol=0, atol=0)
    iu = torch.triu_indices(3, 3)
    col = torch.cat([H[:3, :3][iu[0], iu[1]], H[:3, 3:].reshape(9), H[3:, 3:][iu[0], iu[1]],
                     -plain.b_s, plain.error[None], plain.num_inliers.to(torch.float32)[None]])
    assert col.shape == (29,)
    assert_linearized_close(FL._unpack_unary(col), plain, tol=1e-7)
    assert not plain.H_tt.any() and not plain.H_ts.any() and not plain.b_t.any()

    before = FL.unary_launches
    FL.linearize_vgicp_unary(*args)  # CPU tensors: the plain version, no launch
    assert FL.unary_launches == before
    with pytest.raises(ValueError):
        FL.linearize_vgicp_unary_cuda(*args)
    assert FL.unary_num_blocks(1) == 1 and FL.unary_num_blocks(25_088) == 196
    assert FL.unary_num_blocks(3_136) == 25 and FL.unary_num_blocks(10**8) == 256
