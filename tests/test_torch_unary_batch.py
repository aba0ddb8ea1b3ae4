"""PyTorch port vs the JAX package: the batched unary VGICP linearize (K2),
B poses over one shared source.

On the CPU the port's `linearize_vgicp_unary_batch` takes its plain version,
`torch.func.vmap` of K1's plain version. It is held to the JAX K2 kernel
running in interpret mode and to the JAX package's off-TPU route (`jax.vmap`
of `linearize_vgicp_unary_xla`), per lane and field at 2e-3 x max|ref|: the
voxel covariances come from raw moments, whose f32 cancellation turns
rounding-order differences into ~2e-4 relative (the JAX repo's own
kernel-vs-XLA tolerance, tests/test_pallas_linearize.py:113-120). Inlier
counts are held exactly. Each lane sits at its own pose and reads the moment
rows of its own probe. The CUDA kernel itself runs only on a card
(chip_smoke.py holds it to the plain version and to K1 there); here the
wrapper's shape checks and its refusal of CPU tensors are checked."""

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
from gtsam_points_tpu_torch.ops import fused_linearize as FL

torch.set_num_threads(1)
TOL = 2e-3
EPS = 1e-3
jprobe = jax.jit(PL.probe_moments)


@jax.jit
def _jax_vmapped_xla(p_src, momT_b, found_b, deltas, mvp, src_covs6):
    """The JAX package's off-TPU route of linearize_vgicp_unary_batch
    (pallas_linearize.py:798-803), jitted apart from the kernel route so the
    two never share a trace."""
    return jax.vmap(
        lambda mT, fd, T: PL.linearize_vgicp_unary_xla(p_src, mT, fd, T, mvp, EPS, src_covs6)
    )(momT_b, found_b, deltas)


def _scene(n, extent, seed, grid=False):
    """A voxel map over `n` random points in a cube of side `extent` (leaf
    1.0, so a wide cube holds mostly one-point voxels), a source displaced by
    a small pose, source covariances, and the pose. `grid` snaps the target
    points to multiples of 1/8, whose squares f32 holds exactly. (The same
    scenes as tests/test_torch_unary.py.)"""
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
    """One-point voxels: C_t is zero, so the eps mode's F is eps I. The grid
    keeps C_t's f32 rounding noise exactly zero in every implementation (see
    tests/test_torch_unary.py)."""
    return _scene(3000, 60.0, 12, grid=True)


def _lanes(scene, lanes, seed, twist=0.03):
    """-> (p, momT_b [B,10,N], found_b [B,N], deltas [B,4,4], covs6) as numpy:
    lane b at the scene's pose times its own twist, uniform in +-`twist`,
    with the moment rows of its own probe; half of lane B // 2's found flags
    are False."""
    jmap, p, covs6, delta, _ = scene
    n = p.shape[1]
    rng = np.random.RandomState(seed)
    xis = rng.uniform(-twist, twist, (lanes, 6)).astype(np.float32)
    deltas = np.stack([delta @ np.asarray(jse3.se3_exp(jnp.asarray(xi))) for xi in xis]).astype(np.float32)
    mask = np.ones(n, bool)
    probes = [jprobe(jmap, jnp.asarray(p), jnp.asarray(mask), jnp.asarray(d)) for d in deltas]
    momT_b = np.stack([np.asarray(m) for m, _ in probes])
    found_b = np.stack([np.asarray(f) for _, f in probes])
    found_b[lanes // 2] &= rng.rand(n) > 0.5
    return p, momT_b, found_b, deltas, covs6


def _jax_kernel(monkeypatch, args):
    """The JAX K2 in interpret mode, as one jitted call, waited for: run
    eagerly, the dispatch on the main thread can deadlock against the
    interpreter's callback thread."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(PL, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(jax.jit(PL.linearize_vgicp_unary_batch, static_argnums=(4, 5))(*args))
    monkeypatch.setattr(PL, "_on_tpu", lambda: False)
    return out


def assert_lanes_close(lin, ref, lanes, tol=TOL):
    """Per lane and field: error <= tol x max|ref|; inlier counts exact."""
    for f in Linearized._fields:
        a, b = np.asarray(getattr(lin, f)), np.asarray(getattr(ref, f))
        assert a.shape[0] == b.shape[0] == lanes, f
        for i in range(lanes):
            if f == "num_inliers":
                assert int(a[i]) == int(b[i]), (f, i)
                continue
            scale = np.max(np.abs(b[i])) + 1e-9
            np.testing.assert_allclose(a[i], b[i], rtol=0, atol=tol * scale, err_msg=f"{f} lane {i}")


CASES = {
    # name: (scene, lanes, min_voxel_points, twist); each scene has 3000
    # points, not a multiple of the JAX kernel's 2048-lane tile. The sparse
    # scene reaches 30 m out, where a 0.03 rad twist moves most points out of
    # their 1 m voxels.
    "box-1": ("box", 1, 4.0, 0.03),
    "box-3": ("box", 3, 4.0, 0.03),
    "one_point_voxels-3": ("sparse", 3, 1.0, 0.003),
}


@pytest.mark.parametrize("with_covs", [True, False], ids=["covs", "eps"])
@pytest.mark.parametrize("case", list(CASES))
def test_unary_batch_matches_jax_kernel_and_xla(monkeypatch, request, case, with_covs):
    scene, lanes, mvp, twist = CASES[case]
    p, momT_b, found_b, deltas, covs6 = _lanes(request.getfixturevalue(scene), lanes, lanes + 5, twist)
    sc = covs6 if with_covs else None
    n = p.shape[1]
    gated = found_b & (momT_b[:, 0] >= mvp)
    assert np.all(gated.sum(1) > 0.3 * n)
    if scene == "sparse":
        assert np.mean(momT_b[:, 0][found_b] == 1.0) > 0.8  # mostly one-point voxels
    # the lanes really differ: other poses, other probes, one lane half masked
    assert not np.array_equal(found_b[0], found_b[lanes // 2]) or lanes == 1

    jargs = [jnp.asarray(a) for a in (p, momT_b, found_b, deltas)] + [mvp, EPS, None if sc is None else jnp.asarray(sc)]
    targs = [torch.from_numpy(a) for a in (p, momT_b, found_b, deltas)] + [mvp, EPS, None if sc is None else torch.from_numpy(sc)]

    lin = FL.linearize_vgicp_unary_batch(*targs)
    assert tuple(lin.H_ss.shape) == (lanes, 6, 6) and tuple(lin.num_inliers.shape) == (lanes,)
    assert_lanes_close(lin, _jax_kernel(monkeypatch, jargs), lanes)
    assert_lanes_close(lin, _jax_vmapped_xla(*jargs[:4], mvp, jargs[6]), lanes)
    np.testing.assert_array_equal(lin.num_inliers.numpy(), gated.sum(1))
    assert not lin.H_tt.any() and not lin.H_ts.any() and not lin.b_t.any()
    for i in range(lanes):
        assert float(torch.linalg.eigvalsh(lin.H_ss[i].double())[0]) > 0  # a usable GN system


@pytest.mark.parametrize("with_covs", [True, False], ids=["covs", "eps"])
def test_unary_batch_plain_equals_a_loop_of_k1(box, with_covs):
    """Lane b of the vmapped plain version is K1's plain version on lane b's
    inputs, bit for bit, as K2's lane b is K1 on the card."""
    p, momT_b, found_b, deltas, covs6 = (torch.from_numpy(a) for a in _lanes(box, 3, seed=21))
    sc = covs6 if with_covs else None
    lin = FL.linearize_vgicp_unary_batch_plain(p, momT_b, found_b, deltas, 4.0, EPS, sc)
    for b in range(3):
        ref = FL.linearize_vgicp_unary_plain(p, momT_b[b], found_b[b], deltas[b], 4.0, EPS, sc)
        for f in Linearized._fields:
            assert torch.equal(getattr(lin, f)[b], getattr(ref, f)), (f, b)


def test_unary_batch_wrapper_shapes_and_device_rule(box):
    """CPU tensors never reach the launcher; inputs of the wrong shape, an
    empty batch and CPU tensors given to the CUDA wrapper are refused."""
    p, momT_b, found_b, deltas, covs6 = (torch.from_numpy(a) for a in _lanes(box, 2, seed=31))
    args = (p, momT_b, found_b, deltas, 4.0, EPS, covs6)
    before = FL.unary_batch_launches
    lin = FL.linearize_vgicp_unary_batch(*args)  # CPU tensors: the plain version, no launch
    assert FL.unary_batch_launches == before
    assert tuple(lin.b_s.shape) == (2, 6) and tuple(lin.error.shape) == (2,)
    with pytest.raises(ValueError, match="CUDA"):
        FL.linearize_vgicp_unary_batch_cuda(*args)
    wrong = {
        "momT_b": (p, momT_b[:, :9], found_b, deltas),  # not [B, 10, N]
        "momT_b lanes": (p, momT_b[:1], found_b, deltas),  # B differs from the poses'
        "found_b": (p, momT_b, found_b[:, :-1], deltas),
        "deltas": (p, momT_b, found_b, deltas[:, :3]),  # not [B, 4, 4]
        "one pose": (p, momT_b, found_b, deltas[0]),  # [4, 4]: no batch axis
        "no lanes": (p, momT_b[:0], found_b[:0], deltas[:0]),
    }
    for name, bad in wrong.items():
        with pytest.raises(ValueError):
            FL.linearize_vgicp_unary_batch(*bad, 4.0, EPS, covs6)
        with pytest.raises(ValueError):
            FL.linearize_vgicp_unary_batch_cuda(*bad, 4.0, EPS, covs6)
    with pytest.raises(ValueError):
        FL.linearize_vgicp_unary_batch(p, momT_b, found_b, deltas, 4.0, EPS, covs6[:3])
    with pytest.raises(TypeError):
        FL.linearize_vgicp_unary_batch(p, momT_b.double(), found_b, deltas, 4.0, EPS, covs6)
    assert FL.unary_batch_launches == before
