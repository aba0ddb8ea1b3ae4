"""PyTorch port vs the JAX package: the moments-fused VGICP linearize (K4),
the single-scan entry point `vgicp_scan_linearize`, and the fixed-order
segment sum of the voxel-map build.

On the CPU the port's `linearize_vgicp_moments` takes its plain version. It
is held to the JAX K4 kernel running in interpret mode (as
tests/test_pallas_linearize.py runs it) and to the JAX XLA twin
`linearize_vgicp_moments_xla`, at 2e-3 x max|ref| per field, the JAX repo's
own kernel-vs-XLA tolerance for raw-moment covariances
(tests/test_pallas_linearize.py:113-120); the inlier count is held exactly.
The CUDA kernel runs only on a card (chip_smoke.py holds it to the plain
version there); here the wrapper's refusal of CPU tensors is checked. The
kernel sums K1's 29 source-frame terms and expands them to the 12x12 system;
`linearize_vgicp_moments_source_plain`, that order of sums in plain
PyTorch, is held to the plain version at 1e-4 x max|ref| (both finalize the
raw moments alike) and to the JAX K4 at 2e-3, and shown at a voxel whose
fused covariance lies at the degeneracy threshold, where the two frames'
tests can disagree.

The map build sums each voxel's rows in sorted order on every device
(`voxelmap._run_sum`); on the CPU that is bit for bit what `index_add_`
gave, which the last tests check."""

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
from gtsam_points_tpu_torch.ops import planar
from gtsam_points_tpu_torch.ops import voxelmap as VM
from gtsam_points_tpu_torch.types.frame import make_frame as tmake

torch.set_num_threads(1)
TOL = 2e-3
N = 3000  # not a multiple of the JAX kernel's 2048-lane tile
TWIST = [0.01, -0.02, 0.015, 0.1, -0.05, 0.08]
# one compile per shape, instead of one per operation when run eagerly
jprobe = jax.jit(PL.probe_moments)
jxla = jax.jit(PL.linearize_vgicp_moments_xla, static_argnums=(4, 5))
jscan = jax.jit(PL.vgicp_scan_linearize, static_argnums=(4, 5))


@pytest.fixture(scope="module")
def scene():
    """3000 points in an 8 m cube, each package's leaf-1.0 map of them, and
    source covariances."""
    rng = np.random.RandomState(11)
    pts = (rng.rand(N, 3).astype(np.float32) - 0.5) * 8.0
    jmap = jax.jit(jbuild, static_argnums=(1, 2))(jmake(pts, capacity=N), 1.0, N)
    tmap = VM.build_voxelmap(tmake(pts, device="cpu"), 1.0, N)
    g = rng.randn(N, 3, 3).astype(np.float32) * 0.05
    covs = np.einsum("nij,nkj->nik", g, g) + np.eye(3, dtype=np.float32) * 0.01
    covs6 = np.stack([covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2], covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]])
    return pts, jmap, tmap, covs6.astype(np.float32)


def _source(pts, delta, seed):
    """The target points moved by delta⁻¹, plus 2 cm of noise, planar [3, N]."""
    rng = np.random.RandomState(seed)
    src = (pts - delta[:3, 3]) @ delta[:3, :3] + rng.randn(*pts.shape).astype(np.float32) * 0.02
    return np.ascontiguousarray(src.T.astype(np.float32))


def _delta(at_identity):
    return np.eye(4, dtype=np.float32) if at_identity else np.array(jse3.se3_exp(jnp.asarray(TWIST)))


def _jax_kernel(monkeypatch, args):
    """The JAX K4 in interpret mode, as one jitted call. Run eagerly, the
    unpacking's dispatch on the main thread can deadlock against the
    interpreter's callback thread, which dispatches operations too."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(PL, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(jax.jit(PL.linearize_vgicp_moments, static_argnums=(4, 5))(*args))
    monkeypatch.setattr(PL, "_on_tpu", lambda: False)
    return out


def assert_linearized_close(lin, ref, tol=TOL):
    for f in Linearized._fields:
        a, b = np.asarray(getattr(lin, f)), np.asarray(getattr(ref, f))
        if f == "num_inliers":
            assert int(a) == int(b)
            continue
        scale = np.max(np.abs(b)) + 1e-9
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=f)


CASES = {
    # name: (at the identity, min_voxel_points, half-False mask)
    "identity": (True, 4.0, False),
    "pose": (False, 4.0, False),
    "pose_mvp1": (False, 1.0, False),
    "pose_half_mask": (False, 4.0, True),
}


_JAX_K4 = {}


def _case_inputs(scene, case, with_covs):
    """(jargs, targs, gated) of a CASES entry: the JAX package's probe rows."""
    at_identity, mvp, half_mask = CASES[case]
    pts, jmap, _, covs6 = scene
    delta = _delta(at_identity)
    p = _source(pts, delta, seed=len(case))
    mask = np.ones(N, bool)
    momT, found = (np.array(a) for a in jprobe(jmap, jnp.asarray(p), jnp.asarray(mask), jnp.asarray(delta)))
    if half_mask:
        found = found & (np.random.RandomState(5).rand(N) > 0.5)
    gated = found & (momT[0] >= mvp)
    sc = covs6 if with_covs else None
    jargs = [jnp.asarray(a) for a in (p, momT, found, delta)] + [mvp, 1e-3, None if sc is None else jnp.asarray(sc)]
    targs = [torch.from_numpy(a) for a in (p, momT, found, delta)] + [mvp, 1e-3]
    targs += [None if sc is None else torch.from_numpy(sc)]
    return jargs, targs, gated


def _jax_k4(monkeypatch, case, with_covs, jargs):
    """The JAX K4 on a CASES entry, computed once per module."""
    key = (case, with_covs)
    if key not in _JAX_K4:
        _JAX_K4[key] = _jax_kernel(monkeypatch, jargs)
    return _JAX_K4[key]


@pytest.mark.parametrize("with_covs", [True, False], ids=["covs", "eps"])
@pytest.mark.parametrize("case", list(CASES))
def test_moments_matches_jax_kernel_and_xla(monkeypatch, scene, case, with_covs):
    jargs, targs, gated = _case_inputs(scene, case, with_covs)
    mvp, found = CASES[case][1], jargs[2]
    assert gated.sum() > 0.2 * N and (~gated & np.asarray(found)).any() == (mvp > 1.0)

    lin = FL.linearize_vgicp_moments(*targs)
    assert_linearized_close(lin, _jax_k4(monkeypatch, case, with_covs, jargs))
    assert_linearized_close(lin, jxla(*jargs))
    assert int(lin.num_inliers) == gated.sum()
    H = torch.cat([torch.cat([lin.H_tt, lin.H_ts], 1), torch.cat([lin.H_ts.T, lin.H_ss], 1)])
    # a usable GN system: positive on the source block, and the target block
    # mirrors it (J_t = -J_s up to the pose), so the full H is semidefinite
    assert float(torch.linalg.eigvalsh(lin.H_ss.double())[0]) > 0
    assert float(torch.linalg.eigvalsh(H.double())[0]) > -1e-3 * float(H.abs().max())


@pytest.mark.parametrize("with_covs", [True, False], ids=["covs", "eps"])
@pytest.mark.parametrize("case", list(CASES))
def test_source_order_matches_plain_and_jax_kernel(monkeypatch, scene, case, with_covs):
    """K4's order of sums (K1's 29 source-frame sums, then the expansion)
    against the 92 direct sums of the plain version at 1e-4 and the JAX K4
    at 2e-3 (raw-moment cancellation enters there); its source block is
    K1's plain version bit for bit."""
    jargs, targs, gated = _case_inputs(scene, case, with_covs)
    src = FL.linearize_vgicp_moments_source_plain(*targs)
    assert_linearized_close(src, FL.linearize_vgicp_moments_plain(*targs), tol=1e-4)
    assert_linearized_close(src, _jax_k4(monkeypatch, case, with_covs, jargs))
    k1 = FL.linearize_vgicp_unary_plain(*targs)
    for f in ("H_ss", "b_s", "error", "num_inliers"):
        assert torch.equal(getattr(src, f), getattr(k1, f)), f
    assert int(src.num_inliers) == gated.sum()


def test_source_order_at_the_degeneracy_threshold(monkeypatch, scene):
    """A voxel whose fused covariance F = C_t (zero source covariance) is
    diag(1, 1, d), with d where sym_inv's test on F (the plain version, the
    JAX kernel: W = 0) and its test on Rᵀ F R (K4's order: A != 0) disagree.
    The divergence is that voxel's contribution and nothing else: with it
    masked out the two agree at 1e-4, and with it in, the source order's
    result less the plain version's is the voxel's own contribution to
    within 1e-4 x max|ref|. The point counts as an inlier in both."""
    jargs, targs, _ = _case_inputs(scene, "pose", True)
    p, momT, found, delta, mvp, eps, sc = targs
    R = delta[:3, :3]

    def f6(d):
        return torch.tensor([[1.0], [0.0], [0.0], [1.0], [0.0], [d]], dtype=torch.float32)

    def degenerate(C6):
        return bool(torch.all(planar.sym_inv(C6) == 0))

    ds = [d for d in np.logspace(-12, -6, 241).astype(np.float32)
          if degenerate(f6(d)) != degenerate(planar.sym_rotate(R.T, f6(d)))]
    assert ds, "no d at which the two frames' tests disagree"
    d = float(ds[0])
    momT, sc, found = momT.clone(), sc.clone(), found.clone()
    momT[:, 0] = torch.tensor([10.0, 0.0, 0.0, 0.0, 10.0, 0.0, 0.0, 10.0, 0.0, 10.0 * d])  # mu = 0, C_t = diag(1, 1, d)
    sc[:, 0] = 0.0
    found[0] = True
    assert torch.equal(_voxel_cov6(momT[:, :1]), f6(d))

    def both(fnd):
        args = (p, momT, fnd, delta, mvp, eps, sc)
        return FL.linearize_vgicp_moments_source_plain(*args), FL.linearize_vgicp_moments_plain(*args)

    src_all, plain_all = both(found)
    others = found.clone()
    others[0] = False
    src_rest, plain_rest = both(others)
    alone = torch.zeros_like(found)
    alone[0] = True
    src_one, plain_one = both(alone)
    assert_linearized_close(src_rest, plain_rest, tol=1e-4)
    assert int(src_all.num_inliers) == int(plain_all.num_inliers) == int(plain_rest.num_inliers) + 1
    assert float(plain_one.H_ss.abs().max()) == 0.0 and float(src_one.H_ss.abs().max()) > 0.0
    for f in Linearized._fields[:-1]:
        a, b, one = getattr(src_all, f), getattr(plain_all, f), getattr(src_one, f)
        scale = max(float(a.abs().max()), float(b.abs().max()))
        np.testing.assert_allclose((a - b).numpy(), one.numpy(), rtol=0, atol=1e-4 * scale, err_msg=f)
    # the JAX K4 takes the plain version's side
    jargs = [jnp.asarray(t.numpy()) for t in (p, momT, found, delta)] + [mvp, eps, jnp.asarray(sc.numpy())]
    assert_linearized_close(plain_all, _jax_kernel(monkeypatch, jargs))
    print(f"d = {d:.3e}: the voxel moves H_ss by up to {float(src_one.H_ss.abs().max()):.3e} "
          f"(the rest of the system: {float(plain_rest.H_ss.abs().max()):.3e})")


def _voxel_cov6(momT):
    """Each row's voxel covariance [6, N], as both versions finalize it."""
    return FL._voxel_stats(momT)[1]


@pytest.mark.parametrize("with_covs", [True, False], ids=["covs", "eps"])
def test_scan_linearize_matches_jax(scene, with_covs):
    """The port's `vgicp_scan_linearize` on its own map against the JAX
    package's on its own, from the same points."""
    pts, jmap, tmap, covs6 = scene
    delta = _delta(False)
    p = _source(pts, delta, seed=3)
    mask = np.random.RandomState(4).rand(N) > 0.1
    sc = covs6 if with_covs else None
    ref = jscan(jmap, jnp.asarray(p), jnp.asarray(mask), jnp.asarray(delta), 4.0, 1e-3,
                None if sc is None else jnp.asarray(sc))
    lin = FL.vgicp_scan_linearize(tmap, torch.from_numpy(p), torch.from_numpy(mask), torch.from_numpy(delta),
                                  4.0, 1e-3, None if sc is None else torch.from_numpy(sc))
    assert int(lin.num_inliers) > 0.2 * N
    assert_linearized_close(lin, ref)


@pytest.mark.parametrize("at_identity", [True, False], ids=["identity", "pose"])
def test_scan_linearize_matches_classic_pipeline(scene, at_identity):
    """`vgicp_scan_linearize` == lookup_fetch_planar -> sym_inv -> the plain
    K3 (the JAX repo's own check, tests/test_pallas_linearize.py:123-139)."""
    pts, _, tmap, covs6 = scene
    delta = torch.from_numpy(_delta(at_identity))
    p = torch.from_numpy(_source(pts, delta.numpy(), seed=6))
    mask = torch.ones(N, dtype=torch.bool)
    sc = torch.from_numpy(covs6)
    pm = planar.transform(delta, p)
    found, cnt, mu, C6 = VM.lookup_fetch_planar(tmap, pm, mask)
    W6 = planar.sym_inv(C6 + planar.sym_rotate(delta[:3, :3], sc))
    ref = FL.linearize_fused_plain(p, mu, W6, found & (cnt >= 4.0), delta)
    new = FL.vgicp_scan_linearize(tmap, p, mask, delta, 4.0, src_covs6=sc)
    assert int(new.num_inliers) > 0.2 * N
    for f in Linearized._fields:
        torch.testing.assert_close(getattr(new, f), getattr(ref, f), rtol=1e-5, atol=1e-5, msg=f)


def test_moments_wrapper_device_rule(scene):
    """CPU tensors take the plain version and never reach the launcher; the
    launcher refuses them instead of falling back."""
    pts, _, tmap, covs6 = scene
    delta = torch.from_numpy(_delta(False))
    p = torch.from_numpy(_source(pts, delta.numpy(), seed=7))
    momT, found = FL.probe_moments(tmap, p, torch.ones(N, dtype=torch.bool), delta)
    args = (p, momT, found, delta, 4.0, 1e-3, torch.from_numpy(covs6))
    before = FL.moments_launches
    lin = FL.linearize_vgicp_moments(*args)
    assert FL.moments_launches == before
    assert_linearized_close(lin, FL.linearize_vgicp_moments_plain(*args), tol=0.0)
    with pytest.raises(ValueError):
        FL.linearize_vgicp_moments_cuda(*args)
    assert FL.moments_launches == before


def _index_add_sum(rows, slot, size):
    """What the map build summed with before: `index_add_` into one more
    row, the sentinel, sliced off."""
    return rows.new_zeros((size + 1, rows.shape[1])).index_add_(0, slot, rows)[:size]


def test_run_sum_equals_index_add():
    """Sorted slots with long runs, runs of one row, empty slots and a long
    run at the dropped sentinel slot: bit for bit what `index_add_` sums."""
    rng = np.random.RandomState(0)
    size = 300
    lengths = rng.choice([0, 1, 1, 2, 7, 40], size=size)
    slot = np.concatenate([np.repeat(np.arange(size), lengths), np.full(50, size)])
    rows = torch.from_numpy((rng.randn(len(slot), 16) * 10.0 ** rng.randint(-3, 4, (len(slot), 1))).astype(np.float32))
    slot = torch.from_numpy(slot)
    assert (lengths == 1).any() and (lengths == 0).any()
    out = VM._run_sum(rows, slot, size)
    assert torch.equal(out, _index_add_sum(rows, slot, size))


def test_map_builds_equal_index_add_builds(monkeypatch):
    """build_voxelmap, insert_frame and insert_frame_incremental give, bit
    for bit, the maps they gave when they summed with `index_add_`."""
    rng = np.random.RandomState(1)

    def frame(n, offset):
        pts = (rng.rand(n, 3).astype(np.float32) - 0.5) * 6.0 + offset
        covs = np.broadcast_to(np.eye(3, dtype=np.float32) * 0.01, (n, 3, 3)).copy()
        return tmake(pts, covs=covs, capacity=n + 100, device="cpu")

    frames = [frame(4000, 0.0), frame(3000, 1.5), frame(3000, -2.0)]

    def builds():
        vmap = VM.build_voxelmap(frames[0], 0.5, 4096)
        merged = VM.insert_frame(vmap, frames[1])
        incremental, overflow = VM.insert_frame_incremental(vmap, frames[2])
        return vmap, merged, incremental, overflow

    new = builds()
    monkeypatch.setattr(VM, "_run_sum", _index_add_sum)
    old = builds()
    for a, b in zip(new[:3], old[:3]):
        assert int(a.num_voxels) > 1000
        for x, y in zip(a, b):  # as bits: the probe table's empty keys are NaNs
            assert torch.equal(x.reshape(-1).view(torch.int32), y.reshape(-1).view(torch.int32))
    assert bool(new[3]) == bool(old[3])


@pytest.mark.parametrize("offset", [0.0, 30.0], ids=["origin", "30m"])
def test_source_order_as_close_to_float64_as_plain(offset):
    """Near the optimum (5 mm of noise at the true pose) the gradient is a
    small sum of large terms, so a float32 evaluation lands 1e-5 (map at
    the origin) to 1e-3 (map 30 m out) x max|b| from float64. K4's order
    (K1's source-frame sums, then the expansion) must be as close to its
    own float64 evaluation as the plain version's 92 direct sums are to
    theirs: within 2x in every field. The two orders agree only as far as
    the float32 rotation is orthonormal (Rᵀ (C_t + R C_s Rᵀ) R = Rᵀ C_t R + C_s
    and Rᵀ r = p + Rᵀ (t - mu) need RᵀR = I): near the optimum of a map far
    out that parts them even in float64, not their rounding. The test prints
    |RᵀR - I| and that float64 gap."""
    rng = np.random.RandomState(11)
    n = 20000
    pts = (rng.rand(n, 3).astype(np.float32) - 0.5) * 8.0 + np.float32(offset)
    tmap = VM.build_voxelmap(tmake(pts, device="cpu"), 1.0, n)
    delta = torch.from_numpy(_delta(False))
    noise = torch.from_numpy(rng.randn(n, 3).astype(np.float32) * 0.005)
    p = ((torch.from_numpy(pts) - delta[:3, 3]) @ delta[:3, :3] + noise).T.contiguous()
    g = rng.randn(n, 3, 3).astype(np.float32) * 0.05
    covs = np.einsum("nij,nkj->nik", g, g) + np.eye(3, dtype=np.float32) * 0.01
    sc = torch.from_numpy(np.stack([covs[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]))
    momT, found = FL.probe_moments(tmap, p, torch.ones(n, dtype=torch.bool), delta)
    args = (p, momT, found, delta, 4.0, 1e-3, sc)
    args64 = (p.double(), momT.double(), found, delta.double(), 4.0, 1e-3, sc.double())

    def errs(fn):
        lin, ref = fn(*args), fn(*args64)
        return {f: float((getattr(lin, f).double() - getattr(ref, f)).abs().max() / getattr(ref, f).abs().max())
                for f in Linearized._fields[:-1]}

    plain = errs(FL.linearize_vgicp_moments_plain)
    source = errs(FL.linearize_vgicp_moments_source_plain)
    print({f: f"plain {plain[f]:.2e} source order {source[f]:.2e}" for f in plain})
    R = delta[:3, :3].double()
    ref_b = FL.linearize_vgicp_moments_plain(*args64).b_s
    gap = FL.linearize_vgicp_moments_source_plain(*args64).b_s - ref_b
    print(f"|RᵀR - I| {float((R.T @ R - torch.eye(3, dtype=torch.float64)).abs().max()):.1e}; the two orders "
          f"in float64 differ by {float(gap.abs().max() / ref_b.abs().max()):.1e} x max|b_s|")
    for f in plain:
        assert source[f] <= 2.0 * plain[f] + 1e-7, (f, source[f], plain[f])
