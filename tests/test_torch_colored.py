"""PyTorch port vs the JAX package: the colored (photometric) factors.

- `GaussianVoxelMap.as_frame(with_normals=True)` on the same map: points,
  mask, covariances and intensities bit for bit; normals within 1e-6 (a
  few ulp: eigh3's trigonometry rounds its own way in each package),
  except where the smallest eigenvalue repeats (eigh3 then picks any
  vector of the plane, ROADMAP's known behaviour);
- `estimate_intensity_gradients` within 1e-5 x max|ref|;
- the XYZI 1-NN (`_xyzi_knn`) indices equal, on the plane scene and on a
  lattice whose queries sit at equal XYZI distance from several target
  points (the lowest original index wins in both);
- `ColorConsistencyFactor` and `ColoredGICPFactor`: the `Linearized`
  blocks within 1e-4 x max|ref|, the errors and the frozen error of a batch
  of candidate poses within 1e-5 relative;
- `estimate_intensity_gradients_ivox` and `lookup_intensity_gradients_ivox`
  within 1e-5 x max|ref|;
- the JAX tests' protocols, poses within 1e-3 m and 1e-3 rad:
  tests/test_factors.py::test_colored_gicp_converges (a painted plane) and
  tests/test_voxelmap.py::test_colored_gicp_against_voxelmap.

Both packages get the same frames: the JAX package's kNN normals and
covariances, carried across by interop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors import PriorFactor as JPrior
from gtsam_points_tpu.factors import colored as jcol
from gtsam_points_tpu.ops.features import estimate_normals_covs as jfeatures
from gtsam_points_tpu.ops.hash_grid import build_hash_grid as jgrid
from gtsam_points_tpu.ops.voxelmap import build_voxelmap as jbuild_voxelmap
from gtsam_points_tpu.optim import FactorGraph as JGraph
from gtsam_points_tpu.optim import optimize_lm as jlm
from gtsam_points_tpu.optim.lm import LMParams as JLMParams
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import (
    ColorConsistencyFactor,
    ColoredGICPFactor,
    PriorFactor,
    estimate_intensity_gradients,
    estimate_intensity_gradients_ivox,
    lookup_intensity_gradients_ivox,
    make_color_consistency_factor,
    make_colored_gicp_factor,
)
from gtsam_points_tpu_torch.factors.colored import _xyzi_knn
from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid
from gtsam_points_tpu_torch.optim import FactorGraph, LMParams, optimize_lm
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
GRAD_TOL = 1e-5
NORMAL_TOL = 1e-6
SYSTEM_TOL = 1e-4
ERROR_TOL = 1e-5
TOL_M = 1e-3
TOL_RAD = 1e-3
BLOCKS = ("H_tt", "H_ts", "H_ss", "b_t", "b_s")
XI_PLANE = np.array([0.0, 0.0, 0.02, 0.15, -0.1, 0.0], np.float32)
XI_VOXEL = np.array([0.01, -0.01, 0.02, 0.15, -0.1, 0.05], np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _exp(xi) -> np.ndarray:
    return np.asarray(jse3.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _port(frame):
    return interop.frame_from_numpy(interop.frame_to_numpy(frame), device="cpu")


@pytest.fixture(scope="module")
def plane():
    """tests/test_factors.py::test_colored_gicp_converges's scene: 1200
    points on z = 0 painted sin(2x) + cos(1.5y), the source the target seen
    from se3_exp(XI_PLANE); kNN features k = 8, leaf 1.0 from the JAX
    package."""
    rng = np.random.RandomState(7)
    xy = rng.rand(1200, 2).astype(np.float32) * 10 - 5
    pts = np.concatenate([xy, np.zeros((1200, 1), np.float32)], axis=1)
    intens = np.sin(xy[:, 0] * 2.0) + np.cos(xy[:, 1] * 1.5)
    T_true = _exp(XI_PLANE)
    src = ((pts - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    prep = jax.jit(lambda f: jfeatures(f, k=8, grid_leaf=1.0))
    jf = {"target": prep(jmake(pts, intensities=intens)), "source": prep(jmake(src, intensities=intens))}
    return {"jax": jf, "torch": {k: _port(f) for k, f in jf.items()}, "T_true": T_true}


@pytest.fixture(scope="module")
def surface():
    """tests/test_voxelmap.py::test_colored_gicp_against_voxelmap's scene:
    4000 points of a smooth surface painted sin(2x) cos(2y), covariances
    0.01 I, the target's leaf-0.5 Gaussian voxel map from the JAX package
    (carried across), the source seen from se3_exp(XI_VOXEL)."""
    rng = np.random.RandomState(3)
    xy = (rng.rand(4000, 2) * 8 - 4).astype(np.float32)
    z = (0.1 * np.sin(xy[:, 0]) + 0.05 * xy[:, 1]).astype(np.float32)
    pts = np.concatenate([xy, z[:, None]], axis=1)
    inten = (np.sin(2.0 * xy[:, 0]) * np.cos(2.0 * xy[:, 1])).astype(np.float32)
    covs = np.tile((0.01 * np.eye(3, dtype=np.float32))[None], (4000, 1, 1))
    T = _exp(XI_VOXEL)
    src = np.asarray(jse3.transform_points(jse3.se3_inverse(jnp.asarray(T)), jnp.asarray(pts)))
    jmap = jax.jit(lambda f: jbuild_voxelmap(f, 0.5))(jmake(pts, covs=covs, intensities=inten, capacity=4096))
    jsrc = jmake(src, covs=covs, intensities=inten, capacity=4096)
    return {"jmap": jmap, "map": interop.voxelmap_from_numpy(interop.voxelmap_to_numpy(jmap), device="cpu"),
            "jsrc": jsrc, "src": _port(jsrc), "T": T}


def _repeated_smallest(covs: np.ndarray) -> np.ndarray:
    """Rows whose two smallest eigenvalues agree within 1e-5 of the largest."""
    w = np.linalg.eigvalsh(covs.astype(np.float64) + 1e-9 * np.eye(3))
    return (w[:, 1] - w[:, 0]) <= 1e-5 * np.maximum(np.abs(w[:, 2]), 1e-30)


def test_voxelmap_as_frame_matches_jax(surface):
    jfr = surface["jmap"].as_frame(with_normals=True)
    tfr = surface["map"].as_frame(with_normals=True)
    plain = surface["map"].as_frame()
    assert plain.normals is None and torch.equal(plain.points, tfr.points)
    for name in ("points", "mask", "covs", "intensities"):
        np.testing.assert_array_equal(getattr(tfr, name).numpy(), np.asarray(getattr(jfr, name)), err_msg=name)
    tn, jn = tfr.normals.numpy(), np.asarray(jfr.normals)
    differ = np.abs(tn - jn).max(axis=1) > NORMAL_TOL
    rep = _repeated_smallest(np.asarray(jfr.covs))
    assert not np.any(differ & ~rep), np.nonzero(differ & ~rep)
    valid = np.asarray(jfr.mask)
    assert valid.sum() > 100 and np.all(tn[~valid] == 0.0)


def test_intensity_gradients_match_jax(plane):
    for side in ("target", "source"):
        jg = jax.jit(lambda f: jcol.estimate_intensity_gradients(f, grid_leaf=1.0))(plane["jax"][side])
        tg = estimate_intensity_gradients(plane["torch"][side], grid_leaf=1.0)
        assert tg.shape == jg.shape and _rel(tg, jg) < GRAD_TOL, side


def _xyzi_pair(jt, tt, moved, src_int, mask, scale, max_sq, leaf=1.0):
    jg, tg = jgrid(jt.points, jt.mask, leaf), build_hash_grid(tt.points, tt.mask, leaf)
    ji, jv = jax.jit(lambda m, s, k: jcol._xyzi_knn(jg, jt, m, s, k, 1, scale, 27, 16, max_sq))(
        jnp.asarray(moved), jnp.asarray(src_int), jnp.asarray(mask))
    ti, tv = _xyzi_knn(tg, tt, _t(moved), _t(src_int), torch.from_numpy(mask), scale, 27, max_sq)
    return (np.asarray(ji), np.asarray(jv)), (ti.numpy(), tv.numpy())


def test_xyzi_knn_matches_jax(plane):
    jt, tt = plane["jax"]["target"], plane["torch"]["target"]
    js = plane["jax"]["source"]
    T = _exp(0.5 * XI_PLANE)
    moved = np.asarray(jse3.transform_points(jnp.asarray(T), js.points))
    src_int, mask = np.asarray(js.intensities), np.asarray(js.mask)
    for scale in (1.0, 4.0):
        (ji, jv), (ti, tv) = _xyzi_pair(jt, tt, moved, src_int, mask, scale, 4.0)
        assert tv.sum() > 1000
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)


def test_xyzi_knn_ties_take_the_lowest_index():
    """A lattice of spacing 0.5 with two intensities, in shuffled order;
    queries at cell centres (every corner at the same squared distance
    0.1875, exact) and on lattice edges, some with an intensity that both
    ends match equally: JAX and the port pick the same, lowest, index."""
    rng = np.random.RandomState(5)
    g = np.stack(np.meshgrid(*[np.arange(8) * 0.5] * 3, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    perm = rng.permutation(len(g))
    pts = g[perm]
    inten = (perm % 2).astype(np.float32)
    jt = jmake(pts, intensities=inten)
    tt = _port(jt)
    centres = g[rng.choice(len(g), 300)] + np.float32(0.25)
    edges = g[rng.choice(len(g), 300)] + np.array([0.25, 0.0, 0.0], np.float32)
    moved = np.concatenate([centres, edges]).astype(np.float32)
    src_int = np.concatenate([np.full(300, 0.5), rng.randint(0, 2, 300)]).astype(np.float32)
    mask = np.ones(len(moved), bool)
    (ji, jv), (ti, tv) = _xyzi_pair(jt, tt, moved, src_int, mask, 1.0, 1.0)
    assert tv.all()
    np.testing.assert_array_equal(ti, ji)
    # the ties are real: several candidates at the least distance
    d = ((pts[None] - moved[:, None]) ** 2).sum(-1) + (inten[None] - src_int[:, None]) ** 2
    ties = (d == d.min(1, keepdims=True)).sum(1)
    assert (ties > 1).sum() > 300
    assert np.array_equal(ti[:, 0], np.array([np.nonzero(r == r.min())[0].min() for r in d]))


def _pair(plane, kind: str, **kw):
    make = {"consistency": (jcol.make_color_consistency_factor, make_color_consistency_factor),
            "colored_gicp": (jcol.make_colored_gicp_factor, make_colored_gicp_factor)}[kind]
    j, t = plane["jax"], plane["torch"]
    return make[0](0, 1, j["target"], j["source"], **kw), make[1](0, 1, t["target"], t["source"], **kw)


def _assert_lin(tl, jl):
    for name in BLOCKS:
        assert _rel(getattr(tl, name), getattr(jl, name)) < SYSTEM_TOL, name
    assert _rel(tl.error, jl.error) < ERROR_TOL
    assert int(tl.num_inliers) == int(jl.num_inliers)


@pytest.mark.parametrize("kind", ["consistency", "colored_gicp"])
def test_colored_factor_linearize_matches_jax(plane, kind):
    jf, tf = _pair(plane, kind, max_corr_dist=2.0, photometric_weight=50.0)
    assert isinstance(tf, ColorConsistencyFactor if kind == "consistency" else ColoredGICPFactor)
    assert tf.keys == (0, 1)
    jrun = jax.jit(lambda p, c: (jf.linearize(p), jf.error(p), jax.vmap(jf.linearize_with_error_fn(p)[1])(c)))
    for scale in (0.0, 0.5):
        poses = np.stack([np.eye(4, dtype=np.float32), _exp(scale * XI_PLANE)])
        cands = np.stack([poses, poses @ _exp(np.full(6, 0.01, np.float32))]).astype(np.float32)
        jlin, jerr, jcand = jrun(poses, cands)
        _assert_lin(tf.linearize(_t(poses)), jlin)
        assert _rel(tf.error(_t(poses)), jerr) < ERROR_TOL
        assert _rel(tf.linearize_with_error_fn(_t(poses))[1](_t(cands)), jcand) < ERROR_TOL


def test_ivox_gradients_match_jax(surface):
    jgr = jax.jit(jcol.estimate_intensity_gradients_ivox)(surface["jmap"])
    tgr = estimate_intensity_gradients_ivox(surface["map"])
    assert _rel(tgr, jgr) < GRAD_TOL
    valid = np.asarray(surface["jmap"].keys) != 0x7FFFFFFF
    assert np.all(tgr.numpy()[~valid] == 0.0) and np.abs(tgr.numpy()[valid]).max() > 0.1
    src = surface["jsrc"]
    jg, jfound = jax.jit(jcol.lookup_intensity_gradients_ivox)(surface["jmap"], jgr, src.points, src.mask)
    tg, tfound = lookup_intensity_gradients_ivox(surface["map"], tgr, surface["src"].points, surface["src"].mask)
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    assert tfound.sum() > 1000 and _rel(tg, jg) < GRAD_TOL


def _lm(factor, iterations: int, port: bool):
    eye = np.eye(4, dtype=np.float32)
    if port:
        g = FactorGraph(num_poses=2)
        g.add(PriorFactor(prior=torch.eye(4), weights=torch.full((6,), 1e6), key=0))
        g.add(factor)
        return optimize_lm(g, _t(np.stack([eye, eye])), LMParams(max_iterations=iterations)).poses.numpy()
    g = JGraph(num_poses=2)
    g.add(JPrior(prior=jnp.eye(4), weights=jnp.full((6,), 1e6), key=0))
    g.add(factor)
    return np.asarray(jax.jit(lambda p: jlm(g, p, JLMParams(max_iterations=iterations)))(
        jnp.asarray(np.stack([eye, eye]))).poses)


def _assert_poses(t, j, truth, tol_m, tol_rad):
    rot, trans = tse3.pose_error(_t(j), _t(t))
    assert float(trans.max()) < TOL_M and float(rot.max()) < TOL_RAD, (float(trans.max()), float(rot.max()))
    rot, trans = tse3.pose_error(_t(truth), _t(t[1]))
    assert float(rot) < tol_rad and float(trans) < tol_m, (float(trans), float(rot))


def test_colored_gicp_plane_protocol_matches_jax(plane):
    """tests/test_factors.py::test_colored_gicp_converges: photometric
    weight 50, 15 LM iterations from the identity."""
    jf, tf = _pair(plane, "colored_gicp", max_corr_dist=2.0, photometric_weight=50.0)
    _assert_poses(_lm(tf, 15, True), _lm(jf, 15, False), plane["T_true"], 3e-2, 5e-3)


def test_colored_gicp_voxelmap_protocol_matches_jax(surface):
    """tests/test_voxelmap.py::test_colored_gicp_against_voxelmap: the map's
    frame with normals as target, max_corr_dist 1.0 at leaf 0.5, 20 LM
    iterations from the identity."""
    jv, tv = surface["jmap"].as_frame(with_normals=True), surface["map"].as_frame(with_normals=True)
    jf = jcol.make_colored_gicp_factor(0, 1, jv, surface["jsrc"], max_corr_dist=1.0, grid_leaf=0.5)
    tf = make_colored_gicp_factor(0, 1, tv, surface["src"], max_corr_dist=1.0, grid_leaf=0.5)
    _assert_poses(_lm(tf, 20, True), _lm(jf, 20, False), surface["T"], 5e-2, 5e-3)
