"""PyTorch port vs the JAX package: the LOAM and CT-ICP factors.

- `se3_exp` and `se3_log` under `torch.func.jacfwd` on unbatched inputs
  ([6] and [4, 4]): float32, and within 1e-6 of `jax.jacfwd`; and the
  CT-ICP chain Log(T0⁻¹ T1) differentiated at T0 = T1 = I, finite;
- the hash grid's k = 2 and k = 3 neighbours in JAX's order (ties by the
  lower index), indices equal;
- `PointToEdgeFactor`, `PointToPlaneLOAMFactor` and `LOAMFactor`, with and
  without scan-line validation, and `CTICPFactor` in its three modes: the
  `Linearized` blocks within 1e-4 x max|ref| of JAX's, the errors within
  1e-5 relative (a batch of pose sets against `jax.vmap`);
- `interpolate_poses` and `deskew` within 1e-5;
- the JAX tests' box-scene protocols (tests/test_factors.py): LOAM from the
  identity and CT-ICP from a noised end pose through `optimize_lm`, poses
  within 1e-3 m and 1e-3 rad of JAX's.

Both packages get the same frames: the JAX package's kNN normals and
covariances, carried across by interop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors import PriorFactor as JPrior
from gtsam_points_tpu.factors.ct_icp import deskew as jdeskew
from gtsam_points_tpu.factors.ct_icp import interpolate_poses as jinterp
from gtsam_points_tpu.factors.ct_icp import make_ct_icp_factor as jct
from gtsam_points_tpu.factors.loam import make_loam_factor as jloam
from gtsam_points_tpu.ops.features import estimate_normals_covs as jfeatures
from gtsam_points_tpu.ops.hash_grid import build_hash_grid as jgrid
from gtsam_points_tpu.ops.hash_grid import knn_search as jknn
from gtsam_points_tpu.optim import FactorGraph as JGraph
from gtsam_points_tpu.optim import optimize_lm as jlm
from gtsam_points_tpu.optim.lm import LMParams as JLMParams
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import (
    CTICPFactor,
    LOAMFactor,
    PriorFactor,
    deskew,
    interpolate_poses,
    make_ct_icp_factor,
    make_loam_factor,
)
from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid, knn_search
from gtsam_points_tpu_torch.optim import FactorGraph, LMParams, optimize_lm
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
JAC_TOL = 1e-6
SYSTEM_TOL = 1e-4
ERROR_TOL = 1e-5
DESKEW_TOL = 1e-5
TOL_M = 1e-3
TOL_RAD = 1e-3
BLOCKS = ("H_tt", "H_ts", "H_ss", "b_t", "b_s")
XI_TRUE = np.array([0.04, -0.03, 0.05, 0.25, -0.15, 0.1], np.float32)
XI_MOTION = np.array([0.02, -0.01, 0.03, 0.4, -0.2, 0.1], np.float32)
CT_MODES = ["icp", "plane", "gicp"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _exp(xi) -> np.ndarray:
    return np.asarray(jse3.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _port(frame):
    return interop.frame_from_numpy(interop.frame_to_numpy(frame), device="cpu")


def box_cloud(n=900, seed=0, noise=0.02):
    """tests/test_factors.py's box: three pairs of noisy walls at ±5 m."""
    rng = np.random.RandomState(seed)
    pts = []
    for ax in range(3):
        p = rng.rand(n // 3, 3) * 10 - 5
        p[:, ax] = np.sign(p[:, ax]) * 5 + rng.randn(n // 3) * noise
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


@pytest.fixture(scope="module")
def box():
    """tests/test_factors.py's scene: the box as target, the box seen from
    se3_exp(XI_TRUE) as source, kNN features (k = 8, leaf 1.0) from the JAX
    package; its edge line set for LOAM; the CT-ICP source, the target's
    points observed while moving from I to se3_exp(XI_MOTION), with times;
    each frame in both packages."""
    pts = box_cloud()
    prep = jax.jit(lambda f: jfeatures(f, k=8, grid_leaf=1.0))
    T_true = _exp(XI_TRUE)
    src = (pts - T_true[:3, 3]) @ T_true[:3, :3]
    jf = {"target": prep(jmake(pts)), "source": prep(jmake(src.astype(np.float32)))}
    rng = np.random.RandomState(3)
    t_line = rng.rand(300).astype(np.float32) * 8 - 4
    edges_t = np.stack([t_line, np.ones_like(t_line), np.ones_like(t_line)], axis=1)
    edges_t = (edges_t + rng.randn(300, 3).astype(np.float32) * 0.01).astype(np.float32)
    edges_s = ((edges_t - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    jf["edges_t"], jf["edges_s"] = jmake(edges_t), jmake(edges_s)
    # CT-ICP: world point p seen at time t from T(t): local = T(t)⁻¹ p
    times = np.sort(np.random.RandomState(5).rand(len(pts)).astype(np.float32))
    Ts = np.asarray(jinterp(jnp.eye(4), jnp.asarray(_exp(XI_MOTION)), jnp.asarray(times)))
    local = np.einsum("nji,nj->ni", Ts[:, :3, :3], pts - Ts[:, :3, 3]).astype(np.float32)
    jf["ct_source"] = prep(jmake(local, times=times))
    return {"jax": jf, "torch": {k: _port(f) for k, f in jf.items()}, "T_true": T_true}


# -- se3 under forward-mode AD ----------------------------------------------------


@pytest.mark.parametrize("xi", [np.zeros(6, np.float32), np.array([0.3, -0.2, 0.5, 1.0, -2.0, 0.5], np.float32),
                                np.array([1e-5, 0.0, -2e-5, 0.1, 0.0, 0.0], np.float32)])
def test_se3_jacfwd_unbatched_matches_jax(xi):
    """jacfwd through the port's se3_exp of a [6] and se3_log of a [4, 4]:
    float32 (before the repair, a 0-d tensor times a python float gave a
    float64 tangent and the product raised), and JAX's values."""
    je = jax.jit(jax.jacfwd(jse3.se3_exp))(jnp.asarray(xi))
    te = torch.func.jacfwd(tse3.se3_exp)(_t(xi))
    assert te.dtype == torch.float32 and te.shape == (4, 4, 6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=JAC_TOL)
    T = _exp(xi)
    jl = jax.jit(jax.jacfwd(jse3.se3_log))(jnp.asarray(T))
    tl = torch.func.jacfwd(tse3.se3_log)(_t(T))
    assert tl.dtype == torch.float32 and tl.shape == (6, 4, 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=JAC_TOL)


def test_ct_icp_chain_jacfwd_at_identity():
    """The interpolation's Log(T0⁻¹ T1) differentiated at T0 = T1 = I (the
    CT-ICP demo's start): float32, finite, JAX's values."""
    def jchain(x):
        E = jse3.se3_exp(x.reshape(2, 6))
        return jse3.se3_log(jse3.se3_inverse(E[0]) @ E[1])

    def tchain(x):
        E = tse3.se3_exp(x.reshape(2, 6))
        return tse3.se3_log(tse3.se3_inverse(E[0]) @ E[1])

    jJ = jax.jit(jax.jacfwd(jchain))(jnp.zeros(12))
    tJ = torch.func.jacfwd(tchain)(torch.zeros(12))
    assert tJ.dtype == torch.float32 and bool(torch.all(torch.isfinite(tJ)))
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=JAC_TOL)


# -- kNN order ---------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3])
def test_knn_k2_k3_order_matches_jax(box, k):
    jt, tt = box["jax"]["target"], box["torch"]["target"]
    queries = np.asarray(box["jax"]["source"].points) @ box["T_true"][:3, :3].T + box["T_true"][:3, 3]
    queries = (queries + np.random.RandomState(7).randn(*queries.shape) * 0.2).astype(np.float32)
    qmask = np.asarray(box["jax"]["source"].mask)
    j_idx, j_sq, j_val = jax.jit(lambda q, m: jknn(jgrid(jt.points, jt.mask, 1.0), q, m, k=k,
                                                   max_sq_dist=4.0))(queries, qmask)
    t_idx, t_sq, t_val = knn_search(build_hash_grid(tt.points, tt.mask, 1.0), _t(queries), torch.from_numpy(qmask),
                                    k=k, max_sq_dist=4.0)
    assert np.array_equal(t_val.numpy(), np.asarray(j_val))
    assert np.array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert int(t_val.sum()) > len(queries)


# -- linearization ------------------------------------------------------------------


def _assert_lin(tl, jl):
    for name in BLOCKS:
        assert _rel(getattr(tl, name), getattr(jl, name)) < SYSTEM_TOL, name
    assert _rel(tl.error, jl.error) < ERROR_TOL
    assert int(tl.num_inliers) == int(jl.num_inliers)


def _loam_pair(box, validate: bool):
    j, t = box["jax"], box["torch"]
    kw = dict(max_corr_dist=2.0, enable_correspondence_validation=validate)
    jf = jloam(0, 1, j["edges_t"], j["target"], j["edges_s"], j["source"], **kw)
    tf = make_loam_factor(0, 1, t["edges_t"], t["target"], t["edges_s"], t["source"], **kw)
    return jf, tf


@pytest.mark.parametrize("validate", [False, True])
def test_loam_linearize_matches_jax(box, validate):
    jf, tf = _loam_pair(box, validate)
    assert isinstance(tf, LOAMFactor) and tf.keys == (0, 1)
    poses = np.stack([np.eye(4, dtype=np.float32), _exp(0.5 * XI_TRUE)])
    batch = np.stack([poses, np.stack([np.eye(4), _exp(XI_TRUE)]).astype(np.float32)])
    jle, jlp, jerrs = jax.jit(lambda p, c: (jf.edge.linearize(p), jf.plane.linearize(p),
                                            jax.vmap(jf.error)(c)))(poses, batch)
    # JAX's LOAMFactor.linearize is the sum of its two factors' systems
    jl = type(jle)(*[np.asarray(a) + np.asarray(b) for a, b in zip(jle, jlp)])
    for ref, tsub in zip((jle, jlp, jl), (tf.edge, tf.plane, tf)):
        _assert_lin(tsub.linearize(_t(poses)), ref)
    assert _rel(tf.error(_t(batch)), jerrs) < ERROR_TOL
    assert _rel(tf.error(_t(poses)), jerrs[0]) < ERROR_TOL


def _ct_pair(box, mode: str):
    j, t = box["jax"], box["torch"]
    kw = dict(gicp=mode == "gicp", point_to_plane=mode == "plane", max_corr_dist=2.0)
    return jct(0, 1, j["target"], j["ct_source"], **kw), make_ct_icp_factor(0, 1, t["target"], t["ct_source"], **kw)


@pytest.mark.parametrize("mode", CT_MODES)
def test_ct_icp_linearize_matches_jax(box, mode):
    jf, tf = _ct_pair(box, mode)
    assert isinstance(tf, CTICPFactor)
    np.testing.assert_allclose(tf.source.times.numpy(), np.asarray(jf.source.times), atol=DESKEW_TOL)
    # the system, the error, and the frozen error the LM scores its candidates with
    jrun = jax.jit(lambda p, c: (jf.linearize(p), jf.error(p), jax.vmap(jf.linearize_with_error_fn(p)[1])(c)))
    for xi in (np.zeros(6, np.float32), XI_MOTION + 0.01):
        poses = np.stack([_exp(0.2 * XI_MOTION) if xi.any() else np.eye(4, dtype=np.float32), _exp(xi)])
        cands = np.stack([poses, poses @ _exp(np.full(6, 0.01, np.float32))]).astype(np.float32)
        jlin, jerr, jcand = jrun(poses, cands)
        _assert_lin(tf.linearize(_t(poses)), jlin)
        assert _rel(tf.error(_t(poses)), jerr) < ERROR_TOL
        assert _rel(tf.linearize_with_error_fn(_t(poses))[1](_t(cands)), jcand) < ERROR_TOL


def test_interpolate_and_deskew_match_jax(box):
    rng = np.random.RandomState(11)
    T0, T1 = _exp(rng.uniform(-0.3, 0.3, 6)), _exp(rng.uniform(-0.3, 0.3, 6))
    t = rng.rand(64).astype(np.float32)
    np.testing.assert_allclose(interpolate_poses(_t(T0), _t(T1), _t(t)).numpy(),
                               np.asarray(jinterp(jnp.asarray(T0), jnp.asarray(T1), jnp.asarray(t))),
                               atol=DESKEW_TOL)
    jf, tf = _ct_pair(box, "icp")
    jd = jdeskew(jnp.asarray(T0), jnp.asarray(T1), jf.source)
    td = deskew(_t(T0), _t(T1), tf.source)
    np.testing.assert_allclose(td.points.numpy(), np.asarray(jd.points), atol=DESKEW_TOL)


# -- the box-scene protocols ----------------------------------------------------------


def _lm_pair(factor, poses0, prior_w: float, iterations: int, port: bool):
    if port:
        g = FactorGraph(num_poses=2)
        g.add(PriorFactor(prior=torch.eye(4), weights=torch.full((6,), prior_w), key=0))
        g.add(factor)
        return optimize_lm(g, _t(poses0), LMParams(max_iterations=iterations)).poses.numpy()
    g = JGraph(num_poses=2)
    g.add(JPrior(prior=jnp.eye(4), weights=jnp.full((6,), prior_w), key=0))
    g.add(factor)
    return np.asarray(jax.jit(lambda p: jlm(g, p, JLMParams(max_iterations=iterations)))(jnp.asarray(poses0)).poses)


def _assert_poses(t, j):
    rot, trans = tse3.pose_error(_t(j), _t(t))
    assert float(trans.max()) < TOL_M and float(rot.max()) < TOL_RAD, (float(trans.max()), float(rot.max()))


def test_loam_box_protocol_matches_jax(box):
    """tests/test_factors.py::test_loam_converges: a prior of 1e6 on key 0,
    15 LM iterations from the identity."""
    jf, tf = _loam_pair(box, False)
    poses0 = np.stack([np.eye(4, dtype=np.float32)] * 2)
    j = _lm_pair(jf, poses0, 1e6, 15, port=False)
    t = _lm_pair(tf, poses0, 1e6, 15, port=True)
    _assert_poses(t, j)
    assert float(tse3.pose_error(_t(box["T_true"]), _t(t[1]))[1]) < 5e-2


def test_ct_icp_box_protocol_matches_jax(box):
    """tests/test_factors.py::test_ct_icp_deskew_and_converge: a prior of
    1e4 on key 0, 15 LM iterations from se3_exp(XI_MOTION) noised by
    RandomState(5)'s second draw; then deskew."""
    jf, tf = _ct_pair(box, "icp")
    rng = np.random.RandomState(5)
    rng.rand(len(box_cloud()))
    noise = rng.randn(6).astype(np.float32) * 0.05
    poses0 = np.stack([np.eye(4, dtype=np.float32), _exp(XI_MOTION) @ _exp(noise)]).astype(np.float32)
    j = _lm_pair(jf, poses0, 1e4, 15, port=False)
    t = _lm_pair(tf, poses0, 1e4, 15, port=True)
    _assert_poses(t, j)
    jd = jdeskew(jnp.asarray(j[0]), jnp.asarray(j[1]), jf.source)
    td = deskew(_t(t[0]), _t(t[1]), tf.source)
    assert np.abs(td.points.numpy() - np.asarray(jd.points)).max() < 10 * TOL_M
