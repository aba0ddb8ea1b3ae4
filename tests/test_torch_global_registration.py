"""PyTorch port vs the JAX package: loop detection (global registration).

- `align_points_se3` (batched, weighted, and a reflection case where the
  SVD's rotation needs its determinant fix) and `align_points_4dof` within
  1e-5;
- `compute_pair_features` on seeded pairs, and the bins of every (point,
  neighbour) pair of `estimate_fpfh` on a ring scan: the neighbour tables
  equal, the bins equal except flips, each flip explained by an edge (the
  feature within 1e-4 of a bin edge, in bin units) or by PCL's swap test
  at a tie (||cos1| - |cos2|| < 1e-6), and at most FLIP_SHARE of the pairs;
  the FPFH rows that no flip reaches (through the row's own SPFH or a
  neighbour's) within 1e-3 (percent), and at most REACHED_SHARE reached;
- `estimate_pfh` on the JAX test's surface, the same way;
- `feature_knn` (k = 1 and 3) on the same features: indices equal except
  near ties (the two candidates' exact distances within 1e-5 of
  |q|² + |t|²), at most TIE_SHARE;
- `overlap_score` equal;
- `estimate_pose_gnc` on a ring pair, each package with its own FPFH,
  within 1e-3 m and 1e-3 rad, and within 1e-5 on the same features;
- `estimate_pose_ransac_from_draws` on the JAX package's own draws
  (`PRNGKey(seed)`, `split`, the two `randint` calls) and the same
  features: the pose within 1e-4 m and 1e-4 rad of JAX's and the same
  inlier rate, for 6 and 4 DoF, with a taboo pose, and with `rescore_top`
  below and equal to `max_iterations`; `estimate_pose_ransac` draws the
  same hypotheses from the same seed, call after call.

Frames carry the JAX package's kNN normals and covariances (through
`interop.frame_from_numpy`), so both packages start from the same floats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.ops.features import estimate_normals_covs as jfeatures
from gtsam_points_tpu.ops.hash_grid import build_hash_grid as jgrid
from gtsam_points_tpu.ops.hash_grid import knn_search as jknn_search
from gtsam_points_tpu.registration import GNCParams as JGNCParams
from gtsam_points_tpu.registration import RANSACParams as JRANSACParams
from gtsam_points_tpu.registration import estimate_pose_ransac as jransac
from gtsam_points_tpu.registration import align_points_4dof as jalign4
from gtsam_points_tpu.registration import align_points_se3 as jalign
from gtsam_points_tpu.registration import estimate_fpfh as jfpfh
from gtsam_points_tpu.registration import estimate_pose_gnc as jgnc
from gtsam_points_tpu.registration import fpfh as jfpfh_mod
from gtsam_points_tpu.registration.ransac import overlap_score as joverlap
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid
from gtsam_points_tpu_torch.registration import (
    FPFH_DIM,
    GNCParams,
    RANSACParams,
    align_points_4dof,
    align_points_se3,
    estimate_fpfh,
    estimate_pfh,
    estimate_pose_gnc,
    estimate_pose_ransac,
    estimate_pose_ransac_from_draws,
    feature_knn,
    overlap_score,
    ransac_draws,
)
from gtsam_points_tpu_torch.registration.fpfh import compute_pair_features, fpfh_neighbors, spfh_bins
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
ALIGN_TOL = 1e-5
FEATURE_TOL = 1e-5
EDGE_TOL = 1e-4  # bin units
SWAP_TIE = 1e-6
FLIP_SHARE = 1e-3
HIST_TOL = 1e-3  # percent
REACHED_SHARE = 0.25  # rows whose own or a neighbour's SPFH holds a flip (a flip reaches ~30 rows)
TIE_SHARE = 1e-2
TIE_TOL = 1e-5
GNC_TOL_M = 1e-3
GNC_TOL_RAD = 1e-3
RANSAC_TOL_M = 1e-4
RANSAC_TOL_RAD = 1e-4
RING_WORLD_N = 24000
RING_SCAN_N = 2048
PAIR = (0, 1)
RANGES = ((-1.0, 1.0), (-1.0, 1.0), (-np.pi, np.pi))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _exp(xi) -> np.ndarray:
    return np.asarray(jse3.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _pose_gap(a, b):
    rot, trans = tse3.pose_error(_t(a), _t(b))
    return float(trans), float(rot)


@pytest.fixture(scope="module")
def pair():
    """Two 2048-point ring scans with the JAX package's kNN normals and
    covariances in both packages, their JAX FPFH features, the truth."""
    T = ring_trajectory(max(PAIR) + 1, lap=100)
    scans = ring_scans(ring_world(0, RING_WORLD_N), T, scan_n=RING_SCAN_N, seed=1)
    prep = jax.jit(lambda f: jfeatures(f, k=10, grid_leaf=1.0))
    jf = [prep(jmake(scans[i])) for i in PAIR]
    tf = [interop.frame_from_numpy({k: np.asarray(getattr(f, k)) for k in ("points", "mask", "normals", "covs")},
                                   device="cpu") for f in jf]
    jF = [np.asarray(jax.jit(jfpfh)(f)) for f in jf]
    truth = (np.linalg.inv(T[PAIR[0]]) @ T[PAIR[1]]).astype(np.float32)
    return {"jax": jf, "torch": tf, "jax_fpfh": jF, "truth": truth}


# -- alignment ------------------------------------------------------------------------


def test_align_points_match_jax():
    rng = np.random.RandomState(1)
    src = rng.randn(3, 40, 3).astype(np.float32)
    T = _exp(rng.uniform(-0.7, 0.7, (3, 6)))
    tgt = (np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
           + rng.randn(3, 40, 3).astype(np.float32) * 0.01).astype(np.float32)
    w = rng.uniform(0.0, 2.0, (3, 40)).astype(np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else _t(weights)
        np.testing.assert_allclose(align_points_se3(_t(src), _t(tgt), tw).numpy(),
                                   np.asarray(jalign(jnp.asarray(src), jnp.asarray(tgt), jw)), atol=ALIGN_TOL)
        np.testing.assert_allclose(align_points_4dof(_t(src), _t(tgt), tw).numpy(),
                                   np.asarray(jalign4(jnp.asarray(src), jnp.asarray(tgt), jw)), atol=ALIGN_TOL)
    # exact recovery (the JAX test), and a reflection: the mirrored cloud's
    # best rotation needs det(U Vᵀ) = -1 folded into the last axis
    one = _exp([0.3, -0.5, 0.7, 1.0, 2.0, -1.0])
    exact = align_points_se3(_t(src[0]), _t(src[0] @ one[:3, :3].T + one[:3, 3]))
    assert max(_pose_gap(exact.numpy(), one)) < 1e-4
    mirror = src[0] * np.array([1.0, 1.0, -1.0], np.float32)
    ds, dt = src[0] - src[0].mean(0), mirror - mirror.mean(0)
    U, _, Vt = np.linalg.svd(dt.T.astype(np.float64) @ ds)
    assert np.linalg.det(U @ Vt) < 0  # the unfixed U Vᵀ is a reflection
    jR = np.asarray(jalign(jnp.asarray(src[0]), jnp.asarray(mirror)))
    tR = align_points_se3(_t(src[0]), _t(mirror)).numpy()
    np.testing.assert_allclose(tR, jR, atol=ALIGN_TOL)
    assert abs(np.linalg.det(tR[:3, :3]) - 1.0) < 1e-5
    z = align_points_4dof(_t(src[0]), _t(tgt[0])).numpy()[:3, :3] @ np.array([0.0, 0.0, 1.0])
    np.testing.assert_allclose(z, [0.0, 0.0, 1.0], atol=1e-6)


# -- FPFH / PFH ---------------------------------------------------------------------------


def _scaled(x, lo, hi, bins):
    return (np.asarray(x, np.float64) - lo) / (hi - lo) * bins


def _swap_gap(p1, n1, p2, n2) -> np.ndarray:
    """||cos1| - |cos2|| of PCL's swap test, in float64."""
    p1, n1, p2, n2 = (np.asarray(a, np.float64) for a in (p1, n1, p2, n2))
    du = p2 - p1
    du = du / np.maximum(np.linalg.norm(du, axis=-1, keepdims=True), 1e-12)
    return np.abs(np.abs(np.sum(n1 * du, -1)) - np.abs(np.sum(n2 * du, -1)))


def _flips(jax_feats, port_bins, valid, gap, bins):
    """Pairs whose bins differ -> (flip mask, all explained by an edge or a swap tie)."""
    flip = np.zeros_like(valid)
    explained = True
    for x, b, (lo, hi) in zip(jax_feats, port_bins, RANGES):
        s = _scaled(x, lo, hi, bins)
        jb = np.clip(np.floor(s), 0, bins - 1).astype(np.int32)
        d = (jb != np.asarray(b)) & valid
        flip |= d
        explained &= bool(np.all((np.abs(s - np.round(s)) < EDGE_TOL)[d] | (gap < SWAP_TIE)[d]))
    return flip, explained


def test_pair_features_match_jax():
    rng = np.random.RandomState(3)
    p1, p2 = (rng.randn(2000, 3).astype(np.float32) * 3.0 for _ in range(2))
    n1, n2 = (v / np.linalg.norm(v, axis=-1, keepdims=True) for v in (rng.randn(2000, 3).astype(np.float32) for _ in range(2)))
    jx = [np.asarray(x) for x in jax.jit(jfpfh_mod.compute_pair_features)(p1, n1, p2, n2)]
    tx = [x.numpy() for x in compute_pair_features(_t(p1), _t(n1), _t(p2), _t(n2))]
    clear = _swap_gap(p1, n1, p2, n2) > SWAP_TIE
    assert clear.mean() > 0.99
    for a, b in zip(tx, jx):
        assert np.abs(a - b)[clear].max() < FEATURE_TOL


def test_fpfh_matches_jax(pair):
    jf, tf = pair["jax"][0], pair["torch"][0]

    @jax.jit
    def jax_pairs(f):
        g = jgrid(f.points, f.mask, 2.5)
        idx, sq, valid = jknn_search(g, f.points, f.mask, 31, num_neighbor_cells=27, max_sq_dist=25.0)
        idx, valid = idx[:, 1:], valid[:, 1:]
        i = jnp.maximum(idx, 0)
        return idx, valid, jfpfh_mod.compute_pair_features(f.points[:, None], f.normals[:, None], f.points[i],
                                                           f.normals[i])[:3]

    j_idx, j_valid, j_feats = jax_pairs(jf)
    t_idx, _, t_valid = fpfh_neighbors(tf, device="cpu")
    assert np.array_equal(t_idx.numpy(), np.asarray(j_idx)) and np.array_equal(t_valid.numpy(), np.asarray(j_valid))
    valid = t_valid.numpy()
    i = np.maximum(t_idx.numpy(), 0)
    pts, nrm = tf.points.numpy(), tf.normals.numpy()
    gap = _swap_gap(pts[:, None], nrm[:, None], pts[i], nrm[i])
    flip, explained = _flips(j_feats, spfh_bins(tf, t_idx), valid, gap, 11)
    assert explained and flip.sum() <= FLIP_SHARE * valid.sum(), (int(flip.sum()), int(valid.sum()))

    feats = estimate_fpfh(tf, device="cpu").numpy()
    ref = pair["jax_fpfh"][0]
    assert feats.shape == ref.shape == (tf.capacity, FPFH_DIM)
    touched = flip.any(1)
    reached = touched | (touched[i] & valid).any(1)
    assert np.abs(feats - ref)[~reached].max() < HIST_TOL
    assert reached.mean() < REACHED_SHARE, float(reached.mean())
    mask = tf.mask.numpy()
    sums = feats[mask].reshape(-1, 3, 11).sum(-1)
    assert np.isclose(sums, 100.0, atol=1e-2).mean() > 0.99 and (feats[~mask] == 0).all()


def test_pfh_matches_jax():
    """The JAX test's smooth surface (400 points), k = 8, grid leaf 1.0."""
    rng = np.random.RandomState(11)
    pts = (rng.rand(400, 3) * 4.0).astype(np.float32)
    pts[:, 2] = 0.2 * np.sin(pts[:, 0]) + 0.1 * pts[:, 1]
    jf = jax.jit(lambda f: jfeatures(f, k=10, grid_leaf=1.0))(jmake(pts))
    tf = interop.frame_from_numpy({k: np.asarray(getattr(jf, k)) for k in ("points", "mask", "normals")}, device="cpu")
    ref = np.asarray(jax.jit(lambda f: jfpfh_mod.estimate_pfh(f, k=8, grid_leaf=1.0))(jf))
    out = estimate_pfh(tf, k=8, grid_leaf=1.0, device="cpu").numpy()
    assert out.shape == ref.shape == (tf.capacity, 125)
    rows = np.abs(out - ref).max(1) > HIST_TOL
    assert rows.sum() <= 2, int(rows.sum())
    # a differing row moved whole pairs between bins: each of its 28 pairs
    # (k = 8, all valid here) weighs 100/28
    for r in np.nonzero(rows)[0]:
        moved = np.abs(out[r] - ref[r]) * 28 / 100.0
        np.testing.assert_allclose(moved, np.round(moved), atol=1e-3)


def test_feature_knn_matches_jax(pair):
    jF = pair["jax_fpfh"]
    tm, sm = pair["torch"][0].mask, pair["torch"][1].mask
    for k in (1, 3):
        j_idx, j_sq, j_valid = (np.asarray(x) for x in jax.jit(
            lambda a, b, c, d: jfpfh_mod.feature_knn(a, b, c, d, k=k))(jF[0], np.asarray(tm), jF[1], np.asarray(sm)))
        t_idx, t_sq, t_valid = feature_knn(_t(jF[0]), tm, _t(jF[1]), sm, k=k)
        assert t_idx.dtype == torch.int32 and t_idx.shape == (len(sm), k)
        assert np.array_equal(t_valid.numpy(), j_valid)
        differ = (t_idx.numpy() != j_idx) & j_valid
        assert differ.mean() <= TIE_SHARE, float(differ.mean())
        # a differing index is a near tie: both candidates' exact distances
        # within TIE_TOL of |q|² + |t|², the scale of the rounding of
        # |q|² + |t|² - 2 q·t
        tgt, src = jF[0].astype(np.float64), jF[1].astype(np.float64)
        for q, c in zip(*np.nonzero(differ)):
            tt, tj = tgt[t_idx[q, c]], tgt[j_idx[q, c]]
            gap = abs(np.sum((src[q] - tt) ** 2) - np.sum((src[q] - tj) ** 2))
            assert gap <= TIE_TOL * (np.sum(src[q] ** 2) + max(np.sum(tt**2), np.sum(tj**2))), (q, c, gap)
        ok = j_valid & ~differ
        assert np.abs(t_sq.numpy() - j_sq)[ok].max() <= 1e-4 * max(np.abs(j_sq[ok]).max(), 1.0)


def test_overlap_score_matches_jax(pair):
    jf, tf = pair["jax"], pair["torch"]
    poses = np.stack([pair["truth"], np.eye(4, dtype=np.float32),
                      pair["truth"] @ _exp([0.0, 0.0, 0.05, 0.3, 0.0, 0.0])]).astype(np.float32)
    jg = jgrid(jf[0].points, jf[0].mask, 1.0)
    tg = build_hash_grid(tf[0].points, tf[0].mask, 1.0)
    j = np.asarray(jax.jit(joverlap)(jg, poses, jf[1].points, jf[1].mask))
    t = overlap_score(tg, _t(poses), tf[1].points, tf[1].mask).numpy()
    np.testing.assert_array_equal(t, j)
    assert t[0] > t[2] and t.dtype == np.float32


def test_gnc_matches_jax(pair):
    jf, tf, jF = pair["jax"], pair["torch"], pair["jax_fpfh"]
    jr = jax.jit(lambda: jgnc(jf[0], jf[1], jnp.asarray(jF[0]), jnp.asarray(jF[1]), JGNCParams()))()
    T_j = np.asarray(jr.T_target_source)
    own = estimate_pose_gnc(tf[0], tf[1], estimate_fpfh(tf[0], device="cpu"), estimate_fpfh(tf[1], device="cpu"),
                            GNCParams(), device="cpu")
    same = estimate_pose_gnc(tf[0], tf[1], _t(jF[0]), _t(jF[1]), GNCParams(), device="cpu")
    m, r = _pose_gap(own.T_target_source.numpy(), T_j)
    assert m < GNC_TOL_M and r < GNC_TOL_RAD, (m, r)
    m, r = _pose_gap(same.T_target_source.numpy(), T_j)
    assert m < 1e-5 and r < 1e-5, (m, r)
    assert abs(float(own.inlier_rate) - float(jr.inlier_rate)) < 1e-2
    assert float(same.inlier_rate) == pytest.approx(float(jr.inlier_rate), abs=1e-6)
    # GNC finds the pair without an initial guess, as in the JAX test's bounds
    m, r = _pose_gap(own.T_target_source.numpy(), pair["truth"])
    assert m < 0.5 and r < 0.1, (m, r)


# -- RANSAC -------------------------------------------------------------------------


def _jax_draws(params, n_src: int):
    """The JAX package's draws (ransac.py: PRNGKey(seed), split, the overlap
    sample from the second key, the hypotheses from the first)."""
    k_sample, k_overlap = jax.random.split(jax.random.PRNGKey(params.seed))
    score_idx = jax.random.randint(k_overlap, (params.num_overlap_samples,), 0, n_src)
    cand = jax.random.randint(k_sample, (params.max_iterations, 3), 0, n_src)
    return np.asarray(cand), np.asarray(score_idx)


RANSAC_CASES = {
    "6dof": dict(max_iterations=1024, rescore_top=128),
    "4dof": dict(max_iterations=1024, rescore_top=128, dof=4),
    "all_rescored": dict(max_iterations=256, rescore_top=256, seed=3),
}


def _ransac_pair(pair, kw, taboo=None):
    jf, tf, jF = pair["jax"], pair["torch"], pair["jax_fpfh"]
    jp, tp = JRANSACParams(**kw), RANSACParams(**kw)
    cand, score_idx = _jax_draws(jp, tf[1].capacity)
    jt = None if taboo is None else jnp.asarray(taboo)
    jr = jax.jit(lambda: jransac(jf[0], jf[1], jnp.asarray(jF[0]), jnp.asarray(jF[1]), jp, taboo=jt))()
    tr = estimate_pose_ransac_from_draws(tf[0], tf[1], _t(jF[0]), _t(jF[1]), tp, torch.from_numpy(cand),
                                         torch.from_numpy(score_idx), None if taboo is None else _t(taboo))
    return jr, tr


@pytest.mark.parametrize("case", list(RANSAC_CASES))
def test_ransac_on_jax_draws_matches_jax(pair, case):
    jr, tr = _ransac_pair(pair, RANSAC_CASES[case])
    m, r = _pose_gap(tr.T_target_source.numpy(), np.asarray(jr.T_target_source))
    assert m < RANSAC_TOL_M and r < RANSAC_TOL_RAD, (m, r)
    assert float(tr.inlier_rate) == float(jr.inlier_rate)
    assert tr.T_target_source.shape == (4, 4) and 0.0 < float(tr.inlier_rate) <= 1.0


def test_ransac_taboo_matches_jax(pair):
    """The best pose of the 6-DoF case made taboo: both packages reject it
    (and every hypothesis near it) and agree on the next best."""
    jr0, _ = _ransac_pair(pair, RANSAC_CASES["6dof"])
    taboo = np.asarray(jr0.T_target_source)[None]
    jr, tr = _ransac_pair(pair, RANSAC_CASES["6dof"], taboo)
    m, r = _pose_gap(tr.T_target_source.numpy(), np.asarray(jr.T_target_source))
    assert m < RANSAC_TOL_M and r < RANSAC_TOL_RAD, (m, r)
    assert float(tr.inlier_rate) == float(jr.inlier_rate)
    m, r = _pose_gap(tr.T_target_source.numpy(), taboo[0])
    assert m >= RANSACParams().taboo_thresh_trans or r >= RANSACParams().taboo_thresh_rot


def test_ransac_generator_reproducible(pair):
    tf, jF = pair["torch"], pair["jax_fpfh"]
    params = RANSACParams(max_iterations=512, rescore_top=64, seed=7)
    cand, score_idx = ransac_draws(params, tf[1].capacity)
    g = torch.Generator().manual_seed(7)
    assert torch.equal(score_idx, torch.randint(0, tf[1].capacity, (params.num_overlap_samples,), generator=g))
    assert torch.equal(cand, torch.randint(0, tf[1].capacity, (params.max_iterations, 3), generator=g))
    a = estimate_pose_ransac(tf[0], tf[1], _t(jF[0]), _t(jF[1]), params, device="cpu")
    b = estimate_pose_ransac(tf[0], tf[1], _t(jF[0]), _t(jF[1]), params, device="cpu",
                             generator=torch.Generator().manual_seed(7))
    c = estimate_pose_ransac_from_draws(tf[0], tf[1], _t(jF[0]), _t(jF[1]), params, cand, score_idx)
    assert torch.equal(a.T_target_source, b.T_target_source) and torch.equal(a.T_target_source, c.T_target_source)
    assert float(a.inlier_rate) == float(c.inlier_rate)
