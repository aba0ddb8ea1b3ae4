"""PyTorch port vs the JAX package: the finite-difference Jacobian check
(utils/jacobian_test).

tests/test_factors.py's scene (its 900-point box, JAX's kNN features with
k = 8, carried to the port by interop so both factors see the same frames)
and its two cases, GICP and ICP at poses [I, Exp(0.5 xi_true)], binary;
and GICP unary (target key -1), where only the source is checked.

The bound: a numeric gradient is (E(+eps) - E(-eps)) / (2 eps) of a
float32 error E, so it moves in quanta of ulp(E) / (2 eps), and the order
of the float32 sums inside E (XLA's against PyTorch's) moves it by whole
quanta. The port's numeric gradients lie within
chip_smoke.JACOBIAN_G_QUANTA quanta of JAX's, with E the larger of the
two packages' errors at the linearization point, read in the run; the
same for `numeric_gradient` on each package's frozen error. A planted
fault, a wrapper whose `linearize` scales b_s by 1.5, makes both
packages' checks raise AssertionError.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsam_points_tpu.factors import make_gicp_factor as jgicp
from gtsam_points_tpu.factors import make_icp_factor as jicp
from gtsam_points_tpu.ops.features import estimate_normals_covs as jfeatures
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import jacobian_test as jjac
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import make_gicp_factor as tgicp
from gtsam_points_tpu_torch.factors import make_icp_factor as ticp
from gtsam_points_tpu_torch.utils import jacobian_test as tjac
from test_factors import XI_TRUE, box_cloud

torch.set_num_threads(1)
MAX_CORR = 2.0
CASES = [("gicp", 0), ("icp", 0), ("gicp", -1)]


@pytest.fixture(scope="module")
def scene():
    """tests/test_factors.py's `scene` fixture and poses, both packages' frames."""
    pts = box_cloud()
    src = np.asarray(jse3.transform_points(jse3.se3_inverse(jse3.se3_exp(XI_TRUE)), jnp.asarray(pts)))
    jframes = [jfeatures(jmake(p), k=8, grid_leaf=1.0) for p in (pts, src)]
    tframes = [interop.frame_from_numpy({k: np.asarray(getattr(f, k)) for k in ("points", "mask", "normals", "covs")},
                                        device="cpu") for f in jframes]
    poses = np.stack([np.eye(4, dtype=np.float32), np.asarray(jse3.se3_exp(0.5 * XI_TRUE))])
    return {"jframes": jframes, "tframes": tframes, "poses": poses}


def _factors(scene, kind: str, target_key: int):
    make = {"gicp": (jgicp, tgicp), "icp": (jicp, ticp)}[kind]
    return tuple(m(target_key, 1, *frames, max_corr_dist=MAX_CORR)
                 for m, frames in zip(make, (scene["jframes"], scene["tframes"])))


def _quantum(jf, tf, poses) -> float:
    """ulp(E) / (2 eps) at the larger of the two packages' errors at `poses`."""
    e = max(float(jf.error(jnp.asarray(poses))), float(tf.error(torch.from_numpy(poses))))
    return chip_smoke.gradient_quantum(e)


@pytest.mark.parametrize("kind,target_key", CASES, ids=[f"{k}_{'binary' if t >= 0 else 'unary'}" for k, t in CASES])
def test_torch_check_factor_jacobian_matches_jax(scene, kind, target_key):
    jf, tf = _factors(scene, kind, target_key)
    poses = scene["poses"]
    jg, tg = jjac.check_factor_jacobian(jf, poses), tjac.check_factor_jacobian(tf, poses)
    assert set(tg) == set(jg) == ({"source", "target"} if target_key >= 0 else {"source"})
    bound = chip_smoke.JACOBIAN_G_QUANTA * _quantum(jf, tf, poses)
    for key in jg:
        assert np.abs(tg[key] - jg[key]).max() <= bound, (key, tg[key], jg[key], bound)


@pytest.mark.parametrize("key", [0, 1])
def test_torch_numeric_gradient_matches_jax(scene, key):
    """numeric_gradient of each key on each package's error frozen at the
    poses (the GICP factor's linearize_with_error_fn)."""
    jf, tf = _factors(scene, "gicp", 0)
    poses = scene["poses"]
    _, jerr = jf.linearize_with_error_fn(jnp.asarray(poses))
    _, terr = tf.linearize_with_error_fn(torch.from_numpy(poses))
    jg = jjac.numeric_gradient(jerr, poses, key)
    tg = tjac.numeric_gradient(terr, poses, key, device="cpu")
    assert tg.dtype == np.float64 and tg.shape == (6,)
    bound = chip_smoke.JACOBIAN_G_QUANTA * _quantum(jf, tf, poses)
    assert np.abs(tg - jg).max() <= bound, (tg, jg, bound)
    # and, as the check holds it, against the analytic gradient
    lin = tf.linearize(torch.from_numpy(poses))
    np.testing.assert_allclose((-2.0 * (lin.b_s if key == 1 else lin.b_t)).numpy(), tg, rtol=5e-2, atol=1e-2)


@dataclasses.dataclass(frozen=True)
class _ScaledB:
    """A factor whose linearize returns b_s scaled by `scale` (a planted
    fault); every other attribute is the factor's."""

    factor: object
    scale: float

    def __getattr__(self, name):
        return getattr(self.factor, name)

    def linearize(self, poses):
        lin = self.factor.linearize(poses)
        return lin._replace(b_s=lin.b_s * self.scale)


def test_torch_check_factor_jacobian_catches_a_planted_fault(scene):
    jf, tf = _factors(scene, "gicp", 0)
    with pytest.raises(AssertionError):
        jjac.check_factor_jacobian(_ScaledB(jf, 1.5), scene["poses"])
    with pytest.raises(AssertionError):
        tjac.check_factor_jacobian(_ScaledB(tf, 1.5), scene["poses"])
    # the wrapper itself is sound: unscaled, both pass
    jjac.check_factor_jacobian(_ScaledB(jf, 1.0), scene["poses"])
    tjac.check_factor_jacobian(_ScaledB(tf, 1.0), scene["poses"])
