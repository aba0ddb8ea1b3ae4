"""PyTorch port vs the JAX package: SE(3) algebra and the small SPD solve.

Inputs come from a seeded numpy generator and go through both packages; the
port is held to the JAX output at 1e-5 (float32 round-off of the same
formulas in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu.utils.solve6 import solve_small as jsolve
from gtsam_points_tpu_torch.utils import se3 as tse3
from gtsam_points_tpu_torch.utils.solve6 import solve_small as tsolve

torch.set_num_threads(1)
TOL = 1e-5


def _tangents(seed, scale):
    xi = np.random.RandomState(seed).randn(64, 6).astype(np.float32) * scale
    xi[0] = 0.0  # identity: the Taylor branches
    return xi


@pytest.mark.parametrize("scale", [1e-5, 0.3, 1.5])
def test_se3_exp_log_match_jax(scale):
    xi = _tangents(1, scale)
    T_j = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    T_t = tse3.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tse3.se3_log(torch.from_numpy(T_j)).numpy(), np.asarray(jse3.se3_log(jnp.asarray(T_j))),
        rtol=0, atol=TOL * max(1.0, scale),
    )


def test_so3_log_near_pi_and_pose_error_match_jax():
    rng = np.random.RandomState(2)
    axis = rng.randn(16, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = axis * np.float32(np.pi - 1e-3)
    R = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(
        tse3.so3_log(torch.from_numpy(R)).numpy(), np.asarray(jse3.so3_log(jnp.asarray(R))), atol=1e-4
    )
    Ta = np.asarray(jse3.se3_exp(jnp.asarray(_tangents(3, 0.5))))
    Tb = np.asarray(jse3.se3_exp(jnp.asarray(_tangents(4, 0.5))))
    rj, tj = jse3.pose_error(jnp.asarray(Ta), jnp.asarray(Tb))
    rt, tt = tse3.pose_error(torch.from_numpy(Ta), torch.from_numpy(Tb))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=TOL)
    inv = tse3.se3_inverse(torch.from_numpy(Ta)).numpy()
    np.testing.assert_allclose(inv, np.asarray(jse3.se3_inverse(jnp.asarray(Ta))), atol=TOL)


def _spd(seed, k, n=6):
    rng = np.random.RandomState(seed)
    M = rng.randn(k, n, n).astype(np.float32)
    H = np.einsum("kij,klj->kil", M, M) + np.eye(n, dtype=np.float32) * 0.5
    return H, rng.randn(k, n).astype(np.float32)


@pytest.mark.parametrize("n", [3, 6, 12])
def test_solve_small_matches_jax(n):
    H, b = _spd(5 + n, 5, n)
    x_j = np.asarray(jsolve(jnp.asarray(H), jnp.asarray(b)))
    x_t = tsolve(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    scale = np.max(np.abs(x_j))
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=TOL * scale)
    # and it solves the system
    np.testing.assert_allclose(np.einsum("kij,kj->ki", H, x_t), b, atol=1e-3)


def test_solve_small_singular_matches_jax():
    """A rank-deficient system: the pivot clamp sqrt(max(s, 1e-30)) gives the
    same finite numbers in both packages."""
    H, b = _spd(9, 2)
    H[:, 5, :] = 0.0
    H[:, :, 5] = 0.0
    x_j = np.asarray(jsolve(jnp.asarray(H), jnp.asarray(b)))
    x_t = tsolve(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    finite = np.isfinite(x_j)
    np.testing.assert_array_equal(np.isfinite(x_t), finite)
    np.testing.assert_allclose(x_t[:, :5], x_j[:, :5], rtol=0, atol=TOL * np.max(np.abs(x_j[:, :5])))
    np.testing.assert_allclose(x_t[finite], x_j[finite], rtol=1e-5)
