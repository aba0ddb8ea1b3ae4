"""Finite-difference Jacobian validation harness.

Port of gtsam_points_tpu/utils/jacobian_test.py (reference:
util/jacobian_test.hpp:44-100): perturb each key by ±eps and compare the
analytic linearization against numeric differences, which validates the
residual definition and the retraction convention end to end (b must equal
-1/2 dE/dxi).

A test harness, as the reference's is: each perturbed error is read to the
host with `float()`, 12 reads for a unary check and 24 for a binary one.
On a CUDA GICP factor the analytic side is one K3 launch (ICP's linearize
is `jacfwd` of its residual, as in the JAX package); the perturbed errors
are the plain frozen closure, which launches no kernel.
The float32 error E is read in steps of ulp(E), so a numeric gradient comes
in quanta of ulp(E) / (2 eps).
"""

from __future__ import annotations

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, float32_on, resolve_device
from gtsam_points_tpu_torch.factors.base import factor_poses
from gtsam_points_tpu_torch.factors.linearized import evaluate_error
from gtsam_points_tpu_torch.utils import se3
from gtsam_points_tpu_torch.utils.memory import tensors


def numeric_gradient(error_fn, poses, key: int, eps: float = 1e-4, device: DeviceLike = None) -> np.ndarray:
    """d error / d xi_key via central differences (right retraction). The
    perturbed poses are formed on the host, poses[key] @ Exp(±xi) in numpy,
    and handed to `error_fn` as float32 on `device` (None: cuda)."""
    dev = resolve_device(device)
    if isinstance(poses, torch.Tensor):
        check_on(dev, poses)
        poses = poses.detach().cpu().numpy()
    poses = np.asarray(poses)
    grad = np.zeros(6, dtype=np.float64)
    for i in range(6):
        xi = np.zeros(6, dtype=np.float32)
        xi[i] = eps
        pp = np.array(poses)
        pp[key] = poses[key] @ se3.se3_exp(torch.from_numpy(xi)).numpy()
        e_plus = float(error_fn(float32_on(pp, dev)))
        pp = np.array(poses)
        pp[key] = poses[key] @ se3.se3_exp(torch.from_numpy(-xi)).numpy()
        e_minus = float(error_fn(float32_on(pp, dev)))
        grad[i] = (e_plus - e_minus) / (2 * eps)
    return grad


def check_factor_jacobian(factor, poses, eps: float = 1e-4, rtol: float = 5e-2, atol: float = 1e-2):
    """Assert the factor's linearized b blocks match numeric gradients.

    With E = sum rᵀWr and b = -JᵀWr: dE/dxi = -2 b (holding W and
    correspondences frozen). We freeze them by fixing the residual closure at
    the linearization point. Runs on the factor's device; tensor poses must
    lie there. -> {"source": g_s, "target": g_t}, the target only for a
    binary factor with keys[0] >= 0; raises AssertionError on a mismatch.
    """
    dev = next(tensors(factor)).device
    poses = float32_on(poses, dev)
    lin = factor.linearize(poses)
    T_t0, T_s0 = factor_poses(factor, poses)
    closure = factor.residual_closure(T_t0, T_s0)

    keys = factor.keys
    results = {}

    def err_s(xi):
        return evaluate_error(closure, T_t0, T_s0 @ se3.se3_exp(xi))

    g_s = _numeric_grad6(err_s, eps, dev)
    np.testing.assert_allclose((-2.0 * lin.b_s).cpu().numpy(), g_s, rtol=rtol, atol=atol)
    results["source"] = g_s

    if len(keys) == 2 and keys[0] >= 0:
        def err_t(xi):
            return evaluate_error(closure, T_t0 @ se3.se3_exp(xi), T_s0)

        g_t = _numeric_grad6(err_t, eps, dev)
        np.testing.assert_allclose((-2.0 * lin.b_t).cpu().numpy(), g_t, rtol=rtol, atol=atol)
        results["target"] = g_t
    return results


def _numeric_grad6(f, eps, dev: torch.device):
    g = np.zeros(6)
    for i in range(6):
        xi = torch.zeros(6, dtype=torch.float32, device=dev)
        xi[i] = float(np.float32(eps))
        g[i] = (float(f(xi)) - float(f(-xi))) / (2 * eps)
    return g
