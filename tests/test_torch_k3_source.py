"""The fused point linearization's source-frame route (K3's arithmetic) on
the CPU.

csrc/linearize_fused.cu sums 29 terms a point (the rotated-source block
H~, g~, the error and the count) and expands them to the 12x12 system once.
`linearize_fused_source_plain` is that arithmetic in plain PyTorch. Here it
is held to `linearize_fused_plain` (the 92 direct sums) and to the JAX
`linearize_fused` (its Pallas kernel in interpret mode, one jitted call) on
the payloads of tests/test_torch_linearize.py and on two more: far from the
origin (|t| = 50 m, points 30 m out) and near the optimum (mu = R p + t +
0.01 noise, where b_t and b_s are small and the expansion cancels most).
Each field is held to 1e-4 x max|ref|, the JAX kernel-vs-XLA tolerance.
The grid functions of K3 and K2 are checked too: they depend on N alone."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_points_tpu.ops.pallas_linearize as PL
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.ops import fused_linearize as FL

torch.set_num_threads(1)
TOL = 1e-4
ROT = [0.03, -0.02, 0.05]


def _weights(rng, n):
    A = rng.randn(n, 3, 3).astype(np.float32)
    W = np.einsum("nij,nkj->nik", A, A) + np.eye(3, dtype=np.float32) * 0.1
    return np.ascontiguousarray(np.stack([W[:, 0, 0], W[:, 0, 1], W[:, 0, 2], W[:, 1, 1], W[:, 1, 2], W[:, 2, 2]]))


def _payload(kind, n, seed, mask_frac=0.0):
    """-> (p, mu, W6, mask, delta) as numpy. "random": tests/test_torch_linearize.py's
    payload (mu near p, so the residuals are large); "far": |t| = 50 m, points
    30 m from the sensor, mu = R p + t + 0.1 noise; "near": |t| = 20 m, mu =
    R p + t + 0.01 noise, near the optimum."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        p = rng.randn(3, n).astype(np.float32) * 5
        trans = [0.4, -0.2, 0.3]
    else:
        d = rng.randn(3, n)
        radius = 30.0 if kind == "far" else 1.0 + rng.rand(n) * 29.0
        p = (d / np.linalg.norm(d, axis=0) * radius).astype(np.float32)
        trans = [30.0, -40.0, 0.0] if kind == "far" else [12.0, -16.0, 0.0]
    delta = np.array(jse3.se3_exp(jnp.asarray(ROT + trans, dtype=jnp.float32)), dtype=np.float32)
    if kind == "random":
        mu = p + rng.randn(3, n).astype(np.float32) * 0.1
    else:
        noise = 0.1 if kind == "far" else 0.01
        mu = (delta[:3, :3] @ p + delta[:3, 3:] + rng.randn(3, n) * noise).astype(np.float32)
    mask = rng.rand(n) >= mask_frac
    return p, np.ascontiguousarray(mu), _weights(rng, n), mask, delta


def _jax_kernel(monkeypatch, arrays):
    """The JAX K3 in interpret mode, as one jitted call, waited for (see
    tests/test_torch_linearize.py)."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(PL, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(jax.jit(PL.linearize_fused)(*(jnp.asarray(a) for a in arrays)))
    monkeypatch.setattr(PL, "_on_tpu", lambda: False)
    return out


def assert_linearized_close(lin, ref):
    for f in Linearized._fields:
        a, b = np.asarray(getattr(lin, f)), np.asarray(getattr(ref, f))
        scale = np.max(np.abs(b)) + 1e-9
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale, err_msg=f)


CASES = {
    # name: (kind, n, mask_frac); the first four are tests/test_torch_linearize.py's
    "random-3000": ("random", 3000, 0.25),
    "random-2048": ("random", 2048, 0.0),
    "random-4099": ("random", 4099, 0.5),
    "random-7": ("random", 7, 0.0),
    "far-3000": ("far", 3000, 0.25),
    "near-3000": ("near", 3000, 0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_source_route_matches_direct_sums_and_jax_kernel(monkeypatch, case):
    kind, n, mask_frac = CASES[case]
    arrays = _payload(kind, n, 40 + n, mask_frac)
    args = [torch.from_numpy(a) for a in arrays]
    lin = FL.linearize_fused_source_plain(*args)
    ref = FL.linearize_fused_plain(*args)
    assert_linearized_close(lin, ref)
    assert_linearized_close(lin, _jax_kernel(monkeypatch, arrays))
    assert int(lin.num_inliers) == int(arrays[3].sum())
    if kind == "near":
        # b_t's rotation part is a sum of pm x W r over |pm| of 20-50 m that
        # mostly cancels: the case where the expansion could lose digits
        p, mu, W6, _, delta = args
        pm = delta[:3, :3] @ p + delta[:3, 3:]
        terms = torch.linalg.cross(pm, FL.planar.sym_mul(W6, pm - mu), dim=0)
        assert float(ref.b_t[:3].abs().max()) < 0.1 * float(terms.abs().sum(1).max())


def test_expansion_of_known_sums():
    """The expansion of one point's sums equals that point's
    12x12 system from its Jacobians, in float64."""
    rng = np.random.RandomState(5)
    p, mu = rng.randn(3, 1) * 4, rng.randn(3, 1) * 4
    W6 = _weights(rng, 1).astype(np.float64)

    def skew(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

    # a rotation orthogonal in float64 (Rodrigues): the expansion relies on it
    w = np.array(ROT)
    K, a = skew(w / np.linalg.norm(w)), np.linalg.norm(w)
    R, t = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K, np.array([3.0, -4.0, 1.0])
    delta = np.eye(4)
    delta[:3, :3], delta[:3, 3] = R, t
    pm = R @ p[:, 0] + t

    J = np.concatenate([skew(pm), -np.eye(3), -R @ skew(p[:, 0]), R], 1)  # [3, 12]
    W = np.array([[W6[0, 0], W6[1, 0], W6[2, 0]], [W6[1, 0], W6[3, 0], W6[4, 0]], [W6[2, 0], W6[4, 0], W6[5, 0]]])
    r = pm - mu[:, 0]
    H, g = J.T @ W @ J, J.T @ W @ r
    lin = FL.linearize_fused_source_plain(
        *(torch.from_numpy(a) for a in (p, mu, W6)), torch.ones(1, dtype=torch.bool), torch.from_numpy(delta))
    np.testing.assert_allclose(lin.H_tt.numpy(), H[:6, :6], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lin.H_ts.numpy(), H[:6, 6:], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lin.H_ss.numpy(), H[6:, 6:], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lin.b_t.numpy(), -g[:6], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lin.b_s.numpy(), -g[6:], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(float(lin.error), r @ W @ r, rtol=1e-12)
    assert int(lin.num_inliers) == 1


def test_grids_depend_on_n_alone():
    """K3's grid fills the card at the odometry size; K2's gives a lane one
    block per 256 points and never reads the number of lanes."""
    for fn in (FL.num_blocks, FL.unary_batch_num_blocks):
        assert list(inspect.signature(fn).parameters) == ["n"]
    assert FL.num_blocks(25_000) >= 132
    assert [FL.num_blocks(n) for n in (1, 128, 129, 25_000, 25_088, 10**8)] == [1, 1, 2, 196, 196, 256]
    assert [FL.unary_batch_num_blocks(n) for n in (0, 1, 256, 257, 25_087, 25_088, 10**8)] == [1, 1, 1, 2, 98, 98, 256]
    sizes = range(0, 300_000, 997)
    for fn in (FL.num_blocks, FL.unary_batch_num_blocks):
        grid = [fn(n) for n in sizes]
        assert grid == sorted(grid) and grid == [fn(n) for n in sizes]
