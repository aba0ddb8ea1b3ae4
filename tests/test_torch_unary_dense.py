"""PyTorch port vs the JAX package: the unary VGICP linearize over the dense
view (K5), K1's contract without weights.

On the CPU the port's `linearize_vgicp_unary_dense` takes its plain version,
K1's plain version without weights. It is held to the JAX K5 kernel running
in interpret mode (its inputs padded to a multiple of 4096 points and viewed
as [k, 8, N/8]) and to the JAX XLA twin `linearize_vgicp_unary_xla`, at
2e-3 x max|ref| per field: the voxel covariances come from raw moments (sum
ppᵀ/n - mu muᵀ), whose f32 cancellation turns rounding-order differences into
~2e-4 relative (the JAX repo's own kernel-vs-XLA tolerance,
tests/test_pallas_linearize.py:113-120). Inlier counts are held exactly. The
CUDA kernel itself runs only on a card (chip_smoke.py holds it to the plain
version and to K1 there); here the wrapper's checks and its refusal of CPU
tensors are checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unary import _probe, _scene, assert_linearized_close, jxla

import gtsam_points_tpu.ops.pallas_linearize as PL
from gtsam_points_tpu_torch.ops import fused_linearize as FL

torch.set_num_threads(1)
EPS = 1e-3


@pytest.fixture(scope="module")
def box():
    return _scene(3000, 8.0, 11)


@pytest.fixture(scope="module")
def sparse():
    """One-point voxels on a 1/8 grid (see tests/test_torch_unary.py)."""
    return _scene(3000, 60.0, 12, grid=True)


@pytest.fixture(scope="module")
def past_pad():
    """4097 points: the JAX kernel pads them to 8192, two grid steps."""
    return _scene(4097, 8.0, 13)


def _jax_kernel(monkeypatch, args):
    """The JAX K5 in interpret mode, as one jitted call, waited for: run
    eagerly, the dispatch on the main thread can deadlock against the
    interpreter's callback thread."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(PL, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(jax.jit(PL.linearize_vgicp_unary_dense, static_argnums=(4, 5))(*args))
    monkeypatch.setattr(PL, "_on_tpu", lambda: False)
    return out


CASES = {
    # name: (scene, points, min_voxel_points, half-False mask); None points:
    # the whole scene. One point is the scene's first that passes the gate.
    "box-mvp3": ("box", None, 3.0, False),
    "box-mvp1-half_mask": ("box", None, 1.0, True),
    "one_point_voxels": ("sparse", None, 1.0, False),
    "past_one_pad-mvp3": ("past_pad", None, 3.0, False),
    "one_point": ("box", 1, 1.0, False),
}


@pytest.mark.parametrize("with_covs", [True, False], ids=["covs", "eps"])
@pytest.mark.parametrize("case", list(CASES))
def test_unary_dense_matches_jax_kernel_and_xla(monkeypatch, request, case, with_covs):
    scene, points, mvp, half_mask = CASES[case]
    jmap, p, covs6, delta, _ = request.getfixturevalue(scene)
    momT, found = _probe(jmap, p, delta)
    if half_mask:
        found = found & (np.random.RandomState(p.shape[1] + 9).rand(p.shape[1]) > 0.5)
    if points == 1:
        i = np.flatnonzero(found & (momT[0] >= mvp))[0]
        p, momT, found, covs6 = p[:, i : i + 1], momT[:, i : i + 1], found[i : i + 1], covs6[:, i : i + 1]
    n = p.shape[1]
    gated = found & (momT[0] >= mvp)
    assert gated.sum() > 0.3 * n
    if scene == "sparse":
        assert np.mean(momT[0][found] == 1.0) > 0.8  # mostly one-point voxels
    sc = covs6 if with_covs else None

    jargs = [jnp.asarray(a) for a in (p, momT, found, delta)] + [mvp, EPS, None if sc is None else jnp.asarray(sc)]
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in (p, momT, found, delta)]
    targs += [mvp, EPS, None if sc is None else torch.from_numpy(np.ascontiguousarray(sc))]

    lin = FL.linearize_vgicp_unary_dense(*targs)
    assert_linearized_close(lin, _jax_kernel(monkeypatch, jargs))
    assert_linearized_close(lin, jxla(*jargs))
    assert int(lin.num_inliers) == gated.sum()
    assert not lin.H_tt.any() and not lin.H_ts.any() and not lin.b_t.any()
    if n > 1:
        assert float(torch.linalg.eigvalsh(lin.H_ss.double())[0]) > 0  # a usable GN system


def test_unary_dense_wrapper_checks_and_device_rule(box):
    """CPU tensors never reach the launcher; the CUDA wrapper refuses CPU
    tensors, wrong shapes, wrong dtypes and a strided source, and the
    dispatcher refuses the same shapes and dtypes on the CPU."""
    assert FL.linearize_vgicp_unary_dense_plain is FL.linearize_vgicp_unary_plain  # K1's, without weights
    jmap, p, covs6, delta, _ = box
    momT, found = _probe(jmap, p, delta)
    p, momT, found, delta, covs6 = (torch.from_numpy(a) for a in (p, momT, found, delta, covs6))
    before = FL.dense_launches
    lin = FL.linearize_vgicp_unary_dense(p, momT, found, delta, 3.0, EPS, covs6)  # the plain version
    assert FL.dense_launches == before and tuple(lin.H_ss.shape) == (6, 6)
    with pytest.raises(ValueError, match="CUDA"):
        FL.linearize_vgicp_unary_dense_cuda(p, momT, found, delta, 3.0, EPS, covs6)
    wrong = {
        "momT rows": ((p, momT[:9], found, delta, 3.0, EPS, covs6), ValueError),
        "momT points": ((p, momT[:, :-1], found, delta, 3.0, EPS, covs6), ValueError),
        "found points": ((p, momT, found[:-1], delta, 3.0, EPS, covs6), ValueError),
        "delta": ((p, momT, found, delta[:3], 3.0, EPS, covs6), ValueError),
        "covs rows": ((p, momT, found, delta, 3.0, EPS, covs6[:3]), ValueError),
        "p rank": ((p.reshape(-1), momT, found, delta, 3.0, EPS, covs6), ValueError),
        "momT dtype": ((p, momT.double(), found, delta, 3.0, EPS, covs6), TypeError),
        "found dtype": ((p, momT, found.to(torch.uint8), delta, 3.0, EPS, covs6), TypeError),
        "p dtype": ((p.double(), momT, found, delta, 3.0, EPS, covs6), TypeError),
    }
    for name, (bad, err) in wrong.items():
        with pytest.raises(err):
            FL.linearize_vgicp_unary_dense(*bad)
        with pytest.raises(err):
            FL.linearize_vgicp_unary_dense_cuda(*bad)
    strided = torch.stack([p, p], 2)[:, :, 0]  # [3, N], not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        FL.linearize_vgicp_unary_dense_cuda(strided, momT, found, delta, 3.0, EPS, covs6)
    assert FL.dense_launches == before
    # K1's grid: one point a thread, 128 points a block
    assert [FL.unary_num_blocks(n) for n in (1, 8, 1024, 1025, 3136, 4097, 25_088)] == [1, 1, 8, 9, 25, 33, 196]
