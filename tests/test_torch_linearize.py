"""PyTorch port vs the JAX package: the fused point linearization (K3).

On the CPU the port's `linearize_fused` takes its plain version; the JAX
`linearize_fused` runs its Pallas kernel in interpret mode, as
tests/test_pallas_linearize.py runs it. Fields are held to 1e-4 x max|ref|,
the JAX kernel-vs-XLA tolerance. The CUDA kernel itself runs only on a card
(chip_smoke.py holds it to the plain version there); here the wrapper's
output layout and its refusal of CPU tensors are checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_points_tpu.ops.pallas_linearize as PL
from gtsam_points_tpu.factors.vgicp import VGICPFactor as JVGICPFactor
from gtsam_points_tpu.ops import voxelmap as jvm
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.factors.vgicp import VGICPFactor, make_vgicp_factor
from gtsam_points_tpu_torch.interop import frame_from_numpy, voxelmap_from_numpy
from gtsam_points_tpu_torch.ops import fused_linearize as FL

torch.set_num_threads(1)
TOL = 1e-4


def _payload(n, seed, mask_frac):
    rng = np.random.RandomState(seed)
    p = rng.randn(3, n).astype(np.float32) * 5
    mu = p + rng.randn(3, n).astype(np.float32) * 0.1
    A = rng.randn(n, 3, 3).astype(np.float32)
    W = np.einsum("nij,nkj->nik", A, A) + np.eye(3, dtype=np.float32) * 0.1
    W6 = np.stack([W[:, 0, 0], W[:, 0, 1], W[:, 0, 2], W[:, 1, 1], W[:, 1, 2], W[:, 2, 2]])
    mask = rng.rand(n) >= mask_frac
    delta = np.array(jse3.se3_exp(jnp.asarray([0.03, -0.02, 0.05, 0.4, -0.2, 0.3])))
    return p, mu, np.ascontiguousarray(W6), mask, delta


def _jax_kernel(monkeypatch, arrays):
    """The JAX K3 in interpret mode, as one jitted call. Run eagerly, the
    unpacking's dispatch on the main thread can deadlock against the
    interpreter's callback thread, which dispatches operations too."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(PL, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        return jax.block_until_ready(jax.jit(PL.linearize_fused)(*(jnp.asarray(a) for a in arrays)))


def assert_linearized_close(lin, ref):
    for f in Linearized._fields:
        a, b = np.asarray(getattr(lin, f)), np.asarray(getattr(ref, f))
        scale = np.max(np.abs(b)) + 1e-9
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale, err_msg=f)


@pytest.mark.parametrize("n,mask_frac", [(3000, 0.25), (2048, 0.0), (4099, 0.5), (7, 0.0)])
def test_linearize_fused_matches_jax_kernel(monkeypatch, n, mask_frac):
    """N not a multiple of the 2048-lane tile, and partly-False masks."""
    arrays = _payload(n, 3 + n, mask_frac)
    ref = _jax_kernel(monkeypatch, arrays)
    lin = FL.linearize_fused(*(torch.from_numpy(a) for a in arrays))
    assert_linearized_close(lin, ref)
    assert int(lin.num_inliers) == int(arrays[3].sum())


@pytest.mark.parametrize("batch", [False, True])
def test_error_fused_matches_jax(batch):
    p, mu, W6, mask, delta = _payload(3000, 4, 0.25)
    deltas = np.stack([delta, np.eye(4, dtype=np.float32)]) if batch else delta
    ref = np.asarray(PL.error_fused(*(jnp.asarray(a) for a in (p, mu, W6, mask)), jnp.asarray(deltas[0] if batch else deltas)))
    out = FL.error_fused(*(torch.from_numpy(a) for a in (p, mu, W6, mask, deltas))).numpy()
    first = out[0] if batch else out
    assert abs(float(first) - float(ref)) <= TOL * abs(float(ref))
    if batch:  # every candidate of a batch scores like its own call
        alone = FL.error_fused(*(torch.from_numpy(a) for a in (p, mu, W6, mask, deltas[1])))
        assert abs(float(out[1]) - float(alone)) <= 1e-6 * abs(float(alone))


def test_wrapper_output_layout_and_device_rule():
    """The kernel's 92-float row (upper-triangle H, g, err, count) unpacks to
    the plain version's Linearized; CPU tensors never reach the launcher."""
    arrays = [torch.from_numpy(a) for a in _payload(500, 8, 0.3)]
    plain = FL.linearize_fused_plain(*arrays)
    H = torch.cat([torch.cat([plain.H_tt, plain.H_ts], 1), torch.cat([plain.H_ts.T, plain.H_ss], 1)])
    iu = torch.triu_indices(12, 12)
    row = torch.cat([H[iu[0], iu[1]], -plain.b_t, -plain.b_s, plain.error[None],
                     plain.num_inliers.to(torch.float32)[None]])
    assert row.shape == (92,)
    assert_linearized_close(FL._unpack(row), plain)

    before = FL.launches
    FL.linearize_fused(*arrays)  # CPU tensors: the plain version, no launch
    assert FL.launches == before
    with pytest.raises(ValueError):
        FL.linearize_fused_cuda(*arrays)
    assert FL.num_blocks(1) == 1 and FL.num_blocks(25_088) == 25 and FL.num_blocks(10**8) == 1024


def test_vgicp_factor_linearize_matches_jax():
    """The factor end to end on one map: probe payload, K3 and frozen error."""
    rng = np.random.RandomState(21)
    tgt = np.concatenate([rng.rand(4000, 3) * [20, 20, 0.05], rng.rand(4000, 3) * [0.05, 20, 5]]).astype(np.float32)
    src = (tgt[::2] + rng.randn(4000, 3).astype(np.float32) * 0.01).astype(np.float32)
    jmap = jax.jit(jvm.build_voxelmap, static_argnums=(1, 2))(jmake(tgt), 1.0, 4096)
    jsrc = jmake(src, covs=np.tile(np.eye(3, dtype=np.float32) * 0.01, (len(src), 1, 1)))
    T = jse3.se3_exp(jnp.asarray([0.01, -0.02, 0.015, 0.05, 0.02, -0.03]))
    jf = JVGICPFactor(voxelmap=jmap, source=jsrc, fixed_target_pose=jnp.eye(4), target_key=-1,
                      source_key=0, min_voxel_points=5.0)
    jcorr = jax.jit(jf.correspondences)(T[None])
    jlin, jerr = jf.linearize_corr(T[None], jcorr)
    jerr = jax.jit(jerr)

    tmap = voxelmap_from_numpy({k: np.asarray(v) for k, v in jmap._asdict().items()}, device="cpu")
    tsrc = frame_from_numpy({"points": np.asarray(jsrc.points), "mask": np.asarray(jsrc.mask),
                             "covs": np.asarray(jsrc.covs)}, device="cpu")
    tf = make_vgicp_factor(-1, 0, tmap, tsrc, min_voxel_points=5.0)
    assert isinstance(tf, VGICPFactor) and tf.keys == (-1, 0)
    Tt = torch.from_numpy(np.asarray(T))[None]
    tcorr = tf.correspondences(Tt)
    assert all(c.is_contiguous() for c in tcorr)  # what the CUDA wrapper requires
    np.testing.assert_array_equal(tcorr[0].numpy(), np.asarray(jcorr[0]))
    assert tcorr[0].sum() > 1000
    for a, b in zip(tcorr[1:], jcorr[1:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.max(np.abs(b)))
    tlin, terr = tf.linearize_corr(Tt, tcorr)
    assert_linearized_close(tlin, jlin)
    cand = jse3.se3_exp(jnp.asarray([0.0, 0.0, 0.01, 0.02, 0.0, 0.0]))
    e_j = float(jerr((T @ cand)[None]))
    e_t = float(terr(torch.from_numpy(np.asarray(T @ cand))[None]))
    assert abs(e_t - e_j) <= TOL * abs(e_j)
