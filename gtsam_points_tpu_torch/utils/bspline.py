"""Cubic B-spline pose interpolation + continuous trajectory.

Port of gtsam_points_tpu/utils/bspline.py (reference:
util/bspline.hpp:22-151 and util/continuous_trajectory.hpp:21-95). Plain
PyTorch on every device, as the reference module is plain JAX: forward-mode
AD (`torch.func.jvp`, `torch.func.jacfwd`) supplies every derivative, and
`fit_knots` is a batched Gauss-Newton problem over the knot poses, dense for
few knots and block-banded with a preconditioned CG for many.

Cumulative cubic B-spline (Sommer et al.): for t in [t_i, t_{i+1}) with
normalized u, using knots T_{i-1}..T_{i+2}:
  T(u) = T_{i-1} · prod_{j=1..3} Exp(B_j(u) · Log(T_{i+j-2}⁻¹ T_{i+j-1}))
  B(u) = C·[1, u, u², u³], C the cumulative cubic basis matrix.

Everything is float32, as the reference computes: the knot count, the knot
stamps and the interval lookup round as it rounds, so a stamp on an
interval boundary picks the same interval and the same initial sample.
Once its inputs are on the card, a fit makes no synchronizing call.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, float32_on, resolve_device
from gtsam_points_tpu_torch.ops.voxelmap import scatter_sum
from gtsam_points_tpu_torch.utils import se3

# cumulative basis matrix (rows: B_1..B_3 coefficients of [1, u, u^2, u^3]),
# made on each device by _device_const
_C = (
    (5.0 / 6.0, 3.0 / 6.0, -3.0 / 6.0, 1.0 / 6.0),
    (1.0 / 6.0, 3.0 / 6.0, 3.0 / 6.0, -2.0 / 6.0),
    (0.0, 0.0, 0.0, 1.0 / 6.0),
)
_DEVICE_CONSTS: dict = {}


def _device_const(values: tuple, like: torch.Tensor) -> torch.Tensor:
    """`values` (a tuple, or a tuple of tuples) as a tensor of `like`'s dtype
    on its device, cached. It is made there by fill kernels: a tensor copied
    from pageable host memory to the card syncs the stream. As `se3._const`,
    it is made with functorch's dispatch off, so the cache holds no
    transform's wrapper."""
    key = (values, like.dtype, like.device)
    if key not in _DEVICE_CONSTS:
        with torch._C._DisableFuncTorch():
            parts = [torch.full((1,), float(v), dtype=like.dtype, device=like.device)
                     for v in np.ravel(np.asarray(values, np.float64))]
            _DEVICE_CONSTS[key] = torch.cat(parts).reshape(np.shape(values))
    return _DEVICE_CONSTS[key]


def _basis(u: torch.Tensor) -> torch.Tensor:
    """[..., 3] cumulative weights B_1..B_3 at normalized u [...]."""
    uv = torch.stack([torch.ones_like(u), u, u * u, u * u * u], dim=-1)  # [..., 4]
    return uv @ _device_const(_C, u).T


def bspline_pose(knots: torch.Tensor, u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Interpolate at normalized u in [0,1) within knot interval i.

    knots: [K, 4, 4]; uses knots[i-1 .. i+2] (callers guarantee 1 <= i <= K-3).
    Returns [..., 4, 4] for broadcast u/i of matching shape.
    """
    B = _basis(u)
    T0 = knots[i - 1]
    d1 = se3.se3_log(se3.se3_inverse(knots[i - 1]) @ knots[i])
    d2 = se3.se3_log(se3.se3_inverse(knots[i]) @ knots[i + 1])
    d3 = se3.se3_log(se3.se3_inverse(knots[i + 1]) @ knots[i + 2])
    A1 = se3.se3_exp(B[..., 0, None] * d1)
    A2 = se3.se3_exp(B[..., 1, None] * d2)
    A3 = se3.se3_exp(B[..., 2, None] * d3)
    return T0 @ A1 @ A2 @ A3


class ContinuousTrajectory:
    """Uniform-knot B-spline trajectory over [t0, t1] (reference:
    util/continuous_trajectory.hpp:21-95). It evaluates on its knots'
    device: stamps may be numbers, numpy arrays or tensors on that device."""

    def __init__(self, knots: torch.Tensor, t0: float, knot_interval: float):
        self.knots = knots  # [K, 4, 4]
        self.t0 = float(t0)
        self.dt = float(knot_interval)

    @staticmethod
    def num_knots(t0: float, t1: float, knot_interval: float) -> int:
        # the quotient rounded to float32 before the ceil, as the reference
        # does: (0.4 - 0.1) / 0.1 = 3.0000000000000004 gives 3 there, where
        # math.ceil gives 4
        return int(np.ceil(np.float32((t1 - t0) / knot_interval))) + 3

    def knot_stamp(self, i) -> torch.Tensor:
        i = float32_on(i, self.knots.device)
        return se3._const(self.t0, i) + (i - se3._const(1.0, i)) * se3._const(self.dt, i)

    def _locate(self, t: torch.Tensor):
        t = float32_on(t, self.knots.device)
        s = (t - se3._const(self.t0, t)) / se3._const(self.dt, t)
        # floor(s) carries no tangent; u carries 1/dt of t's
        i = torch.clamp(torch.floor(s).to(torch.int32) + 1, 1, self.knots.shape[0] - 3)
        u = s - (i - 1)
        return u, i

    def pose(self, t) -> torch.Tensor:
        u, i = self._locate(t)
        return bspline_pose(self.knots, u, i)

    def velocity(self, t):
        """(angular [3], linear [3]) world-frame velocities by AD through time."""
        t = float32_on(t, self.knots.device)
        T, dT = torch.func.jvp(self.pose, (t,), (torch.ones_like(t),))
        R = T[..., :3, :3]
        w_hat = dT[..., :3, :3] @ R.transpose(-1, -2)
        omega = torch.stack([w_hat[..., 2, 1], w_hat[..., 0, 2], w_hat[..., 1, 0]], dim=-1)
        return omega, dT[..., :3, 3]

    def imu(self, t, gravity=(0.0, 0.0, -9.80665)):
        """Local-frame (acc, gyro) prediction (reference: bspline_imu,
        util/bspline.hpp)."""

        def vel(tt):
            _, dT = torch.func.jvp(self.pose, (tt,), (torch.ones_like(tt),))
            return dT[..., :3, 3]

        t = float32_on(t, self.knots.device)
        a_world = torch.func.jvp(vel, (t,), (torch.ones_like(t),))[1]
        T = self.pose(t)
        R = T[..., :3, :3]
        g = _device_const(tuple(float(x) for x in gravity), a_world)
        acc_local = torch.einsum("...ji,...j->...i", R, a_world - g)
        omega_w, _ = self.velocity(t)
        gyro_local = torch.einsum("...ji,...j->...i", R, omega_w)
        return acc_local, gyro_local


def fit_knots(
    stamps: torch.Tensor,
    poses: torch.Tensor,
    t0: float,
    t1: float,
    knot_interval: float,
    iterations: int = 20,
    smoothness_weight: float = 1e-2,
    dense_knot_threshold: int = 96,
    device: DeviceLike = None,
) -> ContinuousTrajectory:
    """Batch-fit knot poses to timestamped pose samples with a smoothness prior
    (reference: ContinuousTrajectory::fit_knots, src/.../continuous_trajectory.cpp).
    Gauss-Newton over all knots jointly, `iterations` steps with no host read.

    Small problems use a dense K*6 solve; long trajectories switch to a
    block-banded Gauss-Newton (each sample touches only its 4-knot window, so
    H has block bandwidth 3) solved by preconditioned CG with an O(K) banded
    matvec. `device=None` means cuda; stamps and poses given as tensors must
    lie on that device."""
    dev = resolve_device(device)
    stamps, poses = float32_on(stamps, dev), float32_on(poses, dev)
    K = ContinuousTrajectory.num_knots(t0, t1, knot_interval)
    knots0 = _initial_knots(stamps, poses, t0, knot_interval, K)
    if K > dense_knot_threshold:
        knots = _fit_knots_banded(stamps, poses, float(t0), float(knot_interval), K, knots0, iterations,
                                  smoothness_weight)
        return ContinuousTrajectory(knots, t0, knot_interval)

    def residuals(knots):
        traj = ContinuousTrajectory(knots, t0, knot_interval)
        pred = traj.pose(stamps)
        r_fit = se3.se3_log(se3.se3_inverse(pred) @ poses).reshape(-1)
        d = se3.se3_log(se3.se3_inverse(knots[:-1]) @ knots[1:])
        r_smooth = (d[1:] - d[:-1]).reshape(-1) * se3._const(smoothness_weight, d)
        return torch.cat([r_fit, r_smooth])

    zero = torch.zeros((K * 6,), dtype=torch.float32, device=dev)
    eye = torch.eye(K * 6, dtype=torch.float32, device=dev)
    knots = knots0
    for _ in range(iterations):

        def at(xi, knots=knots):
            r = residuals(knots @ se3.se3_exp(xi.reshape(K, 6)))
            return r, r

        J, r0 = torch.func.jacfwd(at, has_aux=True)(zero)
        H = J.T @ J + 1e-6 * eye
        # cholesky_ex, not cholesky: the latter reads its status on the host;
        # a failed factor gives the zero step, as the reference's NaN does
        L, info = torch.linalg.cholesky_ex(H)
        delta = torch.cholesky_solve(-(J.T @ r0)[:, None], L)[:, 0]
        delta = torch.where((info == 0) & torch.isfinite(delta).all(), delta, 0.0)
        knots = knots @ se3.se3_exp(delta.reshape(K, 6))
    return ContinuousTrajectory(knots, t0, knot_interval)


def _initial_knots(stamps, poses, t0: float, knot_interval: float, K: int) -> torch.Tensor:
    """The nearest sample pose a knot: the first sample at or after the
    knot's stamp, the stamps in float32 (searchsorted's left side)."""
    knot_t = (torch.arange(K, dtype=torch.int32, device=stamps.device) - 1) * knot_interval + t0
    return poses[torch.clamp(torch.searchsorted(stamps, knot_t), 0, len(stamps) - 1)]


def _window_pose(knots4: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Cumulative B-spline pose from an explicit 4-knot window [4,4,4]."""
    B = _basis(u)
    d1 = se3.se3_log(se3.se3_inverse(knots4[0]) @ knots4[1])
    d2 = se3.se3_log(se3.se3_inverse(knots4[1]) @ knots4[2])
    d3 = se3.se3_log(se3.se3_inverse(knots4[2]) @ knots4[3])
    return (
        knots4[0]
        @ se3.se3_exp(B[..., 0, None] * d1)
        @ se3.se3_exp(B[..., 1, None] * d2)
        @ se3.se3_exp(B[..., 2, None] * d3)
    )


def _band_matvec(Hb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[k] = sum_o Hb[k, o] @ x[k + o - 3] for block-banded H ([K,7,6,6])."""
    K = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, 3, 3))
    xs = torch.stack([xp[o:o + K] for o in range(7)], dim=1)
    return torch.einsum("koij,koj->ki", Hb, xs)


def _fit_knots_banded(stamps, poses, t0, dt, K, knots0, iterations, w_smooth, cg_iters=120):
    """Banded GN fit: scatter per-sample 24x24 window Hessians into a [K,7,6,6]
    block band, solve with block-Jacobi-preconditioned CG. It computes in
    the inputs' dtype (fit_knots gives float32; float64 is a witness).

    The band is summed by `scatter_sum`, each block from its samples in input
    order and then its smoothness terms, as the reference's two scatter-adds
    sum on the CPU; `index_add_` on the card would add in no fixed order."""
    dev = stamps.device
    s = (stamps - se3._const(t0, stamps)) / se3._const(dt, stamps)
    iv = torch.clamp(torch.floor(s).to(torch.int32) + 1, 1, K - 3)
    u = s - (iv - 1).to(s.dtype)
    base = (iv - 1).to(torch.int64)  # [S]
    a_idx = torch.arange(4, dtype=torch.int64, device=dev)
    off_ab = a_idx[None, :] - a_idx[:, None] + 3  # [4,4] offset of block (a,b)
    sm_base = torch.arange(K - 2, dtype=torch.int64, device=dev)
    w = se3._const(w_smooth, stamps)

    def sample_r(xi, k4, uu, Ts):
        r = se3.se3_log(se3.se3_inverse(_window_pose(k4 @ se3.se3_exp(xi.reshape(4, 6)), uu)) @ Ts)
        return r, r

    def smooth_r(xi, k3):
        # r_j = (Log(K[j+1]^-1 K[j+2]) - Log(K[j]^-1 K[j+1])) * w over window (j, j+1, j+2)
        k = k3 @ se3.se3_exp(xi.reshape(3, 6))
        d1 = se3.se3_log(se3.se3_inverse(k[0]) @ k[1])
        d2 = se3.se3_log(se3.se3_inverse(k[1]) @ k[2])
        r = (d2 - d1) * w
        return r, r

    sample_Jr = torch.func.vmap(torch.func.jacfwd(sample_r, has_aux=True), in_dims=(None, 0, 0, 0))
    smooth_Jr = torch.func.vmap(torch.func.jacfwd(smooth_r, has_aux=True), in_dims=(None, 0))
    zero24 = torch.zeros((24,), dtype=poses.dtype, device=dev)
    zero18 = torch.zeros((18,), dtype=poses.dtype, device=dev)

    # block (a, b) of sample n goes to row base[n] + a, offset b - a + 3;
    # the smoothness blocks follow the samples' in the sum
    rows = base[:, None] + a_idx[None, :]  # [S,4]
    rows2 = sm_base[:, None] + a_idx[None, :3]  # [K-2,3]
    h_slot = torch.cat([(rows[:, :, None] * 7 + off_ab[None]).reshape(-1),
                        (rows2[:, :, None] * 7 + off_ab[None, :3, :3]).reshape(-1)])
    b_slot = torch.cat([rows.reshape(-1), rows2.reshape(-1)])

    def build_system(knots):
        J, r = sample_Jr(zero24, knots[rows], u, poses)  # [S,6,24], [S,6]
        Jb = J.reshape(-1, 6, 4, 6)  # [S,6,4,6]
        Hs = torch.einsum("siaj,sibk->sabjk", Jb, Jb)  # [S,4,4,6,6]
        bs = -torch.einsum("siaj,si->saj", Jb, r)  # [S,4,6]

        J2, r2 = smooth_Jr(zero18, knots[rows2])
        J2b = J2.reshape(-1, 6, 3, 6)
        Hs2 = torch.einsum("siaj,sibk->sabjk", J2b, J2b)
        bs2 = -torch.einsum("siaj,si->saj", J2b, r2)
        Hb = scatter_sum(torch.cat([Hs.reshape(-1, 6, 6), Hs2.reshape(-1, 6, 6)]), h_slot, K * 7)
        bv = scatter_sum(torch.cat([bs.reshape(-1, 6), bs2.reshape(-1, 6)]), b_slot, K)
        return Hb.reshape(K, 7, 6, 6), bv

    eye6 = torch.eye(6, dtype=poses.dtype, device=dev)

    def cg(Hb, bv):
        # inv_ex, not inv: the latter checks for singularity on the host
        Minv = torch.linalg.inv_ex(Hb[:, 3] + 1e-5 * eye6).inverse

        def prec(v):
            return torch.einsum("kij,kj->ki", Minv, v)

        x = torch.zeros_like(bv)
        rr = bv
        z = prec(rr)
        p = z
        rz = torch.sum(rr * z)
        for _ in range(cg_iters):
            Hp = _band_matvec(Hb, p)
            alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-20)
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = prec(rr)
            rz2 = torch.sum(rr * z)
            beta = rz2 / torch.clamp(rz, min=1e-20)
            p = z + beta * p
            rz = rz2
        return x

    knots = knots0
    for _ in range(iterations):
        Hb, bv = build_system(knots)
        Hb[:, 3] += 1e-4 * eye6  # damping
        delta = cg(Hb, bv)
        delta = torch.where(torch.isfinite(delta).all(), delta, torch.zeros_like(delta))
        knots = knots @ se3.se3_exp(delta)
    return knots
