"""Batched SO(3)/SE(3) Lie-group operations (float32).

Port of gtsam_points_tpu/utils/se3.py with the same conventions: poses are
4x4 homogeneous matrices, tangent vectors are (omega, v) with rotation first,
retraction is right-multiplicative (T @ Exp(xi)). All functions broadcast over
leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_CONSTS: dict = {}


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-d CPU tensor of `like`'s dtype, cached. A python float
    times or over a 0-d tensor gives a float64 tangent under
    `torch.func.jacfwd`; a 0-d tensor of the operand's dtype does not, and
    it enters a CUDA kernel as the same float argument as the python float,
    so values are unchanged. It is made with functorch's dispatch off: a
    tensor made inside a `torch.func` transform is wrapped at that
    transform's level, and the cached wrapper, read under a later nested
    `jvp`, fails functorch's level check."""
    key = (value, like.dtype)
    if key not in _CONSTS:
        with torch._C._DisableFuncTorch():
            _CONSTS[key] = torch.tensor(value, dtype=like.dtype)
    return _CONSTS[key]


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _safe_sqrt(theta2: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """sqrt(theta2), with 1 where `small` (the Taylor branches, which never
    read it): reverse-mode AD of sqrt at 0 gives 0·inf = NaN even through
    the branch a `torch.where` drops, so `torch.autograd` over an error at
    zero tangent (`optim.dogleg.gradient_descent`) needs the sqrt kept off
    0. Where it is read, the value is sqrt(max(theta2, 0)) bit for bit; a
    python 1.0 keeps it one kernel, as the clamp was."""
    return torch.sqrt(torch.where(small, 1.0, theta2))


def _sinc_coeffs(theta2: torch.Tensor):
    """(sin t / t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe near 0."""
    small = theta2 < 1e-8
    theta = _safe_sqrt(theta2, small)
    a_t = 1.0 - theta2 / _const(6.0, theta2)
    b_t = 0.5 - theta2 / _const(24.0, theta2)
    c_t = 1.0 / 6.0 - theta2 / _const(120.0, theta2)
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, a_t, torch.sin(safe) / safe)
    b = torch.where(small, b_t, (1.0 - torch.cos(safe)) / torch.clamp(theta2, min=_EPS))
    c = torch.where(small, c_t, (safe - torch.sin(safe)) / torch.clamp(theta2 * safe, min=_EPS))
    return a, b, c


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    K = skew(w)
    return _eye3_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle (quaternion-based)."""
    q = rot_to_quat(R)
    sign = torch.where(q[..., 3] < 0, -1.0, 1.0)
    v = q[..., :3] * sign[..., None]
    qw = q[..., 3] * sign
    nv2 = torch.sum(v * v, dim=-1)
    small = nv2 < 1e-10
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    two = _const(2.0, qw)
    theta = two * torch.atan2(nv, qw)
    qw_safe = torch.clamp(qw, min=1e-3)
    taylor = torch.reciprocal(qw_safe) * two * (1.0 - nv2 / (_const(3.0, qw) * qw_safe * qw_safe))
    scale = torch.where(small, taylor, theta / nv)
    return v * scale[..., None]


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3): the Expmap translation coupling matrix."""
    theta2 = torch.sum(w * w, dim=-1)
    _, b, c = _sinc_coeffs(theta2)
    K = skew(w)
    return _eye3_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta = _safe_sqrt(theta2, small)
    K = skew(w)
    half = theta * _const(0.5, theta)
    cot_term = torch.where(
        small,
        _const(1.0 / 12.0, theta2) + theta2 / _const(720.0, theta2),
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / torch.clamp(theta2, min=_EPS),
    )
    return _eye3_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] (omega, v) -> [..., 4, 4] homogeneous transform."""
    w, v = xi[..., :3], xi[..., 3:]
    return make_transform(so3_exp(w), _matvec(so3_left_jacobian(w), v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6] (omega, v)."""
    w = so3_log(T[..., :3, :3])
    v = _matvec(so3_left_jacobian_inv(w), T[..., :3, 3])
    return torch.cat([w, v], dim=-1)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    # the row [0 0 0 1] made on the device: writing a python scalar into a
    # CUDA tensor (x[i] = 1.0) copies it from the host and syncs the stream
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -_matvec(Rt, T[..., :3, 3]))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to [..., N, 3] points."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def rotate_points(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], vecs)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6, 6] adjoint in (omega, v) order:
    Ad(T) = [[R, 0], [[t]x R, R]]."""
    R = T[..., :3, :3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bottom = torch.cat([skew(T[..., :3, 3]) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] in (x, y, z, w) order -> [..., 3, 3] rotation."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), Shepperd's branch selection."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    one = _const(1.0, tr)
    c = torch.stack(
        [one + tr, one + m00 - m11 - m22, one - m00 + m11 - m22, one - m00 - m11 + m22], dim=-1
    )
    case = torch.argmax(c, dim=-1, keepdim=True)
    s = torch.sqrt(torch.clamp(torch.gather(c, -1, case)[..., 0], min=1e-12))
    inv2s = torch.reciprocal(s) * _const(0.5, s)
    half_s = _const(0.5, s) * s
    q0 = torch.stack([(m21 - m12) * inv2s, (m02 - m20) * inv2s, (m10 - m01) * inv2s, half_s], -1)
    q1 = torch.stack([half_s, (m01 + m10) * inv2s, (m02 + m20) * inv2s, (m21 - m12) * inv2s], -1)
    q2 = torch.stack([(m01 + m10) * inv2s, half_s, (m12 + m21) * inv2s, (m02 - m20) * inv2s], -1)
    q3 = torch.stack([(m02 + m20) * inv2s, (m12 + m21) * inv2s, half_s, (m10 - m01) * inv2s], -1)
    q = torch.where(case == 0, q0, torch.where(case == 1, q1, torch.where(case == 2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def pose_from_xyzq(xyzq: torch.Tensor) -> torch.Tensor:
    """[..., 7] = (x, y, z, qx, qy, qz, qw) -> [..., 4, 4]."""
    return make_transform(quat_to_rot(xyzq[..., 3:7]), xyzq[..., :3])


def pose_error(T_a: torch.Tensor, T_b: torch.Tensor):
    """Rotation (rad) and translation (m) error between two poses."""
    dT = se3_inverse(T_a) @ T_b
    w = so3_log(dT[..., :3, :3])
    return torch.linalg.norm(w, dim=-1), torch.linalg.norm(dT[..., :3, 3], dim=-1)

