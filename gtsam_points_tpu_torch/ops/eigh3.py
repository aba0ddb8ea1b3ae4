"""Batched closed-form symmetric 3x3 eigendecomposition.

Port of gtsam_points_tpu/ops/eigh3.py: the trigonometric eigenvalue formula
plus eigenvectors from the largest cross product of rows of (A - lam I).
Eigenvalues come out in ascending order.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-20


def eigvals3(A: torch.Tensor) -> torch.Tensor:
    """Analytic eigenvalues of symmetric [..., 3, 3], ascending."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.where(p > _EPS, detB / torch.clamp(2.0 * p * p * p, min=_EPS), 0.0)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def _eigvec(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of A for eigenvalue lam (largest cross product of rows of
    A - lam I; a fixed unit vector where all are degenerate)."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack(
        [torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2), torch.linalg.cross(r1, r2)], dim=-2
    )
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    nv2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = nv2[..., 0] < 1e-12
    nv = torch.sqrt(torch.where(small[..., None], 1.0, nv2))
    fallback = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype, device=A.device).expand(v.shape)
    return torch.where(small[..., None], fallback, v / nv)


def eigh3(A: torch.Tensor):
    """Symmetric [..., 3, 3] -> (eigvals [..., 3] ascending, eigvecs
    [..., 3, 3] with eigvecs[..., :, i] the i-th eigenvector)."""
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1)), min=_EPS)
    As = A / scale[..., None, None]
    w = eigvals3(As)
    v_hi = _eigvec(As, w[..., 2])
    v_lo = _eigvec(As, w[..., 0])
    v_lo = v_lo - torch.sum(v_lo * v_hi, dim=-1, keepdim=True) * v_hi
    nlo = torch.sqrt(torch.clamp(torch.sum(v_lo * v_lo, dim=-1, keepdim=True), min=_EPS))
    diag = torch.tensor([0.57735, 0.57735, 0.57735], dtype=A.dtype, device=A.device)
    alt = torch.linalg.cross(v_hi, diag.expand(v_hi.shape))
    alt = alt / torch.clamp(torch.linalg.norm(alt, dim=-1, keepdim=True), min=_EPS)
    v_lo = torch.where(nlo < 1e-6, alt, v_lo / nlo)
    v_mid = torch.linalg.cross(v_hi, v_lo)
    V = torch.stack([v_lo, v_mid, v_hi], dim=-1)
    return w * scale[..., None], V
