"""Unrolled small SPD solve for the registration hot loop.

Port of gtsam_points_tpu/utils/solve6.py: up to UNROLL_MAX unknowns the
Cholesky factorisation and both substitutions are written out element by
element over any batch prefix (the LM solves all K damped systems of its
lambda ladder at once; the pyramid's Gauss-Newton step solves one 6x6 system
through `solve6`). Pivots are clamped as sqrt(max(s, 1e-30)), so a singular
system returns finite numbers instead of raising, exactly as the reference
does. Above UNROLL_MAX (more than three poses) the unrolled op count, about
n³/3 elementwise kernels, stops paying: the reference takes `cho_solve`
there, and the port `torch.linalg.cholesky_ex` and `torch.cholesky_solve`.
A factorisation that fails (not positive definite) gives NaN there, as the
reference's `cho_factor` does, and `cholesky_ex` neither raises nor reads
its status back to the host.
"""

from __future__ import annotations

import torch

UNROLL_MAX = 18


def solve_small(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD H [..., n, n], b [..., n] -> x [..., n]."""
    n = H.shape[-1]
    if n > UNROLL_MAX:
        return cho_solve(H, b)
    a = [[H[..., i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = d
        inv_d[j] = 1.0 / d
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d[j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv_d[i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s * inv_d[i]
    return torch.stack(x, dim=-1)


def cho_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b by a Cholesky factorisation (the reference's
    `cho_solve(cho_factor(H, lower=True), b)`): H [..., n, n], b [..., n] ->
    x [..., n], NaN where H is not positive definite."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    return torch.where((info == 0).unsqueeze(-1), x, float("nan"))


def solve6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """6x6 alias of solve_small (the registration Gauss-Newton step)."""
    return solve_small(H, b)
