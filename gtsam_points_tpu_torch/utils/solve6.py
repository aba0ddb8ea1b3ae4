"""Unrolled small SPD solve for the registration hot loop.

Port of gtsam_points_tpu/utils/solve6.py: the Cholesky factorisation and both
substitutions are written out element by element over any batch prefix (the
LM solves all K damped systems of its lambda ladder at once; the pyramid's
Gauss-Newton step solves one 6x6 system through `solve6`). Pivots are
clamped as sqrt(max(s, 1e-30)), so a singular system returns finite numbers
instead of raising, exactly as the reference does.
"""

from __future__ import annotations

import torch


def solve_small(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD H [..., n, n], b [..., n] -> x [..., n]."""
    n = H.shape[-1]
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


def solve6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """6x6 alias of solve_small (the registration Gauss-Newton step)."""
    return solve_small(H, b)
