"""Murmur-style bucket hash of packed voxel keys.

Port of `hash_key` in gtsam_points_tpu/ops/hash_index.py, bit for bit. The
reference works in uint32 with wraparound multiplies; PyTorch has no uint32
shift on the CPU, so this works in int64, masks to 32 bits after every step,
and splits each 32x32-bit multiply into two 32x16-bit halves so that no
intermediate overflows int64.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_MIX = (
    (0x85EBCA6B, 0xC2B2AE35),
    (0xCC9E2D51, 0x1B873593),
)


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for 0 <= h < 2^32 in int64, without overflow."""
    lo = h * (m & 0xFFFF)  # < 2^48
    hi = ((h * (m >> 16)) & 0xFFFF) << 16  # (h * m_hi mod 2^16) * 2^16
    return (lo + hi) & _M32


def hash_key(key: torch.Tensor, which: int = 0, size: int = 1 << 20) -> torch.Tensor:
    """int32 keys -> int32 bucket ids in [0, size) (size a power of two)."""
    m1, m2 = _MIX[which]
    h = key.to(torch.int64) & _M32
    h = _mul32(h ^ (h >> 16), m1)
    h = _mul32(h ^ (h >> 13), m2)
    h = h ^ (h >> 16)
    return (h & (size - 1)).to(torch.int32)
