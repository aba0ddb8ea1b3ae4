"""Double-hash index over packed voxel keys.

Port of gtsam_points_tpu/ops/hash_index.py, bit for bit. Each table slot
holds the pair (row, key), so one gather both locates a record and verifies
its key. A key goes to its slot in the first table; the losers of a slot go
to the second; a key that loses twice is dropped.

`hash_key` is the murmur-style bucket hash. The reference works in uint32
with wraparound multiplies; PyTorch has no uint32 shift on the CPU, so this
works in int64, masks to 32 bits after every step, and splits each 32x32-bit
multiply into two 32x16-bit halves so that no intermediate overflows int64.
"""

from __future__ import annotations

import torch

from gtsam_points_tpu_torch.ops import voxel_keys as vk

HASH_BITS = 20
HASH_SIZE = 1 << HASH_BITS
MIN_HASH_SIZE = 1 << 12

_M32 = 0xFFFFFFFF
_MIX = (
    (0x85EBCA6B, 0xC2B2AE35),
    (0xCC9E2D51, 0x1B873593),
)
_SENTINEL = 0x7FFFFFFF


def table_size_for(capacity: int) -> int:
    """Power-of-two table size about 4x the number of keys."""
    size = MIN_HASH_SIZE
    while size < 4 * capacity and size < HASH_SIZE:
        size *= 2
    return size


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for 0 <= h < 2^32 in int64, without overflow."""
    lo = h * (m & 0xFFFF)  # < 2^48
    hi = ((h * (m >> 16)) & 0xFFFF) << 16  # (h * m_hi mod 2^16) * 2^16
    return (lo + hi) & _M32


def hash_key(key: torch.Tensor, which: int = 0, size: int = HASH_SIZE) -> torch.Tensor:
    """int32 keys -> int32 bucket ids in [0, size) (size a power of two)."""
    m1, m2 = _MIX[which]
    h = key.to(torch.int64) & _M32
    h = _mul32(h ^ (h >> 16), m1)
    h = _mul32(h ^ (h >> 13), m2)
    h = h ^ (h >> 16)
    return (h & (size - 1)).to(torch.int32)


def empty_hash_index(size: int, device=None) -> torch.Tensor:
    """[2, size, 2] pair table: row = -1, key = INVALID_KEY."""
    empty = torch.tensor([-1, vk.INVALID_KEY], dtype=torch.int32, device=device)
    return empty.expand(2, size, 2).clone()


def _claim(slots: torch.Tensor, rows: torch.Tensor, keys: torch.Tensor, won_before, size: int):
    """One table: the lowest row that hashes to a slot wins it (a scatter-min,
    whose result does not depend on the order of the updates). `slots` holds
    `size`, the dump slot, for keys that do not take part. -> (rows [size]
    with the sentinel where empty, keys [size], won [C])."""
    t = torch.full((size + 1,), _SENTINEL, dtype=torch.int32, device=keys.device)
    t = t.scatter_reduce(0, slots.long(), rows, "amin", include_self=True)[:size]
    won = won_before & (t[torch.clamp(slots, max=size - 1).long()] == rows)
    k = torch.full((size + 1,), vk.INVALID_KEY, dtype=torch.int32, device=keys.device)
    k[torch.where(won, slots, size).long()] = keys  # only the dump slot repeats
    return t, k[:size], won


def build_hash_index(keys: torch.Tensor, size: int | None = None) -> torch.Tensor:
    """[C] keys (INVALID_KEY padded) -> [2, size, 2] double-hash pair index
    (row = -1 and key = INVALID_KEY where empty). Keys that lose their slot
    in both tables are dropped, as in the reference."""
    if size is None:
        size = table_size_for(keys.shape[0])
    valid = keys != vk.INVALID_KEY
    rows = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    slots1 = torch.where(valid, hash_key(keys, 0, size), size)
    t1, k1, won1 = _claim(slots1, rows, keys, valid, size)
    rest = valid & ~won1
    slots2 = torch.where(rest, hash_key(keys, 1, size), size)
    t2, k2, _ = _claim(slots2, rows, keys, rest, size)
    t1 = torch.where(t1 == _SENTINEL, -1, t1)
    t2 = torch.where(t2 == _SENTINEL, -1, t2)
    return torch.stack([torch.stack([t1, k1], dim=-1), torch.stack([t2, k2], dim=-1)])


def probe(index: torch.Tensor, keys_table: torch.Tensor, query_keys: torch.Tensor):
    """-> (row [..], found [..]); row is max(row, 0), so a miss reads row 0.
    `keys_table` is unused: the key comes with the gathered pair (kept for
    symmetry with build_hash_index's input, as in the reference)."""
    del keys_table
    size = index.shape[-2]
    e1 = index[0][hash_key(query_keys, 0, size).long()]  # [..., 2]
    e2 = index[1][hash_key(query_keys, 1, size).long()]
    ok1 = e1[..., 1] == query_keys
    ok2 = e2[..., 1] == query_keys
    row = torch.where(ok1, e1[..., 0], e2[..., 0])
    found = (ok1 | ok2) & (query_keys != vk.INVALID_KEY)
    return torch.clamp(row, min=0), found
