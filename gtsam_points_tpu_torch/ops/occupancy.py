"""Bit-packed occupancy grid.

Port of gtsam_points_tpu/ops/occupancy.py: each 4x4x4 block of cells is 64
occupancy bits in two 32-bit words, and the blocks sit in a sorted key array
with the double-hash index of ops/hash_index.py. An occupancy check is a
probe, a word gather and a bit test.

The reference keeps the words as uint32. PyTorch's uint32 lacks shifts,
sums and `index_put_` on CUDA, so here each word's bit pattern is held in
int64, a value in [0, 2^32); `interop.occupancy_grid_to_numpy` gives them
as uint32. The bits of a block are ORed as a sum of distinct single-bit
words (after a dedupe of the (block, bit) pairs), and an integer
`index_put_(accumulate=True)` gives that sum in any order, so the card and
the CPU build the same words. Cell coordinates stay int32, whose `>>` and
`&` are arithmetic for negative coordinates as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.hash_index import build_hash_index, probe
from gtsam_points_tpu_torch.utils import se3


class OccupancyGrid(NamedTuple):
    """leaf () f32 cell size; block_keys [B] int32 packed block coords
    (sorted, INVALID_KEY padded); bits [B, 2] int64 words in [0, 2^32), 64
    cells a block; hash_index [2, size, 2] int32 over block_keys."""

    leaf: torch.Tensor
    block_keys: torch.Tensor
    bits: torch.Tensor
    hash_index: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.block_keys.shape[0]


def _split_coords(coords: torch.Tensor):
    """int32 cell coords [..., 3] -> (block coords [..., 3], bit index in [0, 64))."""
    block = coords >> 2
    local = coords & 3
    bit = (local[..., 0] << 4) | (local[..., 1] << 2) | local[..., 2]
    return block, bit


def build_occupancy_grid(points: torch.Tensor, mask: torch.Tensor, leaf: float,
                         block_capacity: Optional[int] = None) -> OccupancyGrid:
    """The grid of the masked points [N, 3] at cell size `leaf`, with room
    for `block_capacity` blocks (default N); blocks past it are dropped.
    Runs on the points' device."""
    n = points.shape[0]
    dev = points.device
    cap = block_capacity or n
    coords = vk.voxel_coords(points, 1.0 / leaf)
    block, bit = _split_coords(coords)
    keys = torch.where(mask, vk.pack_coords(block), vk.INVALID_KEY)

    skeys, order = torch.sort(keys, stable=True)
    sbit = bit[order]
    valid = skeys != vk.INVALID_KEY
    first = torch.ones((1,), dtype=torch.bool, device=dev)
    is_new = valid & torch.cat([first, skeys[1:] != skeys[:-1]])
    seg = torch.cumsum(is_new.to(torch.int64), 0) - 1
    slot = torch.where(valid, torch.clamp(seg, max=cap), cap)

    # OR the bits of a block: a sum of single-bit words is an OR once each
    # (slot, bit) pair contributes once
    pair = slot * 64 + torch.where(valid, sbit, 0).to(torch.int64)
    pair_sorted = torch.sort(pair).values
    uniq_first = torch.cat([first, pair_sorted[1:] != pair_sorted[:-1]])
    uniq = torch.where(uniq_first, pair_sorted, cap * 64 + 63)
    u_slot = uniq // 64
    u_bit = uniq % 64
    u_val = torch.ones_like(u_bit) << (u_bit & 31)
    bits = torch.zeros((cap + 1, 2), dtype=torch.int64, device=dev)
    bits.index_put_((u_slot, u_bit >> 5), u_val, accumulate=True)

    block_keys = torch.full((cap + 1,), vk.INVALID_KEY, dtype=torch.int32, device=dev)
    block_keys[torch.where(is_new, torch.clamp(seg, max=cap), cap)] = skeys  # only the dump slot repeats
    block_keys = block_keys[:cap]
    return OccupancyGrid(
        leaf=torch.tensor(leaf, dtype=torch.float32, device=dev),
        block_keys=block_keys,
        bits=bits[:cap],
        hash_index=build_hash_index(block_keys),
    )


def occupied(grid: OccupancyGrid, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[N] bool: whether each masked point's cell holds a grid point."""
    coords = vk.voxel_coords(points, 1.0 / grid.leaf)
    block, bit = _split_coords(coords)
    keys = torch.where(mask, vk.pack_coords(block), vk.INVALID_KEY)
    row, found_block = probe(grid.hash_index, grid.block_keys, keys)
    w = grid.bits[row.long(), (bit >> 5).long()]
    return found_block & (((w >> (bit & 31)) & 1) != 0) & mask


def calc_overlap(grid: OccupancyGrid, points: torch.Tensor, mask: torch.Tensor,
                 T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The share () f32 of the masked points (moved by T where given) that
    land in occupied cells."""
    pts = points if T is None else se3.transform_points(T, points)
    occ = occupied(grid, pts, mask)
    return torch.sum(occ.to(torch.float32)) / torch.clamp(torch.sum(mask.to(torch.int32)), min=1)
