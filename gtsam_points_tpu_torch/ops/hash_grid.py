"""Sorted voxel-key grid: the spatial index behind kNN and radius search.

Port of gtsam_points_tpu/ops/hash_grid.py. Points are sorted by packed voxel
key, each cell is densified into a fixed-width tile of at most
`max_points_per_cell` points, and cells are found through the double-hash
index of ops/hash_index.py. A kNN query gathers the tiles of its 27 (or 1,
7, 19) neighbouring cells and takes the nearest candidates. The reference
computes all of it with XLA ops, no Pallas kernel, so plain PyTorch is the
port; it runs on the device of its inputs.

Three things keep the results equal to the reference's:

- the sort is stable, so the rank of a point inside its cell, which decides
  which `max_points_per_cell` points a cell keeps, is the reference's;
- the reference's scatters drop indices past their array; here every such
  index goes to the dump slot at the end of the array, which is cut off;
- each `lax.cond` of the reference becomes an unconditional computation
  whose result is selected with `torch.where`, so nothing is read to the
  host (see the comments at the two places).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.hash_index import build_hash_index, probe

_BIGF = float(2**30)
_offsets: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _neighbor_offsets(num: int, dev: torch.device) -> torch.Tensor:
    """vk.neighbor_offsets, copied to the device once: a copy from the host
    waits for the device, and a search runs every LM iteration."""
    key = (num, dev)
    if key not in _offsets:
        _offsets[key] = vk.neighbor_offsets(num, dev)
    return _offsets[key]


class HashGrid(NamedTuple):
    """Static-shape voxel grid over a fixed point buffer.

    leaf:          () f32 voxel edge length
    cell_keys:     [C] int32 sorted unique voxel keys (INVALID_KEY padded)
    cell_points:   [C, J, 3] per-cell point tile (inf padded)
    cell_pt_index: [C, J] int32 original index of each tile slot (-1 padded)
    cell_count:    [C] int32 number of points in the cell (may exceed J)
    cell_records:  [C, J*4] packed (x, y, z, float(orig_index)) per slot
                   (inf, inf, inf, -1 padded)
    num_cells:     () int32 distinct voxels present (may exceed C)
    hash_index:    [2, size, 2] int32 (row, key) pair index over cell_keys
    neighbor_rows: [C, 27] int32 rows of each cell's 27 neighbours (-1 where
                   unoccupied)
    coarse:        optional second-level grid with a larger leaf
                   (build_hash_grid(coarse_factor=...)), searched for the
                   queries the fine level finds no candidate for
    """

    leaf: torch.Tensor
    cell_keys: torch.Tensor
    cell_points: torch.Tensor
    cell_pt_index: torch.Tensor
    cell_count: torch.Tensor
    cell_records: torch.Tensor
    num_cells: torch.Tensor
    hash_index: torch.Tensor
    neighbor_rows: torch.Tensor
    coarse: "Optional[HashGrid]" = None

    @property
    def cell_capacity(self) -> int:
        return self.cell_keys.shape[0]

    @property
    def points_per_cell(self) -> int:
        return self.cell_points.shape[1]

    @property
    def overflowed(self) -> torch.Tensor:
        """True when more distinct voxels were present than `cell_capacity`
        holds: the cells of the highest keys were dropped."""
        return self.num_cells > self.cell_capacity


def _scatter(size: int, fill, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A [size + 1, ...] array of `fill` with `values` set at `index`, the
    last row the dump slot for indices at or past `size`; -> its first
    `size` rows. Only the dump slot may repeat in `index`."""
    out = torch.full((size + 1,) + tuple(values.shape[1:]), fill, dtype=values.dtype, device=values.device)
    out[torch.clamp(index, max=size).long()] = values
    return out[:size]


def build_hash_grid(
    points: torch.Tensor,
    mask: torch.Tensor,
    leaf: float,
    cell_capacity: Optional[int] = None,
    max_points_per_cell: int = 16,
    coarse_factor: Optional[int] = None,
) -> HashGrid:
    """Build the grid over points [N, 3] with mask [N]. `cell_capacity`
    bounds the distinct voxels (default: N); each cell keeps its first
    `max_points_per_cell` points in the input's order. `coarse_factor` also
    builds a second level at leaf `coarse_factor * leaf`, which knn_search
    consults for queries more than one fine cell off the surface."""
    n = points.shape[0]
    dev = points.device
    cap = cell_capacity if cell_capacity is not None else n
    J = max_points_per_cell
    keys = vk.point_keys(points, mask, leaf)

    skeys, order = torch.sort(keys, stable=True)
    spoints = points[order]
    sindex = torch.where(skeys == vk.INVALID_KEY, -1, order.to(torch.int32))

    valid = skeys != vk.INVALID_KEY
    first = torch.ones((1,), dtype=torch.bool, device=dev)
    is_new = valid & torch.cat([first, skeys[1:] != skeys[:-1]])
    seg_id = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1  # [N]
    num_cells = torch.clamp(seg_id[-1] + 1, min=0)

    slot = torch.where(is_new, seg_id, cap)
    cell_keys = _scatter(cap, vk.INVALID_KEY, slot, skeys)
    arange = torch.arange(n, dtype=torch.int32, device=dev)
    cell_start = _scatter(cap, 0, slot, arange)
    count_slot = torch.clamp(torch.where(valid, seg_id, cap), max=cap).long()
    cell_count = torch.zeros((cap + 1,), dtype=torch.int32, device=dev).index_add_(
        0, count_slot, valid.to(torch.int32))[:cap]

    # densify the cells: the rank of each sorted point within its cell
    seg_c = torch.clamp(seg_id, 0, cap - 1)
    rank = arange - cell_start[seg_c.long()]
    keep = valid & (rank < J) & (seg_id < cap)
    dest = torch.where(keep, seg_c * J + rank, cap * J)
    cell_points = _scatter(cap * J, float("inf"), dest, spoints).reshape(cap, J, 3)
    cell_pt_index = _scatter(cap * J, -1, dest, sindex).reshape(cap, J)
    rec_src = torch.cat([spoints, sindex.to(torch.float32)[:, None]], dim=-1)
    rec = torch.full((cap * J + 1, 4), float("inf"), dtype=torch.float32, device=dev)
    rec[:, 3] = -1.0
    rec[dest.long()] = rec_src
    cell_records = rec[: cap * J].reshape(cap, J * 4)

    hash_index = build_hash_index(cell_keys)
    # each cell's 27 neighbour rows, probed once here for every later query
    offs = _neighbor_offsets(27, dev)
    nb_keys = vk.pack_coords(vk.unpack_key(cell_keys)[:, None, :] + offs[None, :, :])
    nb_keys = torch.where((cell_keys != vk.INVALID_KEY)[:, None], nb_keys, vk.INVALID_KEY)
    nb_rows, nb_found = probe(hash_index, cell_keys, nb_keys)
    neighbor_rows = torch.where(nb_found, nb_rows, -1)

    coarse = None
    if coarse_factor is not None:
        # as the reference: the cell budget scales by one factor (a surface
        # coarsens by factor^2, not factor^3) with a floor of 4096 cells, and
        # the per-cell budget by the factor, at most 256
        coarse = build_hash_grid(
            points,
            mask,
            leaf * coarse_factor,
            cell_capacity=max(4096, cap // max(coarse_factor, 1)),
            max_points_per_cell=min(J * coarse_factor, 256),
        )

    return HashGrid(
        leaf=torch.tensor(leaf, dtype=torch.float32, device=dev),
        cell_keys=cell_keys,
        cell_points=cell_points,
        cell_pt_index=cell_pt_index,
        cell_count=cell_count,
        cell_records=cell_records,
        num_cells=num_cells,
        hash_index=hash_index,
        neighbor_rows=neighbor_rows,
        coarse=coarse,
    )


def lookup_cells(grid: HashGrid, query_keys: torch.Tensor):
    """Keys -> (cell row, found) through the hash index."""
    return probe(grid.hash_index, grid.cell_keys, query_keys)


def _candidates(grid: HashGrid, queries: torch.Tensor, rows: torch.Tensor, found: torch.Tensor, max_sq_dist):
    """Squared distances [Q, O*J] (inf where not a candidate) and original
    indices as floats [Q, O*J] of the tiles at `rows` [Q, O]. The distance
    sums (dx² + dy²) + dz², the reference's order, so ties fall alike."""
    q, o = rows.shape
    jj = grid.points_per_cell
    rec = grid.cell_records[rows.long()].reshape(q, o, jj, 4)
    d = rec[..., :3] - queries[:, None, None, :]
    d2 = d * d
    sq = ((d2[..., 0] + d2[..., 1]) + d2[..., 2]).reshape(q, o * jj)
    cif = rec[..., 3].reshape(q, o * jj)
    # found per slot; an expand, since repeat_interleave reads its output size to the host
    ok = (cif >= 0) & (sq <= max_sq_dist) & found[:, :, None].expand(q, o, jj).reshape(q, o * jj)
    return torch.where(ok, sq, float("inf")), cif


def _knn_one_level(
    grid: HashGrid,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    k: int,
    num_neighbor_cells: int = 27,
    max_sq_dist=float("inf"),
):
    """Single-level grid kNN (see knn_search)."""
    dev = queries.device
    inv_leaf = 1.0 / grid.leaf
    coords = vk.voxel_coords(queries, inv_leaf)  # [Q, 3]
    own_keys = torch.where(query_mask, vk.pack_coords(coords), vk.INVALID_KEY)
    last = grid.cell_capacity - 1

    if num_neighbor_cells == 27:
        own_row, own_found = lookup_cells(grid, own_keys)  # one probe a query
        nb = grid.neighbor_rows[torch.where(own_found, own_row, 0).long()]  # [Q, 27]
        found = own_found[:, None] & (nb >= 0)
        rows = torch.where(found, nb, last)
        # A query whose own cell is empty probes its 27 neighbour keys. The
        # reference skips this probe with lax.cond when no query misses;
        # here it always runs, and its result is used only where `miss`:
        # elsewhere its keys are INVALID_KEY, so fb_found is False there and
        # the selections below give what the skipped branch gives.
        miss = query_mask & ~own_found
        offs = _neighbor_offsets(27, dev)
        fb_keys = vk.pack_coords(coords[:, None, :] + offs[None, :, :])
        fb_keys = torch.where(miss[:, None], fb_keys, vk.INVALID_KEY)
        fb_rows, fb_found = lookup_cells(grid, fb_keys)
        found = torch.where(own_found[:, None], found, fb_found)
        rows = torch.where(own_found[:, None], rows, torch.where(fb_found, fb_rows, last))
    else:
        offsets = _neighbor_offsets(num_neighbor_cells, dev)  # [O, 3]
        nb_keys = vk.pack_coords(coords[:, None, :] + offsets[None, :, :])  # [Q, O]
        nb_keys = torch.where(query_mask[:, None], nb_keys, vk.INVALID_KEY)
        cell_idx, found = lookup_cells(grid, nb_keys)  # [Q, O]
        rows = torch.where(found, cell_idx, last)

    sq, cif = _candidates(grid, queries, rows, found, max_sq_dist)
    if k == 1:
        best = torch.amin(sq, dim=-1)
        idx = torch.amin(torch.where(sq == best[:, None], cif, _BIGF), dim=-1).to(torch.int32)
        valid = torch.isfinite(best) & query_mask
        return (
            torch.where(valid, idx, -1)[:, None],
            torch.where(valid, best, float("inf"))[:, None],
            valid[:, None],
        )

    # the k smallest distances (values only: their order among ties does not
    # matter), then k passes that each take the lowest original index at
    # that distance and strike it out, so equal distances advance
    top_sq = -torch.topk(-sq, k, dim=-1).values  # [Q, k] ascending
    idxs = []
    sq_w = sq
    for j in range(k):
        m = sq_w == top_sq[:, j : j + 1]
        ij = torch.amin(torch.where(m, cif, _BIGF), dim=-1)
        sq_w = torch.where(m & (cif == ij[:, None]), float("inf"), sq_w)
        idxs.append(ij)
    top_valid = torch.isfinite(top_sq) & query_mask[:, None]
    orig_idx = torch.where(top_valid, torch.stack(idxs, dim=-1).to(torch.int32), -1)
    return orig_idx, torch.where(top_valid, top_sq, float("inf")), top_valid


def knn_search(
    grid: HashGrid,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    k: int,
    num_neighbor_cells: int = 27,
    max_points_per_cell: Optional[int] = None,
    max_sq_dist=float("inf"),
):
    """Grid kNN of queries [Q, 3]: scan the 1/7/19/27 neighbour cells of each
    query and take the k nearest. Queries whose own cell is empty probe
    their 27 neighbour keys; with a coarse level, queries with no fine
    candidate search the coarse level. `max_points_per_cell` is fixed when
    the grid is built; a value other than the grid's raises.

    Returns (indices [Q, k] into the original point array, sq_dists [Q, k],
    valid [Q, k]); invalid slots have index -1 and sq_dist inf.
    """
    if max_points_per_cell is not None and max_points_per_cell != grid.points_per_cell:
        raise ValueError(f"max_points_per_cell={max_points_per_cell}, but the grid was built keeping "
                         f"{grid.points_per_cell} points a cell; pass the budget to build_hash_grid")
    idx, sq, valid = _knn_one_level(grid, queries, query_mask, k, num_neighbor_cells, max_sq_dist)
    if grid.coarse is None:
        return idx, sq, valid

    # The reference runs the coarse search under lax.cond only when a query
    # is missing; here it always runs, with `missing` as its query mask. A
    # query outside `missing` then finds nothing (-1, inf, False), which is
    # what the reference's skipped branch returns, and the selection below
    # takes the fine result wherever a query has one.
    have = torch.any(valid, dim=-1)
    missing = query_mask & ~have
    cidx, csq, cval = _knn_one_level(grid.coarse, queries, missing, k, 27, max_sq_dist)
    return (
        torch.where(have[:, None], idx, cidx),
        torch.where(have[:, None], sq, csq),
        torch.where(have[:, None], valid, cval),
    )


def _smallest(x: torch.Tensor, k: int):
    """The k smallest of x [..., M] along the last axis, ascending, the lower
    position first among equal values (as lax.top_k on -x orders ties) ->
    (values, positions)."""
    values, pos = torch.sort(x, dim=-1, stable=True)
    return values[..., :k], pos[..., :k]


def radius_search(
    grid: HashGrid,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    radius,
    max_neighbors: int,
    num_neighbor_cells: int = 27,
):
    """Up to `max_neighbors` points within `radius` of each query,
    nearest first. On a grid with a coarse level both levels are searched
    and merged (deduplicated by point index), which extends exact reach to
    about coarse_factor leaves, within each level's per-cell budget.

    Returns (indices [Q, M], sq_dists [Q, M], valid [Q, M], num_found [Q]).
    """
    r = torch.as_tensor(radius, dtype=torch.float32, device=queries.device)
    r2 = r * r
    if grid.coarse is None:
        idx, sq, valid = knn_search(grid, queries, query_mask, max_neighbors,
                                    num_neighbor_cells=num_neighbor_cells, max_sq_dist=r2)
    else:
        # the fine level without knn_search's coarse fallback: the merge
        # below searches the coarse level for every query anyway
        idx, sq, valid = _knn_one_level(grid, queries, query_mask, max_neighbors, num_neighbor_cells, r2)
        cidx, csq, cvalid = _knn_one_level(grid.coarse, queries, query_mask, max_neighbors, 27, r2)
        m_idx = torch.cat([idx, cidx], dim=-1)  # [Q, 2M]
        m_sq = torch.cat([sq, csq], dim=-1)
        m_val = torch.cat([valid, cvalid], dim=-1)
        _, order = torch.sort(torch.where(m_val, m_idx, 2**30), dim=-1, stable=True)
        s_idx = torch.gather(m_idx, -1, order)
        s_sq = torch.gather(m_sq, -1, order)
        s_val = torch.gather(m_val, -1, order)
        dup = torch.cat([torch.zeros_like(s_val[:, :1]), s_idx[:, 1:] == s_idx[:, :-1]], dim=-1)
        s_sq = torch.where(s_val & ~dup, s_sq, float("inf"))
        sq, pick = _smallest(s_sq, max_neighbors)
        valid = torch.isfinite(sq)
        idx = torch.where(valid, torch.gather(s_idx, -1, pick), -1)
    return idx, sq, valid, torch.sum(valid.to(torch.int32), dim=-1)


def brute_force_knn(
    points: torch.Tensor,
    point_mask: torch.Tensor,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    k: int,
    max_sq_dist=float("inf"),
    block: int = 2048,
):
    """Exact O(N*Q) kNN, the oracle of the grid search. Blocks of `block`
    queries; the distances are |a|^2 + |b|^2 - 2 a.b, as in the reference."""
    pts = torch.where(point_mask[:, None], points, 0.0)
    p_sq = torch.sum(pts * pts, dim=-1)
    out = []
    for s in range(0, queries.shape[0], block):
        qb, mb = queries[s : s + block], query_mask[s : s + block]
        d = torch.sum(qb * qb, dim=-1, keepdim=True) + p_sq[None, :] - 2.0 * (qb @ pts.T)
        d = torch.where(point_mask[None, :], d, float("inf"))
        d = torch.clamp(d, min=0.0)
        d = torch.where(d <= max_sq_dist, d, float("inf"))
        sq, idx = _smallest(d, k)
        valid = torch.isfinite(sq) & mb[:, None]
        out.append((torch.where(valid, idx, -1).to(torch.int32), torch.where(valid, sq, float("inf")), valid))
    idx, sq, valid = (torch.cat(x) for x in zip(*out))
    return idx, sq, valid
