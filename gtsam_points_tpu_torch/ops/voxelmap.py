"""Gaussian voxel maps: per-voxel raw moments with a bucketed probe table.

Port of gtsam_points_tpu/ops/voxelmap.py, same layout and same results:

- `moments` [C, 16] f32 rows: count, sum p (3), sum ppᵀ upper (6, plus summed
  point covariances), sum intensity, 5 pad lanes;
- `table` [m, 128] f32: m buckets of 8 probe records of 16 lanes each
  (key as int32 bitcast to f32, map row as an f32 value, moment lanes 0..10).
  A lookup is one hash, one 512-byte row gather and a key compare.

Bucket priority comes from stable sorts (the first 8 keys of a bucket win),
so every argsort here passes `stable=True`. Scatters that the reference makes
with `mode="drop"` or with a sliced-off extra row write into an extra
sentinel row here, which is then sliced off. Keys stored in float tables are
compared through `.view(torch.int32)`, never as floats: INVALID_KEY bitcasts
to a NaN.

Every function returns new tensors and leaves its inputs untouched, as the
reference's pure functions do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device
from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.hash_index import hash_key
from gtsam_points_tpu_torch.types.frame import Frame

_MOM_LANES = 16
_REC_LANES = 16
_BUCKET_SLOTS = 8
_BUCKET_LANES = _BUCKET_SLOTS * _REC_LANES  # 128 lanes = 512 B per bucket row

_I64 = torch.int64


def _n_buckets(capacity: int) -> int:
    """Power-of-two bucket count with >= 2x capacity slot headroom."""
    m = 512
    while m * _BUCKET_SLOTS < 2 * capacity:
        m *= 2
    return m


class GaussianVoxelMap(NamedTuple):
    """Sorted-key Gaussian voxel map of static capacity C.

    leaf [] f32, keys [C] int32 (INVALID_KEY padded), moments [C, 16] f32,
    last_seen [C] int32 (insertion epoch of last touch, for LRU),
    epoch [] int32, num_voxels [] int32, table [m, 128] f32.
    """

    leaf: torch.Tensor
    keys: torch.Tensor
    moments: torch.Tensor
    last_seen: torch.Tensor
    epoch: torch.Tensor
    num_voxels: torch.Tensor
    table: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def count(self) -> torch.Tensor:
        return self.moments[:, 0]

    @property
    def mean(self) -> torch.Tensor:
        return finalize_mean(self.moments)

    @property
    def cov(self) -> torch.Tensor:
        return finalize_cov(self.moments)

    @property
    def intensity(self) -> torch.Tensor:
        return finalize_intensity(self.moments)


def finalize_mean(moments: torch.Tensor) -> torch.Tensor:
    cnt = torch.clamp(moments[..., 0], min=1.0)
    return moments[..., 1:4] / cnt[..., None]


def finalize_intensity(moments: torch.Tensor) -> torch.Tensor:
    cnt = torch.clamp(moments[..., 0], min=1.0)
    return moments[..., 10] / cnt


def _cov_from_sums(cnt: torch.Tensor, sum_p: torch.Tensor, sum_pp: torch.Tensor) -> torch.Tensor:
    """[..] count, [.., 3] sum p, [.., 6] sum ppᵀ upper -> [.., 3, 3] cov."""
    cnt = torch.clamp(cnt, min=1.0)
    mu = sum_p / cnt[..., None]
    s = sum_pp / cnt[..., None]
    xx = s[..., 0] - mu[..., 0] * mu[..., 0]
    xy = s[..., 1] - mu[..., 0] * mu[..., 1]
    xz = s[..., 2] - mu[..., 0] * mu[..., 2]
    yy = s[..., 3] - mu[..., 1] * mu[..., 1]
    yz = s[..., 4] - mu[..., 1] * mu[..., 2]
    zz = s[..., 5] - mu[..., 2] * mu[..., 2]
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def finalize_cov(moments: torch.Tensor) -> torch.Tensor:
    return _cov_from_sums(moments[..., 0], moments[..., 1:4], moments[..., 4:10])


def point_moments(
    points: torch.Tensor,
    covs: Optional[torch.Tensor],
    w: torch.Tensor,
    intensities: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-point moment rows [N, 16] weighted by w (0/1 mask)."""
    p = points
    upper = torch.stack(
        [
            p[:, 0] * p[:, 0], p[:, 0] * p[:, 1], p[:, 0] * p[:, 2],
            p[:, 1] * p[:, 1], p[:, 1] * p[:, 2], p[:, 2] * p[:, 2],
        ],
        dim=-1,
    )
    if covs is not None:
        upper = upper + torch.stack(
            [covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2], covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]],
            dim=-1,
        )
    n = p.shape[0]
    inten = intensities[:, None] if intensities is not None else p.new_zeros((n, 1))
    rows = torch.cat(
        [p.new_ones((n, 1)), p, upper, inten, p.new_zeros((n, _MOM_LANES - 11))], dim=-1
    )
    return rows * w[:, None]


def _empty_record(device: torch.device) -> torch.Tensor:
    """One empty probe record: key = INVALID bitcast, row = -1, rest 0."""
    # made from device fills: a python scalar written into a CUDA tensor
    # would be copied from the host and sync the stream
    key = torch.full((1,), vk.INVALID_KEY, dtype=torch.int32, device=device).view(torch.float32)
    row = torch.full((1,), -1.0, dtype=torch.float32, device=device)
    return torch.cat([key, row, torch.zeros((_REC_LANES - 2,), dtype=torch.float32, device=device)])


def _make_records(keys: torch.Tensor, rows: torch.Tensor, moments: torch.Tensor) -> torch.Tensor:
    """[C] keys + [C] row ids + [C, 16] moments -> [C, 16] probe records."""
    kf = keys.to(torch.int32).contiguous().view(torch.float32)[:, None]
    rf = rows.to(torch.float32)[:, None]
    pad = moments.new_zeros((keys.shape[0], _REC_LANES - 13))
    return torch.cat([kf, rf, moments[:, :11], pad], dim=-1)


def _run_rank(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Position of each element inside its run of equal sorted ids."""
    idx = torch.arange(sorted_ids.shape[0], dtype=_I64, device=sorted_ids.device)
    is_first = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = torch.cummax(torch.where(is_first, idx, 0), dim=0).values
    return idx - run_start


def _is_new_run(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Valid sorted keys that differ from their predecessor."""
    is_new = sorted_keys != vk.INVALID_KEY
    is_new[1:] &= sorted_keys[1:] != sorted_keys[:-1]
    return is_new


def _run_sum(rows: torch.Tensor, slot: torch.Tensor, size: int) -> torch.Tensor:
    """Sum rows [M, L] into [size, L] by slot [M], which must be sorted; rows
    whose slot is `size` or more (the dropped sentinel, sorted last) are not
    read. Each run of equal slots is summed from its first row to its last,
    on every device: the order in which `index_add_` sums on the CPU and the
    reference's sorted scatter-add sums, where `index_add_` on CUDA uses float
    atomics in no fixed order. Slots with no row get zeros."""
    bounds = torch.arange(size + 1, dtype=slot.dtype, device=slot.device)
    offsets = torch.searchsorted(slot, bounds)
    # unsafe: the offsets are sorted and end within M by construction, and
    # the checks (which also want them to end at M) would read them back to
    # the host
    return torch.segment_reduce(rows, "sum", offsets=offsets, axis=0, unsafe=True)


def build_probe_table(keys: torch.Tensor, moments: torch.Tensor) -> torch.Tensor:
    """Claim bucket slots for every valid key (first 8 per bucket in stable
    sorted order; overflow dropped) and write complete records."""
    C = keys.shape[0]
    m = _n_buckets(C)
    valid = keys != vk.INVALID_KEY
    hv = torch.where(valid, hash_key(keys, 0, m).to(_I64), m)
    order = torch.argsort(hv, stable=True)
    sh = hv[order]
    rank = _run_rank(sh)
    n_slots = m * _BUCKET_SLOTS
    slot = torch.where(valid[order] & (rank < _BUCKET_SLOTS), sh * _BUCKET_SLOTS + rank, n_slots)

    rows = torch.arange(C, dtype=torch.int32, device=keys.device)
    recs = _make_records(keys, rows, moments)[order]
    flat = _empty_record(keys.device).expand(n_slots + 1, _REC_LANES).clone()
    flat[slot] = recs
    return flat[:n_slots].reshape(m, _BUCKET_LANES)


def table_probe(table: torch.Tensor, query_keys: torch.Tensor):
    """One-gather probe -> (row [..], found [..], pick [.., 16], slot [..]).
    `pick` is the matching record (zeros when not found), `slot` its flat
    table slot."""
    m = table.shape[0]
    h = hash_key(query_keys, 0, m).to(_I64)
    rec = table[h]  # [..., 128]: the single gather
    rec4 = rec.reshape(rec.shape[:-1] + (_BUCKET_SLOTS, _REC_LANES))
    kl = rec4[..., 0].view(torch.int32)
    sel = (kl == query_keys[..., None]) & (query_keys != vk.INVALID_KEY)[..., None]
    found = torch.any(sel, dim=-1)
    pick = torch.sum(rec4 * sel.to(table.dtype)[..., None], dim=-2)
    row = pick[..., 1].to(torch.int32)  # row stored as an exact f32 value
    sub = torch.argmax(sel.to(torch.uint8), dim=-1)
    slot = h * _BUCKET_SLOTS + sub
    return torch.clamp(row, min=0), found, pick, slot


def lookup_rows(vmap: GaussianVoxelMap, query_keys: torch.Tensor):
    """-> (row [..], found [..]) for packed voxel keys."""
    row, found, _, _ = table_probe(vmap.table, query_keys)
    return row, found


def lookup_fetch_planar(vmap: GaussianVoxelMap, moved_p: torch.Tensor, mask: torch.Tensor):
    """Probe + record fetch for the VGICP path: moved_p [3, N] ->
    (found [N], count [N], mean [3, N], cov6 [6, N])."""
    keys = vk.point_keys_planar(moved_p, mask, vmap.leaf)
    _, found, pick, _ = table_probe(vmap.table, keys)
    rT = pick[:, 2:13].T.contiguous()  # [11, N] moment lanes 0..10, planar
    found = found & mask
    cnt = rT[0]
    safe = torch.clamp(cnt, min=1.0)
    mu = rT[1:4] / safe
    s6 = rT[4:10] / safe
    mu2 = torch.stack(
        [mu[0] * mu[0], mu[0] * mu[1], mu[0] * mu[2], mu[1] * mu[1], mu[1] * mu[2], mu[2] * mu[2]]
    )
    return found, cnt, mu, s6 - mu2


def empty_voxelmap(leaf: float, capacity: int, device: DeviceLike = None) -> GaussianVoxelMap:
    """An empty map of `capacity` voxels on `device` (default `cuda`)."""
    dev = resolve_device(device)
    m = _n_buckets(capacity)
    table = _empty_record(dev).repeat(m * _BUCKET_SLOTS).reshape(m, _BUCKET_LANES)
    return GaussianVoxelMap(
        leaf=torch.tensor(leaf, dtype=torch.float32, device=dev),
        keys=torch.full((capacity,), vk.INVALID_KEY, dtype=torch.int32, device=dev),
        moments=torch.zeros((capacity, _MOM_LANES), dtype=torch.float32, device=dev),
        last_seen=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        num_voxels=torch.zeros((), dtype=torch.int32, device=dev),
        table=table,
    )


def _scan_moments(frame: Frame, leaf, capacity: int):
    """Per-voxel moment rows of one scan: (keys [cap], moments [cap, 16])."""
    keys = vk.point_keys(frame.points, frame.mask, leaf)
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    valid = skeys != vk.INVALID_KEY
    is_new = _is_new_run(skeys)
    seg = torch.cumsum(is_new.to(_I64), dim=0) - 1
    slot = torch.where(valid, torch.clamp(seg, max=capacity), capacity)

    rows = point_moments(frame.points, frame.covs, frame.mask.to(torch.float32), frame.intensities)[order]
    mom = _run_sum(rows, slot, capacity)
    out_keys = torch.full((capacity + 1,), vk.INVALID_KEY, dtype=torch.int32, device=keys.device)
    out_keys[torch.where(is_new, torch.clamp(seg, max=capacity), capacity)] = skeys
    return out_keys[:capacity], mom


def build_voxelmap(frame: Frame, leaf: float, capacity: Optional[int] = None) -> GaussianVoxelMap:
    """One-shot map from a single frame, on the frame's device."""
    cap = capacity if capacity is not None else frame.capacity
    return insert_frame(empty_voxelmap(leaf, cap, frame.device), frame)


def insert_frame(vmap: GaussianVoxelMap, frame: Frame) -> GaussianVoxelMap:
    """Structural merge of a scan into the map: scan moments, union with the
    map (sort + segment sum), LRU eviction by oldest last_seen on overflow,
    and a rebuild of the probe table."""
    cap = vmap.capacity
    dev = vmap.keys.device
    new_keys, new_mom = _scan_moments(frame, vmap.leaf, cap)
    epoch = vmap.epoch + 1

    keys = torch.cat([vmap.keys, new_keys])
    mom = torch.cat([vmap.moments, new_mom])
    seen = torch.cat([vmap.last_seen, epoch.expand(cap)])
    valid = (keys != vk.INVALID_KEY) & (mom[:, 0] > 0)
    keys = torch.where(valid, keys, vk.INVALID_KEY)

    order = torch.argsort(keys, stable=True)
    keys, mom, seen, valid = keys[order], mom[order], seen[order], valid[order]
    is_new = _is_new_run(keys)
    seg = torch.cumsum(is_new.to(_I64), dim=0) - 1
    n2 = keys.shape[0]
    slot = torch.where(valid, seg, n2)

    m_mom = _run_sum(mom, slot, n2)
    m_seen = torch.zeros((n2 + 1,), dtype=torch.int32, device=dev).scatter_reduce_(
        0, slot, torch.where(valid, seen, 0), "amax", include_self=True
    )[:n2]
    m_keys = torch.full((n2 + 1,), vk.INVALID_KEY, dtype=torch.int32, device=dev)
    m_keys[torch.where(is_new, seg, n2)] = keys
    m_keys = m_keys[:n2]

    num_merged = torch.clamp(seg[-1] + 1, min=0)
    merged_valid = m_keys != vk.INVALID_KEY
    recency = torch.where(merged_valid, m_seen, -1)
    overflow = num_merged > cap
    rank_order = torch.argsort(-recency, stable=True)  # most recent first, invalid last
    keep_flag = torch.zeros((n2,), dtype=torch.bool, device=dev)
    keep_flag[rank_order[:cap]] = True
    keep = torch.where(overflow, keep_flag & merged_valid, merged_valid)

    m_keys = torch.where(keep, m_keys, vk.INVALID_KEY)
    dest = torch.where(keep, torch.cumsum(keep.to(_I64), dim=0) - 1, cap)
    f_keys = torch.full((cap + 1,), vk.INVALID_KEY, dtype=torch.int32, device=dev)
    f_keys[dest] = m_keys
    f_mom = mom.new_zeros((cap + 1, _MOM_LANES))
    f_mom[dest] = m_mom
    f_seen = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    f_seen[dest] = m_seen
    f_keys, f_mom, f_seen = f_keys[:cap], f_mom[:cap], f_seen[:cap]

    return GaussianVoxelMap(
        leaf=vmap.leaf,
        keys=f_keys,
        moments=f_mom,
        last_seen=f_seen,
        epoch=epoch,
        num_voxels=torch.clamp(num_merged, max=cap).to(torch.int32),
        table=build_probe_table(f_keys, f_mom),
    )


def insert_frame_incremental(
    vmap: GaussianVoxelMap, frame: Frame, scan_cells_capacity: Optional[int] = None
):
    """Incremental insert: add moments into existing voxels and append new
    ones, without a full-map sort. `scan_cells_capacity` bounds the distinct
    voxels of one scan (default: the scan's point capacity).
    -> (new_vmap, overflow): overflow is True when the append ran past map
    capacity or the scan exceeded scan_cells_capacity; callers then run the
    structural `insert_frame`."""
    n = frame.points.shape[0]
    ucap = scan_cells_capacity if scan_cells_capacity is not None else n
    keys = vk.point_keys(frame.points, frame.mask, vmap.leaf)
    rows = point_moments(frame.points, frame.covs, frame.mask.to(torch.float32), frame.intensities)
    return insert_rows_incremental(vmap, keys, rows, ucap)


def insert_rows_incremental(
    vmap: GaussianVoxelMap, keys: torch.Tensor, rows: torch.Tensor, ucap: int
):
    """Merge per-row moment contributions ([M] keys, [M, 16] rows) with at
    most `ucap` distinct keys. -> (new_vmap, overflow)."""
    cap = vmap.capacity
    dev = keys.device
    epoch = vmap.epoch + 1

    # 0) per-voxel pre-aggregation of the input rows into ucap unique cells
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    valid = skeys != vk.INVALID_KEY
    is_new = _is_new_run(skeys)
    seg = torch.cumsum(is_new.to(_I64), dim=0) - 1
    num_unique = torch.clamp(seg[-1] + 1, min=0)
    uslot = torch.where(valid, torch.clamp(seg, max=ucap), ucap)
    umom = _run_sum(rows[order], uslot, ucap)
    ukeys = torch.full((ucap + 1,), vk.INVALID_KEY, dtype=torch.int32, device=dev)
    ukeys[torch.where(is_new, torch.clamp(seg, max=ucap), ucap)] = skeys
    ukeys = ukeys[:ucap]
    uvalid = ukeys != vk.INVALID_KEY

    row, found, _, tslot = table_probe(vmap.table, ukeys)
    found = found & uvalid

    # 1+2) existing cells accumulate at their row, new cells append after
    # num_voxels; row `cap` is the sentinel that drops what does not fit
    new_mask = uvalid & ~found
    rank_new = torch.cumsum(new_mask.to(_I64), dim=0) - 1
    num_new = torch.sum(new_mask.to(_I64))
    dest = torch.where(new_mask, vmap.num_voxels + rank_new, cap)
    overflow = ((vmap.num_voxels + num_new) > cap) | (num_unique > ucap)
    dest = torch.clamp(dest, max=cap)

    touched = found | new_mask
    slot_all = torch.where(found, row.to(_I64), dest)
    moments = torch.cat([vmap.moments, vmap.moments.new_zeros((1, _MOM_LANES))])
    # one row per slot but the dropped sentinel `cap`, so no two atomics meet
    moments.index_add_(0, slot_all, torch.where(touched[:, None], umom, 0.0))
    moments = moments[:cap]
    last_seen = torch.cat([vmap.last_seen, vmap.last_seen.new_zeros((1,))])
    last_seen.scatter_reduce_(
        0, slot_all, torch.where(touched, epoch, 0).to(torch.int32), "amax", include_self=True
    )
    last_seen = last_seen[:cap]
    new_keys = torch.cat([vmap.keys, vmap.keys.new_full((1,), vk.INVALID_KEY)])
    new_keys[dest] = torch.where(new_mask, ukeys, vk.INVALID_KEY)
    new_keys = new_keys[:cap]

    # 3) incremental probe-table update: existing records get the updated
    # moments at their slot, new records go to their bucket's free tail
    m = vmap.table.shape[0]
    n_slots = m * _BUCKET_SLOTS
    hkey = torch.where(new_mask, hash_key(ukeys, 0, m).to(_I64), m)
    order2 = torch.argsort(hkey, stable=True)
    hb2 = hkey[order2]
    brow = vmap.table[torch.where(hb2 < m, hb2, 0)]  # [ucap, 128]
    k8 = brow.reshape(ucap, _BUCKET_SLOTS, _REC_LANES)[:, :, 0].view(torch.int32)
    occ = torch.sum((k8 != vk.INVALID_KEY).to(_I64), dim=1)
    rank = _run_rank(hb2)
    dest2 = dest[order2]
    found2 = found[order2]
    ok_new = (hb2 < m) & (occ + rank < _BUCKET_SLOTS) & (dest2 < cap)
    slot_new = torch.where(ok_new, hb2 * _BUCKET_SLOTS + occ + rank, n_slots)
    slot_tab = torch.where(found2, tslot[order2], slot_new)
    maprow2 = torch.where(found2, row[order2].to(_I64), dest2)
    recs = _make_records(ukeys[order2], maprow2, moments[torch.clamp(maprow2, max=cap - 1)])
    flat = torch.cat([vmap.table.reshape(n_slots, _REC_LANES), _empty_record(dev)[None]])
    flat[slot_tab] = recs
    table = flat[:n_slots].reshape(m, _BUCKET_LANES)

    out = GaussianVoxelMap(
        leaf=vmap.leaf,
        keys=new_keys,
        moments=moments,
        last_seen=last_seen,
        epoch=epoch,
        num_voxels=torch.clamp(vmap.num_voxels + num_new, max=cap).to(torch.int32),
        table=table,
    )
    return out, overflow
