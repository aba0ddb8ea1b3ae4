"""PFH / FPFH feature histograms (PCL's binning).

Port of gtsam_points_tpu/registration/fpfh.py. Pair features (alpha, phi,
theta) come from Darboux frames; an SPFH is the per-point histogram over its
k neighbours (3 x 11 bins); the FPFH adds the distance-weighted blend of the
neighbours' SPFHs. Histograms are one-hot sums over the [N, k] neighbour
table of the port's hash grid. The reference computes all of it with XLA
ops, no Pallas kernel, so plain PyTorch is the port; the entry points take
`device` (default `cuda`) as the port's others do. `feature_knn` is the brute-force nearest neighbour in feature
space, a [Q, N] distance product a block of queries at a time, with the
reference's rule for ties: the lower index first.
"""

from __future__ import annotations

from typing import Optional

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.ops.hash_grid import HashGrid, _smallest, build_hash_grid, knn_search
from gtsam_points_tpu_torch.types.frame import Frame

FPFH_BINS = 11
FPFH_DIM = 3 * FPFH_BINS  # 33
PFH_DIM = 125


def compute_pair_features(p1, n1, p2, n2):
    """Darboux-frame pair features (alpha, phi, theta, d) in PCL's
    convention, which swaps (p1, n1) and (p2, n2) so that the angle of n1 to
    the joining line is the smaller."""
    dvec = p2 - p1
    d = torch.linalg.norm(dvec, dim=-1)
    du = dvec / torch.clamp(d, min=1e-12)[..., None]
    cos1 = torch.sum(n1 * du, dim=-1)
    cos2 = torch.sum(n2 * -du, dim=-1)
    swap = (torch.abs(cos2) > torch.abs(cos1))[..., None]
    a1 = torch.where(swap, n2, n1)
    a2 = torch.where(swap, n1, n2)
    du = torch.where(swap, -du, du)
    u = a1
    v = torch.linalg.cross(du, u, dim=-1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    w = torch.linalg.cross(u, v, dim=-1)
    alpha = torch.sum(v * a2, dim=-1)
    phi = torch.sum(u * du, dim=-1)
    theta = torch.atan2(torch.sum(w * a2, dim=-1), torch.sum(u * a2, dim=-1))
    return alpha, phi, theta, d


def bin_index(x: torch.Tensor, lo: float, hi: float, bins: int = FPFH_BINS) -> torch.Tensor:
    """floor((x - lo) / (hi - lo) · bins), clipped to [0, bins - 1], int32."""
    b = torch.floor((x - lo) / (hi - lo) * bins).to(torch.int32)
    return torch.clamp(b, 0, bins - 1)


def _percent(h: torch.Tensor) -> torch.Tensor:
    """Each histogram on the last axis scaled to sum to 100."""
    return h / torch.clamp(torch.sum(h, dim=-1, keepdim=True), min=1e-12) * 100.0


def _histogram(bins: torch.Tensor, weight: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Σ over axis 1 of one_hot(bins) · weight -> [N, n_bins]."""
    oh = torch.nn.functional.one_hot(bins.long(), n_bins).to(torch.float32) * weight[..., None]
    return torch.sum(oh, dim=1)


def spfh_bins(frame: Frame, nn_idx: torch.Tensor):
    """The (alpha, phi, theta) bins [N, k] of each point's pairs with its
    neighbours nn_idx [N, k] (an invalid -1 reads point 0)."""
    idx = torch.clamp(nn_idx, min=0).long()
    alpha, phi, theta, _ = compute_pair_features(frame.points[:, None, :], frame.normals[:, None, :],
                                                 frame.points[idx], frame.normals[idx])
    return (bin_index(alpha, -1.0, 1.0), bin_index(phi, -1.0, 1.0), bin_index(theta, -torch.pi, torch.pi))


def _spfh(frame: Frame, nn_idx: torch.Tensor, nn_valid: torch.Tensor) -> torch.Tensor:
    """[N, 33] SPFH histograms, each sub-histogram in percent."""
    w = nn_valid.to(torch.float32)
    return torch.cat([_percent(_histogram(b, w, FPFH_BINS)) for b in spfh_bins(frame, nn_idx)], dim=-1)


def fpfh_neighbors(
    frame: Frame,
    k: int = 30,
    grid: Optional[HashGrid] = None,
    grid_leaf: float = 2.5,
    num_neighbor_cells: int = 27,
    max_search_radius: float = 5.0,
    *,
    device: DeviceLike = None,
):
    """estimate_fpfh's neighbour table: the k nearest within
    max_search_radius, the point itself dropped -> (idx, sq, valid) [N, k].
    Runs on `device` (default `cuda`), where the frame and the grid lie."""
    check_on(resolve_device(device), frame.points, frame.normals, None if grid is None else grid.cell_points)
    if grid is None:
        grid = build_hash_grid(frame.points, frame.mask, grid_leaf)
    nn_idx, nn_sq, nn_valid = knn_search(grid, frame.points, frame.mask, k + 1, num_neighbor_cells=num_neighbor_cells,
                                         max_sq_dist=max_search_radius**2)
    return nn_idx[:, 1:], nn_sq[:, 1:], nn_valid[:, 1:]


def estimate_fpfh(
    frame: Frame,
    k: int = 30,
    grid: Optional[HashGrid] = None,
    grid_leaf: float = 2.5,
    num_neighbor_cells: int = 27,
    max_points_per_cell: int = 32,
    max_search_radius: float = 5.0,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """[N, 33] FPFH descriptors (zero in invalid slots), on `device`
    (default `cuda`), where the frame (and `grid`) must lie.

    The defaults approximate the reference's radius-5.0 search with a
    k-bounded grid neighbourhood. The grid keeps build_hash_grid's 16 points
    a cell: `max_points_per_cell` is accepted for the reference's signature,
    whose knn_search ignores it too."""
    del max_points_per_cell
    if frame.normals is None:
        raise ValueError("FPFH requires normals")
    nn_idx, nn_sq, nn_valid = fpfh_neighbors(frame, k, grid, grid_leaf, num_neighbor_cells, max_search_radius,
                                             device=device)
    spfh = _spfh(frame, nn_idx, nn_valid)
    # FPFH_i = SPFH_i + (1/k) Σ_j SPFH_j / w_ij, w the squared distance (as PCL)
    wgt = torch.where(nn_valid, 1.0 / torch.clamp(nn_sq, min=1e-6), 0.0)
    nb_spfh = spfh[torch.clamp(nn_idx, min=0).long()]  # [N, k, 33]
    cnt = torch.clamp(torch.sum(nn_valid.to(torch.int32), dim=-1), min=1)
    fpfh = spfh + torch.einsum("nk,nkd->nd", wgt, nb_spfh) / cnt[:, None]
    out = _percent(fpfh.reshape(-1, 3, FPFH_BINS)).reshape(-1, FPFH_DIM)
    return torch.where(frame.mask[:, None], out, 0.0)


def estimate_pfh(
    frame: Frame,
    k: int = 10,
    grid: Optional[HashGrid] = None,
    grid_leaf: float = 2.0,
    bins: int = 5,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """[N, 125] PFH: the joint 5³ histogram over all pairs (i < j) of each
    point's k-neighbourhood (itself included), on `device` (default `cuda`)."""
    if frame.normals is None:
        raise ValueError("PFH requires normals")
    check_on(resolve_device(device), frame.points, frame.normals, None if grid is None else grid.cell_points)
    if grid is None:
        grid = build_hash_grid(frame.points, frame.mask, grid_leaf)
    nn_idx, _, nn_valid = knn_search(grid, frame.points, frame.mask, k)
    idx = torch.clamp(nn_idx, min=0).long()
    p, n = frame.points[idx], frame.normals[idx]  # [N, k, 3]
    ii, jj = torch.triu_indices(k, k, 1, device=idx.device)
    valid = nn_valid[:, ii] & nn_valid[:, jj]
    alpha, phi, theta, _ = compute_pair_features(p[:, ii], n[:, ii], p[:, jj], n[:, jj])
    joint = (bin_index(alpha, -1.0, 1.0, bins) * bins * bins + bin_index(phi, -1.0, 1.0, bins) * bins
             + bin_index(theta, -torch.pi, torch.pi, bins))
    h = _percent(_histogram(joint, valid.to(torch.float32), bins**3))
    return torch.where(frame.mask[:, None], h, 0.0)


def feature_knn(target_feats: torch.Tensor, target_mask: torch.Tensor, source_feats: torch.Tensor,
                source_mask: torch.Tensor, k: int = 1, block: int = 1024):
    """Brute-force kNN of each source feature among the target features
    (any dimension): |q|² + |t|² - 2 q·t in blocks of `block` queries, the
    lower index first among equal distances.
    -> (idx [Q, k] int32, -1 where invalid; sq [Q, k]; valid [Q, k])."""
    t_clean = torch.where(target_mask[:, None], target_feats, 0.0)
    t_sq = torch.sum(t_clean**2, dim=-1)
    out = []
    for s in range(0, source_feats.shape[0], block):
        qb, mb = source_feats[s : s + block], source_mask[s : s + block]
        d = torch.sum(qb * qb, dim=-1, keepdim=True) + t_sq[None, :] - 2.0 * (qb @ t_clean.T)
        d = torch.where(target_mask[None, :], d, float("inf"))
        if k == 1:
            best = torch.amin(d, dim=-1, keepdim=True)
            pos = torch.arange(d.shape[1], dtype=torch.int32, device=d.device)
            idx = torch.amin(torch.where(d == best, pos, torch.iinfo(torch.int32).max), dim=-1, keepdim=True)
        else:
            best, idx = _smallest(d, k)
        sq = torch.clamp(best, min=0.0)
        valid = torch.isfinite(sq) & mb[:, None]
        out.append((torch.where(valid, idx.to(torch.int32), -1), sq, valid))
    idx, sq, valid = (torch.cat(x) for x in zip(*out))
    return idx, sq, valid
