"""Min-cut foreground/background segmentation.

Port of gtsam_points_tpu/segmentation/min_cut.py: a kNN graph with
distance-based edge weights, source edges to the points within the
foreground radius of the seed and sink edges from those beyond the
background radius, a max-flow, and the source side of the cut as the
foreground. The kNN search runs on the frame's device; the max-flow runs on
the host with scipy (`maximum_flow`, then `breadth_first_order`), as in the
reference package (and in the original, which solves with Boost on the
host). Capacities are int64 `weight * weight_scale`, at least 1, and the
graph is symmetrized with its maximum against its transpose.

`min_cut` searches the kNN table and calls `_min_cut_from_knn`, which takes
the table, so that two devices can be held to each other on one table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gtsam_points_tpu_torch._device import check_on
from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid, knn_search
from gtsam_points_tpu_torch.types.frame import Frame


@dataclasses.dataclass(frozen=True)
class MinCutParams:
    k: int = 10
    distance_sigma: float = 0.25  # edge weight scale
    foreground_radius: float = 0.5
    background_radius: float = 4.0
    foreground_weight: float = 100.0
    background_weight: float = 100.0
    grid_leaf: float = 0.5
    weight_scale: float = 1000.0  # float -> int capacity scale for the max-flow


def _min_cut_from_knn(frame: Frame, seed_point, params: MinCutParams, nn_idx: torch.Tensor, nn_sq: torch.Tensor,
                     nn_valid: torch.Tensor) -> np.ndarray:
    """Min-cut on a given kNN table (nn_idx, nn_sq, nn_valid [N, k]) ->
    [N] bool foreground mask (numpy)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow

    p = params
    check_on(frame.device, nn_idx, nn_sq, nn_valid)
    pts = frame.points.cpu().numpy()
    mask = frame.mask.cpu().numpy()
    idx = nn_idx.cpu().numpy()
    sq = nn_sq.cpu().numpy()
    valid = nn_valid.cpu().numpy()
    seed = (seed_point.cpu().numpy() if isinstance(seed_point, torch.Tensor) else np.asarray(seed_point)
            ).astype(np.float32)

    n = len(pts)
    src_node, sink_node = n, n + 1
    rows, cols, caps = [], [], []

    # smoothness edges: w = exp(-d² / sigma²)
    w = np.exp(-sq / (p.distance_sigma**2)) * valid
    ii = np.repeat(np.arange(n), p.k)
    jj = idx.reshape(-1)
    ww = w.reshape(-1)
    keep = (ww > 1e-4) & (jj >= 0) & (ii != jj)
    rows.append(ii[keep])
    cols.append(jj[keep])
    caps.append(ww[keep])

    # terminal edges from the distance to the seed
    d_seed = np.linalg.norm(pts - seed, axis=1)
    fg_idx = np.nonzero(mask & (d_seed <= p.foreground_radius))[0]
    bg_idx = np.nonzero(mask & (d_seed >= p.background_radius))[0]
    rows.append(np.full(len(fg_idx), src_node))
    cols.append(fg_idx)
    caps.append(np.full(len(fg_idx), p.foreground_weight))
    rows.append(bg_idx)
    cols.append(np.full(len(bg_idx), sink_node))
    caps.append(np.full(len(bg_idx), p.background_weight))

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    caps = np.concatenate(caps)
    cap_int = np.maximum((caps * p.weight_scale).astype(np.int64), 1)
    g = csr_matrix((cap_int, (rows, cols)), shape=(n + 2, n + 2))
    g = g.maximum(g.T.tocsr())  # undirected smoothness
    res = maximum_flow(g, src_node, sink_node)
    residual = g - res.flow.maximum(0)
    reach, _ = breadth_first_order(residual > 0, src_node, directed=True, return_predecessors=True)
    out = np.zeros(n, dtype=bool)
    out[reach[(reach >= 0) & (reach < n)]] = True
    return out & mask


def min_cut(frame: Frame, seed_point, params: Optional[MinCutParams] = None) -> np.ndarray:
    """-> [N] bool foreground mask (numpy); the kNN search on the frame's device."""
    p = params or MinCutParams()
    grid = build_hash_grid(frame.points, frame.mask, p.grid_leaf)
    nn_idx, nn_sq, nn_valid = knn_search(grid, frame.points, frame.mask, p.k)
    return _min_cut_from_knn(frame, seed_point, p, nn_idx, nn_sq, nn_valid)
