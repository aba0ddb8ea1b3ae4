"""ISAM2-style incremental optimizer: a bounded window and exact Schur marginals.

Port of gtsam_points_tpu/optim/isam2.py (`ISAM2ResultExt`, the program
cache, `ISAM2Ext`, `ISAM2ExtDummy`):

- at most `window_size` poses stay active; older poses are marginalized by
  Schur complement into a dense MarginalPriorFactor and their estimates
  frozen;
- every update relinearizes the whole window through `optimize_lm`, whose
  matching factors run K3 on the card;
- a factor retired by marginalization leaves a pose-graph edge behind, so a
  late loop closure to a frozen pose is realized as an edge (a local pair
  registration), the whole trajectory relaxed by the block-sparse pose-graph
  LM (optim/sparse.py), and the window's marginal priors re-anchored.

The reference caches one jitted program per graph structure and counts the
builds. Here the routines run eagerly and only the structure keys are kept,
built the same way: each factor's class, its meta fields by value and its
tensor fields by shape and dtype, nested frames, voxel maps and grids
followed field by field (`structure_key`), so `num_compiles` and each
update's `compiled` equal the reference's on the same sequence. Estimates live on the host as 4x4 float32
numpy arrays; an update reads the window LM's poses, errors and iteration
count in one copy, beside the LM's one flag an iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.factors.base import remap_keys
from gtsam_points_tpu_torch.optim.graph import FactorGraph
from gtsam_points_tpu_torch.optim.incremental import MarginalPriorFactor, marginal_information, marginalize_system
from gtsam_points_tpu_torch.optim.lm import LMParams, LMResult, optimize_lm
from gtsam_points_tpu_torch.optim.sparse import PoseGraphEdges, optimize_pose_graph
from gtsam_points_tpu_torch.utils import se3
from gtsam_points_tpu_torch.utils.memory import children, is_node, tensors


class ISAM2ResultExt(NamedTuple):
    """Update telemetry (the reference's isam2_result_ext.hpp)."""

    error_before: float
    error_after: float
    num_factors: int
    num_values: int
    elapsed_time: float
    num_iterations: int
    num_relinearized: int = 0  # active window size this update
    num_marginalized: int = 0  # poses frozen this update
    compiled: bool = False  # True iff this update met a new window structure
    num_loop_closures: int = 0  # frozen-touching factors realized this update

    def to_string(self) -> str:
        return (
            f"error {self.error_before:.3f} -> {self.error_after:.3f} | "
            f"factors {self.num_factors} | values {self.num_values} | "
            f"window {self.num_relinearized} | marg {self.num_marginalized} | "
            f"iters {self.num_iterations} | "
            f"{f'loops {self.num_loop_closures} | ' if self.num_loop_closures else ''}"
            f"{'compile ' if self.compiled else ''}{self.elapsed_time * 1e3:.1f} ms"
        )


def structure_key(obj):
    """The reference's (treedef, leaf avals) of a factor, a tuple of
    factors or a field: a tensor by shape and dtype, a frame, voxel map or
    grid (a dataclass or NamedTuple) by its class and its fields', a tuple
    by its items', anything else (keys, thresholds) by value. For every
    factor of the port the tensor fields are the reference's data fields
    and the rest its meta fields."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), str(obj.dtype))
    if is_node(obj):
        return (type(obj).__name__,) + tuple((name, structure_key(v)) for name, v in children(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(structure_key(v) for v in obj)
    return obj


def _host(x) -> np.ndarray:
    """A pose, weights or matrix as a float32 numpy array (a tensor is copied to the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _is_prior(f) -> bool:
    return hasattr(f, "prior") and hasattr(f, "key")


def _fetch_lm(res: LMResult):
    """One copy to the host -> (poses [P, 4, 4], error before, error after, iterations)."""
    p = res.poses.shape[0]
    flat = torch.cat([res.poses.reshape(-1), res.status.error[:1], res.error.reshape(1),
                      res.status.num_iterations.to(torch.float32).reshape(1)]).cpu().numpy()
    return flat[: 16 * p].reshape(p, 4, 4), flat[16 * p], flat[16 * p + 1], int(flat[16 * p + 2])


class ISAM2Ext:
    """Incremental optimizer: push factors and initial values, optimize the
    bounded active window, marginalize what falls out.

    update(new_factors, new_values) -> ISAM2ResultExt; calculate_estimate()
    returns every pose, frozen ones included (a loop-closure relax moves
    them). A factor that touches a frozen pose is a late loop closure: a
    BetweenFactor becomes a pose-graph edge as it is, a matching factor by a
    local pair registration against its target's estimate, a PriorFactor
    joins the history skeleton; the trajectory is relaxed and a matching
    factor whose target is frozen and source active stays in the window
    with its target baked in (unary mode). enable_loop_closure=False raises
    on such factors instead. `device` (keyword only) is where the factors
    lie and the window is optimized; factors elsewhere are refused.
    """

    def __init__(
        self,
        window_size: int = 8,
        lm_params: Optional[LMParams] = None,
        max_poses: Optional[int] = None,
        enable_loop_closure: bool = True,
        full_edge_info: bool = True,
        *,
        device: DeviceLike = None,
    ):
        if max_poses is not None:  # legacy alias: capacity == window bound
            window_size = max_poses
        if window_size < 2:
            raise ValueError("window_size must be >= 2")
        self.device = resolve_device(device)
        self.window_size = window_size
        self.lm_params = lm_params or LMParams(max_iterations=10)
        self.factors: List = []  # active factors (marginal priors included), global keys
        self.estimates: Dict[int, np.ndarray] = {}  # key -> 4x4 (active and frozen)
        self.window: List[int] = []  # ordered active global keys
        self.frozen: Dict[int, np.ndarray] = {}
        self.num_values = 0
        self._structures: set = set()  # structure keys met: the reference's jitted programs
        self.enable_loop_closure = enable_loop_closure
        # True: a retired factor's full [6, 6] source-block Hessian (PD-floored
        # by eigenvalue clip) informs its skeleton edge; False: its diagonal
        self.full_edge_info = full_edge_info
        # pose-graph skeleton of frozen history: (t, s, measured 4x4, info [6, 6])
        self.history_edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        # priors retired by marginalization: (key, T 4x4, w [6])
        self.history_priors: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.loop_edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        # unary-baked loop factors with their frozen target key, so a later
        # relax can refresh their fixed_target_pose
        self._baked_loops: List[Tuple[object, int]] = []

    # -- public API ---------------------------------------------------------

    @property
    def num_compiles(self) -> int:
        return len(self._structures)

    def update(self, new_factors: List = (), new_values: Optional[dict] = None) -> ISAM2ResultExt:
        t0 = time.perf_counter()
        for f in new_factors:
            check_on(self.device, *tensors(f))
        if new_values:
            for key in sorted(new_values):
                self.estimates[key] = _host(new_values[key])
                if key not in self.window and key not in self.frozen:
                    self.window.append(key)
                self.num_values = max(self.num_values, key + 1)

        loop_factors = []
        for f in new_factors:
            frozen_keys = [k for k in f.keys if k >= 0 and k in self.frozen]
            if frozen_keys and self.enable_loop_closure:
                loop_factors.append(f)
            else:
                self.factors.append(self._adopt(f))
        if loop_factors:
            for f in loop_factors:
                if _is_prior(f):
                    # a prior on a frozen key joins the skeleton as it is
                    self.history_priors.append((f.key, _host(f.prior), _host(f.weights)))
                else:
                    self.loop_edges.append(self._realize_edge(f))
            self._relax()
            # keep the loop in the window where its frozen TARGET can be baked in
            for f in loop_factors:
                baked = self._try_bake(f)
                if baked is not None:
                    self.factors.append(baked)

        n_marg = len(self.window) - self.window_size
        if n_marg > 0:
            self._marginalize(self.window[:n_marg])
        else:
            n_marg = 0

        err_before, err_after, iters, compiled = self._optimize()
        return ISAM2ResultExt(
            error_before=err_before,
            error_after=err_after,
            num_factors=len(self.factors),
            num_values=self.num_values,
            elapsed_time=time.perf_counter() - t0,
            num_iterations=iters,
            num_relinearized=len(self.window),
            num_marginalized=n_marg,
            compiled=compiled,
            num_loop_closures=len(loop_factors),
        )

    def calculate_estimate(self) -> np.ndarray:
        """All pose estimates stacked [num_values, 4, 4] (never-seen keys identity)."""
        out = np.tile(np.eye(4, dtype=np.float32), (max(self.num_values, 1), 1, 1))
        for k, T in self.estimates.items():
            out[k] = T
        return out

    def calculate_estimate_dict(self) -> Dict[int, np.ndarray]:
        return dict(self.estimates)

    def calculate_estimate_pose(self, key: int) -> np.ndarray:
        return np.asarray(self.estimates[key])

    # -- internals ----------------------------------------------------------

    def _first(self, key) -> bool:
        """True the first time a structure key is met: where the reference
        builds (compiles) a program."""
        first = key not in self._structures
        self._structures.add(key)
        return first

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    def _bakeable(self, factor, frozen_keys) -> bool:
        return hasattr(factor, "target_key") and hasattr(factor, "fixed_target_pose") and frozen_keys == [
            factor.target_key]

    def _adopt(self, factor):
        """Validate keys; bake a frozen target pose into unary mode."""
        frozen_keys = [k for k in factor.keys if k >= 0 and k in self.frozen]
        if not frozen_keys:
            return factor
        if self._bakeable(factor, frozen_keys):
            return dataclasses.replace(factor, target_key=-1,
                                       fixed_target_pose=self._tensor(self.frozen[factor.target_key]))
        raise ValueError(
            f"factor references marginalized pose(s) {frozen_keys}; "
            f"increase window_size (currently {self.window_size})"
        )

    def _local_poses(self, keys: List[int]) -> torch.Tensor:
        return self._tensor(np.stack([self.estimates[k] for k in keys]))

    # -- loop closures -------------------------------------------------------

    def _edge_info(self, H_ss: np.ndarray) -> np.ndarray:
        """A retired factor's information from its source-block Hessian: the
        full [6, 6] (eigenvalues clipped at 1e-3) when full_edge_info, else
        its diagonal as a diag matrix. float64 on the host."""
        H = np.asarray(H_ss, np.float64)
        if not self.full_edge_info:
            return np.diag(np.clip(np.diagonal(H), 1e-3, None)).astype(np.float32)
        H = 0.5 * (H + H.T)
        w, V = np.linalg.eigh(H)
        return (V @ np.diag(np.clip(w, 1e-3, None)) @ V.T).astype(np.float32)

    @staticmethod
    def _between_edge(factor) -> Tuple[int, int, np.ndarray, np.ndarray]:
        return factor.target_key, factor.source_key, _host(factor.measured), np.diag(_host(factor.weights))

    def _realize_edge(self, factor) -> Tuple[int, int, np.ndarray, np.ndarray]:
        """A factor touching frozen pose(s) as a pose-graph edge (t, s,
        measured 4x4, info [6, 6]). A BetweenFactor directly; a matching
        factor by a local pair registration: its target fixed at its
        estimate, the source optimized under the factor alone (15 LM
        iterations), measured the registered relative pose, info its
        source-block Hessian there (see _edge_info). One copy to the host."""
        for k in (getattr(factor, "target_key", None), getattr(factor, "source_key", None)):
            if k is not None and k >= 0 and k not in self.estimates:
                raise ValueError(
                    f"loop-closure factor {type(factor).__name__} references key {k}, "
                    f"which has no estimate in this ISAM2 session (known keys: "
                    f"{sorted(self.estimates)[:8]}{'...' if len(self.estimates) > 8 else ''})"
                )
        if hasattr(factor, "measured"):  # BetweenFactor
            return self._between_edge(factor)
        if not (hasattr(factor, "target_key") and hasattr(factor, "fixed_target_pose")):
            raise ValueError(
                f"cannot realize {type(factor).__name__} touching frozen pose(s) "
                "as a loop-closure edge (supported: BetweenFactor and matching-cost "
                "factors with a fixable target; PriorFactors on frozen keys join the "
                "history as priors)"
            )
        t, s = factor.target_key, factor.source_key
        unary = dataclasses.replace(factor, target_key=-1, source_key=0,
                                    fixed_target_pose=self._tensor(self.estimates[t]))

        self._first(("edge", structure_key(unary)))
        res = optimize_lm(FactorGraph([unary], num_poses=1), self._tensor(self.estimates[s])[None],
                          LMParams(max_iterations=15))
        H_ss = unary.linearize(res.poses).H_ss
        flat = torch.cat([res.poses[0].reshape(-1), H_ss.reshape(-1)]).cpu().numpy()
        measured = (np.linalg.inv(self.estimates[t]) @ flat[:16].reshape(4, 4)).astype(np.float32)
        return (t, s, measured, self._edge_info(flat[16:].reshape(6, 6)))

    def _realize_edge_at_estimates(self, factor) -> Tuple[int, int, np.ndarray, np.ndarray]:
        """The history edge of a binary factor retired by marginalization:
        the window was just optimized, so the estimates are the factor's
        optimum; info its source-block Hessian there."""
        if hasattr(factor, "measured"):  # BetweenFactor
            return self._between_edge(factor)
        t, s = factor.target_key, factor.source_key
        local = remap_keys(factor, {t: 0, s: 1})

        self._first(("edgeinfo", structure_key(local)))
        H_ss = local.linearize(self._local_poses([t, s])).H_ss.cpu().numpy()
        measured = (np.linalg.inv(self.estimates[t]) @ self.estimates[s]).astype(np.float32)
        return (t, s, measured, self._edge_info(H_ss))

    def _try_bake(self, factor):
        """The loop factor in unary mode at the relaxed frozen target, where
        it is a matching factor with a frozen target and an active source;
        None otherwise (its pose-graph edge carries the constraint)."""
        frozen_keys = [k for k in factor.keys if k >= 0 and k in self.frozen]
        if self._bakeable(factor, frozen_keys) and factor.source_key in self.window:
            baked = dataclasses.replace(factor, target_key=-1,
                                        fixed_target_pose=self._tensor(self.frozen[factor.target_key]))
            self._baked_loops.append((baked, factor.target_key))
            return baked
        return None

    def _relax(self):
        """The global relax after a loop closure: history skeleton, loop
        edges and the active window as a rigid chain, through the
        block-sparse pose-graph LM. Every estimate (frozen ones included) is
        updated; marginal priors are re-anchored (see _reanchor) and baked
        loop factors refreshed to the relaxed frozen targets. Edge, prior
        and pose counts are padded to powers of two (at least 8), as the
        reference pads them, with zero-information edges and zero-weight
        priors that leave the padding poses at identity."""
        keys = sorted(self.estimates)
        if len(keys) < 2:
            return
        idx = {k: i for i, k in enumerate(keys)}

        edges = list(self.history_edges) + list(self.loop_edges)
        for a, b in zip(self.window, self.window[1:]):
            m = np.linalg.inv(self.estimates[a]) @ self.estimates[b]
            edges.append((a, b, m.astype(np.float32), np.diag(np.full(6, 1e6, np.float32))))

        priors = list(self.history_priors)
        for f in self.factors:
            if _is_prior(f):
                priors.append((f.key, _host(f.prior), _host(f.weights)))
        if not priors:  # gauge fix
            priors.append((keys[0], self.estimates[keys[0]], np.full(6, 1e6, np.float32)))

        def pad(n, mult=8):
            return max(mult, 1 << (n - 1).bit_length())

        E, Q, P = pad(len(edges)), pad(len(priors)), pad(len(keys))
        eye = np.eye(4, dtype=np.float32)
        e_info = np.stack([e[3] for e in edges] + [np.zeros((6, 6), np.float32)] * (E - len(edges)))

        self._first(("relax", P, E, Q))
        i32 = dict(dtype=torch.int32, device=self.device)
        pg = PoseGraphEdges(
            measured=self._tensor(np.stack([e[2] for e in edges] + [eye] * (E - len(edges)))),
            weights=self._tensor(np.diagonal(e_info, axis1=1, axis2=2)),
            t_idx=torch.tensor([idx[e[0]] for e in edges] + [0] * (E - len(edges)), **i32),
            s_idx=torch.tensor([idx[e[1]] for e in edges] + [0] * (E - len(edges)), **i32),
            prior_T=self._tensor(np.stack([p[1] for p in priors] + [eye] * (Q - len(priors)))),
            prior_w=self._tensor(np.stack([p[2] for p in priors] + [np.zeros(6, np.float32)] * (Q - len(priors)))),
            prior_idx=torch.tensor([idx[p[0]] for p in priors] + [0] * (Q - len(priors)), **i32),
            info=self._tensor(e_info),
        )
        poses0 = self._tensor(np.stack([self.estimates[k] for k in keys] + [eye] * (P - len(keys))))
        new_poses = optimize_pose_graph(pg, poses0, max_iterations=50).poses.cpu().numpy()
        if not np.all(np.isfinite(new_poses)):
            return  # keep the previous estimates
        pre_estimates = {k: self.estimates[k].copy() for k in keys}
        for k in keys:
            self.estimates[k] = new_poses[idx[k]]
        for k in self.frozen:
            self.frozen[k] = self.estimates[k]
        self.factors = [
            self._reanchor(f, pre_estimates) if isinstance(f, MarginalPriorFactor) else f
            for f in self.factors
        ]
        # refresh the baked loop factors to the relaxed frozen targets; one
        # that marginalization absorbed is dropped
        still_baked = []
        for obj, key in self._baked_loops:
            for i, f in enumerate(self.factors):
                if f is obj:
                    new_f = dataclasses.replace(obj, fixed_target_pose=self._tensor(self.frozen[key]))
                    self.factors[i] = new_f
                    still_baked.append((new_f, key))
                    break
        self._baked_loops = still_baked

    def _reanchor(self, f: MarginalPriorFactor, pre_estimates) -> MarginalPriorFactor:
        """Re-anchor a marginal prior at the relaxed estimates, transporting
        its pending offset: with T*_k = lin_k Exp(delta*_k) the prior's
        optimum before the relax, the new offset is
        delta*'_k = Log(T_pre_k⁻¹ T*_k), its residual at the pre-relax
        estimate (first order; zero when the window had converged onto the
        prior). On the host."""
        K = len(f.pose_keys)
        lin_new = np.stack([self.estimates[k] for k in f.pose_keys])
        old_lin = f.lin_poses.cpu()
        dstar = f.delta_star.cpu().reshape(K, 6)
        T_opt = old_lin @ se3.se3_exp(dstar)
        pre = np.stack([pre_estimates.get(k, self.estimates[k]) for k in f.pose_keys])
        dnew = se3.se3_log(torch.from_numpy(np.linalg.inv(pre)) @ T_opt)
        return dataclasses.replace(f, lin_poses=self._tensor(lin_new), delta_star=dnew.reshape(-1).to(self.device))

    def _marginalize(self, marg_keys: List[int]):
        marg_set = set(marg_keys)
        touching = [f for f in self.factors if any(k in marg_set for k in f.keys if k >= 0)]
        remaining = [f for f in self.factors if not any(k in marg_set for k in f.keys if k >= 0)]
        involved = sorted({k for f in touching for k in f.keys if k >= 0})
        keep = [k for k in involved if k not in marg_set]

        if self.enable_loop_closure:
            # retired factors leave a pose-graph skeleton behind for late loop closures
            for f in touching:
                ks = [k for k in f.keys if k >= 0]
                if _is_prior(f):
                    self.history_priors.append((f.key, _host(f.prior), _host(f.weights)))
                elif len(ks) == 2 and hasattr(f, "target_key") and not isinstance(f, MarginalPriorFactor):
                    self.history_edges.append(self._realize_edge_at_estimates(f))

        if touching and keep:
            # the subgraph over the involved keys only: a [6K, 6K] system
            mapping = {k: i for i, k in enumerate(involved)}
            local = tuple(remap_keys(f, mapping) for f in touching)
            marg_slots = tuple(mapping[k] for k in marg_keys if k in mapping)
            keep_slots = tuple(mapping[k] for k in keep)

            self._first(("marg", structure_key(local), marg_slots, keep_slots))
            poses_local = self._local_poses(involved)
            A, b, _ = FactorGraph(list(local), num_poses=len(involved)).linearize_full(poses_local)
            sqrt_info_t, delta_star = marginal_information(
                *marginalize_system(A, b, list(marg_slots), list(keep_slots)))
            keep_idx = torch.tensor([mapping[k] for k in keep], dtype=torch.long, device=self.device)
            remaining.append(MarginalPriorFactor(lin_poses=poses_local[keep_idx], sqrt_info_t=sqrt_info_t,
                                                 delta_star=delta_star, pose_keys=tuple(keep)))
        self.factors = remaining
        for k in marg_keys:
            self.frozen[k] = self.estimates[k]
            self.window.remove(k)

    def _optimize(self) -> Tuple[float, float, int, bool]:
        if not self.window or not self.factors:
            return 0.0, 0.0, 0, False
        mapping = {k: i for i, k in enumerate(self.window)}
        for f in self.factors:
            unknown = [k for k in f.keys if k >= 0 and k not in mapping]
            if unknown:
                raise ValueError(
                    f"factor {type(f).__name__} references key(s) {unknown} with no "
                    "value in the active window (add the value first)"
                )
        local = tuple(remap_keys(f, mapping) for f in self.factors)
        key = structure_key(local)
        params = self.lm_params
        num_poses = len(self.window)
        compiled = self._first(("opt", key, num_poses, params))
        graph = FactorGraph(list(local), num_poses=num_poses)
        poses0 = self._local_poses(self.window)
        new_poses, err0, err1, n_iter = _fetch_lm(optimize_lm(graph, poses0, params))
        if not np.all(np.isfinite(new_poses)):
            # retry once with heavy damping (the reference's fixed-lag
            # smoother with fallback rebuilds the same way)
            heavy = dataclasses.replace(params, lambda_initial=1e2)
            compiled = self._first(("opt", key, num_poses, heavy)) or compiled
            new_poses, err0, err1, n_iter = _fetch_lm(optimize_lm(graph, poses0, heavy))
            if not np.all(np.isfinite(new_poses)):
                return float(err0), float(err1), 0, compiled  # keep the previous estimates
        for k, i in mapping.items():
            self.estimates[k] = new_poses[i]
        return (float(err0), float(err1), int(n_iter), compiled)


class ISAM2ExtDummy(ISAM2Ext):
    """No-op variant (the reference's isam2_ext_dummy.hpp, for debugging
    with optimization disabled): update() records factors and values but
    never optimizes or marginalizes."""

    def update(self, new_factors: List = (), new_values: Optional[dict] = None) -> ISAM2ResultExt:
        t0 = time.perf_counter()
        if new_values:
            for key in sorted(new_values):
                self.estimates[key] = _host(new_values[key])
                if key not in self.window:
                    self.window.append(key)
                self.num_values = max(self.num_values, key + 1)
        self.factors.extend(new_factors)
        return ISAM2ResultExt(
            0.0, 0.0, len(self.factors), self.num_values, time.perf_counter() - t0, 0
        )
