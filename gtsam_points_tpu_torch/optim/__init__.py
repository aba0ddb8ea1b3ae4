from gtsam_points_tpu_torch.optim.dogleg import DoglegParams, DoglegResult, gradient_descent, optimize_dogleg
from gtsam_points_tpu_torch.optim.graph import FactorGraph, retract
from gtsam_points_tpu_torch.optim.lm import GNResult, LMParams, LMResult, LMStatus, optimize_gn, optimize_lm
from gtsam_points_tpu_torch.optim.sparse import (
    PoseGraphEdges,
    PoseGraphResult,
    SparseSystem,
    linearize_pose_graph,
    make_pose_graph,
    optimize_pose_graph,
    pose_graph_error,
    solve_cg_block,
    sparse_matvec,
)

__all__ = [
    "DoglegParams",
    "DoglegResult",
    "gradient_descent",
    "optimize_dogleg",
    "FactorGraph",
    "retract",
    "GNResult",
    "LMParams",
    "LMResult",
    "LMStatus",
    "optimize_gn",
    "optimize_lm",
    "PoseGraphEdges",
    "PoseGraphResult",
    "SparseSystem",
    "linearize_pose_graph",
    "make_pose_graph",
    "optimize_pose_graph",
    "pose_graph_error",
    "solve_cg_block",
    "sparse_matvec",
]
