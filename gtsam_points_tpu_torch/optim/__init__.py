from gtsam_points_tpu_torch.optim.dogleg import DoglegParams, DoglegResult, gradient_descent, optimize_dogleg
from gtsam_points_tpu_torch.optim.graph import FactorGraph, retract
from gtsam_points_tpu_torch.optim.lm import GNResult, LMParams, LMResult, LMStatus, optimize_gn, optimize_lm
from gtsam_points_tpu_torch.optim.isam2 import ISAM2Ext, ISAM2ExtDummy, ISAM2ResultExt
from gtsam_points_tpu_torch.optim.incremental import (
    FixedLagSmoother,
    MarginalPriorFactor,
    make_marginal_prior,
    marginalize_system,
)
from gtsam_points_tpu_torch.optim.solvers import block_jacobi_preconditioner, cg_solve, schur_pose_landmark
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
    "ISAM2Ext",
    "ISAM2ExtDummy",
    "ISAM2ResultExt",
    "FixedLagSmoother",
    "MarginalPriorFactor",
    "make_marginal_prior",
    "marginalize_system",
    "block_jacobi_preconditioner",
    "cg_solve",
    "schur_pose_landmark",
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
