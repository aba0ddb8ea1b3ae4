from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.factors.icp import ICPFactor, make_icp_factor
from gtsam_points_tpu_torch.factors.gicp import GICPFactor, make_gicp_factor
from gtsam_points_tpu_torch.factors.vgicp import (
    VGICPClustersFactor,
    VGICPFactor,
    make_vgicp_clusters_factor,
    make_vgicp_factor,
)
from gtsam_points_tpu_torch.factors.pose_factors import BetweenFactor, LinearDampingFactor, PriorFactor
from gtsam_points_tpu_torch.factors.batch import VGICPFactorBatch, make_vgicp_factor_batch
from gtsam_points_tpu_torch.factors.loam import (
    LOAMFactor,
    PointToEdgeFactor,
    PointToPlaneLOAMFactor,
    make_loam_factor,
)
from gtsam_points_tpu_torch.factors.ct_icp import CTICPFactor, deskew, interpolate_poses, make_ct_icp_factor
from gtsam_points_tpu_torch.factors.balm import (
    EdgeEVMFactor,
    LsqBAFactor,
    PlaneEVMFactor,
    make_evm_factor,
    make_lsq_ba_factor,
)
from gtsam_points_tpu_torch.factors.misc_factors import (
    Pose3CalibFactor,
    Pose3InterpolationFactor,
    RotateVector3Factor,
)

__all__ = [
    "Linearized",
    "ICPFactor",
    "make_icp_factor",
    "GICPFactor",
    "make_gicp_factor",
    "VGICPFactor",
    "VGICPClustersFactor",
    "make_vgicp_factor",
    "make_vgicp_clusters_factor",
    "PriorFactor",
    "BetweenFactor",
    "LinearDampingFactor",
    "VGICPFactorBatch",
    "make_vgicp_factor_batch",
    "LOAMFactor",
    "PointToEdgeFactor",
    "PointToPlaneLOAMFactor",
    "make_loam_factor",
    "CTICPFactor",
    "make_ct_icp_factor",
    "deskew",
    "interpolate_poses",
    "PlaneEVMFactor",
    "EdgeEVMFactor",
    "LsqBAFactor",
    "make_evm_factor",
    "make_lsq_ba_factor",
    "Pose3CalibFactor",
    "Pose3InterpolationFactor",
    "RotateVector3Factor",
]
