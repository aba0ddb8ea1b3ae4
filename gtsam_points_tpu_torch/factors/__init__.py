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
from gtsam_points_tpu_torch.factors.colored import (
    ColorConsistencyFactor,
    ColoredGICPFactor,
    estimate_intensity_gradients,
    estimate_intensity_gradients_ivox,
    lookup_intensity_gradients_ivox,
    make_color_consistency_factor,
    make_colored_gicp_factor,
)
from gtsam_points_tpu_torch.factors.imu import ImuMeasurements, ReintegratedImuFactor, make_imu_measurements, reintegrate
from gtsam_points_tpu_torch.factors.experimental import (
    Sim3,
    align_trajectories_sim3,
    between_sim3_se3_error,
    scaled_transform,
    sim3_apply,
    sim3_identity,
    sim3_matrix,
    sim3_retract,
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
    "ColorConsistencyFactor",
    "ColoredGICPFactor",
    "estimate_intensity_gradients",
    "estimate_intensity_gradients_ivox",
    "lookup_intensity_gradients_ivox",
    "make_color_consistency_factor",
    "make_colored_gicp_factor",
    "ImuMeasurements",
    "ReintegratedImuFactor",
    "make_imu_measurements",
    "reintegrate",
    "Sim3",
    "sim3_identity",
    "sim3_matrix",
    "sim3_apply",
    "sim3_retract",
    "scaled_transform",
    "between_sim3_se3_error",
    "align_trajectories_sim3",
]
