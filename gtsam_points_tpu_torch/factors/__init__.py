from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.factors.icp import ICPFactor, make_icp_factor
from gtsam_points_tpu_torch.factors.gicp import GICPFactor, make_gicp_factor
from gtsam_points_tpu_torch.factors.vgicp import (
    VGICPClustersFactor,
    VGICPFactor,
    make_vgicp_clusters_factor,
    make_vgicp_factor,
)
from gtsam_points_tpu_torch.factors.pose_factors import PriorFactor

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
]
