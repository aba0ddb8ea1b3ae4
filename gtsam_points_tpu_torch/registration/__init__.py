from gtsam_points_tpu_torch.registration.alignment import align_points_4dof, align_points_se3
from gtsam_points_tpu_torch.registration.fpfh import FPFH_DIM, estimate_fpfh, estimate_pfh, feature_knn
from gtsam_points_tpu_torch.registration.ransac import (
    RANSACParams,
    RegistrationResult,
    estimate_pose_ransac,
    estimate_pose_ransac_from_draws,
    overlap_score,
    ransac_draws,
)
from gtsam_points_tpu_torch.registration.gnc import GNCParams, estimate_pose_gnc
from gtsam_points_tpu_torch.registration.cluster import (
    DEFAULT_CLUSTER_CAPACITY,
    DEFAULT_CLUSTER_LEAF,
    DEFAULT_CLUSTER_STAGES,
    QUALITY_CLUSTER_STAGES,
    SourceClusters,
    cluster_source,
    insert_clusters_incremental,
    register_clusters_pyramid,
)
from gtsam_points_tpu_torch.registration.pyramid import (
    DEFAULT_STAGES,
    QUALITY_STAGES,
    PyramidStage,
    StageSpec,
    build_pyramid,
    register_pair_pyramid,
    register_scan_pyramid,
)
