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
