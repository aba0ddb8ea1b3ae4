from gtsam_points_tpu_torch.registration.pyramid import (
    DEFAULT_STAGES,
    QUALITY_STAGES,
    PyramidStage,
    StageSpec,
    build_pyramid,
    register_pair_pyramid,
    register_scan_pyramid,
)
