from gtsam_points_tpu_torch.pipelines.odometry import (
    FrameToFrameState,
    OdometryParams,
    OdometryState,
    frame_to_frame_step,
    init_odometry,
    make_odometry_stepper,
    odometry_step,
)

__all__ = [
    "FrameToFrameState",
    "OdometryParams",
    "OdometryState",
    "frame_to_frame_step",
    "init_odometry",
    "make_odometry_stepper",
    "odometry_step",
]
