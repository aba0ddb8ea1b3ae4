from gtsam_points_tpu_torch.types.frame import Frame, make_frame, merge_frames, transform_frame
