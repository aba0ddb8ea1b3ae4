from gtsam_points_tpu_torch.segmentation.region_growing import RegionGrowingParams, region_growing
from gtsam_points_tpu_torch.segmentation.min_cut import MinCutParams, min_cut

__all__ = ["region_growing", "RegionGrowingParams", "min_cut", "MinCutParams"]
