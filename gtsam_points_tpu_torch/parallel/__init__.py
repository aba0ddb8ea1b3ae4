from gtsam_points_tpu_torch.parallel.sharding import (
    Mesh,
    init_distributed,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_frame,
)
from gtsam_points_tpu_torch.parallel.sharded_voxelmap import (
    VGICPShardedFactor,
    build_sharded_voxelmap,
    collective_bytes_per_linearize,
    linearize_vgicp_sharded,
    make_vgicp_sharded_factor,
    place_sharded,
    shard_of_keys,
    sharded_insert_frame,
    sharded_num_voxels,
    sharded_overlap,
)
