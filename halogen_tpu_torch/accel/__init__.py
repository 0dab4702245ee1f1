from halogen_tpu_torch.accel.bvh import (
    BVH,
    MAX_DEPTH,
    MAX_LEAF_TRIS,
    build_bvh,
    bvh_stats,
    validate_bvh,
)

__all__ = ["BVH", "build_bvh", "bvh_stats", "validate_bvh", "MAX_LEAF_TRIS",
           "MAX_DEPTH"]
