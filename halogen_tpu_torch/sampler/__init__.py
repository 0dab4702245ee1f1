from halogen_tpu_torch.sampler.sobol import (
    DIM_FOCAL_DISC,
    DIM_RAY_JITTER,
    DIM_ROUGH_REFLECTION,
    DIM_MATERIAL_BRDF,
    DIM_RUSSIAN_ROULETTE,
    BOUNCE_DIM_STRIDE,
    u32_hash,
    owen_scramble,
    sobol1d,
    ld_sample_1d,
    ld_sample_2d,
    ld_sample_4d,
)
from halogen_tpu_torch.sampler.mappings import (
    unit_vector_from_2d,
    point_in_circle,
    blackman_harris_filter,
    inverse_blackman_harris_cdf,
)

__all__ = [
    "DIM_FOCAL_DISC", "DIM_RAY_JITTER", "DIM_ROUGH_REFLECTION",
    "DIM_MATERIAL_BRDF", "DIM_RUSSIAN_ROULETTE", "BOUNCE_DIM_STRIDE",
    "u32_hash", "owen_scramble", "sobol1d",
    "ld_sample_1d", "ld_sample_2d", "ld_sample_4d",
    "unit_vector_from_2d", "point_in_circle",
    "blackman_harris_filter", "inverse_blackman_harris_cdf",
]
