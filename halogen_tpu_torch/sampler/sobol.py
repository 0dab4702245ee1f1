"""Owen-scrambled Sobol sampler on uint32 (PyTorch port of
`halogen_tpu/sampler/sobol.py`).

Bit for bit the JAX sampler (and the reference's `HalogenRandom.hlsl`).
Torch has no uint32 arithmetic with shifts and multiplies on every
backend, so a uint32 value is held in an int64 tensor and masked with
`& 0xFFFFFFFF` after every `*`, `+` and `<<`; that reproduces the JAX
uint32 wraparound exactly. int64 -> float32 rounds to nearest, as
`uint32.astype(float32)` does.

Every function takes int64 tensors (or Python ints) of broadcastable shape
and returns int64 tensors holding uint32 values (or float32 samples).
"""

from __future__ import annotations

import numpy as np
import torch

# Dimension IDs for the random events of a path (HalogenRandom.hlsl:61-74).
# Camera events use the base IDs; bounce k uses ID + 5*k.
DIM_FOCAL_DISC = 0
DIM_RAY_JITTER = 1
DIM_ROUGH_REFLECTION = 2
DIM_MATERIAL_BRDF = 3
DIM_RUSSIAN_ROULETTE = 4
BOUNCE_DIM_STRIDE = 5
DIM_ENV_NEE_BASE = 1 << 16
DIM_LIGHT_NEE_SEL = 1 << 17
DIM_LIGHT_NEE_POINT = (1 << 17) + 1

MASK32 = 0xFFFFFFFF

# 4 x 32 Sobol direction numbers (HalogenRandom.hlsl:10-46; the standard
# first-four-dimension Joe-Kuo direction numbers).
_SOBOL_DIRECTIONS = np.array(
    [
        [1 << (31 - b) for b in range(32)],
        [0x80000000, 0xC0000000, 0xA0000000, 0xF0000000,
         0x88000000, 0xCC000000, 0xAA000000, 0xFF000000,
         0x80800000, 0xC0C00000, 0xA0A00000, 0xF0F00000,
         0x88880000, 0xCCCC0000, 0xAAAA0000, 0xFFFF0000,
         0x80008000, 0xC000C000, 0xA000A000, 0xF000F000,
         0x88008800, 0xCC00CC00, 0xAA00AA00, 0xFF00FF00,
         0x80808080, 0xC0C0C0C0, 0xA0A0A0A0, 0xF0F0F0F0,
         0x88888888, 0xCCCCCCCC, 0xAAAAAAAA, 0xFFFFFFFF],
        [0x80000000, 0xC0000000, 0x60000000, 0x90000000,
         0xE8000000, 0x5C000000, 0x8E000000, 0xC5000000,
         0x68800000, 0x9CC00000, 0xEE600000, 0x55900000,
         0x80680000, 0xC09C0000, 0x60EE0000, 0x90550000,
         0xE8808000, 0x5CC0C000, 0x8E606000, 0xC5909000,
         0x6868E800, 0x9C9C5C00, 0xEEEE8E00, 0x5555C500,
         0x8000E880, 0xC0005CC0, 0x60008E60, 0x9000C590,
         0xE8006868, 0x5C009C9C, 0x8E00EEEE, 0xC5005555],
        [0x80000000, 0xC0000000, 0x20000000, 0x50000000,
         0xF8000000, 0x74000000, 0xA2000000, 0x93000000,
         0xD8800000, 0x25400000, 0x59E00000, 0xE6D00000,
         0x78080000, 0xB40C0000, 0x82020000, 0xC3050000,
         0x208F8000, 0x51474000, 0xFBEA2000, 0x75D93000,
         0xA0858800, 0x914E5400, 0xDBE79E00, 0x25DB6D00,
         0x58800080, 0xE54000C0, 0x79E00020, 0xB6D00050,
         0x800800F8, 0xC00C0074, 0x200200A2, 0x50050093],
    ],
    dtype=np.uint32,
)


def _u32(x) -> torch.Tensor:
    """A uint32 value (Python int or integer tensor) as a masked int64
    tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(np.asarray(x, np.uint64).astype(np.int64)
                           & MASK32)


def u32_hash(value) -> torch.Tensor:
    """PCG output hash (HalogenRandom.hlsl:110-115)."""
    v = _u32(value)
    state = (v * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def hash_combine(seed, v) -> torch.Tensor:
    """Boost-style hash combine (HalogenRandom.hlsl:131-133)."""
    seed = _u32(seed)
    v = _u32(v)
    return seed ^ ((v + ((seed << 6) & MASK32) + (seed >> 2)) & MASK32)


def reverse_bits_u32(x) -> torch.Tensor:
    """Bit-reversal of a uint32 (HLSL `reversebits`)."""
    x = _u32(x)
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return (x >> 16) | ((x << 16) & MASK32)


def owen_scramble(value, seed) -> torch.Tensor:
    """Hash-based Owen scramble (HalogenRandom.hlsl:140-161)."""
    seed = _u32(seed)
    x = reverse_bits_u32(value)
    x = x ^ ((x * 0x3D20ADEA) & MASK32)
    x = (x + seed) & MASK32
    x = (x * ((seed >> 16) | 1)) & MASK32
    x = x ^ ((x * 0x05526C56) & MASK32)
    x = x ^ ((x * 0x53A22864) & MASK32)
    return reverse_bits_u32(x)


def sobol1d(index, dim: int) -> torch.Tensor:
    """Sobol point for one of the 4 tabulated dimensions
    (HalogenRandom.hlsl:178-185)."""
    index = _u32(index)
    x = torch.zeros_like(index)
    for bit in range(32):
        mask = (index >> bit) & 1
        x = x ^ (mask * int(_SOBOL_DIRECTIONS[dim, bit]))
    return x


def sobol_dim1_reversed(index) -> torch.Tensor:
    """`reverse_bits_u32(sobol1d(index, 1))` in five steps. Dimension 1's
    direction numbers are the rows of Pascal's triangle mod 2, bit-reversed,
    so the product with them is a butterfly: the form the CUDA kernels use
    (`csrc/path_common.cuh`), where the reversal then cancels against the
    one that opens `owen_scramble`."""
    y = _u32(index)
    y = y ^ ((y >> 1) & 0x55555555)
    y = y ^ ((y >> 2) & 0x33333333)
    y = y ^ ((y >> 4) & 0x0F0F0F0F)
    y = y ^ ((y >> 8) & 0x00FF00FF)
    return y ^ ((y >> 16) & 0x0000FFFF)


def _seeded(dimension, seed):
    return _u32(seed) ^ u32_hash(dimension)


def u32_owen_scrambled_sobol_1d(index, dimension, seed) -> torch.Tensor:
    """1D scrambled Sobol (HalogenRandom.hlsl:203-209): scrambles the
    value but does NOT shuffle the index (reference quirk)."""
    seed = _seeded(dimension, seed)
    return owen_scramble(sobol1d(index, 0), u32_hash(seed))


def u32_owen_scrambled_sobol_2d(index, dimension, seed):
    """2D shuffled+scrambled Sobol (HalogenRandom.hlsl:215-228)."""
    seed = _seeded(dimension, seed)
    shuffled = owen_scramble(_u32(index), seed)
    x = owen_scramble(sobol1d(shuffled, 0), hash_combine(seed, 0))
    y = owen_scramble(sobol1d(shuffled, 1), hash_combine(seed, 1))
    return x, y


def u32_owen_scrambled_sobol_4d(index, dimension, seed):
    """4D shuffled+scrambled Sobol (HalogenRandom.hlsl:235-250)."""
    seed = _seeded(dimension, seed)
    shuffled = owen_scramble(_u32(index), seed)
    return tuple(
        owen_scramble(sobol1d(shuffled, d), hash_combine(seed, d))
        for d in range(4)
    )


_INV_U32 = float(np.float32(1.0 / 4294967296.0))


def _to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """uint32 -> [0, 1) float32 (divide by 2^32, HalogenRandom.hlsl:258)."""
    return u.to(torch.float32) * _INV_U32


def ld_sample_1d(index, dimension, seed) -> torch.Tensor:
    """Float low-discrepancy sample in [0,1) (HalogenRandom.hlsl:252-259)."""
    return _to_unit_float(u32_owen_scrambled_sobol_1d(index, dimension, seed))


def ld_sample_2d(index, dimension, seed):
    """2D float low-discrepancy sample (HalogenRandom.hlsl:261-268)."""
    x, y = u32_owen_scrambled_sobol_2d(index, dimension, seed)
    return _to_unit_float(x), _to_unit_float(y)


def ld_sample_4d(index, dimension, seed):
    """4D float low-discrepancy sample (HalogenRandom.hlsl:270-277)."""
    return tuple(_to_unit_float(u)
                 for u in u32_owen_scrambled_sobol_4d(index, dimension, seed))


# PRNG ablation path (OVERRIDE_SAMPLING_TO_PRNG, HalogenDefines.hlsl:9):
# counter-based, the event index folds into the hash.

def prng_sample_1d(index, dimension, seed) -> torch.Tensor:
    """Counter-based PCG stand-in for `random_value()`
    (HalogenRandom.hlsl:99-102)."""
    h = u32_hash(hash_combine(hash_combine(seed, index), dimension))
    return _to_unit_float(h)


def prng_sample_2d(index, dimension, seed):
    h0 = hash_combine(hash_combine(seed, index), dimension)
    return (_to_unit_float(u32_hash(h0)),
            _to_unit_float(u32_hash(h0 ^ 0x9E3779B9)))


def pixel_seed(pixel_index) -> torch.Tensor:
    """Per-pixel sampler seed: PCG-hashed flat pixel id
    (HalogenRandom.hlsl:117-124)."""
    return u32_hash(pixel_index)


def sample_index(frame, spp_idx, spp: int) -> torch.Tensor:
    """Global sample index frame * spp + lane (SURVEY.md §3.4 redesign)."""
    return (_u32(frame) * spp + _u32(spp_idx)) & MASK32
