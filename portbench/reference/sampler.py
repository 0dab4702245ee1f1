"""Owen-scrambled Sobol sampler on uint32, the Blackman-Harris filter's
inverse CDF and the sphere and disc warps, in plain PyTorch (a frozen copy
of the port's plain sampler, from `HalogenRandom.hlsl` of the upstream
renderer). A uint32 value is held in an int64 tensor and masked with
`& 0xFFFFFFFF` after every `*`, `+` and `<<`.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import sqrt

# Dimension IDs for the random events of a path (HalogenRandom.hlsl:61-74).
# Camera events use the base IDs; bounce k uses ID + 5*k.
DIM_FOCAL_DISC = 0
DIM_RAY_JITTER = 1
DIM_ROUGH_REFLECTION = 2
DIM_MATERIAL_BRDF = 3
DIM_RUSSIAN_ROULETTE = 4
BOUNCE_DIM_STRIDE = 5

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


def _byte_tables() -> torch.Tensor:
    """[4, 4, 256] int64: for dimension d and byte position k, the XOR of
    the direction numbers of the set bits of each byte value."""
    t = np.zeros((4, 4, 256), np.int64)
    for d in range(4):
        for k in range(4):
            for v in range(256):
                x = 0
                for b in range(8):
                    if v >> b & 1:
                        x ^= int(_SOBOL_DIRECTIONS[d, 8 * k + b])
                t[d, k, v] = x
    return torch.from_numpy(t)


_TABLES = _byte_tables()
_ON_DEVICE: dict = {}


def sobol1d(index, dim: int) -> torch.Tensor:
    """Sobol point for one of the 4 tabulated dimensions
    (HalogenRandom.hlsl:178-185): the XOR of the direction numbers of the
    index's set bits, a byte at a time."""
    index = _u32(index)
    if index.device not in _ON_DEVICE:
        _ON_DEVICE[index.device] = _TABLES.to(index.device)
    tab = _ON_DEVICE[index.device][dim]
    x = tab[0][index & 0xFF]
    for k in range(1, 4):
        x = x ^ tab[k][(index >> (8 * k)) & 0xFF]
    return x


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


def pixel_seed(pixel_index) -> torch.Tensor:
    """Per-pixel sampler seed: PCG-hashed flat pixel id
    (HalogenRandom.hlsl:117-124)."""
    return u32_hash(pixel_index)


def sample_index(frame, spp_idx, spp: int) -> torch.Tensor:
    """Global sample index frame * spp + lane (SURVEY.md §3.4 redesign)."""
    return (_u32(frame) * spp + _u32(spp_idx)) & MASK32


_TWO_PI = float(np.float32(2.0 * np.pi))


def unit_vector_from_2d(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from two [0,1) samples
    (HalogenRandom.hlsl:282-298). Returns [..., 3]."""
    theta = u * _TWO_PI
    cos_phi = 2.0 * v - 1.0
    sin_phi = sqrt(torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0))
    return torch.stack([sin_phi * torch.cos(theta), sin_phi * torch.sin(theta),
                        cos_phi], dim=-1)


def point_in_circle(radius, u: torch.Tensor, v: torch.Tensor):
    """Point inside a disc of `radius` (HalogenRandom.hlsl:303-308); the
    radial coordinate is linear in the sample, as in the reference."""
    theta = u * _TWO_PI
    r = radius * v
    return torch.cos(theta) * r, torch.sin(theta) * r


def _arctanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.log((1.0 + x) / (1.0 - x))


def inverse_blackman_harris_cdf(x: torch.Tensor) -> torch.Tensor:
    """Inverse-transform sampling of the Blackman-Harris distribution via
    the reference's analytic CDF-inverse approximation
    (HalogenRandom.hlsl:328-330). Maps [0,1) -> ~[-0.5, 0.5]."""
    return _arctanh(x * 1.99221575606 - 0.99610787803) / 6.24
