"""Render configuration (PyTorch port of `halogen_tpu/config.py`).

Field names, defaults and the `__post_init__` clamps are identical to the
JAX package, so `RenderSettings(**dataclasses.asdict(jax_settings))`
builds the same configuration. The settings mirror the reference's
`HalogenSettings` (`HalogenRenderFeature.cs:24-67`) plus the compile-time
flags of `HalogenDefines.hlsl:4-10`.
"""

from __future__ import annotations

import dataclasses
import enum


class DebugMode(enum.IntEnum):
    """Debug render views (reference `HalogenRenderFeature.cs:6-13`)."""

    NONE = 0
    ALBEDO = 1
    NORMAL = 2
    RAY_TRIANGLE_TESTS = 3
    RAY_BOX_TESTS = 4
    COMBINED = 5


class SamplerKind(enum.IntEnum):
    """Owen-scrambled Sobol, or the PCG PRNG ablation
    (reference `HalogenDefines.hlsl:9` OVERRIDE_SAMPLING_TO_PRNG)."""

    SOBOL = 0
    PRNG = 1


class Fused(enum.IntEnum):
    """Fused-bounce megakernel dispatch (`kernels/megakernel.py`).

    In the port AUTO and FORCE mean the same: on a CUDA device every frame
    goes through the CUDA megakernel, which raises NotImplementedError for
    a scene outside its caps (`megakernel.fused_supported`); on the CPU the
    lockstep integrator, the kernel's plain version, runs. OFF always uses
    the lockstep integrator.
    """

    AUTO = 0
    OFF = 1
    FORCE = 2


class Intersector(enum.IntEnum):
    """Scene-intersection backend. The port has the brute-force tier only;
    AUTO resolves to BRUTE."""

    AUTO = 0
    BRUTE = 1
    BVH = 2
    PALLAS = 3
    TREELET = 4
    FLATLET = 5
    RAYLET = 6


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render settings; field-by-field the JAX package's."""

    # Image
    width: int = 256
    height: int = 256

    # Sampling
    samples_per_pixel: int = 1
    max_accumulated_frames: int = 16
    unlimited_sampling: bool = True
    accumulate: bool = True

    # Bounces (a limit of N allows N+1 interactions of that type before
    # termination — reference `HalgoenCompute.compute:869-871` uses `>`)
    max_bounces: int = 12
    max_diffuse_bounces: int = 4
    max_glossy_bounces: int = 4
    max_transmission_bounces: int = 12

    # Film
    filter_radius: float = 1.0  # in pixels

    # Environment
    use_envmap: bool = False
    env_mip_level: int = 1
    env_importance_sampling: bool = False
    light_importance_sampling: bool = False

    # Compile-time flags (HalogenDefines.hlsl:4-10)
    mip_importance_bias: bool = True
    mip_importance_range: float = 8.0
    sampler: SamplerKind = SamplerKind.SOBOL
    russian_roulette: bool = True

    # Debug
    debug_mode: DebugMode = DebugMode.NONE
    first_interaction_only: bool = False
    triangle_debug_display_range: int = 64
    box_debug_display_range: int = 64

    # Execution knobs (no reference counterpart)
    intersector: Intersector = Intersector.AUTO
    fused: Fused = Fused.AUTO
    wavefront: bool = False
    wavefront_block: int = 8192
    ray_chunk_size: int = 65536  # rays traced per inner step (memory bound)
    triangle_block: int = 128
    brute_force_max_tris: int = 4096

    def __post_init__(self):
        clamp = lambda name, lo, hi=None: object.__setattr__(
            self, name, max(lo, getattr(self, name)) if hi is None
            else min(hi, max(lo, getattr(self, name))))
        # Defensive clamping mirrors HalogenRenderPass.cs:169-233
        clamp("samples_per_pixel", 1)
        clamp("max_bounces", 0)
        clamp("max_diffuse_bounces", 0)
        clamp("max_glossy_bounces", 0)
        clamp("max_transmission_bounces", 0)
        clamp("filter_radius", 0.0)
        clamp("max_accumulated_frames", 1)
        clamp("env_mip_level", 0, 2)
        clamp("triangle_debug_display_range", 1)
        clamp("box_debug_display_range", 1)
        if self.debug_mode != DebugMode.NONE and self.first_interaction_only:
            object.__setattr__(self, "max_bounces", 0)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)
